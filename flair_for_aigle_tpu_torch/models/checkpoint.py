"""Checkpoint conversion and loading for the PyTorch port.

* ``state_dict_from_flax`` turns the JAX package's numpy parameter trees
  into a torch state dict, with the rules of
  ``flair_for_aigle_tpu/models/checkpoint.py:155 export_torch_state_dict``
  (HWIO -> OIHW, transposed convolutions HWIO flipped -> IOHW, Linear
  kernel transpose, ``torch_key_for`` leaf names).
* ``load_checkpoint`` ports the reference loader behaviour of
  ``flair_for_aigle_tpu/models/checkpoint.py:346``: read ``.safetensors`` or
  a torch checkpoint, strip a ``model.`` prefix the target lacks, apply the
  external key-layout aliases, re-initialise task heads whose class count
  differs (Xavier weight, zero bias), interpolate Swin relative-position
  bias tables (bicubic), keep the init for other shape mismatches, load
  non-strictly and log per-module coverage.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from flair_for_aigle_tpu_torch.models.flair_model import FLAIR_TRANSPOSE_CONV_PATTERNS

logger = logging.getLogger(__name__)

_LEAF_TO_TORCH = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def _flatten(tree: Mapping[str, Any], prefix=()) -> dict[tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def torch_key_for(path: tuple[str, ...]) -> str:
    *mods, leaf = path
    suffix = _LEAF_TO_TORCH.get(leaf, leaf)
    return ".".join([*mods, suffix]) if mods else suffix


def state_dict_from_flax(params: Mapping[str, Any],
                         batch_stats: Mapping[str, Any] | None = None,
                         transpose_conv_patterns: tuple[str, ...] = FLAIR_TRANSPOSE_CONV_PATTERNS
                         ) -> dict[str, torch.Tensor]:
    """Flax ``params`` (+ ``batch_stats``) trees of numpy arrays -> torch
    state dict (float32 tensors in the torch layout). A 4-D kernel is HWIO
    -> OIHW, except on a path that contains one of
    ``transpose_conv_patterns``: a transposed convolution's kernel, stored
    spatially flipped in HWIO, becomes (I, O, kH, kW) unflipped."""
    out = {}
    for tree in (params, batch_stats or {}):
        for path, leaf in _flatten(tree).items():
            v = np.asarray(leaf)
            if v.ndim == 4 and any(p in ".".join(path) for p in transpose_conv_patterns):
                v = np.transpose(v, (2, 3, 0, 1))[:, :, ::-1, ::-1]
            elif v.ndim == 4:
                v = np.transpose(v, (3, 2, 0, 1))
            elif v.ndim == 2 and path[-1] == "kernel":
                v = v.T
            out[torch_key_for(path)] = torch.tensor(np.ascontiguousarray(v))
    return out


def read_torch_checkpoint(path: str) -> dict[str, np.ndarray]:
    """Load .safetensors or torch .ckpt/.pt/.pth into numpy arrays."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return dict(load_file(path))
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items()}


def strip_model_prefix_if_needed(state_dict: dict, target_keys) -> dict:
    """Remove a 'model.' prefix when the target keys do not use it."""
    ckpt_has = any(k.startswith("model.") for k in state_dict)
    target_lacks = all(not k.startswith("model.") for k in target_keys)
    if ckpt_has and target_lacks:
        return {(k[len("model."):] if k.startswith("model.") else k): v
                for k, v in state_dict.items()}
    return state_dict


# published smp-0.4.0 / timm-1.x spellings -> canonical tree; each rewrite is
# kept only if it strictly increases the matched-key count
_EXTERNAL_ALIASES: tuple[tuple[str, str, str], ...] = (
    ("getter-nesting", r"\.model\.model\.", ".model."),
    ("flattened-stages", r"\.layers_(\d+)\.", r".layers.\1."),
    ("psp-sequential", r"\.psp\.blocks\.(\d+)\.1\.", r".psp.blocks.\1.pool.1."),
    ("psp-last-conv", r"\.psp_last_conv\.", ".psp.out_conv."),
)


def normalize_external_state_dict(state_dict: dict, target_keys
                                  ) -> tuple[dict, list[str]]:
    targets = set(target_keys)

    def n_matched(sd):
        return sum(1 for k in sd if k in targets)

    applied = []
    best = n_matched(state_dict)
    for name, pat, repl in _EXTERNAL_ALIASES:
        rewritten, clash = {}, False
        for k, v in state_dict.items():
            nk = re.sub(pat, repl, "." + k)[1:]
            if nk in rewritten:
                clash = True
                break
            rewritten[nk] = v
        if clash:
            continue
        score = n_matched(rewritten)
        if score > best:
            state_dict, best = rewritten, score
            applied.append(name)
    return state_dict, applied


def _bicubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax <= 1, (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1,
        np.where(ax < 2, a * ax ** 3 - 5 * a * ax ** 2 + 8 * a * ax - 4 * a, 0.0))


def bicubic_resize_2d(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """torch F.interpolate(mode='bicubic', align_corners=False) on (H, W, C)."""

    def axis_weights(in_size, out_size):
        src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
        idx = np.floor(src).astype(int)[:, None] + np.arange(-1, 3)[None, :]
        w = _bicubic_kernel(src[:, None] - idx)
        return np.clip(idx, 0, in_size - 1), w

    idx_h, w_h = axis_weights(img.shape[0], out_h)
    idx_w, w_w = axis_weights(img.shape[1], out_w)
    rows = (img[idx_h] * w_h[:, :, None, None]).sum(axis=1)
    return (rows[:, idx_w] * w_w[None, :, :, None]).sum(axis=2)


def interpolate_bias_table(table: np.ndarray, target_shape) -> np.ndarray:
    """Resize a Swin relative-position bias table (N, heads) bicubically."""
    old_len, heads = table.shape
    new_len = target_shape[0]
    if old_len == new_len:
        return table
    s_old, s_new = int(old_len ** 0.5), int(new_len ** 0.5)
    assert s_old * s_old == old_len and s_new * s_new == new_len
    img = table.reshape(s_old, s_old, heads).astype(np.float32)
    return bicubic_resize_2d(img, s_new, s_new).reshape(new_len, heads)


def _xavier_oihw(rng: np.random.Generator, shape) -> np.ndarray:
    """Xavier-uniform drawn in the reference's HWIO layout, returned OIHW."""
    o, i, kh, kw = shape
    fan_in, fan_out = i * kh * kw, o * kh * kw
    bound = float(np.sqrt(6.0 / (fan_in + fan_out)))
    hwio = rng.uniform(-bound, bound, size=(kh, kw, i, o)).astype(np.float32)
    return np.ascontiguousarray(np.transpose(hwio, (3, 2, 0, 1)))


_HEAD_RE = re.compile(r"(main_decoders|aux_decoders)\.([^.]+)\.seg_model"
                      r"\.segmentation_head\.0\.weight$")


def load_checkpoint(model: nn.Module, path: str, seed: int = 0) -> dict:
    """Load a reference-format checkpoint into ``model`` (non-strict).
    Returns a report {loaded, missing, unused, shape_mismatch,
    matched_tasks, reinit_tasks, coverage}."""
    logger.info("-> Loading checkpoint from: %s", path)
    if not path or not os.path.isfile(path):
        raise SystemExit(f"Invalid checkpoint path: {path!r}")
    state_dict = read_torch_checkpoint(path)
    rng = np.random.default_rng(seed)
    target = model.state_dict()
    state_dict = strip_model_prefix_if_needed(state_dict, list(target))
    state_dict, aliases = normalize_external_state_dict(state_dict, list(target))
    if aliases:
        logger.info("-> Applied external key-layout aliases: %s", aliases)

    matched_tasks, reinit_tasks = set(), set()
    for key, leaf in target.items():
        m = _HEAD_RE.match(key)
        if not m:
            continue
        task = m.group(2).split("__")[-1]
        if key in state_dict:
            if state_dict[key].shape[0] != leaf.shape[0]:
                logger.info("-> Mismatch: %s: ckpt=%d, config=%d", key,
                            state_dict[key].shape[0], leaf.shape[0])
                del state_dict[key]
                state_dict.pop(key[:-len("weight")] + "bias", None)
                reinit_tasks.add(task)
            else:
                matched_tasks.add(task)
        else:
            logger.info("-> Missing: %s", key)
            reinit_tasks.add(task)

    report = {"loaded": [], "missing": [], "unused": [], "shape_mismatch": []}
    new_sd = {}
    for key, leaf in target.items():
        if key not in state_dict:
            report["missing"].append(key)
            continue
        src = np.asarray(state_dict[key])
        if src.ndim == 3 and src.shape[-1] == 1 and leaf.ndim == 2:
            src = src[:, :, 0]  # a kernel-1 Conv1d used as a Linear (LTAE inconv)
        if "relative_position_bias_table" in key and src.shape != tuple(leaf.shape):
            logger.info("-> Interpolating %s: %s -> %s", key, src.shape,
                        tuple(leaf.shape))
            src = interpolate_bias_table(src, tuple(leaf.shape))
        if src.shape != tuple(leaf.shape):
            report["shape_mismatch"].append((key, src.shape, tuple(leaf.shape)))
            continue
        new_sd[key] = torch.as_tensor(np.ascontiguousarray(src), dtype=leaf.dtype)
        report["loaded"].append(key)
    report["unused"] = [k for k in state_dict if k not in target
                        and not k.endswith("num_batches_tracked")]

    for key, leaf in target.items():
        hm = re.search(r"\.([^.]+)\.seg_model\.segmentation_head\.0\.(weight|bias)$", key)
        if hm and hm.group(1).split("__")[-1] in reinit_tasks:
            new_sd[key] = (torch.from_numpy(_xavier_oihw(rng, tuple(leaf.shape)))
                           if hm.group(2) == "weight" else torch.zeros(leaf.shape))
    model.load_state_dict(new_sd, strict=False)

    report["matched_tasks"] = sorted(matched_tasks)
    report["reinit_tasks"] = sorted(reinit_tasks)
    loaded = set(report["loaded"])
    coverage: dict[str, list[int]] = {}
    for key in target:
        parts = key.split(".")
        top = ".".join(parts[:2]) if parts[0] in (
            "encoders", "main_decoders", "aux_decoders") else parts[0]
        c = coverage.setdefault(top, [0, 0])
        c[1] += 1
        c[0] += key in loaded
    report["coverage"] = {k: (v[0], v[1]) for k, v in coverage.items()}
    for module, (n_loaded, n_total) in sorted(report["coverage"].items()):
        if n_total >= 5 and n_loaded < 0.9 * n_total:
            logger.error("-> Checkpoint covers only %d/%d params of '%s' — the "
                         "name map likely does not match this checkpoint",
                         n_loaded, n_total, module)
    logger.info("Checkpoint load summary: matched=%s reinit=%s loaded=%d "
                "missing=%d unused=%d", report["matched_tasks"],
                report["reinit_tasks"], len(report["loaded"]),
                len(report["missing"]), len(report["unused"]))
    return report
