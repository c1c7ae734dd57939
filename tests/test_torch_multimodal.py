"""The port's multimodal FlairHubModel against the JAX package's, on the CPU.

Seeded flax variables of the JAX model (``tests/test_torch_utae.py
_fill``, shapes from ``eval_shape``) load strictly into the port's model
through ``state_dict_from_flax``; the same seeded numpy batch goes through
both, float32, eval mode.

* The fusion handler's four cases, with aux heads on both kinds of
  modality and two tasks where the case allows them: one mono modality
  (pass-through), one time series (its logits), two time series (the mean
  of their logits, 1x1 task heads), full fusion of a Swin encoder with a
  UTAE, and full fusion of two Swin encoders (AERIAL_RGBI + DEM_ELEV). Every
  task and aux output within 1e-4 of its largest magnitude.
* Full fusion in stride-4 mode (the zonal epilogue's input): NHWC logits
  at h / 4, within the same bound.
* ``resolve_model_plan``, ``adjust_fm_length``, ``calc_backbones_channels``
  and ``print_model_parameters`` give the JAX package's values.
* Modality dropout replaces a modality's maps only by noise inside the
  Xavier-uniform bound of their shape, keeps 0-size maps, and both keeps
  and drops over a few seeds.

``tests/test_torch_multimodal_golden.py`` holds the port against the torch
oracle of the reference layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.models import flair_model as jfm
from flair_for_aigle_tpu_torch.models import flair_model as tfm
from flair_for_aigle_tpu_torch.models.checkpoint import state_dict_from_flax
from tests._fixtures import make_config
from tests.test_torch_utae import _close, _fill

ARCH = "swin_micro_patch4_window12_384-upernet"
PX, S2_PX, T = 64, 8, 4

CASES = {
    "mono": dict(mono=("AERIAL_RGBI",), multi=(), aux=("AERIAL_RGBI",),
                 tasks=(("T1", 5), ("T2", 3))),
    "one_ts": dict(mono=(), multi=("SENTINEL2_TS",), aux=("SENTINEL2_TS",),
                   tasks=(("T1", 5),)),
    "two_ts": dict(mono=(), multi=("SENTINEL2_TS", "SENTINEL1-ASC_TS"),
                   aux=("SENTINEL1-ASC_TS",), tasks=(("T1", 5), ("T2", 3))),
    "mono_ts": dict(mono=("AERIAL_RGBI",), multi=("SENTINEL2_TS",),
                    aux=("AERIAL_RGBI", "SENTINEL2_TS"), tasks=(("T1", 5), ("T2", 3))),
    "two_mono": dict(mono=("AERIAL_RGBI", "DEM_ELEV"), multi=(),
                     aux=("AERIAL_RGBI", "DEM_ELEV"), tasks=(("T1", 5),)),
}


def case_config(name: str) -> dict:
    return make_config(arch=ARCH, **CASES[name])


def make_batch(cfg: dict, seed: int = 0, b: int = 2) -> dict:
    """Mono modalities at PX, time series at S2_PX with the last date of
    the second sample padded, zero task placeholders."""
    rng = np.random.default_rng(seed)
    chans = cfg["modalities"]["inputs_channels"]
    out = {}
    for mod, active in cfg["modalities"]["inputs"].items():
        if not active:
            continue
        if mod.endswith("_TS"):
            x = rng.normal(size=(b, T, len(chans[mod]), S2_PX, S2_PX)).astype(np.float32)
            x[1, -1] = 0.0
            out[mod] = x
            out[mod.replace("_TS", "_DATES")] = np.sort(
                rng.integers(-180, 180, size=(b, T))).astype(np.float32)
        else:
            c = 2 if mod == "DEM_ELEV" else len(chans[mod])
            out[mod] = rng.normal(size=(b, c, PX, PX)).astype(np.float32)
    for task in cfg["labels"]:
        k = len(cfg["labels_configs"][task]["value_name"])
        out[task] = np.zeros((b, k, PX, PX), np.float32)
    return out


def pair(cfg: dict, batch: dict, seed: int = 0):
    """(JAX model, its seeded variables, the port's model holding them)."""
    jmodel = jfm.FlairHubModel(config=cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.key(0), b), jb)
    rng = np.random.default_rng(seed)
    v = {col: _fill(tree, rng, col) for col, tree in shapes.items()}
    tmodel = tfm.FlairHubModel(cfg).eval()
    tmodel.load_state_dict(state_dict_from_flax(v["params"], v.get("batch_stats")),
                           strict=True)
    return jmodel, v, tmodel


def run_both(cfg: dict, batch: dict):
    jmodel, v, tmodel = pair(cfg, batch)
    want = jax.jit(jmodel.apply)(v, {k: jnp.asarray(x) for k, x in batch.items()})
    with torch.no_grad():
        got = tmodel({k: torch.from_numpy(x.copy()) for k, x in batch.items()})
    return got, want, tmodel


@pytest.mark.parametrize("name", sorted(CASES))
def test_fusion_case_matches_jax(name):
    cfg = case_config(name)
    got, want, tmodel = run_both(cfg, make_batch(cfg))
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            _close(g[k].numpy(), w[k], 1e-4)
    assert set(got[0]) == set(cfg["labels"])
    assert set(got[1]) == {f"aux_{m}_{t}" for m in CASES[name]["aux"] for t in cfg["labels"]}
    has_conv_f = hasattr(tmodel.fusion_handler, "conv_f")
    assert has_conv_f == (name in ("mono_ts", "two_mono"))


def test_full_fusion_stride4_logits_match_jax():
    cfg = {**case_config("mono_ts"), "zonal_stride4_logits": True}
    (got, _), (want, _), tmodel = run_both(cfg, make_batch(cfg, seed=3))
    assert tmodel.stride4
    for task, w in want.items():
        assert got[task].shape == w.shape == (2, PX // 4, PX // 4, w.shape[-1])
        _close(got[task].numpy(), w, 1e-4)


@pytest.mark.parametrize("name", ["mono_ts", "two_mono", "one_ts"])
def test_plan_widths_and_parameter_table_match_jax(name):
    cfg = case_config(name)
    jplan, tplan = jfm.resolve_model_plan(cfg), tfm.resolve_model_plan(cfg)
    for k in ("active_mono", "active_multi", "labels", "nclasses", "task_nclasses",
              "channels", "multitemp", "aux_losses"):
        assert tplan[k] == jplan[k], k
    assert tfm.calc_backbones_channels(tplan) == jfm.calc_backbones_channels(jplan)
    for mono_oc in ([3, 0, 128, 256, 512, 1024], [3, 0, 64, 128, 256, 512, 1024], [8, 16]):
        assert (tfm.adjust_fm_length(cfg, mono_oc) == jfm.adjust_fm_length(cfg, mono_oc))
        mt = cfg["models"]["multitemp_model"]
        assert tfm.adjust_fm_length(mt, mono_oc) == jfm.adjust_fm_length(mt, mono_oc)
    batch = make_batch(cfg)
    jmodel, v, tmodel = pair(cfg, batch)
    assert tfm.print_model_parameters(tmodel, cfg) == jfm.print_model_parameters(v, cfg)


def test_modality_dropout_replaces_maps_only_by_bounded_noise():
    cfg = case_config("mono_ts")
    batch = {k: torch.from_numpy(x) for k, x in make_batch(cfg).items()}
    model = pair(cfg, make_batch(cfg))[2]
    seen = []
    model.fusion_handler.register_forward_hook(
        lambda mod, args, out: seen.append(args[0]))
    with torch.no_grad():
        model(batch)
        clean = seen.pop()
        outcomes = set()
        for seed in range(8):
            model(batch, apply_mod_dropout=True,
                  generator=torch.Generator().manual_seed(seed))
            maps = seen.pop()
            assert list(maps) == list(clean)
            for mod in maps:
                kept = [torch.equal(a, b) for a, b in zip(maps[mod], clean[mod])]
                assert all(kept) or not any(kept[i] for i, a in enumerate(clean[mod])
                                            if a.numel()), (mod, kept)
                for a, b in zip(maps[mod], clean[mod]):
                    if a.numel() == 0:
                        assert a.shape == b.shape
                    elif not all(kept):
                        receptive = np.prod(a.shape[:-2])
                        bound = np.sqrt(6.0 / ((a.shape[-2] + a.shape[-1]) * receptive))
                        assert a.abs().max() <= bound and a.std() > bound / 4
                outcomes.add(all(kept))
    assert outcomes == {True, False}
