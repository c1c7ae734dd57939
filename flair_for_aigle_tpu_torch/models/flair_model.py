"""FLAIR-HUB multimodal fusion model.

Port of ``flair_for_aigle_tpu/models/flair_model.py``: ``resolve_model_plan``,
``FusionHandler`` and ``FlairHubModel`` for every combination of active
modalities. Mono modalities (B, C, H, W) run a monotemporal encoder each; time
series (B, T, C, H, W) with ``<MOD>_DATES`` (B, T) run a UTAE each, whose
logits are resized to the tile. The fusion handler takes one of four cases:
one mono modality (pass-through), one time series (its logits), the mean of
several time series' logits, or full fusion of the mono stages with the
UTAE maps (``FusionHandler.forward``). Module names are the reference
checkpoint keys: ``encoders.<MOD>.seg_model.*`` (mono), ``encoders.<MOD>.*``
(UTAE), ``fusion_handler.conv_f.{i}``, ``main_decoders.<task>.seg_model.*``
(or a 1x1 ``main_decoders.<task>`` without a mono modality and with several
tasks), ``aux_decoders.<MOD>__<task>.seg_model.*`` (mono) and a 1x1
``aux_decoders.<MOD>__<task>`` (UTAE).

``zonal_stride4_logits`` in the config makes the UPerNet head emit NHWC
stride-4 logits for the fused zonal epilogue when a mono modality is active
(reference :355-358); otherwise the forward returns full-resolution NCHW
logits per task. Mono encoders and decoders are any family of
``models/monotemp.py``.
"""

from __future__ import annotations

import contextlib
import logging
import math
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from flair_for_aigle_tpu_torch.models.layers import TorchConv, xavier_uniform_like
from flair_for_aigle_tpu_torch.models.linknet import LINKNET_TRANSPOSE_CONV_PATTERNS
from flair_for_aigle_tpu_torch.models.monotemp import (
    MonotempDecoder,
    MonotempSpec,
    encoder_mode,
    encoder_out_channels,
    make_encoder,
)
from flair_for_aigle_tpu_torch.models.utae import UTAE, UTAE_TRANSPOSE_CONV_PATTERNS
from flair_for_aigle_tpu_torch.ops.resize import resize_bilinear_nhwc
from flair_for_aigle_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)

MONO_KEYS = ["AERIAL_RGBI", "AERIAL-RLT_PAN", "DEM_ELEV", "SPOT_RGBI"]
MULTI_KEYS = ["SENTINEL2_TS", "SENTINEL1-ASC_TS", "SENTINEL1-DESC_TS"]

# checkpoint paths of transposed convolutions (UTAE's up blocks, LinkNet's
# TransposeX2)
FLAIR_TRANSPOSE_CONV_PATTERNS = (tuple(UTAE_TRANSPOSE_CONV_PATTERNS)
                                 + tuple(LINKNET_TRANSPOSE_CONV_PATTERNS))

DEFAULT_MULTITEMP = {
    "ref_date": "05-15",
    "encoder_widths": [64, 64, 64, 128],
    "decoder_widths": [32, 32, 64, 128],
    "out_conv": [32, 19],
    "str_conv_k": 3, "str_conv_s": 1, "str_conv_p": 1,
    "agg_mode": "att_group", "encoder_norm": "group",
    "n_head": 16, "d_model": 256, "d_k": 4,
    "pad_value": 0, "padding_mode": "reflect",
}


def round_to_nearest_power_of_two(x: float) -> int:
    return 2 ** round(math.log2(x))


def _drop_dummies(seq: list) -> list:
    """A pyramid without its two leading entries when either is a 0-channel
    dummy (the Swin encoders' input and stride-2 slots)."""
    if len(seq) > 2 and (seq[0] == 0 or seq[1] == 0):
        return seq[2:]
    return seq


def adjust_fm_length(config_or_mt: dict, mono_channels: list[int]) -> list[int]:
    """UTAE widths for the mono encoder's stages: as many as it has stages,
    spread between the configured widths' extremes and rounded to powers of
    two. Takes the full config or its ``multitemp_model`` entry."""
    chans = _drop_dummies(list(mono_channels))
    mt = config_or_mt
    if "models" in config_or_mt:
        mt = config_or_mt["models"].get("multitemp_model",
                                        {"encoder_widths": [64, 64, 64, 128]})
    ew = mt["encoder_widths"]
    expanded = np.linspace(min(ew) - 1, max(ew) + 1, len(chans)).astype(int)
    return [round_to_nearest_power_of_two(v) for v in expanded]


def compute_channels_dict(config: dict) -> dict[str, int]:
    """Reference channel inference incl. the DEM elevation rule."""
    channels = {}
    for mod in config["modalities"]["inputs"]:
        if mod in ("AERIAL-RLT_PAN", "DEM_ELEV"):
            channels[mod] = 1
        else:
            channels[mod] = len(
                config["modalities"].get("inputs_channels", {}).get(mod, []))
    if config["modalities"]["inputs"].get("DEM_ELEV"):
        pp = config["modalities"]["pre_processings"]
        channels["DEM_ELEV"] = (
            1 if pp["calc_elevation"] and not pp["calc_elevation_stack_dsm"] else 2)
    return channels


def resolve_model_plan(config: dict) -> dict:
    """Static planning: active modalities, channels, UTAE widths, class
    counts."""
    inputs = config["modalities"]["inputs"]
    active_mono = [m for m in MONO_KEYS if inputs.get(m, False)]
    active_multi = [m for m in MULTI_KEYS if inputs.get(m, False)]
    labels = list(config["labels"])
    nclasses = {t: len(config["labels_configs"][t]["value_name"]) for t in labels}
    task_nclasses = sum(nclasses.values())
    channels = compute_channels_dict(config)
    spec = MonotempSpec.from_arch(config["models"]["monotemp_model"]["arch"])

    mt = dict(config["models"].get("multitemp_model", DEFAULT_MULTITEMP))
    out_conv = list(mt["out_conv"])
    if active_multi and task_nclasses != out_conv[-1]:
        out_conv = out_conv + [task_nclasses]
    if active_mono:
        mono_oc = list(encoder_out_channels(spec.encoder_name, channels[active_mono[0]]))
        widths = adjust_fm_length(mt, mono_oc)
        mt["encoder_widths"] = widths
        mt["decoder_widths"] = widths
    mt["out_conv"] = out_conv
    aux_losses = {
        mod: loss
        for mod, loss in config["modalities"].get("aux_loss", {}).items()
        if loss and inputs.get(mod, False)
    }
    return dict(
        active_mono=active_mono,
        active_multi=active_multi,
        labels=labels,
        nclasses=nclasses,
        task_nclasses=task_nclasses,
        channels=channels,
        spec=spec,
        multitemp=mt,
        aux_losses=aux_losses,
    )


def calc_backbones_channels(plan: dict) -> list[int]:
    """Summed channels of the fused stages (reference
    flair_model.py:292-315)."""
    per_backbone = []
    for mod in plan["active_mono"]:
        oc = list(encoder_out_channels(plan["spec"].encoder_name, plan["channels"][mod]))
        per_backbone.append(_drop_dummies(oc))
    reversed_decoder = list(plan["multitemp"]["decoder_widths"])[::-1]
    for _ in plan["active_multi"]:
        per_backbone.append(reversed_decoder)
    return [sum(x) for x in zip(*per_backbone)]


def utae_map_channels(mt: dict) -> list[int]:
    """Channels of UTAE's maps: the LTAE output, then each up block's."""
    ew, dw = list(mt["encoder_widths"]), list(mt["decoder_widths"])
    return [ew[-1]] + dw[-2::-1]


def _repeat_first(seq: list, n: int) -> list:
    """A modality's stages matched to the target's count by repeating its
    first one in front (reference flair_model.py:522-524)."""
    return [seq[0]] * (n - len(seq)) + list(seq)


class FusionHandler(nn.Module):
    """Reference FusionHandler (flair_model.py:437-547), NHWC. Built with
    the target's pyramid channels and each fused modality's; its 1x1
    ``conv_f.{i}`` exist only for full fusion."""

    def __init__(self, target_channels=(), mod_channels: dict | None = None):
        super().__init__()
        tfc = _drop_dummies(list(target_channels))
        mod_channels = mod_channels or {}
        ins = [sum(chs) for chs in zip(*(_repeat_first(_drop_dummies(list(c)), len(tfc))
                                          for c in mod_channels.values()))]
        if ins:
            self.conv_f = nn.ModuleList(TorchConv(i, o, 1, 1, 0) for i, o in zip(ins, tfc))

    def forward(self, feature_maps: dict, target_fm_maps):
        active = list(feature_maps)
        mono = [k for k in active if k in MONO_KEYS]
        multi = [k for k in active if k in MULTI_KEYS]
        if len(mono) == 1 and not multi:
            return feature_maps[mono[0]]
        if not mono and len(multi) == 1:
            return feature_maps[multi[0]]
        if not mono and len(multi) > 1:
            return torch.stack([feature_maps[k] for k in multi]).mean(0)

        # full fusion: stages aligned by position, resized to the target's
        targets = list(target_fm_maps)
        dummy_maps = None
        if targets[0].shape[-1] == 0 or targets[1].shape[-1] == 0:
            dummy_maps, targets = targets[:2], targets[2:]
        aligned = []
        for mod in active:
            fmaps = feature_maps[mod]
            if fmaps[0].shape[-1] == 0 or fmaps[1].shape[-1] == 0:
                fmaps = fmaps[2:]
            fmaps = _repeat_first(fmaps, len(targets))
            aligned.append([resize_bilinear_nhwc(fm, t.shape[-3], t.shape[-2])
                            for fm, t in zip(fmaps, targets)])
        adjusted = [conv(torch.cat(fms, dim=-1))
                    for conv, fms in zip(self.conv_f, zip(*aligned))]
        return dummy_maps + adjusted if dummy_maps is not None else adjusted


class _SegModel(nn.Module):
    """Holds a module under the ``seg_model`` key level."""

    def __init__(self, seg_model: nn.Module):
        super().__init__()
        self.seg_model = seg_model


class FlairHubModel(nn.Module):
    """Multimodal multi-task segmentation model (reference FLAIR_HUB_Model)."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        self.config = config
        plan = resolve_model_plan(config)
        self.plan = plan
        labels, spec, mt = plan["labels"], plan["spec"], plan["multitemp"]
        mcfg = config["models"]["monotemp_model"]
        self.stride4 = bool(config.get("zonal_stride4_logits") and plan["active_mono"]
                            and spec.decoder_name == "upernet")

        self.encoders = nn.ModuleDict()
        self.aux_decoders = nn.ModuleDict()
        os_, depth = encoder_mode(spec.decoder_name)
        enc_ch = {}
        for mod in plan["active_mono"]:
            self.encoders[mod] = _SegModel(make_encoder(
                spec.encoder_name, plan["channels"][mod],
                attn_f32=mcfg.get("attn_f32", True), output_stride=os_, depth=depth,
                remat=mcfg.get("remat", False)))
            enc_ch[mod] = self.encoders[mod].seg_model.out_channels
            if plan["aux_losses"].get(mod):
                for task in labels:
                    self.aux_decoders[f"{mod}__{task}"] = _SegModel(MonotempDecoder(
                        spec.decoder_name, enc_ch[mod], plan["nclasses"][task]))
        n_logits = mt["out_conv"][-1]
        for mod in plan["active_multi"]:
            self.encoders[mod] = UTAE(
                input_dim=len(config["modalities"]["inputs_channels"][mod]),
                encoder_widths=mt["encoder_widths"], decoder_widths=mt["decoder_widths"],
                out_conv=mt["out_conv"], str_conv_k=mt["str_conv_k"],
                str_conv_s=mt["str_conv_s"], str_conv_p=mt["str_conv_p"],
                agg_mode=mt["agg_mode"], encoder_norm=mt["encoder_norm"],
                n_head=mt["n_head"], d_model=mt["d_model"], d_k=mt["d_k"],
                encoder=False, return_maps=True, pad_value=mt["pad_value"],
                padding_mode=mt["padding_mode"])
            if plan["aux_losses"].get(mod):
                for task in labels:
                    self.aux_decoders[f"{mod}__{task}"] = TorchConv(
                        n_logits, plan["nclasses"][task], 1, 1, 0)

        if plan["active_mono"]:
            target = enc_ch[plan["active_mono"][0]]
            mods = {**enc_ch, **{m: utae_map_channels(mt) for m in plan["active_multi"]}}
            full = len(plan["active_mono"]) > 1 or plan["active_multi"]
            self.fusion_handler = FusionHandler(target, mods if full else None)
        else:
            self.fusion_handler = FusionHandler()

        self.main_decoders = nn.ModuleDict()
        for task in labels:
            if plan["active_mono"]:
                self.main_decoders[task] = _SegModel(MonotempDecoder(
                    spec.decoder_name, enc_ch[plan["active_mono"][0]],
                    plan["nclasses"][task], head_upsampling=1 if self.stride4 else 4))
            elif len(labels) > 1:
                self.main_decoders[task] = TorchConv(n_logits, plan["nclasses"][task],
                                                     1, 1, 0)

    def drop_modalities(self, fmaps: dict, generator: torch.Generator | None) -> dict:
        """Modality dropout (reference flair_model.py:305-328): per
        modality a uniform draw sets the drop probability and a second draw
        decides; a dropped modality's maps are replaced by Xavier-uniform
        noise (0-size maps stay). Acts only with more than one modality."""
        if len(fmaps) <= 1:
            return fmaps
        device = next(iter(fmaps.values()))[0].device
        out = {}
        for key, maps in fmaps.items():
            drop_prob, draw = torch.rand(2, generator=generator, device=device)
            items = list(maps) if isinstance(maps, (list, tuple)) else [maps]
            replaced = [t if t.numel() == 0 else
                        torch.where(draw < drop_prob, xavier_uniform_like(t, generator), t)
                        for t in items]
            out[key] = replaced if isinstance(maps, (list, tuple)) else replaced[0]
        return out

    def forward(self, batch: Dict[str, torch.Tensor], apply_mod_dropout: bool = False,
                generator: torch.Generator | None = None):
        """batch: NCHW tensors keyed by modality, (B, T, C, H, W) time series
        with ``<MOD>_DATES`` (B, T), task keys (read for the output size
        only). Returns ({task: logits}, {aux key: logits}); logits are NCHW
        at full resolution, or NHWC stride-4 in stride-4 mode.
        ``generator`` draws the modality dropout and, in training mode,
        UTAE's and the decoders' dropout. Spans: ``model.encoder`` (with
        ``model.encoder.utae`` a time series) and ``model.decoder`` (with
        ``model.fusion`` where modalities are fused), the inner two timed
        on the card while a profiler session is on."""
        plan = self.plan
        labels = plan["labels"]
        img_size = batch[labels[0]].shape[-1]
        device = batch[labels[0]].device
        fmaps: dict[str, Any] = {}
        logits_tasks: dict[str, torch.Tensor] = {}
        logits_aux: dict[str, torch.Tensor] = {}

        with profiling.span("model.encoder"):
            for mod in plan["active_mono"]:
                fmaps[mod] = self.encoders[mod].seg_model(batch[mod].permute(0, 2, 3, 1))
                if plan["aux_losses"].get(mod):
                    for task in labels:
                        out = self.aux_decoders[f"{mod}__{task}"].seg_model(
                            *fmaps[mod], generator=generator)
                        out = resize_bilinear_nhwc(out, img_size, img_size)
                        logits_aux[f"aux_{mod}_{task}"] = out.permute(0, 3, 1, 2)
            for mod in plan["active_multi"]:
                dates = batch.get(mod.replace("TS", "DATES"))
                with profiling.span("model.encoder.utae", device=device):
                    lg, maps = self.encoders[mod](batch[mod].permute(0, 1, 3, 4, 2),
                                                  batch_positions=dates, generator=generator)
                lg = resize_bilinear_nhwc(lg, img_size, img_size)
                logits_tasks[mod] = lg
                fmaps[mod] = maps
                if plan["aux_losses"].get(mod):
                    for task in labels:
                        aux = self.aux_decoders[f"{mod}__{task}"](lg)
                        logits_aux[f"aux_{mod}_{task}"] = aux.permute(0, 3, 1, 2)

        with profiling.span("model.decoder"):
            if apply_mod_dropout:
                fmaps = self.drop_modalities(fmaps, generator)

            maps_in, target = ((fmaps, fmaps[plan["active_mono"][0]]) if plan["active_mono"]
                               else (logits_tasks, logits_tasks[plan["active_multi"][0]]))
            # a span only where modalities are fused: one passes through
            with (profiling.span("model.fusion", device=device) if len(maps_in) > 1
                  else contextlib.nullcontext()):
                fused = self.fusion_handler(maps_in, target)

            out_tasks = {}
            for task in labels:
                if plan["active_mono"]:
                    out = self.main_decoders[task].seg_model(*fused, generator=generator)
                    if not self.stride4:
                        out = resize_bilinear_nhwc(out, img_size, img_size)
                elif len(labels) > 1:
                    out = self.main_decoders[task](fused)
                else:
                    out = fused
                out_tasks[task] = out if self.stride4 else out.permute(0, 3, 1, 2)
        return out_tasks, logits_aux


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def print_model_parameters(model: FlairHubModel, config: dict) -> str:
    """Parameter-count table per component (reference
    print_model_parameters, flair_model.py:219-289). Returns the table and
    logs it."""
    arch = config["models"]["monotemp_model"]["arch"]
    enc_arch = arch.split("-")[0]
    dec_arch = arch.split("-")[1] if "-" in arch else arch
    groups: dict[str, dict] = {"backbone": {}, "aux loss decoder": {},
                               "task decoder": {}, "other": {}}
    for key, sub in model.encoders.items():
        groups["backbone"][key] = ("utae" if key in MULTI_KEYS else enc_arch,
                                   count_params(sub))
    for key, sub in model.aux_decoders.items():
        groups["aux loss decoder"][key] = (dec_arch, count_params(sub))
    for key, sub in model.main_decoders.items():
        groups["task decoder"][key] = (dec_arch, count_params(sub))
    n_fusion = count_params(model.fusion_handler)
    if n_fusion:
        groups["other"]["fusion_handler"] = ("-", n_fusion)
    lines = [" " + "-" * 113]
    lines.append("| {:<37} | {:<35} | {:<17} | {:<13} |".format(
        "Model modality", "Architecture", "Type", "Parameters"))
    for gname in ("backbone", "aux loss decoder", "task decoder", "other"):
        for key, (kind, n) in groups[gname].items():
            lines.append("| {:<37} | {:<35} | {:<17} | {:>13,} |".format(
                key, kind, gname, n))
    lines.append("| {:<37}   {:<35}   {:<17}   {:>13,} |".format(
        "Total parameters", "", "", count_params(model)))
    lines.append(" " + "-" * 113)
    table = "\n".join(lines)
    logger.info("\n%s", table)
    return table
