"""FLAIR-HUB model, single mono-modality case (the zonal and training paths).

Port of ``flair_for_aigle_tpu/models/flair_model.py``: ``resolve_model_plan``
and ``FlairHubModel`` for one active mono modality, where the fusion handler
passes the encoder's features straight through (reference :182-183). The
multimodal / time-series (UTAE) cases raise ``NotImplementedError`` (ROADMAP
Queue A item 7). Module names mirror the reference checkpoint keys:
``encoders.<MOD>.seg_model.*``, ``main_decoders.<task>.seg_model.*``,
``aux_decoders.<MOD>__<task>.seg_model.*``.

``zonal_stride4_logits`` in the config makes the UPerNet head emit NHWC
stride-4 logits for the fused zonal epilogue (reference :355-385); otherwise
the forward returns full-resolution NCHW logits per task.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from flair_for_aigle_tpu_torch.models.monotemp import (
    MonotempDecoder,
    MonotempSpec,
    encoder_out_channels,
    make_encoder,
)
from flair_for_aigle_tpu_torch.ops.resize import resize_bilinear_nhwc

MONO_KEYS = ["AERIAL_RGBI", "AERIAL-RLT_PAN", "DEM_ELEV", "SPOT_RGBI"]
MULTI_KEYS = ["SENTINEL2_TS", "SENTINEL1-ASC_TS", "SENTINEL1-DESC_TS"]


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
    """Static planning: active modalities, channels, class counts."""
    inputs = config["modalities"]["inputs"]
    active_mono = [m for m in MONO_KEYS if inputs.get(m, False)]
    active_multi = [m for m in MULTI_KEYS if inputs.get(m, False)]
    labels = list(config["labels"])
    nclasses = {t: len(config["labels_configs"][t]["value_name"]) for t in labels}
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
        task_nclasses=sum(nclasses.values()),
        channels=compute_channels_dict(config),
        spec=MonotempSpec.from_arch(config["models"]["monotemp_model"]["arch"]),
        aux_losses=aux_losses,
    )


class _SegModel(nn.Module):
    """Holds a module under the ``seg_model`` key level."""

    def __init__(self, seg_model: nn.Module):
        super().__init__()
        self.seg_model = seg_model


class FlairHubModel(nn.Module):
    """FLAIR-HUB segmentation model for one mono modality."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        self.config = config
        plan = resolve_model_plan(config)
        if plan["active_multi"] or len(plan["active_mono"]) != 1:
            raise NotImplementedError(
                "flair_for_aigle_tpu_torch runs one mono modality only; the "
                "multimodal / time-series (UTAE) path is ROADMAP Queue A item 7")
        self.plan = plan
        self.mod = plan["active_mono"][0]
        mcfg = config["models"]["monotemp_model"]
        spec = plan["spec"]
        in_ch = plan["channels"][self.mod]
        enc_ch = encoder_out_channels(spec.encoder_name, in_ch)
        self.stride4 = bool(config.get("zonal_stride4_logits")
                            and spec.decoder_name == "upernet")
        self.encoders = nn.ModuleDict({self.mod: _SegModel(make_encoder(
            spec.encoder_name, in_ch, attn_f32=mcfg.get("attn_f32", True)))})
        self.main_decoders = nn.ModuleDict({
            task: _SegModel(MonotempDecoder(
                spec.decoder_name, enc_ch, plan["nclasses"][task],
                head_upsampling=1 if self.stride4 else 4))
            for task in plan["labels"]})
        self.aux_decoders = nn.ModuleDict({
            f"{self.mod}__{task}": _SegModel(MonotempDecoder(
                spec.decoder_name, enc_ch, plan["nclasses"][task]))
            for task in plan["labels"] if plan["aux_losses"].get(self.mod)})

    def forward(self, batch: Dict[str, torch.Tensor]):
        """batch: NCHW tensors keyed by modality (+ task keys, read for the
        output size only). Returns ({task: logits}, {aux key: logits});
        logits are NCHW at full resolution, or NHWC stride-4 in stride-4
        mode."""
        labels = self.plan["labels"]
        img_size = batch[labels[0]].shape[-1]
        feats = self.encoders[self.mod].seg_model(batch[self.mod].permute(0, 2, 3, 1))
        logits_aux = {}
        for key, dec in self.aux_decoders.items():
            task = key.split("__", 1)[1]
            out = resize_bilinear_nhwc(dec.seg_model(*feats), img_size, img_size)
            logits_aux[f"aux_{self.mod}_{task}"] = out.permute(0, 3, 1, 2)
        out_tasks = {}
        for task in labels:
            out = self.main_decoders[task].seg_model(*feats)
            if not self.stride4:
                out = resize_bilinear_nhwc(out, img_size, img_size).permute(0, 3, 1, 2)
            out_tasks[task] = out
        return out_tasks, logits_aux

