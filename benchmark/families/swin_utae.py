"""FLAIR-HUB's aerial + Sentinel-2 model: Swin with smp's UPerNet on the
aerial tile (``families/swin.py``), fused with U-TAE over the tile's
Sentinel-2 series (``reference/utae.py``). The plain reference model, the
Swin stages, and the forward operations of one tile.

Operations are those of the products alone, two a multiply-add, as in
``families/upernet.py``: the Swin-UPerNet's, ``conv_f``'s 1 x 1 fusion
convolutions on the Swin stages, and U-TAE's convolutions and L-TAE's
products on the frames a tile keeps (the frames that pad a batch to its
largest date count are not counted). Norms, activations, resizes and
U-TAE's temporal aggregation (a weighted sum over the dates) are left out.
"""

from __future__ import annotations

from benchmark.families import swin
from benchmark.families.upernet import conv_flops
from benchmark.reference.utae import FusedModel, adjust_fm_length

stages = swin.stages


def modalities(cfg: dict) -> tuple[str, str, str, int]:
    """(mono modality, time series, task, series channels) of the
    configuration's zonal settings."""
    z = cfg["zonal"]
    active = [m for m, on in z["modalities"]["inputs"].items() if on]
    mono = [m for m in active if not m.endswith("_TS")]
    series = [m for m in active if m.endswith("_TS")]
    tasks = [t["name"] for t in z["tasks"] if t["active"]]
    if len(mono) != 1 or len(series) != 1 or len(tasks) != 1:
        raise ValueError("the family runs one mono modality, one time series and one task")
    return mono[0], series[0], tasks[0], len(z["modalities"][series[0]]["channels"])


def build(cfg: dict, in_channels: int) -> FusedModel:
    mono, series, task, series_channels = modalities(cfg)
    return FusedModel(mono, series, task, in_channels, series_channels, cfg["encoder"],
                      cfg["decoder"], cfg["utae"], cfg["num_classes"])


def widths(cfg: dict) -> list[int]:
    """U-TAE's widths after ``adjust_fm_length`` to the Swin's stages."""
    return adjust_fm_length(cfg["utae"]["encoder_widths"], len(cfg["encoder"]["depths"]))


def _side(side: int, k: int, s: int, p: int) -> int:
    return (side + 2 * p - k) // s + 1


def utae_flops(cfg: dict, dates: float, series_px: int, series_channels: int) -> float:
    """U-TAE on ``dates`` kept frames of ``series_px`` x ``series_px``: the
    encoder's convolutions a frame, L-TAE's input and key projections and
    its two attention products a frame and pixel and its MLP a pixel, the
    decoder's and ``out_conv``'s convolutions once."""
    u = cfg["utae"]
    ew = widths(cfg)
    k, s, p = u["str_conv_k"], u["str_conv_s"], u["str_conv_p"]
    side = series_px
    sides = [side]
    frame = conv_flops(side * side, series_channels, ew[0], 3) + conv_flops(
        side * side, ew[0], ew[0], 3)
    for i in range(len(ew) - 1):
        down = _side(side, k, s, p)
        frame += conv_flops(down * down, ew[i], ew[i], k)
        frame += conv_flops(down * down, ew[i], ew[i + 1], 3)
        frame += conv_flops(down * down, ew[i + 1], ew[i + 1], 3)
        side = down
        sides.append(side)
    n, dm, nh, dk = side * side, u["d_model"], u["n_head"], u["d_k"]
    frame += 2 * n * (ew[-1] * dm + dm * nh * dk + nh * dk + dm)
    once = 2 * n * dm * ew[-1]  # L-TAE's MLP
    for i in range(len(ew) - 1, 0, -1):  # up blocks, deepest first
        d_in, d_out, d_skip = ew[i], ew[i - 1], ew[i - 1]
        lo, hi = sides[i], sides[i - 1]
        once += 2 * lo * lo * d_in * d_out * k * k  # transposed conv, counted on its input
        once += conv_flops(hi * hi, d_skip, d_skip, 1)
        once += conv_flops(hi * hi, d_out + d_skip, d_out, 3)
        once += conv_flops(hi * hi, d_out, d_out, 3)
    oc = [ew[0]] + list(u["out_conv"])
    if oc[-1] != cfg["num_classes"]:
        oc.append(cfg["num_classes"])
    once += sum(conv_flops(sides[0] * sides[0], a, b, 3) for a, b in zip(oc, oc[1:]))
    return dates * frame + once


def fusion_flops(cfg: dict, px: int) -> int:
    ew = widths(cfg)
    maps = [ew[-1]] + ew[-2::-1]
    return sum(conv_flops(st.tokens, st.c + m, st.c, 1)
               for st, m in zip(stages(cfg, px), maps))


def forward_flops(cfg: dict, px: int, in_channels: int, dates: float = 0.0,
                  series_px: int = 0) -> float:
    """One tile: ``px`` aerial pixels a side, ``dates`` kept frames of
    ``series_px`` series pixels a side."""
    *_, series_channels = modalities(cfg)
    return (swin.forward_flops(cfg, px, in_channels) + fusion_flops(cfg, px)
            + utae_flops(cfg, dates, series_px, series_channels))
