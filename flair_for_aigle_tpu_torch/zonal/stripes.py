"""Streamed canvas D2H: two-ended row frontier + tiered stripe codec
(PyTorch port).

Port of ``flair_for_aigle_tpu/zonal/stripes.py``. The on-device uint8
canvases are fetched as horizontal stripes while the device is still
computing, instead of one D2H after the last batch. Two cooperating pieces:

* :class:`StripeStream` — tracks which output rows are final (no remaining
  tile can write them; last-write-wins preserved) via a two-ended frontier,
  and encodes newly final rows in fixed-height quanta.
* :class:`StripeCodec` — encodes each stripe on the device (RLE / 5-bit
  pack / raw) and ships only the winner to the host, with a
  probe-then-commit scheduler so tier decisions never block the stream.

Every device-to-host copy goes into pinned host memory on the device's
current stream, followed by a ``torch.cuda.Event``: a transfer overlaps the
remaining compute, ``Event.query()`` says whether it landed, and only the
finalize waits. On the CPU the copies are plain clones and every decision
resolves at once.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from flair_for_aigle_tpu_torch.ops.pack import pack_labels5, unpack_labels5_into
from flair_for_aigle_tpu_torch.ops.rle import rle_decode_into, rle_encode5
from flair_for_aigle_tpu_torch.utils import profiling

#: the record of the last inference_and_write call (``utils/profiling.py
#: recording``): its spans' host seconds and its counters summed by key, the
#: codec's mode and the unpack route
LAST_TIMINGS: Dict[str, float] = {}


def future_frontiers(order: np.ndarray, tile_tops: np.ndarray,
                     tile_bots: np.ndarray, img_h: int):
    """future_min_top[c], future_max_bottom[c]: bounds of the output rows
    any tile at processing position >= c can still write."""
    n = len(order)
    fmt = np.empty(n + 1, np.int64)
    fmb = np.empty(n + 1, np.int64)
    fmt[n] = img_h
    fmb[n] = 0
    for i in range(n - 1, -1, -1):
        fmt[i] = min(tile_tops[order[i]], fmt[i + 1])
        fmb[i] = max(tile_bots[order[i]], fmb[i + 1])
    return fmt, fmb


class _Fetch:
    """The asynchronous device-to-host copy of one tensor: into pinned host
    memory on its device's current stream, then an event (a CUDA tensor);
    a host copy made at once (a CPU tensor)."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t.clone()
            self.event = None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        """The host bytes, waiting for the copy to land (no wait, and no
        synchronising call, once it has)."""
        if self.event is not None and not self.event.query():
            with profiling.blocked():
                self.event.synchronize()
        return self.host.numpy()


class StripeCodec:
    """Tiered stripe D2H encoder/decoder for the on-device canvases.

    Tiers per stripe (all encodings computed on the device; only the chosen
    one crosses to the host at full size):

    * ``rle-small`` — fixed-capacity RLE at 1 run / 256 px (~32x fewer
      bytes than 5-bit packing); the buffer and run count ship async the
      moment the stripe's rows are final.
    * ``rle-mid`` — 1 run / 32 px capacity (~4x cut), fetched on demand
      when the true run count overflows the small tier.
    * ``pack5`` — 5-bit packed (1.6x cut), the incompressible fallback.
    * ``raw`` — dense bytes (``pack_d2h: false`` or class_prob canvases).

    RLE is lossless (run-split of the flattened row-major map); outputs
    are byte-identical across tiers.

    Probe-then-commit: the first stripes (<= MAX_PROBES) run both
    encodings and dual-ship — the packed bytes stream at once (so an
    incompressible map never waits on a verdict) while the RLE run count
    crosses asynchronously. ``poll`` resolves any stripe whose run count
    has landed, without blocking; the first verdict commits the whole run
    to ``rle`` (later stripes skip the packed transfer) or ``pack5``
    (noise-like maps, e.g. argmax of random weights; also chosen when no
    probe resolves in time). Stragglers are resolved at finalize with one
    stacked fetch of their run counts (``plan_all``).
    """

    MAX_PROBES = 3

    def __init__(self, pack: bool, use_rle: bool, img_w: Dict[str, int]):
        self.img_w = img_w
        self._pending: list = []  # encoded, tier not yet resolved
        # probe -> rle | pack5: the run's compressibility is measured on
        # its first stripes and the whole run commits to one codec
        self.mode = "probe" if (pack and use_rle) else ("pack5" if pack else "raw")
        self._probes = 0
        profiling.note("d2h_codec_mode", self.mode)
        if pack:
            self.w8 = {t: -(-w // 8) * 8 for t, w in img_w.items()}

    def _commit(self, mode: str) -> None:
        self.mode = mode
        profiling.note("d2h_codec_mode", mode)

    @profiling.span("stripes.encode")
    def encode(self, canvas: torch.Tensor, t: str, a: int, b: int) -> dict:
        """Encode canvas rows [a, b) and start their async D2H."""
        rec = {"y0": a, "h": b - a}
        if self.mode == "raw":
            rec["raw"] = _Fetch(canvas[:, a:b, : self.img_w[t]])
            return rec
        packed = pack_labels5(canvas[:, a:b, : self.w8[t]])
        rec["packed"] = packed
        mode = self.mode
        if mode == "probe" and self._probes >= self.MAX_PROBES:
            # probes unresolved — stop betting: they dual-shipped their
            # packed bytes, so pack5 keeps every transfer overlapped
            self._commit("pack5")
            mode = "pack5"
        if mode in ("probe", "rle"):
            sl = canvas[:, a:b, : self.img_w[t]]
            npx = sl.numel()
            small = max(64, npx // 256)
            mid = max(small * 2, npx // 32)
            if mid * 5 < packed.numel():
                runs_mid, n_runs = rle_encode5(sl, mid)
                rec.update(small=_Fetch(runs_mid[:small]), n_small=small, mid=runs_mid,
                           n_runs=n_runs, n_runs_h=_Fetch(n_runs))
                if mode == "probe":
                    # dual-ship: the packed fallback streams now so an
                    # incompressible map never waits on the verdict
                    rec["packed_h"] = _Fetch(packed)
                    rec["packed_sent"] = True
                    self._probes += 1
                    profiling.note("rle_probes", self._probes)
                self._pending.append(rec)
                self.poll()
                return rec
        rec["packed_h"] = _Fetch(packed)
        return rec

    def _decide(self, rec: dict, nr: int) -> None:
        """Tier decision from the fetched run count; starts the chosen
        tier's D2H and commits the run's codec mode on the first verdict."""
        rec["nr"] = nr
        if nr <= rec["n_small"]:
            rec["tier"] = "small"
            compressible = True
        elif nr <= rec["mid"].shape[0]:
            rec["tier"] = "mid"
            rec["mid_h"] = _Fetch(rec["mid"])
            compressible = True
        else:
            rec["tier"] = "packed"
            if not rec.get("packed_sent"):
                rec["packed_h"] = _Fetch(rec["packed"])
            compressible = False
        if self.mode == "probe":
            self._commit("rle" if compressible else "pack5")

    def poll(self) -> None:
        """Resolve, without blocking, every pending stripe whose run count
        has landed on the host, so its chosen transfer starts while the
        compute goes on."""
        still = []
        for rec in self._pending:
            if rec["n_runs_h"].ready():
                self._decide(rec, int(rec["n_runs_h"].numpy()))
            else:
                still.append(rec)
        self._pending = still

    @profiling.span("stripes.plan", "finalize_plan_s")
    def plan_all(self, recs: list) -> None:
        """Phase A: pick every stripe's tier with one host round-trip (the
        pending run counts stacked on the device and fetched as one
        tensor), then start every on-demand fetch, so all transfers are in
        flight before phase B waits on the first."""
        pend = [r for r in recs if "n_runs" in r and "tier" not in r]
        profiling.note("plan_pending", len(pend))
        if not pend:
            return
        with profiling.blocked():
            counts = torch.stack([r["n_runs"] for r in pend]).tolist()
        for rec, nr in zip(pend, counts):
            self._decide(rec, int(nr))
        self._pending = [r for r in self._pending if "tier" not in r]

    def decode_into(self, rec: dict, dst: np.ndarray) -> int:
        """Phase B: land the stripe into the canvas view (spans
        ``stripes.wait``, its D2H landing, and ``stripes.unpack``), count it
        under its tier (``stripes_small``, ``_mid``, ``_packed``, ``_raw``);
        returns the bytes fetched."""
        tier = rec.get("tier")
        if tier in ("small", "mid"):
            with profiling.span("stripes.wait", "finalize_wait_s"):
                runs = (rec["small"] if tier == "small" else rec["mid_h"]).numpy()
            with profiling.span("stripes.unpack", "finalize_unpack_s"):
                rle_decode_into(runs, rec["nr"], dst)
            # a probe stripe dual-shipped its packed fallback too
            nbytes = runs.nbytes + 4 + (rec["packed"].numel() if rec.get("packed_sent") else 0)
        elif "packed" in rec:
            tier = "packed"
            with profiling.span("stripes.wait", "finalize_wait_s"):
                arr = rec["packed_h"].numpy()
            with profiling.span("stripes.unpack", "finalize_unpack_s"):
                # native in-place unpack straight into the canvas slice
                profiling.note("unpack_route", unpack_labels5_into(arr, dst))
            nbytes = arr.nbytes + (rec["small"].host.numel() + 4 if "small" in rec else 0)
        else:
            tier = "raw"
            with profiling.span("stripes.wait", "finalize_wait_s"):
                arr = rec["raw"].numpy()
            with profiling.span("stripes.unpack", "finalize_unpack_s"):
                dst[...] = arr
            nbytes = arr.nbytes
        profiling.count("stripes_" + tier)
        return nbytes


class StripeStream:
    """Encodes newly final canvas rows as they fall outside the frontier,
    in fixed ``quantum``-row stripes (the sub-quantum rest lands at
    finalize)."""

    def __init__(self, tasks, img_h: int, codec: StripeCodec, quantum: int = 512):
        self.tasks = list(tasks)
        self.codec = codec
        self.quantum = quantum
        self.fetched_top = 0        # rows [0, fetched_top) encoded
        self.fetched_bot = img_h    # rows [fetched_bot, H) encoded
        self.stripes: Dict[str, list] = {t: [] for t in self.tasks}

    def advance(self, canvases: Dict[str, torch.Tensor], hi: int, lo: int) -> None:
        """Encode newly final rows: [0, hi) from the top frontier and
        [lo, H) from the bottom one (the two ends never cross)."""
        q = self.quantum
        hi = min(int(hi), self.fetched_bot) // q * q
        while hi - self.fetched_top >= q:
            for t in self.tasks:
                self.stripes[t].append(self.codec.encode(
                    canvases[t], t, self.fetched_top, self.fetched_top + q))
            self.fetched_top += q
        lo = max(int(lo), self.fetched_top)
        lo = self.fetched_bot - (self.fetched_bot - lo) // q * q
        while self.fetched_bot - lo >= q:
            for t in self.tasks:
                self.stripes[t].append(self.codec.encode(
                    canvases[t], t, self.fetched_bot - q, self.fetched_bot))
            self.fetched_bot -= q


@profiling.span("stripes.finalize", "finalize_s")
def finalize_canvases(canvases, stream: StripeStream, img_h, output_files) -> None:
    """Encode the canvas rows not yet streamed, plan every stripe's tier,
    land every stripe in its writer's canvas and write the rasters."""
    codec, stripes = stream.codec, stream.stripes
    for t in stream.tasks:
        if stream.fetched_top < min(stream.fetched_bot, img_h[t]):
            stripes[t].append(codec.encode(
                canvases[t], t, stream.fetched_top, min(stream.fetched_bot, img_h[t])))
    codec.plan_all([rec for t in stream.tasks for rec in stripes[t]])
    for t in stream.tasks:
        w = output_files[t]
        for rec in stripes[t]:
            y0, rows = rec["y0"], rec["h"]
            profiling.count("d2h_bytes", codec.decode_into(rec, w.canvas[:, y0:y0 + rows, :]))
        with profiling.span("stripes.write", "finalize_tiff_write_s"):
            w.close()
