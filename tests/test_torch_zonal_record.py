"""The exact keys of a zonal call's record (``zonal/stripes.py
LAST_TIMINGS``), on the CPU.

The engine's keys (``zonal/inference.py RECORD_KEYS``) and those the layers
below declare beside their counts (``utils/profiling.py declare``:
``blocked_s``, ``const_uploads``, ``dw_ln_launches``) fill every call's
record, whichever tile source runs it; the codec, the spans inside the
forward and the time series add theirs. The benchmark, ``bench.py`` and
``chip_smoke.py`` read these keys, so each route's set is held here to the
one it had before the keys moved to their owners: a toy dalle (the span
tests' swin_micro-UPerNet, 160 x 160 raster, batch 2, labels through the
stripe codec) on the resident route, on the host route, and with a
Sentinel-2 series on the host route.
"""

import pytest

from flair_for_aigle_tpu_torch.utils import profiling
from flair_for_aigle_tpu_torch.zonal import inference as zi
from tests._torch_threads import few_torch_threads  # noqa: F401
from tests.test_torch_series_spans import _series_config
from tests.test_torch_zonal_spans import _config, _dalle

MONO = {
    "batches", "blocked_s", "const_uploads", "d2h_bytes", "d2h_codec_mode", "dispatch_s",
    "dw_ln_launches", "engine_setup_s", "finalize_plan_s", "finalize_s",
    "finalize_tiff_write_s", "finalize_unpack_s", "finalize_wait_s", "forward_s", "gather_s",
    "model.decoder", "model.encoder", "model.encoder.block", "model.encoder.stage1",
    "model.encoder.stage2", "model.encoder.stage3", "model.encoder.stage4", "plan_pending",
    "poll_s", "put_s", "read_s", "rle_probes", "stitch_s", "stream_s", "stripes.encode",
    "stripes_mid", "stripes_packed", "stripes_raw", "stripes_small", "tiles", "total_s",
    "unpack_route", "zonal.epilogue"}
KEYS = {"resident": MONO, "host": MONO,
        "series": MONO | {"model.encoder.utae", "model.fusion", "series_frames",
                          "series_frames_padded", "series_s"}}


@pytest.mark.parametrize("call", ["resident", "host", "series"])
def test_each_route_records_exactly_its_keys(call, tmp_path):
    cfg = _series_config(tmp_path) if call == "series" else _config(tmp_path, call)
    rec, n_tiles, _ = _dalle({**cfg, "output_path": str(tmp_path / "out")})
    assert set(rec) == KEYS[call], (set(rec) ^ KEYS[call])
    assert rec["batches"] > 0 and rec["tiles"] == n_tiles
    # the engine's and the stripes' keys, and none counted below zonal/
    assert set(zi.RECORD_KEYS) | {"blocked_s", "const_uploads", "dw_ln_launches"} == \
        set(profiling.declared())
    assert not {"blocked_s", "const_uploads", "dw_ln_launches"} & set(zi.RECORD_KEYS)
