"""The series route's spans and counters, on the CPU (``utils/profiling.py``).

A toy aerial + Sentinel-2 dalle (swin_micro-UPerNet fused with the zonal
U-TAE, a 160 x 160 raster at 0.5 m, 64 px tiles, batch 2, a 6-date series
at 4 m whose cloud mask leaves the tiles different dates) runs through
``inference_and_write`` on the host route, once under ``profile_trace``
and once with no profiler:

* the record holds ``series_s`` (the loader's ``zonal.series`` a tile,
  within the call's ``total_s``) and the counters ``series_frames``
  (every batch's B x T) and ``series_frames_padded`` (the frames padding
  each batch to its largest T), equal to what the tiles' kept dates give;
* ``model.encoder.utae`` lies inside ``model.encoder`` and
  ``model.fusion`` inside ``model.decoder``, once a batch;
* a mono dalle's record and trace hold none of them.
"""

import os

import numpy as np
import pytest

from flair_for_aigle_tpu_torch.geo.geotiff import write_geotiff
from flair_for_aigle_tpu_torch.geo.windows import from_origin
from flair_for_aigle_tpu_torch.utils import profiling
from tests._torch_threads import few_torch_threads  # noqa: F401
from tests.test_torch_zonal_spans import (BATCH, N_CLS, RES, SIDE, TASK, _annotations, _config,
                                           _dalle, _within)

S2_RES, DATES, CHANNELS = 4.0, 6, 10
SERIES_KEYS = {"series_s", "series_frames", "series_frames_padded"}


def _series_config(d) -> dict:
    cfg = _config(d, "host")
    side = int(SIDE * RES / S2_RES)
    origin = (10000.0, 20000.0)
    rng = np.random.default_rng(1)
    s2, mask, dates = str(d / "s2.tif"), str(d / "s2_msk.tif"), str(d / "dates.txt")
    write_geotiff(s2, rng.integers(1, 4000, (DATES * CHANNELS, side, side)).astype(np.uint16),
                  from_origin(*origin, S2_RES, S2_RES), "EPSG:2154")
    msk = np.zeros((DATES * 2, side, side), np.uint8)
    msk[1 * 2 + 1, :, :5] = 90  # date 1 cloudy over the western tiles alone
    msk[3 * 2, side - 4:] = 90  # date 3 snowy over the southern tiles alone
    msk[4 * 2 + 1, ::2, ::2] = 90  # date 4 over a quarter of every tile
    write_geotiff(mask, msk, from_origin(*origin, S2_RES, S2_RES), "EPSG:2154")
    with open(dates, "w") as f:
        f.write("\n".join(f"2021{m:02d}15" for m in range(3, 3 + DATES)))
    cfg["modalities"]["inputs"]["SENTINEL2_TS"] = True
    cfg["modalities"]["SENTINEL2_TS"] = {
        "input_img_path": s2, "channels": list(range(1, CHANNELS + 1)), "dates_txt": dates,
        "filter_clouds": True, "filter_clouds_img_path": mask, "temporal_average": False}
    cfg["multitemp_model_ref_date"] = "05-15"
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("series_spans")
    cfg = _series_config(d)
    logdir = d / "trace"
    with profiling.profile_trace(str(logdir)):
        traced = _dalle(cfg)
    plain = _dalle({**cfg, "output_path": str(d / "off")})
    mono_dir = d / "mono"
    os.makedirs(mono_dir)
    with profiling.profile_trace(str(mono_dir / "trace")):
        mono = _dalle(_config(d, "host"))
    return {"traced": traced, "plain": plain, "ann": _annotations(logdir), "mono": mono,
            "mono_ann": _annotations(mono_dir / "trace")}


def _expected_frames(d_cfg) -> tuple[int, int]:
    """(frames, padded) of the dalle's batches from each tile's kept dates,
    in the engine's bottom-up order, the last batch padded by its last
    tile."""
    from flair_for_aigle_tpu_torch.zonal import inference as zi
    from flair_for_aigle_tpu_torch.zonal.model_utils import compute_patch_sizes
    from flair_for_aigle_tpu_torch.zonal.slicing import generate_patches_from_reference

    cfg = zi.initialize_geometry_and_resolutions(dict(d_cfg))
    path = cfg["modalities"]["AERIAL_RGBI"]["input_img_path"]
    tiles = generate_patches_from_reference(cfg, path, None)
    dataset = zi.prep_dataset(cfg, tiles, compute_patch_sizes(cfg))
    kept = np.array([dataset[i]["SENTINEL2_TS"].shape[0] for i in range(len(tiles))])
    dataset.close()
    tops = np.array([round((cfg["image_bounds"]["top"] - t["top"]) / RES) for t in tiles])
    lefts = np.array([round((t["left"] - cfg["image_bounds"]["left"]) / RES) for t in tiles])
    order = np.lexsort((lefts, -tops))
    frames = padded = 0
    for s in range(0, len(order), BATCH):
        ts = list(kept[order[s:s + BATCH]])
        ts += [ts[-1]] * (BATCH - len(ts))
        frames += BATCH * max(ts)
        padded += sum(max(ts) - t for t in ts)
    assert len(set(kept)) > 1
    return frames, padded


def test_series_time_and_frames_are_recorded(runs, tmp_path):
    d_cfg = _series_config(tmp_path)
    frames, padded = _expected_frames(d_cfg)
    assert padded > 0
    for rec, n_tiles, _ in (runs["traced"], runs["plain"]):
        assert SERIES_KEYS <= set(rec)
        assert rec["series_s"] > 0
        assert (rec["series_frames"], rec["series_frames_padded"]) == (frames, padded)
    np.testing.assert_array_equal(runs["traced"][2], runs["plain"][2])


def test_series_time_lies_within_the_call(runs):
    """``zonal.series`` runs on the loader's thread, beside the driving
    thread's spans: its sum lies within the call's ``total_s``."""
    for rec, _, _ in (runs["traced"], runs["plain"]):
        assert 0 < rec["series_s"] < rec["total_s"]


def test_utae_and_fusion_spans_nest_in_the_model_spans(runs):
    ann, rec = runs["ann"], runs["traced"][0]
    for name, parent in (("model.encoder.utae", "model.encoder"),
                         ("model.fusion", "model.decoder")):
        spans = [a for a in ann if a[0] == name]
        assert len(spans) == rec["batches"], name
        parents = [a for a in ann if a[0] == parent]
        assert all(any(_within(s, p) for p in parents) for s in spans), name
        assert rec[name] > 0


def test_a_mono_dalle_holds_none_of_them(runs):
    rec = runs["mono"][0]
    new = SERIES_KEYS | {"model.encoder.utae", "model.fusion"}
    assert not new & set(rec)
    assert not {"zonal.series", "model.encoder.utae", "model.fusion"} & \
        {a[0] for a in runs["mono_ann"]}
    assert {"model.encoder", "model.decoder"} <= {a[0] for a in runs["mono_ann"]}


def test_the_host_route_stacks_no_label_placeholder(runs, tmp_path, monkeypatch):
    """The engine stands device zeros in for the labels, so its loader
    stacks none; a dataset read outside the engine keeps its placeholders
    (the model reads the output size from them there)."""
    from flair_for_aigle_tpu_torch.zonal import dataset as zd

    seen = []
    make = zd.BatchedLoader._make_batch

    def recording(self, indices):
        batch = make(self, indices)
        seen.append(set(batch))
        return batch

    monkeypatch.setattr(zd.BatchedLoader, "_make_batch", recording)
    rec, _, labels = _dalle({**_series_config(tmp_path), "output_path": str(tmp_path / "o")})
    assert seen and all("SENTINEL2_TS" in k and TASK not in k for k in seen)
    np.testing.assert_array_equal(labels, runs["plain"][2])
    assert rec["series_frames"] == runs["plain"][0]["series_frames"]

    from flair_for_aigle_tpu_torch.zonal import inference as zi
    from flair_for_aigle_tpu_torch.zonal.model_utils import compute_patch_sizes
    from flair_for_aigle_tpu_torch.zonal.slicing import generate_patches_from_reference

    cfg = zi.initialize_geometry_and_resolutions(_series_config(tmp_path))
    tiles = generate_patches_from_reference(
        cfg, cfg["modalities"]["AERIAL_RGBI"]["input_img_path"], None)
    ds = zi.prep_dataset(cfg, tiles, compute_patch_sizes(cfg))
    assert ds[0][TASK].shape == (N_CLS, 64, 64)
    ds.close()


def test_spans_and_counters_from_many_threads_lose_no_update():
    """The loader's threads add to the record beside the driving thread:
    every addition lands, with more threads than cores and a short switch
    interval."""
    import sys
    import threading

    record, n_threads, n_adds = {}, 16, 400
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording(record):
            def work():
                for _ in range(n_adds):
                    profiling.count("series_frames", 2)
                    with profiling.span("zonal.series", "series_s"):
                        pass

            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert record["series_frames"] == 2 * n_threads * n_adds
    assert record["series_s"] > 0
