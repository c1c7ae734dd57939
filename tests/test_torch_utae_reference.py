"""The port's U-TAE, its aerial + Sentinel-2 model and its series route
against the benchmark's plain float32 reference
(``benchmark/reference/utae.py``: upstream utae-paps U-TAE and L-TAE,
FLAIR-HUB's full fusion), on the CPU at a small size, with seeded random
weights drawn by ``benchmark/weights.py`` in FLAIR-HUB's checkpoint layout.

* U-TAE at the published widths (``[64, 64, 128, 128]`` after
  ``adjust_fm_length``, ``d_model`` 256, 16 heads, ``d_k`` 4, k3 s1 p1)
  on a batch of three series that keep 7, 4 and 5 dates, padded to 7: the
  logits and every map the fusion reads.
* ``FlairHubModel`` with ``AERIAL_RGBI`` (swin_micro-UPerNet) and
  ``SENTINEL2_TS`` in full fusion, float32: the task logits.
* The series route: the frames and day offsets the port's zonal dataset
  gives every tile of a seed-made series and mask, against the
  reference's own window, cover rule and cast; on a small dalle and on the
  cell's own geometry (5000 px at 0.2 m, a 10 m series, 144 tiles).
* A series reaching past its dalle is refused by the engine.
* Each planted fault of the series route (``benchmark/control_mm.py``)
  run through the cell at a small size comes out above the cell's
  ``label_gap`` limit, and the sound run within it.
"""

import copy
import tempfile

import numpy as np
import pytest
import torch

from benchmark import control_mm, registry, weights
from benchmark.drivers import zonal_mm as dmm
from benchmark.frozen import memory_io, raster, series as fseries
from benchmark.reference import utae as uref
from benchmark.reference import zonal as zref
from benchmark.tests import small_mm
from flair_for_aigle_tpu_torch.geo.windows import from_origin
from flair_for_aigle_tpu_torch.models import utae as tu
from flair_for_aigle_tpu_torch.models.flair_model import FlairHubModel
from flair_for_aigle_tpu_torch.zonal import inference as zi
from flair_for_aigle_tpu_torch.zonal.model_utils import compute_patch_sizes, prepare_model_config
from flair_for_aigle_tpu_torch.zonal.slicing import generate_patches_from_reference
from tests._torch_threads import few_torch_threads  # noqa: F401

CPU = torch.device("cpu")
CONFIG = registry.config(registry.load_benchmark(), "swinb-upernet-utae")
WIDTHS = [64, 64, 128, 128]


def _close(got, want, rel):
    """Within ``rel`` of the reference's largest magnitude."""
    got, want = got.double(), want.double()
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()), (err, float(want.abs().max()))


def _series_batch(seed=0, lengths=(7, 4, 5), side=8, channels=10):
    """Frames (B, T, C, h, w) of reflectance-like values, padded with zero
    frames to the largest length, and their day offsets (zero padded)."""
    g = torch.Generator().manual_seed(seed)
    items = []
    for n in lengths:
        frames = torch.rand((n, channels, side, side), generator=g) * 3000 + 1
        days = torch.sort(torch.randint(-130, 230, (n,), generator=g)).values.float()
        items.append((frames.numpy(), days.numpy()))
    frames, dates = uref.pad_batch(items)
    return torch.from_numpy(frames), torch.from_numpy(dates)


def test_utae_with_padded_dates_matches_the_reference():
    u = CONFIG["utae"]
    assert uref.adjust_fm_length(u["encoder_widths"], 4) == WIDTHS == u["adjusted_widths"]
    ref = uref.UTAE(10, WIDTHS, WIDTHS, u["out_conv"], u["str_conv_k"], u["str_conv_s"],
                    u["str_conv_p"], u["agg_mode"], u["encoder_norm"], u["n_head"],
                    u["d_model"], u["d_k"], u["pad_value"], u["padding_mode"]).eval()
    state = weights.make(weights.layout(ref), 3, CPU)
    ref.load_state_dict(state)
    port = tu.UTAE(10, WIDTHS, WIDTHS, u["out_conv"], u["str_conv_k"], u["str_conv_s"],
                   u["str_conv_p"], u["agg_mode"], u["encoder_norm"], u["n_head"],
                   u["d_model"], u["d_k"], encoder=False, return_maps=True,
                   pad_value=u["pad_value"], padding_mode=u["padding_mode"]).eval()
    port.load_state_dict(dmm.port_state(state), strict=True)
    frames, dates = _series_batch()
    assert int((frames.flatten(2) == 0).all(-1).sum()) == 3 + 2  # two Ts padded to 7
    with torch.no_grad():
        want, want_maps = ref(frames, dates)
        got, got_maps = port(frames.permute(0, 1, 3, 4, 2), batch_positions=dates)
    # float32 on both sides, summed in other orders (the port's einsums and
    # NHWC convolutions); the reflectances (~3000) lose about 12 of float32's
    # 24 bits where the first GroupNorm centres them, hence 1e-4 and not 1e-6
    _close(got.permute(0, 3, 1, 2), want, 1e-4)
    assert len(got_maps) == len(want_maps) == 4
    for g, w in zip(got_maps, want_maps):
        _close(g.permute(0, 3, 1, 2), w, 1e-4)


def test_full_fusion_matches_the_reference():
    cfg = copy.deepcopy(CONFIG)
    cfg["encoder"]["depths"] = [1, 1, 1, 1]
    fam = registry.family(cfg["family"])
    ref = fam.build(cfg, 3).eval()
    state = weights.make(weights.layout(ref), 4, CPU)
    ref.load_state_dict(state)
    z = copy.deepcopy(cfg["zonal"])
    z.update(monotemp_arch="swin_micro_patch4_window12_384-upernet", model_weights="")
    port = FlairHubModel(prepare_model_config(z)).eval()
    port.load_state_dict(dmm.port_state(state), strict=True)
    frames, dates = _series_batch(seed=1, side=10)
    aerial = torch.randn((3, 3, 96, 96), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = ref(aerial, frames, dates)
        got, _ = port({"AERIAL_RGBI": aerial, "SENTINEL2_TS": frames,
                       "SENTINEL2_DATES": dates,
                       "AERIAL_LABEL-COSIA": torch.zeros((3, 1, 96, 96))})
    # float32 Swin, UPerNet and U-TAE, summed in other orders (the port's
    # resizes are matrix products); the series' reflectances cost U-TAE
    # about 12 bits as above, hence 1e-4
    _close(got["AERIAL_LABEL-COSIA"], want, 1e-4)


def _dataset_series(traffic: dict, seed: int, margin: int, patch: int):
    """(port items, reference items) of every tile of dalle 0."""
    ctx = small_mm.context_for(seed, traffic=traffic)
    ctx.config["zonal"].update(img_pixels_detection=patch, margin=margin)
    tr = ctx.traffic
    side, res, s2_res = tr["side_px"], tr["res_m"], tr["series"]["res_m"]
    series, mask = fseries.series_pool(seed, dict(tr, pool=1), CPU)[0]
    offsets = uref.day_offsets(fseries.date_strings(tr["series"]), "05-15")
    store = memory_io.Store()
    with dmm.installed(store), tempfile.TemporaryDirectory() as work:
        z = dmm.zonal_config(ctx, work)
        paths, west, north = dmm.Dalles(ctx, z, None, store, work).put(
            0, np.zeros((3, side, side), np.uint8), (series, mask))
        z["modalities"]["AERIAL_RGBI"]["input_img_path"] = paths[0]
        z["modalities"]["SENTINEL2_TS"]["input_img_path"] = paths[1]
        z["modalities"]["SENTINEL2_TS"]["filter_clouds_img_path"] = paths[2]
        z = zi.initialize_geometry_and_resolutions(z)
        tiles = generate_patches_from_reference(z, paths[0], None)
        dataset = zi.prep_dataset(z, tiles, compute_patch_sizes(z))
        got = [(dataset[i]["SENTINEL2_TS"], dataset[i]["SENTINEL2_DATES"])
               for i in range(len(tiles))]
        dataset.close()
    windows = uref.series_windows(side, side, west, north, res, patch, margin, s2_res)
    assert len(windows) == len(zref.tiles(side, side, west, north, res, patch, margin))
    want = [uref.tile_series(series, mask, offsets, *w, 10) for w in windows]
    return got, want, tr["series"]["dates"]


@pytest.mark.parametrize("geometry", ["small", "cell"])
def test_series_route_keeps_the_reference_dates(geometry):
    if geometry == "small":
        traffic, patch, margin = {}, 96, 8
    else:
        traffic = {k: registry.traffic("dalle-s2-b16")[k]
                   for k in ("side_px", "res_m", "series", "grid_origin_m", "grid_columns")}
        patch, margin = 512, 40
    got, want, full = _dataset_series(traffic, 31, margin, patch)
    assert len(got) == len(want) > 1
    kept = [len(w[0]) for w in want]
    assert min(kept) < max(kept) < full  # clouds leave tiles different dates
    for (gf, gd), (wf, wd) in zip(got, want):
        assert gf.dtype == np.float32 and gd.dtype == np.float32
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gd, wd)
    if geometry == "cell":
        assert len(got) == 144 and 30 <= np.mean(kept) <= 45


def test_a_series_past_the_dalle_is_refused():
    """The series covers its dalle's km and no more: the engine refuses a
    modality whose bounds are not the aerial's (to 1 cm and a relative
    1e-5, 7 m at the cell's eastings), so a series with a margin of one of
    the cell's 10 m pixels is refused, and the tiles along the edges read
    past the series boundless, as they would a user's."""
    ctx = small_mm.context_for(31)
    tr = ctx.traffic
    side, s2_res = tr["side_px"], tr["series"]["res_m"]
    series, mask = fseries.series_pool(31, dict(tr, pool=1), CPU)[0]
    store = memory_io.Store()
    with dmm.installed(store), tempfile.TemporaryDirectory() as work:
        z = dmm.zonal_config(ctx, work)
        paths, west, north = dmm.Dalles(ctx, z, None, store, work).put(
            0, np.zeros((3, side, side), np.uint8), (series, mask))
        z["modalities"]["AERIAL_RGBI"]["input_img_path"] = paths[0]
        z["modalities"]["SENTINEL2_TS"]["input_img_path"] = paths[1]
        z = zi.initialize_geometry_and_resolutions(z)
        assert z["image_bounds"]["left"] == west
        cell_res = registry.traffic("dalle-s2-b16")["series"]["res_m"]
        m = int(round(cell_res / s2_res))
        wide = np.pad(series, ((0, 0), (m, m), (m, m)))
        store.put(paths[1], wide, from_origin(west - cell_res, north + cell_res, s2_res, s2_res),
                  "EPSG:2154")
        z.pop("image_shape_px", None)
        with pytest.raises(ValueError, match="Bounds mismatch"):
            zi.initialize_geometry_and_resolutions(z)


@pytest.mark.parametrize("fault", sorted(control_mm.FAULTS))
def test_each_planted_fault_is_above_the_limit(fault):
    out = small_mm.run(57, fault=control_mm.FAULTS[fault])
    gap = out["checks"]["label_gap"]
    assert out["correct"] is False and gap["value"] > gap["limit"], gap


def test_the_sound_run_is_within_the_limit():
    gap = small_mm.run(57)["checks"]["label_gap"]
    assert gap["value"] <= gap["limit"] / 2, gap
