"""The port's stripe D2H codec (``ops/pack.py``, ``ops/rle.py``,
``zonal/stripes.py StripeCodec``) against the JAX package's, on the CPU.

* ``pack_labels5``: the packed bytes equal the JAX ``pack_labels5``'s for
  labels < 32 and for any uint8; ``unpack_labels5_into`` lands them in a
  strided canvas slice whose width is not a multiple of 8, on the native
  route (``native/pack.cc`` built alone under ``build/``) and on numpy's,
  touching nothing outside the slice.
* ``rle_encode5``: the run buffer and the run count equal the JAX
  encoder's, the zero-length fill past the last run, the truncated buffer
  on overflow and one run per pixel included; the decode restores the map.
* ``StripeCodec``: probes dual-ship, the first verdict commits a
  compressible canvas to ``rle`` and a noise canvas to ``pack5``, as the
  JAX codec does on the same canvases; every tier (rle-small, rle-mid,
  pack5, raw) lands the stripe byte for byte, and a probe's bytes equal the
  JAX codec's.
* The codec choice: the port's default for an absent ``pack_d2h`` is raw
  (the JAX package's is pack + RLE), explicit keys behave as in JAX.
* ``run_inference`` (swin_micro-UPerNet, a 96 x 96 raster, 64 px tiles):
  ``pack_d2h: false``, ``d2h_codec: pack5`` and ``auto`` write the same
  bytes, equal to the JAX ``run_inference`` raster (which packs by
  default); a class-biased head gives a constant map, which ``auto``
  commits to RLE.
* ``FLAIR_ZONAL_TIMING`` logs one ``[timing]`` line of the call's record on
  the resident and the host path, and nothing without it.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from flair_for_aigle_tpu.geo.geotiff import open_raster, write_geotiff
from flair_for_aigle_tpu.geo.windows import from_origin
from flair_for_aigle_tpu.models.checkpoint import export_torch_state_dict
from flair_for_aigle_tpu.models.flair_model import FlairHubModel as JaxModel
from flair_for_aigle_tpu.ops import pack as jpack
from flair_for_aigle_tpu.ops import rle as jrle
from flair_for_aigle_tpu.zonal import stripes as jstripes
from flair_for_aigle_tpu.zonal.inference import run_inference as jax_run_inference
from flair_for_aigle_tpu.zonal.model_utils import example_batch_for
from flair_for_aigle_tpu.zonal.model_utils import prepare_model_config as jax_prepare
from flair_for_aigle_tpu_torch.ops import pack, rle
from flair_for_aigle_tpu_torch.zonal import inference as zi
from flair_for_aigle_tpu_torch.zonal import stripes
from tests._torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- pack5 -----------------------------------------------------------------

@pytest.mark.parametrize("high", [32, 256])
@pytest.mark.parametrize("shape", [(2, 13, 40), (1, 7, 8), (3, 1, 64)])
def test_pack_labels5_bytes_equal_jax(shape, high):
    x = np.random.default_rng(0).integers(0, high, shape).astype(np.uint8)
    want = np.asarray(jax.jit(jpack.pack_labels5)(jnp.asarray(x)))
    got = pack.pack_labels5(torch.from_numpy(x))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    assert tuple(got.shape) == (shape[0], shape[1], pack.packed_width(shape[2]))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_unpack_into_a_strided_canvas_slice(route, monkeypatch):
    x = np.random.default_rng(1).integers(0, 32, (2, 13, 40)).astype(np.uint8)
    packed = pack.pack_labels5(torch.from_numpy(x)).numpy()
    if route == "numpy":
        monkeypatch.setattr(pack, "native_library", lambda: None)
    canvas = np.zeros((2, 20, 64), np.uint8)
    assert pack.unpack_labels5_into(packed, canvas[:, 4:17, 9:46]) == route
    np.testing.assert_array_equal(canvas[:, 4:17, 9:46], x[:, :, :37])
    assert not canvas[:, :4].any() and not canvas[:, 17:].any()
    assert not canvas[:, :, :9].any() and not canvas[:, :, 46:].any()
    np.testing.assert_array_equal(pack.unpack_labels5(packed, 37), jpack.unpack_labels5(packed, 37))


def test_native_unpack_builds_pack_cc_alone_under_build():
    src = os.path.join(REPO, "native", "pack.cc")
    assert pack.NATIVE_SOURCE == src
    with open(src, "rb") as f:
        before = f.read()
    path = pack.build_native()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native_pack")
    assert os.path.basename(path).startswith("libflairpack_") and os.path.exists(path)
    assert path == pack.library_path() == pack.build_native()  # keyed, built once
    with open(src, "rb") as f:
        assert f.read() == before
    assert pack.native_library() is not None
    assert not [f for f in os.listdir(os.path.join(REPO, "native"))
                if f.startswith("libflairpack")]


# --- RLE -------------------------------------------------------------------

def _piecewise(seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = np.repeat(rng.integers(0, 19, (1, 9, 14)), 5, axis=2)
    return np.repeat(x, 3, axis=1).astype(np.uint8)  # (1, 27, 70)


RLE_CASES = {
    "roomy": (_piecewise(), 1024),
    "exact": (_piecewise(), 354),
    "overflow": (_piecewise(), 8),
    "per_pixel": ((np.arange(64, dtype=np.uint8) % 19).reshape(1, 4, 16), 64),
    "constant": (np.full((2, 5, 11), 7, np.uint8), 64),
}


@pytest.mark.parametrize("case", sorted(RLE_CASES))
def test_rle_encode5_equals_jax(case):
    x, cap = RLE_CASES[case]
    want_runs, want_n = jax.jit(jrle.rle_encode5, static_argnums=1)(jnp.asarray(x), cap)
    runs, n = rle.rle_encode5(torch.from_numpy(x), cap)
    assert runs.dtype == torch.uint8 and n.dtype == torch.int32 and n.dim() == 0
    assert tuple(runs.shape) == (cap, 5)
    np.testing.assert_array_equal(runs.numpy(), np.asarray(want_runs))
    assert int(n) == int(want_n)
    if int(n) <= cap:
        dst = np.empty_like(x)
        rle.rle_decode_into(runs.numpy(), int(n), dst)
        np.testing.assert_array_equal(dst, x)
    assert rle.default_max_runs(x.size) == jrle.default_max_runs(x.size)


# --- StripeCodec -------------------------------------------------------------

W = 640


def _bands() -> np.ndarray:
    """(1, 2048, W) canvas of constant class bands: compressible."""
    return (np.repeat(np.arange(8, dtype=np.uint8) % 19, W // 8)[None, None, :]
            * np.ones((1, 2048, 1), np.uint8))


def _noise() -> np.ndarray:
    return np.random.default_rng(0).integers(0, 19, (1, 2048, W)).astype(np.uint8)


def _encode_all(codec, canvas, n: int = 4):
    recs = [codec.encode(canvas, "T", i * 512, (i + 1) * 512) for i in range(n)]
    codec.plan_all(recs)
    return recs


@pytest.mark.parametrize("kind,mode", [("bands", "rle"), ("noise", "pack5")])
def test_stripe_codec_probe_commits_as_jax(kind, mode):
    canvas = _bands() if kind == "bands" else _noise()
    codec = stripes.StripeCodec(True, True, {"T": W})
    assert codec.mode == "probe"
    recs = _encode_all(codec, torch.from_numpy(canvas))
    jcodec = jstripes.StripeCodec(True, True, {"T": W})
    jrecs = _encode_all(jcodec, jnp.asarray(canvas))
    assert codec.mode == jcodec.mode == mode
    assert stripes.LAST_TIMINGS["d2h_codec_mode"] == mode
    # on the CPU the first probe resolves at once and commits the run:
    # later stripes ship RLE alone (rle) or the packed bytes alone (pack5)
    assert [bool(r.get("packed_sent")) for r in recs] == [True, False, False, False]
    assert [("n_runs" in r) for r in recs] == [True] + [mode == "rle"] * 3
    # (how many stripes JAX probes depends on when its run counts land)
    assert jrecs[0].get("packed_sent") and jrecs[0]["tier"] == recs[0]["tier"]
    for r, j in zip(recs, jrecs):
        np.testing.assert_array_equal(r["packed"].numpy(), np.asarray(j["packed"]))
        if "n_runs" in r and "n_runs" in j:
            assert r["nr"] == j["nr"]
            np.testing.assert_array_equal(r["mid"].numpy(), np.asarray(j["mid"]))
    for i, r in enumerate(recs):
        dst = np.empty((1, 512, W), np.uint8)
        codec.decode_into(r, dst)
        np.testing.assert_array_equal(dst, canvas[:, i * 512:(i + 1) * 512])


def _layers() -> np.ndarray:
    """(1, 512, W) canvas of 8 horizontal class layers: 8 runs of the
    flattened map, within the small tier (1280 runs)."""
    return np.repeat(np.arange(8, dtype=np.uint8), 64)[None, :, None] * np.ones((1, 1, W),
                                                                               np.uint8)


@pytest.mark.parametrize("tier", ["small", "mid", "packed", "raw"])
def test_every_tier_lands_byte_for_byte(tier):
    # small: 8 runs; mid: 4096 runs (8 a row) of the 10240 it holds
    canvas = {"small": _layers(), "mid": _bands()[:, :512],
              "packed": _noise()[:, :512], "raw": _noise()[:, :512]}[tier]
    # the canvas is wider than the image, as the engine's padded canvases are
    padded = np.full((1, 512 + 40, W + 40), 3, np.uint8)
    padded[:, :512, :W] = canvas
    codec = stripes.StripeCodec(tier != "raw", tier != "raw", {"T": W})
    rec = codec.encode(torch.from_numpy(padded), "T", 0, 512)
    codec.plan_all([rec])
    assert rec.get("tier", "raw") == tier
    dst = np.zeros((1, 512, W), np.uint8)
    nbytes = codec.decode_into(rec, dst)
    np.testing.assert_array_equal(dst, canvas)
    assert 0 < nbytes <= canvas.nbytes + (W * 512 // 8 * 5 + 1305 if tier != "raw" else 0)


def test_probes_stop_after_max_probes_unresolved(monkeypatch):
    """No run count lands (a slow link): after MAX_PROBES dual-shipped
    probes the codec commits to pack5, and every stripe still lands."""
    monkeypatch.setattr(stripes._Fetch, "ready", lambda self: False)
    codec = stripes.StripeCodec(True, True, {"T": W})
    canvas = _bands()
    recs = [codec.encode(torch.from_numpy(canvas), "T", i * 512, (i + 1) * 512)
            for i in range(4)]
    assert codec.mode == "pack5" and stripes.LAST_TIMINGS["rle_probes"] == 3
    assert [("n_runs" in r) for r in recs] == [True, True, True, False]
    codec.plan_all(recs)
    assert stripes.LAST_TIMINGS["plan_pending"] == 3
    for i, r in enumerate(recs):
        dst = np.empty((1, 512, W), np.uint8)
        codec.decode_into(r, dst)
        np.testing.assert_array_equal(dst, canvas[:, i * 512:(i + 1) * 512])


class _Out:
    def __init__(self, count):
        self.count = count


@pytest.mark.parametrize("keys,output_type,n_cls,count,want", [
    ({}, "argmax", 19, 1, (False, False)),
    ({"d2h_codec": "pack5"}, "argmax", 19, 1, (False, False)),
    ({"pack_d2h": True}, "argmax", 19, 1, (True, True)),
    ({"pack_d2h": True, "d2h_codec": "auto"}, "argmax", 32, 1, (True, True)),
    ({"pack_d2h": True, "d2h_codec": "pack5"}, "argmax", 19, 1, (True, False)),
    ({"pack_d2h": True}, "class_prob", 19, 19, (False, False)),
    ({"pack_d2h": True}, "argmax", 33, 1, (False, False)),
    ({"pack_d2h": False}, "argmax", 19, 1, (False, False)),
])
def test_codec_choice_and_the_raw_default(keys, output_type, n_cls, count, want):
    cfg = {**keys, "output_type": output_type,
           "tasks": [{"name": "T", "active": True,
                      "class_names": {i: str(i) for i in range(n_cls)}},
                     {"name": "off", "active": False,
                      "class_names": {i: str(i) for i in range(40)}}]}
    assert zi.d2h_codec_choice(cfg, {"T": _Out(count)}) == want


# --- run_inference -----------------------------------------------------------

RES, PATCH, MARGIN, N_CLS, SIDE = 0.5, 64, 8, 5, 96
TASK = "AERIAL_LABEL-COSIA"


@pytest.fixture(scope="module")
def zonal(tmp_path_factory):
    d = tmp_path_factory.mktemp("codec")
    img = str(d / "img.tif")
    raster = np.random.default_rng(0).integers(0, 255, (3, SIDE, SIDE)).astype(np.uint8)
    write_geotiff(img, raster, from_origin(10000.0, 20000.0, RES, RES), "EPSG:2154")
    cfg = {
        "output_path": str(d / "out"), "output_name": "codec",
        "write_dataframe": False, "output_type": "argmax", "cog_conversion": False,
        "model_weights": str(d / "w.safetensors"), "batch_size": 2, "num_worker": 1,
        "img_pixels_detection": PATCH, "margin": MARGIN, "output_px_meters": RES,
        "monotemp_arch": "swin_micro_patch4_window12_384-upernet",
        "normalize_on_device": True,
        "modalities": {
            "inputs": {"AERIAL_RGBI": True},
            "AERIAL_RGBI": {"input_img_path": img, "channels": [1, 2, 3],
                            "normalization": {"type": "custom", "means": [105.0, 111.0, 102.0],
                                              "stds": [52.0, 45.0, 44.0]}},
        },
        "tasks": [{"name": TASK, "active": True,
                   "class_names": {i: f"c{i}" for i in range(N_CLS)}}],
    }
    mc = jax_prepare({**cfg, "model_weights": ""})
    variables = jax.device_get(jax.jit(JaxModel(config=mc).init)(
        jax.random.key(3), example_batch_for(mc, {"AERIAL_RGBI": PATCH}, 1)))
    sd = {k: np.ascontiguousarray(v) for k, v in export_torch_state_dict(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]}).items()}
    save_file(sd, cfg["model_weights"])
    # a head biased to class 2: a constant label map
    head = [k for k, v in sd.items() if k.endswith("bias") and v.shape == (N_CLS,)]
    assert len(head) == 1
    biased = dict(sd)
    biased[head[0]] = np.where(np.arange(N_CLS) == 2, 1e4, 0).astype(np.float32)
    save_file(biased, str(d / "biased.safetensors"))
    return {"cfg": cfg, "dir": d, "biased": str(d / "biased.safetensors")}


CODECS = {"raw": {"pack_d2h": False}, "pack5": {"pack_d2h": True, "d2h_codec": "pack5"},
          "auto": {"pack_d2h": True, "d2h_codec": "auto"}, "absent": {}}


def _port_runs(cfg, d, tag):
    out = {}
    for name, keys in CODECS.items():
        c = {**copy.deepcopy(cfg), **keys, "output_path": str(d / f"{tag}_{name}")}
        os.makedirs(c["output_path"])
        with open_raster(zi.run_inference(c, device="cpu")[TASK]) as src:
            out[name] = src.read()
        out[name + "_timings"] = dict(stripes.LAST_TIMINGS)
    return out


def test_run_inference_codecs_write_the_jax_raster(zonal):
    cfg, d = zonal["cfg"], zonal["dir"]
    got = _port_runs(cfg, d, "port")
    jcfg = {**copy.deepcopy(cfg), "output_path": str(d / "jax")}
    os.makedirs(jcfg["output_path"])
    with open_raster(jax_run_inference(jcfg)[TASK]) as src:
        want = src.read()
    assert want.shape == (1, SIDE, SIDE) and len(np.unique(want)) > 1
    for name in CODECS:
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    modes = {n: got[n + "_timings"]["d2h_codec_mode"] for n in CODECS}
    # random weights give a noise-like map: auto's probe commits to pack5
    assert modes == {"raw": "raw", "pack5": "pack5", "auto": "pack5", "absent": "raw"}
    for n in ("pack5", "auto"):
        assert got[n + "_timings"]["unpack_route"] == "native"
        assert got[n + "_timings"]["d2h_bytes"] < got["raw_timings"]["d2h_bytes"] + 2000
    assert got["raw_timings"]["d2h_bytes"] == SIDE * SIDE


def test_run_inference_auto_commits_a_constant_map_to_rle(zonal):
    cfg = {**copy.deepcopy(zonal["cfg"]), "model_weights": zonal["biased"]}
    got = _port_runs(cfg, zonal["dir"], "biased")
    for name in CODECS:
        np.testing.assert_array_equal(got[name], np.full((1, SIDE, SIDE), 2, np.uint8),
                                      err_msg=name)
    t = got["auto_timings"]
    assert t["d2h_codec_mode"] == "rle" and t["rle_probes"] == 1
    # one stripe of 96 x 96 px: 64 runs' capacity (320 B) + count + the
    # dual-shipped packed probe (96 x 60 B)
    assert t["d2h_bytes"] == 64 * 5 + 4 + SIDE * SIDE // 8 * 5
    assert {"finalize_plan_s", "finalize_unpack_s", "finalize_wait_s",
            "plan_pending"} <= set(t)


@pytest.mark.parametrize("path", ["resident", "host"])
def test_flair_zonal_timing_logs_the_timing_line(zonal, path, monkeypatch, caplog):
    cfg = {**copy.deepcopy(zonal["cfg"]), "output_path": str(zonal["dir"] / f"timing_{path}")}
    if path == "host":
        cfg["device_resident_tiles"] = False
    os.makedirs(cfg["output_path"])
    monkeypatch.setenv("FLAIR_ZONAL_TIMING", "1")
    with caplog.at_level("WARNING", logger=zi.logger.name):
        zi.run_inference(cfg, device="cpu")
    lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("[timing]")]
    assert len(lines) == 1 and lines[0].startswith(f"[timing] {path} path:"), lines
    # the record's seconds: both paths read (stripes, or the loader's
    # batches), dispatch batches and finalize
    assert all(f" {k}=" in lines[0] for k in ("read", "dispatch", "forward", "finalize",
                                                "blocked", "total")), lines[0]
    monkeypatch.delenv("FLAIR_ZONAL_TIMING")
    caplog.clear()
    with caplog.at_level("WARNING", logger=zi.logger.name):
        zi.run_inference({**cfg, "output_path": cfg["output_path"] + "_off"}, device="cpu")
    assert not [r for r in caplog.records if r.getMessage().startswith("[timing]")]
