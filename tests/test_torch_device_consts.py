"""The forward's shape-made constants kept on the device
(``flair_for_aigle_tpu_torch/device.py device_constant``), on the CPU.

* Swin's relative-position index (windows of 12 and clamped below it),
  the resize matrices (bilinear, bilinear align-corners, adaptive pool),
  the nearest indices and K4's tables read from the cache equal freshly
  built ones bit for bit, and the resizes equal their two products on
  fresh matrices.
* An entry is one (constant, sizes, device): two devices, two constants
  of other dtypes at the same sizes, never share one.
* Under ``profiling.recording``, a second swin-micro-UPerNet forward at a
  geometry uploads nothing (``const_uploads`` 0, no ``blocked_s``); a new
  geometry counts each of its uploads once, and its labels equal those of
  a forward with an empty cache.
* A training step gives every ``relative_position_bias_table`` a nonzero
  gradient, bit for bit the one of uploads made afresh in every forward,
  with and without ``remat``.
"""

import numpy as np
import pytest
import torch

from flair_for_aigle_tpu_torch import device as dev_mod
from flair_for_aigle_tpu_torch.device import device_constant
from flair_for_aigle_tpu_torch.models import swin
from flair_for_aigle_tpu_torch.models.flair_model import FlairHubModel
from flair_for_aigle_tpu_torch.models.layers import init_weights
from flair_for_aigle_tpu_torch.ops import epilogue, resize
from flair_for_aigle_tpu_torch.train import optim
from flair_for_aigle_tpu_torch.train.task import make_steps
from flair_for_aigle_tpu_torch.utils import profiling
from flair_for_aigle_tpu_torch.zonal.model_utils import prepare_model_config
from tests._fixtures import make_batch, make_config
from tests._torch_threads import few_torch_threads  # noqa: F401

CPU = torch.device("cpu")
TASK = "T"


@pytest.fixture
def empty_cache(monkeypatch):
    """A cache of no entries for the test, the process's restored after."""
    monkeypatch.setattr(dev_mod, "_CONSTANTS", {})
    return dev_mod._CONSTANTS


def _fresh(make):
    """The function under its ``lru_cache``, if any: a new array a call."""
    return getattr(make, "__wrapped__", make)


@pytest.mark.parametrize("ws", [12, 8, 7, 4, 2])
def test_swin_index_from_the_cache_is_a_fresh_one(empty_cache, ws):
    got = device_constant(swin._relative_position_index, ws, ws, 12, device=CPU)
    want = torch.as_tensor(_fresh(swin._relative_position_index)(ws, ws, 12))
    assert got.dtype == torch.int64 and torch.equal(got, want)
    attn = swin.WindowAttention(32, 2, 12)
    attn.reset_parameters(torch.Generator().manual_seed(0))
    bias = attn.relative_position_bias_table[want.reshape(-1)].reshape(ws * ws, ws * ws, -1)
    assert torch.equal(attn.position_bias(ws), bias.permute(2, 0, 1).float())


RESIZE_SIZES = [(16, 128), (128, 16), (32, 128), (1, 16), (16, 1), (16, 3), (16, 6),
                (7, 5), (5, 7)]


@pytest.mark.parametrize("make", [resize._bilinear_matrix, resize._bilinear_ac_matrix,
                                  resize._pool_matrix, resize._torch_nearest_index],
                         ids=["bilinear", "bilinear_ac", "pool", "nearest"])
@pytest.mark.parametrize("n_in,n_out", RESIZE_SIZES)
def test_resize_constants_from_the_cache_are_fresh_ones(empty_cache, make, n_in, n_out):
    got = device_constant(make, n_in, n_out, device=CPU)
    want = torch.as_tensor(_fresh(make)(n_in, n_out))
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert device_constant(make, n_in, n_out, device=CPU) is got


@pytest.mark.parametrize("fn,make", [(resize.resize_bilinear_nhwc, resize._bilinear_matrix),
                                     (resize.resize_bilinear_ac_nhwc,
                                      resize._bilinear_ac_matrix),
                                     (resize.adaptive_avg_pool_nhwc, resize._pool_matrix)],
                         ids=["bilinear", "bilinear_ac", "pool"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resizes_equal_their_products_on_fresh_matrices(empty_cache, fn, make, dtype):
    x = torch.randn((2, 7, 5, 3), generator=torch.Generator().manual_seed(1)).to(dtype)
    for out_h, out_w in ((16, 12), (3, 2), (1, 1)):
        mh = torch.as_tensor(_fresh(make)(7, out_h))
        mw = torch.as_tensor(_fresh(make)(5, out_w))
        want = torch.einsum("pw,...owc->...opc", mw,
                            torch.einsum("oh,...hwc->...owc", mh, x.float())).to(dtype)
        for _ in range(2):  # the upload, then the cache
            assert torch.equal(fn(x, out_h, out_w), want)


def test_nearest_resize_equals_fresh_indices(empty_cache):
    x = torch.randn((2, 6, 10, 3), generator=torch.Generator().manual_seed(2))
    ih = torch.as_tensor(resize._torch_nearest_index(6, 9))
    iw = torch.as_tensor(resize._torch_nearest_index(10, 15))
    want = x.index_select(-3, ih).index_select(-2, iw)
    for _ in range(2):
        assert torch.equal(resize.resize_nearest_nhwc(x, 9, 15), want)


@pytest.mark.parametrize("h4,scale,margin", [(128, 4, 40), (16, 4, 7), (13, 4, 3), (16, 2, 2)])
def test_epilogue_tables_from_the_cache_are_the_plans(empty_cache, h4, scale, margin):
    plan = epilogue.epilogue_plan(h4, scale, margin)
    got = device_constant(epilogue._plan_tables, h4, scale, margin, device=CPU)
    want = (plan.row_loc, plan.row_w, plan.row_tile, plan.col_start, plan.group_base,
            plan.col_w)
    assert len(got) == 6
    for g, w in zip(got, want):
        assert g.dtype == torch.as_tensor(w).dtype and torch.equal(g, torch.as_tensor(w))
    assert device_constant(epilogue._plan_tables, h4, scale, margin, device=CPU) is got


def test_devices_and_dtypes_never_share_an_entry(empty_cache):
    on_cpu = device_constant(resize._pool_matrix, 16, 3, device=CPU)
    on_meta = device_constant(resize._pool_matrix, 16, 3, device=torch.device("meta"))
    assert on_cpu.device.type == "cpu" and on_meta.device.type == "meta"
    assert on_meta.shape == on_cpu.shape
    # a float32 matrix and an int64 index of the same sizes: two entries
    index = device_constant(resize._torch_nearest_index, 16, 3, device=CPU)
    assert on_cpu.dtype == torch.float32 and index.dtype == torch.int64
    assert len(empty_cache) == 3
    assert {k[2] for k in empty_cache} == {"cpu", "meta"}


def test_uploads_are_counted_and_blocked_once(empty_cache):
    rec = {}
    with profiling.recording(rec):
        a = device_constant(resize._bilinear_matrix, 16, 128, device=CPU)
        tables = device_constant(epilogue._plan_tables, 16, 4, 8, device=CPU)
    assert rec["const_uploads"] == 1 + len(tables) and rec["blocked_s"] >= 0
    with profiling.recording(rec):
        assert device_constant(resize._bilinear_matrix, 16, 128, device=CPU) is a
        assert device_constant(epilogue._plan_tables, 16, 4, 8, device=CPU) is tables
    assert rec == {}


def test_an_upload_under_inference_mode_serves_a_backward_later(empty_cache):
    """The zonal path may first meet a geometry in inference mode; the
    cached index must still be saved by a training step's gather."""
    attn = swin.WindowAttention(32, 2, 12)
    attn.reset_parameters(torch.Generator().manual_seed(0))
    with torch.inference_mode():
        attn.position_bias(4)
    attn.position_bias(4).sum().backward()
    assert attn.relative_position_bias_table.grad.abs().sum() > 0


def _swin_upernet(seed: int = 0) -> FlairHubModel:
    cfg = prepare_model_config({
        "model_weights": "", "monotemp_arch": "swin_micro_patch4_window12_384-upernet",
        "modalities": {"inputs": {"AERIAL_RGBI": True}, "AERIAL_RGBI": {"channels": [1, 2, 3]}},
        "tasks": [{"name": TASK, "active": True, "class_names": ["a", "b", "c", "d", "e"]}]})
    return init_weights(FlairHubModel(cfg), torch.Generator().manual_seed(seed)).eval()


def _labels(model, px: int, seed: int = 1) -> torch.Tensor:
    x = torch.randn((2, 3, px, px), generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        return model({"AERIAL_RGBI": x, TASK: torch.zeros(2, 1, px, px)})[0][TASK].argmax(1)


def test_a_second_forward_at_a_geometry_uploads_nothing(empty_cache, monkeypatch):
    model = _swin_upernet()
    for px in (64, 96):  # windows 12, 8, 4, 2 at 64 px; 12, 12, 6, 3 at 96 px
        rec, n0 = {}, len(empty_cache)
        with profiling.recording(rec):
            first = _labels(model, px)
        assert rec["const_uploads"] == len(empty_cache) - n0 > 0
        assert rec["blocked_s"] > 0
        with profiling.recording(rec):
            again = _labels(model, px)
        assert rec.get("const_uploads", 0) == 0 and rec.get("blocked_s", 0) == 0, rec
        assert torch.equal(first, again)
    # labels of the cached forward equal those of one with an empty cache
    monkeypatch.setattr(dev_mod, "_CONSTANTS", {})
    assert torch.equal(_labels(model, 96), again)


def _uncached(make, *sizes, device):
    """``device_constant`` as the forward ran before the cache: a new
    upload at every call."""
    host = make(*sizes)
    if isinstance(host, tuple):
        return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device) for a in host)
    return torch.as_tensor(np.ascontiguousarray(host), device=device)


def _table_grads(remat: bool) -> dict:
    cfg = make_config(arch="swin_micro_patch4_window12_384-upernet", tasks=((TASK, 5),))
    cfg["models"]["monotemp_model"]["remat"] = remat
    cfg["hyperparams"].update(learning_rate=1e-3)
    model = init_weights(FlairHubModel(cfg), torch.Generator().manual_seed(0))
    steps = make_steps(model, cfg, optim.make_optimizer(cfg["hyperparams"],
                                                        list(model.parameters())), "cpu")
    _, grads, _, _ = steps.loss_and_grads(make_batch(cfg, batch=2, size=64, seed=3))
    names = [n for n, _ in model.named_parameters()]
    return {n: g for n, g in zip(names, grads) if n.endswith("relative_position_bias_table")}


@pytest.mark.parametrize("remat", [False, True])
def test_training_gradients_reach_the_tables_as_before(empty_cache, monkeypatch, remat):
    cached = _table_grads(remat)
    cached_again = _table_grads(remat)
    monkeypatch.setattr(swin, "device_constant", _uncached)
    monkeypatch.setattr(resize, "device_constant", _uncached)
    fresh = _table_grads(remat)
    assert len(cached) == 4  # swin_micro: one block a stage, windows 12, 8, 4, 2
    for n, g in cached.items():
        assert g is not None and g.abs().max() > 0, n
        assert torch.equal(g, fresh[n]), n
        assert torch.equal(g, cached_again[n]), n
