"""K5 plain version (flair_for_aigle_tpu_torch.ops.merge) vs the Pallas
patch-merge kernel in interpret mode, its gradient vs ``jax.vjp``, and the
port's PatchMerging module vs the JAX module, on the same numpy inputs.

Tolerances: float32 2e-4 (LayerNorm over 512 channels and a 512-deep
float32 product, summed in another order). bfloat16: one ulp at the
output's largest magnitude (the LN rounds to bf16 before the product, so a
rounding flip there moves an output by that much). Gradients (float32,
both sides recompute through the plain twin): 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.models.swin import PatchMerging as JPatchMerging
from flair_for_aigle_tpu.ops.pallas import merge as jmerge
from flair_for_aigle_tpu_torch.models.checkpoint import state_dict_from_flax
from flair_for_aigle_tpu_torch.models.swin import PatchMerging
from flair_for_aigle_tpu_torch.ops import merge
from tests._torch_threads import few_torch_threads  # noqa: F401


C, OUT = 128, 256


def _inputs(seed=0, shape=(1, 16, 16, C)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    s = (rng.normal(size=(4 * shape[-1],)) * 0.1 + 1).astype(np.float32)
    b = (rng.normal(size=(4 * shape[-1],)) * 0.1).astype(np.float32)
    w = (rng.normal(size=(4 * shape[-1], OUT)) * 0.05).astype(np.float32)  # JAX (in, out)
    return x, s, b, w


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(v), 2.0 ** -20))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_plain_matches_pallas(dtype):
    x, s, b, w = _inputs()
    want = jmerge.fused_patch_merge(jnp.asarray(x.copy()).astype(dtype), jnp.asarray(s.copy()),
                                    jnp.asarray(b.copy()), jnp.asarray(w.copy()),
                                    interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = merge.fused_patch_merge(torch.from_numpy(x.copy()).to(tdt), torch.from_numpy(s.copy()),
                                  torch.from_numpy(b.copy()), torch.from_numpy(w.T.copy()))
    assert got.dtype == tdt and got.shape == want.shape == (1, 8, 8, OUT)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        assert np.abs(got - want).max() <= _bf16_ulp(np.abs(want).max())


def test_merge_gradient_matches_jax_vjp():
    x, s, b, w = _inputs(1)
    g = np.random.default_rng(2).normal(size=(1, 8, 8, OUT)).astype(np.float32)
    _, pullback = jax.vjp(lambda *a: jmerge.fused_patch_merge(*a, interpret=True),
                          *(jnp.asarray(v.copy()) for v in (x, s, b, w)))
    want = [np.asarray(v) for v in pullback(jnp.asarray(g.copy()))]
    leaves = [torch.from_numpy(v.copy()).requires_grad_() for v in (x, s, b, w.T)]
    out = merge.fused_patch_merge(*leaves)
    out.backward(torch.from_numpy(g.copy()))
    got = [t.grad.numpy() for t in leaves]
    got[3] = got[3].T
    for name, a, e in zip(["dx", "dscale", "dbias", "dw"], got, want):
        np.testing.assert_allclose(a, e, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("hw", [16, 15])
def test_patch_merging_module_matches_jax(hw):
    # 15: the odd pad stays outside the fused op, as in the reference
    x = np.random.default_rng(3).normal(size=(2, hw, hw, C)).astype(np.float32)
    jmod = JPatchMerging(OUT, kernel_mode="off")
    variables = jmod.init(jax.random.key(0), jnp.asarray(x.copy()))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x.copy())))
    tmod = PatchMerging(C, OUT)
    tmod.load_state_dict(state_dict_from_flax(variables["params"]), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x.copy())).numpy()
    assert got.shape == want.shape == (2, (hw + 1) // 2, (hw + 1) // 2, OUT)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("c", [96, 128])
def test_merge_kernel_gather_map_matches_the_plain_gather(c):
    """K5's A producer (``csrc/merge.cu MergeA``) copies the 16-byte chunk
    at column k of row m = (b, i, j) from x[b, 2i + (s & 1), 2j + (s >> 1),
    k % C], s = k / C (three compares), at the offset a_row(m) + ((s & 1) W
    + (s >> 1)) C + k - s C: that map, in numpy over chunks of 8, gives the
    plain version's timm-order gather; C % 8 == 0 keeps each chunk inside
    one segment."""
    b, h, w = 2, 6, 10
    x = np.arange(b * h * w * c, dtype=np.int64).reshape(b, h, w, c)
    flat = x.reshape(-1)
    m_rows = b * (h // 2) * (w // 2)
    got = np.empty((m_rows, 4 * c), dtype=np.int64)
    for m in range(m_rows):
        bb, rem = divmod(m, (h // 2) * (w // 2))
        i, j = divmod(rem, w // 2)
        row = ((bb * h + 2 * i) * w + 2 * j) * c
        for k in range(0, 4 * c, 8):
            s = (k >= c) + (k >= 2 * c) + (k >= 3 * c)
            assert (k + 7) // c == s  # the chunk lies in one segment
            at = row + ((s & 1) * w + (s >> 1)) * c + (k - s * c)
            got[m, k:k + 8] = flat[at:at + 8]
    want = merge.patch_gather(torch.from_numpy(x)).reshape(m_rows, 4 * c).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 16, 16, C), (2, 8, 12, 96)])
def test_3xtf32_merge_matches_pallas_and_the_exact_plain_version(shape):
    """On the card K5's float32 reduction runs as 3xTF32 on the tensor
    cores (``csrc/gemm_mma.cuh``) on the LN rows in float32. That scheme,
    emulated on the plain version's LN rows by patching ``torch.matmul``
    with ``tests/_tf32.py``'s ``matmul_3xtf32``, matches the Pallas merge in
    interpret mode within 2e-5 and the exact plain version within 1e-5 of
    the output's largest magnitude."""
    from unittest import mock

    from tests._tf32 import matmul_3xtf32

    x, s, b, w = _inputs(5, shape)
    want = np.asarray(jmerge.fused_patch_merge(
        *(jnp.asarray(v.copy()) for v in (x, s, b, w)), interpret=True))
    port = [torch.from_numpy(v.copy()) for v in (x, s, b, w.T)]
    with mock.patch.object(torch, "matmul", matmul_3xtf32):
        got = merge.fused_patch_merge_reference(*port).numpy()
    exact = merge.fused_patch_merge_reference(*port).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert np.abs(got - exact).max() <= 1e-5 * np.abs(exact).max()
    assert not np.array_equal(got, exact)  # the emulation rounds


class _FakeLib:
    """Stands in for the kernel library: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,split", [((16, 64, 64, 32), False), ((1, 8, 8, 256), True)])
def test_merge_wrapper_allocates_only_the_output(dtype, shape, split, monkeypatch):
    """The wrapper's launch path (``ops/merge.py _kernel``, here on CPU
    tensors with the library stood in for) allocates the output, and the
    float32 partials only where the plan cuts K, and no (M, 4C) buffer of
    LN rows; it hands the kernel x, the float32 LayerNorm parameters and
    the weight in x's dtype as they are, uncopied."""
    from flair_for_aigle_tpu_torch.ops import _build

    fake = _FakeLib()
    monkeypatch.setattr(_build, "lib", lambda: fake)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(merge, "n_sm", lambda dev: 132)
    b, h, w, c = shape
    x = torch.randn(shape).to(dtype)
    s, bias = torch.ones(4 * c), torch.zeros(4 * c)
    wr = torch.randn(2 * c, 4 * c).to(dtype)
    made = []
    empty = torch.empty

    def spy(*a, **k):
        t = empty(*a, **k)
        made.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", spy)
    out = merge._kernel(x, s, bias, wr, 1e-5)
    m = b * (h // 2) * (w // 2)
    name, args = fake.calls[-1]
    assert name == "merge_fwd"
    assert args[:4] == (x.data_ptr(), s.data_ptr(), bias.data_ptr(), wr.data_ptr())
    nz = args[13]
    assert (nz > 1) == split
    assert sorted(made) == sorted([(b, h // 2, w // 2, 2 * c)] + [(nz, m, 2 * c)] * (nz > 1))
    assert out.shape == (b, h // 2, w // 2, 2 * c)
