"""K1 plain version (flair_for_aigle_tpu_torch.ops.prep) vs the Pallas
prologue kernel in interpret mode, on the same numpy inputs.

Tolerances: float32 within 1e-5 (same math, summation order may differ);
bfloat16 within one bf16 unit in the last place of the reference value, or
1e-5 absolute near zero (the float32 LN differs by that much before the
rounding, which at |v| ~ 1e-6 is many bf16 ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.ops.pallas import prep as jprep
from flair_for_aigle_tpu_torch.ops import prep


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    a = np.abs(v.astype(np.float64))
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.maximum(a, 1e-30))) - 7), 2.0 ** -133)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw,ss", [(24, 0), (24, 6), (20, 0), (20, 6)])
def test_prep_plain_matches_pallas(hw, ss, dtype):
    b, c, ws = 2, 128, 12
    rng = np.random.default_rng(hw * 10 + ss)
    x = rng.normal(size=(b, hw, hw, c)).astype(np.float32)
    s = (rng.normal(size=(c,)) * 0.1 + 1).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)

    want = jprep.fused_ln_shift_partition(
        jnp.asarray(x.copy()).astype(dtype), jnp.asarray(s.copy()),
        jnp.asarray(bias.copy()), ws=ws, ss=ss, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = prep.fused_ln_shift_partition(
        torch.from_numpy(x.copy()).to(tdt), torch.from_numpy(s.copy()),
        torch.from_numpy(bias.copy()), ws=ws, ss=ss)
    assert got.dtype == tdt
    got = got.float().numpy()
    hp = hw + (ws - hw % ws) % ws
    assert got.shape == want.shape == (b * (hp // ws) ** 2, ws * ws, c)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= np.maximum(_bf16_ulp(want), 1e-5))


def test_window_partition_roundtrip():
    x = torch.arange(2 * 24 * 36 * 3, dtype=torch.float32).reshape(2, 24, 36, 3)
    win = prep.window_partition(x, 12)
    assert win.shape == (2 * 2 * 3, 144, 3)
    assert torch.equal(prep.window_reverse(win, 12, 24, 36), x)


@pytest.mark.parametrize("hw,ss", [(24, 0), (20, 6)])
def test_prep_gradient_matches_jax_vjp(hw, ss):
    """Autograd through the port's op (its backward recomputes through the
    plain version) vs ``jax.vjp`` of the Pallas op, float32, 1e-4."""
    import jax

    b, c, ws = 2, 128, 12
    rng = np.random.default_rng(hw + ss)
    x = rng.normal(size=(b, hw, hw, c)).astype(np.float32)
    s = (rng.normal(size=(c,)) * 0.1 + 1).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    hp = hw + (ws - hw % ws) % ws
    g = rng.normal(size=(b * (hp // ws) ** 2, ws * ws, c)).astype(np.float32)
    _, pullback = jax.vjp(
        lambda *a: jprep.fused_ln_shift_partition(*a, ws=ws, ss=ss, interpret=True),
        *(jnp.asarray(v.copy()) for v in (x, s, bias)))
    want = [np.asarray(v) for v in pullback(jnp.asarray(g.copy()))]
    leaves = [torch.from_numpy(v.copy()).requires_grad_() for v in (x, s, bias)]
    prep.fused_ln_shift_partition(*leaves, ws=ws, ss=ss).backward(torch.from_numpy(g))
    for name, t, e in zip(["dx", "dscale", "dbias"], leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), e, rtol=1e-4, atol=1e-4, err_msg=name)


# swin widths (96 and 128 times powers of two up to 1024) and small ones
PLAN_WIDTHS = [32, 96, 128, 192, 256, 384, 512, 768, 1024]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", PLAN_WIDTHS)
def test_prep_plan_covers_every_channel_once(c, dtype):
    """The kernel's group of g lanes, lane l owning the 16-byte vectors l,
    l + g, ... below C / VEC: every channel of a token lies in exactly one
    lane's slice; groups tile a warp; a lane holds at most 32 values of a
    token; the launch bounds promise 4 blocks per SM where a lane holds at
    most 8 values of a token, 2 up to 16, 3 beyond (one token's registers
    a lane, scale and bias in shared memory)."""
    vec = prep.prep_vec(dtype)
    g, v = prep.prep_group(c, dtype)
    assert 32 % g == 0 and (v == 1 or g == 32) and v * vec <= 32
    seen = np.zeros(c, dtype=int)
    for lane in range(g):
        for k in range(v):
            j = lane + g * k
            if j < c // vec:
                seen[j * vec:(j + 1) * vec] += 1
    assert (seen == 1).all()
    assert prep.prep_min_blocks(v, dtype) == (4 if v * vec <= 8 else 2 if v * vec <= 16 else 3)


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 100), (torch.bfloat16, 36),
                                     (torch.float32, 102), (torch.float32, 1028),
                                     (torch.bfloat16, 2048)])
def test_prep_plan_rejects_widths_the_kernel_does_not_take(dtype, c):
    """C must be whole 16-byte vectors (a multiple of 8 in bf16, 4 in
    float32) and at most 1024."""
    with pytest.raises(ValueError):
        prep.prep_group(c, dtype)
    with pytest.raises(ValueError):
        prep.prep_plan(c, dtype, 132, 1000)


def _kernel_walk(b, h, w, ws, ss, plan):
    """The positions ``csrc/prep.cu prep_kernel`` visits, group by group,
    with the same seek and advance steps: {output token: source token
    (b, row, column) or None for a padded one}, and how often each output
    token was written."""
    hp, wp = h + (ws - h % ws) % ws, w + (ws - w % ws) % ws
    nwh, nww = hp // ws, wp // ws
    n_pos = b * hp * wp
    groups = plan.blocks * (plan.threads // plan.g)
    got, writes = {}, {}

    def seek(q):
        row, cc = divmod(q, wp)
        bb, r = divmod(row, hp)
        return dict(b=bb, r=r, c=cc, wr=r // ws, tr=r % ws, wc=cc // ws, tc=cc % ws,
                    sr=(r + ss) % h, sc=(cc + ss) % w)

    for group in range(groups):
        u = group
        p = u * plan.run
        if p >= n_pos:
            continue
        s = seek(p)
        left = min(plan.run, n_pos - p)
        while True:
            tok = ((s["b"] * nwh + s["wr"]) * nww + s["wc"]) * ws * ws + s["tr"] * ws + s["tc"]
            pad = s["r"] >= h or s["c"] >= w
            got[tok] = None if pad else (s["b"], s["sr"], s["sc"])
            writes[tok] = writes.get(tok, 0) + 1
            left -= 1
            if left == 0:
                u += groups
                p = u * plan.run
                if p >= n_pos:
                    break
                s = seek(p)
                left = min(plan.run, n_pos - p)
                continue
            s["c"] += 1
            if s["c"] == wp:
                s = seek((s["b"] * hp + s["r"] + 1) * wp)
                continue
            s["tc"] += 1
            if s["tc"] == ws:
                s["tc"], s["wc"] = 0, s["wc"] + 1
            s["sc"] += 1
            if s["sc"] == w:
                s["sc"] = 0
    return got, writes


@pytest.mark.parametrize("b,h,w,ws,ss", [(3, 20, 28, 12, 6), (2, 24, 24, 12, 6),
                                         (1, 8, 8, 8, 0), (3, 6, 6, 4, 2), (2, 7, 5, 4, 3)])
@pytest.mark.parametrize("run,blocks", [(1, 3), (5, 1), (16, 2), (3, 100)])
def test_prep_kernel_walk_writes_every_window_token_once(b, h, w, ws, ss, run, blocks):
    """The kernel's walk over the padded raster (units of ``run``
    positions, a group's units ``groups`` apart, the window and source
    indices advanced by increments across window and raster rows and
    images) writes each output token once, from the source token the
    plain version's roll, pad and partition put there."""
    plan = prep.PrepPlan(g=16, v=1, run=run, threads=prep.PREP_THREADS, blocks=blocks)
    got, writes = _kernel_walk(b, h, w, ws, ss, plan)
    hp, wp = h + (ws - h % ws) % ws, w + (ws - w % ws) % ws
    # the plain version's map: token ids through roll, pad and partition
    ids = torch.arange(b * h * w, dtype=torch.float64).reshape(b, h, w, 1) + 1
    y = torch.roll(ids, (-ss, -ss), dims=(1, 2)) if ss else ids
    y = torch.nn.functional.pad(y, (0, 0, 0, wp - w, 0, hp - h))
    want = prep.window_partition(y, ws).reshape(-1).long().tolist()
    assert sorted(writes) == list(range(len(want))) and set(writes.values()) == {1}
    for tok, src in got.items():
        expect = want[tok] - 1
        assert (src is None) == (expect < 0), tok
        if src is not None:
            assert (src[0] * h + src[1]) * w + src[2] == expect, tok


def test_prep_plan_fills_the_card_at_the_stage_sizes():
    """At swin-base's four stages at the zonal batch (16, bf16), the
    training batch (5, float32) and batch 2: the grid is at most one wave
    of the blocks the launch bounds promise on 132 SMs; a full wave gives
    every group a unit, ``PREP_UNITS_PER_GROUP`` of them unless a unit is
    already ``PREP_MAX_RUN`` long; a smaller grid has no block without a
    unit."""
    for batch, dtype in ((16, torch.bfloat16), (5, torch.float32), (2, torch.bfloat16)):
        for hw, c in [(128, 128), (64, 256), (32, 512), (16, 1024)]:
            hp = hw + (12 - hw % 12) % 12
            n_pos = batch * hp * hp
            plan = prep.prep_plan(c, dtype, 132, n_pos)
            wave = 132 * prep.prep_min_blocks(plan.v, dtype)
            per_block = plan.threads // plan.g
            units = -(-n_pos // plan.run)
            assert 1 <= plan.run <= prep.PREP_MAX_RUN and 1 <= plan.blocks <= wave
            if plan.blocks == wave:
                assert units >= plan.blocks * per_block
                assert (units >= prep.PREP_UNITS_PER_GROUP * plan.blocks * per_block
                        or plan.run == 1 or plan.run == prep.PREP_MAX_RUN)
            else:
                assert plan.blocks == -(-units // per_block)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prep_wrapper_allocates_only_the_output(dtype, monkeypatch):
    """The wrapper's launch path (``ops/prep.py _kernel``, here on CPU
    tensors with the library stood in for) allocates the output alone and
    hands the kernel x and the float32 LayerNorm parameters as they are,
    uncopied, with the plan for this card (132 SMs)."""
    from flair_for_aigle_tpu_torch.ops import _build

    calls = []
    lib = type("Lib", (), {"prep_fwd": staticmethod(lambda *a: calls.append(a) or 0)})()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(prep, "n_sm", lambda dev: 132)
    x = torch.randn(2, 20, 28, 96).to(dtype)
    s, b = torch.ones(96), torch.zeros(96)
    made = []
    empty = torch.empty

    def spy(*a, **k):
        t = empty(*a, **k)
        made.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", spy)
    out = prep._kernel(x, s, b, 12, 6, 1e-5)
    assert made == [(2 * 2 * 3, 144, 96)] and out.shape == (12, 144, 96)
    (args,) = calls
    assert args[:3] == (x.data_ptr(), s.data_ptr(), b.data_ptr())
    plan = prep.prep_plan(96, dtype, 132, 2 * 24 * 36)
    assert args[11:15] == (plan.g, plan.v, plan.run, plan.blocks)
