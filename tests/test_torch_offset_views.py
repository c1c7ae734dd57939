"""Views off a 16-byte boundary, on the CPU. The port's kernels read and
write 16 bytes at a time, so every wrapper passes each tensor it hands a
kernel through ``_build.aligned``: a view whose data starts off a 16-byte
boundary (which ``.contiguous()`` returns unchanged) becomes a fresh copy,
and anything else passes untouched. The wrappers then compute on such a
view what the reference and the plain versions compute, where the card
would otherwise fault with a misaligned address. Here each wrapper takes
its plain version (the card tests in tests/test_torch_kernels_cuda.py run
the same cases through the kernels)."""

import pytest
import torch

from flair_for_aigle_tpu_torch.ops import _build
from _offset_views import WRAPPERS, offset_view, outputs, wrapper_case


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aligned_copies_exactly_the_views_off_a_16_byte_boundary(dtype):
    buf = torch.randn(400).to(dtype)
    assert buf.data_ptr() % 16 == 0
    per16 = 16 // buf.element_size()
    for off in range(2 * per16 + 1):
        view = buf[off:off + 120].view(5, 24)
        got = _build.aligned(view)
        if off % per16 == 0:
            assert got is view  # on a boundary: untouched, no copy
        else:
            assert got.data_ptr() % 16 == 0 and got.is_contiguous()
            assert got.data_ptr() != view.data_ptr() and got.dtype == dtype
            assert torch.equal(got, view)
    fresh = torch.empty((3, 7), dtype=dtype)
    assert _build.aligned(fresh) is fresh


@pytest.mark.parametrize("case", ["aligned_f32", "bf16_copy", "offset_view", "requires_grad"])
def test_param_is_the_wrappers_one_parameter_path(case):
    """``_build.param``, which every wrapper hands its parameters through:
    a parameter already in place comes back as itself; any other request
    makes the aligned contiguous copy the kernel reads, equal to the
    parameter converted, detached from autograd."""
    cpu = torch.device("cpu")
    w = torch.randn((24, 40), generator=torch.Generator().manual_seed(0))
    assert w.data_ptr() % 16 == 0
    if case == "aligned_f32":
        assert _build.param(w, cpu, torch.float32) is w
    elif case == "bf16_copy":
        got = _build.param(w, cpu, torch.bfloat16)
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        assert got.data_ptr() % 16 == 0 and torch.equal(got, w.to(torch.bfloat16))
    elif case == "offset_view":
        view = w.reshape(-1)[1:961]  # 4 bytes off a 16-byte boundary
        assert view.data_ptr() % 16 == 4
        got = _build.param(view, cpu, torch.float32)
        assert got.data_ptr() % 16 == 0 and got.is_contiguous()
        assert torch.equal(got, view)
    else:
        p = torch.nn.Parameter(w.clone())
        kept = _build.param(p, cpu, torch.float32)
        assert kept is p and torch.equal(kept, w)
        got = _build.param(p, cpu, torch.bfloat16)
        assert not got.requires_grad and got.grad_fn is None
        assert torch.equal(got, w.to(torch.bfloat16))


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_on_offset_views_computes_the_plain_version(name):
    """Every tensor argument of the wrapper a view off a 16-byte boundary:
    the result is the plain version's on fresh tensors, bit for bit, and no
    kernel launched (CPU tensors take the plain version)."""
    fn, ref, args, kw = wrapper_case(name, torch.float32, "cpu")
    want = outputs(ref(*args, **kw))
    fn.launches = 0
    got = outputs(fn(*(offset_view(a) for a in args), **kw))
    assert fn.launches == 0
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
