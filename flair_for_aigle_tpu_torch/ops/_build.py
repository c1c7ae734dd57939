"""Build and bind the CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects into one shared library
with a plain C interface, loaded through ctypes. The library lands in
``build/torch_kernels/`` at the repository root, keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
loaded as it is. Nothing here runs at import time: the first wrapper that
launches a kernel on a CUDA tensor triggers the build.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` raises on anything but 0, so a refused launch (too many threads,
too much shared memory) never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: name -> argtypes (all return int = cudaError_t)
_SIGNATURES = {
    # x, scale, bias, out, b, h, w, c, ws, ss, eps, g, v, run, blocks,
    # dtype, stream
    "prep_fwd": [_P] * 4 + [_I] * 6 + [_F] + [_I] * 5 + [_P],
    # dtype, g, v, out (int[4]: registers, local bytes, shared bytes,
    # blocks per SM)
    "prep_info": [_I] * 3 + [_P],
    # x, wqkv, bqkv, wproj, bproj, bias, qkv, o, out,
    # bnw, t, c, nh, ws, ss, nwh, nww, attn_f32, tile_qkv, tile_proj, dtype,
    # stream
    "window_attn_fwd": [_P] * 9 + [_I] * 12 + [_P],
    # dtype, tile, out (int[4]: registers, local bytes, shared bytes,
    # blocks per SM)
    "window_attn_gemm_info": [_I] * 2 + [_P],
    # qkv, bias, o, bnw, t, c, nh, ws, ss, nwh, nww, attn_f32, dtype, stream
    "window_attn_core": [_P] * 3 + [_I] * 10 + [_P],
    # t, attn_f32, dtype, out (int[4]: registers, local bytes, shared
    # bytes, blocks per SM)
    "window_attn_core_info": [_I] * 3 + [_P],
    # x, attn, ln_scale, ln_bias, w1, b1, w2, b2, ln, h, part, out,
    # n, c, hidden, tile1, tile2, k_chunk2, nz2, eps, dtype, stream
    "ffn_fwd": [_P] * 12 + [_I] * 7 + [_F, _I, _P],
    # dtype, tile, epilogue, out (int[4]: registers, local bytes, shared
    # bytes, blocks per SM)
    "ffn_gemm_info": [_I] * 3 + [_P],
    # logits, row_loc, row_w, row_tile, col_start, group_base, col_w, out,
    # b, k, h4, w4, inner, tr, gt, nc, nr, col_tiles, row_tiles, p,
    # class_prob, dtype, stream
    "epilogue_fwd": [_P] * 8 + [_I] * 14 + [_P],
    # dtype, p, class_prob, k, tr, nc, nr, out (int[4]: registers, local
    # bytes, shared bytes, blocks per SM)
    "epilogue_info": [_I] * 7 + [_P],
    # x, ln_scale, ln_bias, w_red, part, out, b, h, w, c, out_c, tile,
    # k_chunk, nz, eps, dtype, stream
    "merge_fwd": [_P] * 6 + [_I] * 8 + [_F, _I, _P],
    # dtype, tile, split, out (int[4]: registers, local bytes, shared
    # bytes, blocks per SM)
    "merge_info": [_I] * 3 + [_P],
    # x, g, wqkv, bqkv, wqkv_t, wproj_t, bias, qkv, do, o, dqkv, dbias_part,
    # dbqkv_part, wpart, dx, dwqkv, dbqkv, dwproj, dbproj, dbias,
    # bnw, t, c, nh, ws, ss, nwh, nww, attn_f32, n_groups, tile_qkv,
    # tile_proj, tile_w, k_chunk_proj, k_chunk_qkv, dtype, stream
    "window_attn_bwd": [_P] * 20 + [_I] * 16 + [_P],
    # a, w, out, part, m, n, k, k_chunk, tile, wgrad, dtype, stream
    "window_attn_bwd_gemm": [_P] * 4 + [_I] * 7 + [_P],
    # dtype, tile, wgrad, out (int[4]: registers, local bytes, shared
    # bytes, blocks per SM)
    "window_attn_bwd_gemm_info": [_I] * 3 + [_P],
    # qkv, do, bias, o, dqkv, dbias_part, dbqkv_part, dbias, dbqkv,
    # bnw, t, c, nh, ws, ss, nwh, nww, attn_f32, n_groups, dtype, stream
    "window_attn_bwd_core": [_P] * 9 + [_I] * 11 + [_P],
    # t, attn_f32, dtype, out (int[5]: registers, local bytes, shared
    # bytes, blocks per SM, warps per SM)
    "window_attn_bwd_core_info": [_I] * 3 + [_P],
    # win, x, ln_scale, ln_bias, w1, b1, w2, b2, ln, a, h, part, out,
    # b, h, w, c, hidden, ws, ss, g, v, tile1, tile2, k_chunk2, nz2, eps,
    # dtype, stream
    "finish_fwd": [_P] * 13 + [_I] * 13 + [_F, _I, _P],
    # dtype, g, v, out (int[4]: registers, local bytes, shared bytes, blocks
    # per SM)
    "finish_info": [_I] * 3 + [_P],
    # x, attn, g, ln_scale, ln_bias, w1, b1, w1t, w2t, ln, h0, h, dh0c,
    # db1_part, part, dln, row_part, dx, dvec, dw1, db1, dw2,
    # n, c, hidden, tile_h, tile_w, k_chunk_w2, k_chunk_w1, tile_dln,
    # k_chunk_dln, rows, eps, dtype, stream
    "ffn_bwd": [_P] * 22 + [_I] * 10 + [_F, _I, _P],
    # dtype, tile, product (0 fc1, 1 dh, 2 weight gradients, 3 dln), out
    # (int[4]: registers, local bytes, shared bytes, blocks per SM)
    "ffn_bwd_gemm_info": [_I] * 3 + [_P],
    # q, k, v, out, bnw, t, c, nh, bw, stream
    "attn_dots_per_head": [_P] * 4 + [_I] * 5 + [_P],
    "attn_dots_grouped": [_P] * 4 + [_I] * 5 + [_P],
    # grouped, out (int[4]: registers, local bytes, shared bytes, blocks
    # per SM)
    "attn_dots_info": [_I, _P],
}

_lock = threading.Lock()
_lib = None
#: seconds the last nvcc build in this process took (0.0: none ran)
LAST_BUILD_SECONDS = 0.0


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of flair_for_aigle_tpu_torch build only where the CUDA "
            "toolkit is installed")
    return found


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libflair_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands as concurrent processes; raise with the output of
    the first that fails, after every one has ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")


def build() -> str:
    """Compile the kernels if no library for the current sources exists;
    returns the library path."""
    global LAST_BUILD_SECONDS
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{path}.{os.getpid()}"
    nvcc = _nvcc()
    cus = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{tag}.{os.path.basename(cu)}.o" for cu in cus]
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", cu, "-o", obj]
                  for cu, obj in zip(cus, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tag}.tmp", *objs]])
        os.replace(f"{tag}.tmp", path)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    LAST_BUILD_SECONDS = time.perf_counter() - t0
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = so
        return _lib


def aligned(t):
    """t itself where its data starts on a 16-byte boundary, else a fresh
    contiguous copy (which does). The kernels read and write their tensors
    16 bytes at a time (``cp.async`` copies, ``uint4`` / ``float4`` loads and
    stores); a view at an offset into a larger buffer, which
    ``.contiguous()`` returns unchanged, would fault on the card as a
    misaligned address. Fresh allocations pass through untouched."""
    import torch

    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)


def param(p, device, dtype):
    """A kernel's view of a parameter: ``p`` itself where it already lies
    on ``device`` in ``dtype``, contiguous and 16-byte aligned (the
    models' parameters, call after call: no copy and no new tensor), else
    an aligned contiguous copy there."""
    if (p.device == device and p.dtype == dtype and p.is_contiguous()
            and p.data_ptr() % 16 == 0):
        return p
    return aligned(p.detach().to(device, dtype).contiguous())


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {rc}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t) -> int:
    import torch

    return {torch.float32: 0, torch.bfloat16: 1}[t.dtype]
