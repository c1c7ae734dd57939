"""5-bit label packing for the canvas D2H (PyTorch port).

Port of ``flair_for_aigle_tpu/ops/pack.py``. Zonal argmax canvases are
uint8 class ids (< 32 classes for every FLAIR nomenclature); packing 8
pixels into 5 bytes cuts the device-to-host bytes of each canvas stripe by
1.6x.

The device packs with torch ops (``pack_labels5``; the JAX version is jnp
outside any Pallas kernel, so neither package has a kernel here); the host
unpacks with the repository's native loop (``native/pack.cc``
``fl_unpack5_rows``), built alone with ``g++`` on first use into a
source-hash-keyed folder under ``build/``, or with vectorised numpy where no
compiler is found. Byte order is explicit (no bitcasts), so the pair
round-trips on any backend and the packed bytes equal the JAX package's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_SOURCE = os.path.join(_REPO, "native", "pack.cc")
BUILD_DIR = os.path.join(_REPO, "build", "native_pack")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]


def packed_width(w: int) -> int:
    """Packed byte count for a row of ``w`` pixels (next multiple of 8)."""
    return -(-w // 8) * 5


def pack_labels5(x: torch.Tensor) -> torch.Tensor:
    """(C, H, W) uint8 labels < 32, W % 8 == 0 -> (C, H, W//8*5) uint8.

    Bytes 0-3 hold the little-endian 32-bit word of pixels 0-5 (5 bits
    each) and pixel 6's low 2 bits (bits 30-31); byte 4 holds pixel 6's high
    3 bits and pixel 7. The word is built in int64, so bit 31 never meets a
    sign, and cut into bytes with shifts and masks."""
    c, h, w = x.shape
    g = x.reshape(c, h, w // 8, 8).to(torch.int64)
    lo = (g[..., 0] | (g[..., 1] << 5) | (g[..., 2] << 10)
          | (g[..., 3] << 15) | (g[..., 4] << 20) | (g[..., 5] << 25)
          | ((g[..., 6] & 3) << 30))
    hi = (g[..., 6] >> 2) | (g[..., 7] << 3)
    parts = [(lo >> (8 * i)) & 255 for i in range(4)] + [hi & 255]
    return torch.stack(parts, dim=-1).to(torch.uint8).reshape(c, h, w // 8 * 5)


def unpack_labels5(p: np.ndarray, w: int) -> np.ndarray:
    """(C, H, W8//8*5) packed -> (C, H, w) uint8 labels."""
    c, h, _ = p.shape
    out = np.empty((c, h, w), np.uint8)
    unpack_labels5_into(p, out)
    return out


def unpack_labels5_into(p: np.ndarray, dst: np.ndarray) -> str:
    """Unpack (C, H, PW) 5-bit rows straight into a (C, h, w) uint8 view.

    ``dst`` may be a strided row-slice of the output canvas (rows must be
    contiguous); the native loop writes it in place, skipping the
    full-width intermediate the numpy route allocates (0.05 s against 0.7 s
    per km² canvas on one core, ``native/pack.cc``). Returns the route that
    ran: ``"native"`` or ``"numpy"``."""
    c, h, pw = p.shape
    cd, hd, w = dst.shape
    assert c == cd and h == hd and pw // 5 * 8 >= w
    lib = native_library()
    if lib is not None and p.flags.c_contiguous and dst.strides[2] == 1:
        row_stride = dst.strides[1]
        for ci in range(c):
            lib.fl_unpack5_rows(p[ci].ctypes.data, dst[ci].ctypes.data, h, pw, w,
                                row_stride)
        return "native"
    g = p.reshape(c, h, pw // 5, 5).astype(np.uint32)
    lo = g[..., 0] | (g[..., 1] << 8) | (g[..., 2] << 16) | (g[..., 3] << 24)
    hi = g[..., 4]
    px = np.empty((c, h, pw // 5, 8), np.uint8)
    for i in range(6):
        px[..., i] = (lo >> (5 * i)) & 31
    px[..., 6] = ((lo >> 30) & 3) | ((hi & 7) << 2)
    px[..., 7] = (hi >> 3) & 31
    dst[...] = px.reshape(c, h, -1)[:, :, :w]
    return "numpy"


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def library_path() -> str:
    """Where the library built from the current ``native/pack.cc`` and
    flags lives: ``build/native_pack/libflairpack_<hash>.so``."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(NATIVE_SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libflairpack_{h.hexdigest()[:16]}.so")


def build_native() -> str:
    """Compile ``native/pack.cc`` alone (it needs no library) into
    ``library_path()`` unless it is there; returns the path. Raises where
    no C++ compiler is found or the compile fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ / c++) to build native/pack.cc")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, NATIVE_SOURCE, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{cxx} failed on native/pack.cc:\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def native_library() -> ctypes.CDLL | None:
    """The loaded unpack library (built on first call), or None where it
    cannot be built or loaded: the numpy route runs then."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                so = ctypes.CDLL(build_native())
                fn = so.fl_unpack5_rows
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_size_t] * 4
                fn.restype = None
                _lib = so
            except (OSError, RuntimeError):
                _lib = None
        return _lib
