"""ctypes loader for the native geo library (native/libflairgeo.so).

Builds on demand with make if the shared object is missing (the repo ships
sources, not binaries). All higher-level geo modules route through here.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libflairgeo.so"))

_lock = threading.Lock()
_lib = None


def _build() -> None:
    subprocess.run(
        ["make", "-C", os.path.abspath(_NATIVE_DIR)],
        check=True,
        capture_output=True,
    )


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            _build()
        lib = ctypes.CDLL(_LIB_PATH)

        lib.gt_open.restype = ctypes.c_void_p
        lib.gt_open.argtypes = [ctypes.c_char_p]
        lib.gt_close.argtypes = [ctypes.c_void_p]
        lib.gt_info.restype = ctypes.c_int
        lib.gt_info.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.gt_read_window.restype = ctypes.c_int
        lib.gt_read_window.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_double,
        ]
        lib.gt_write.restype = ctypes.c_int
        lib.gt_write.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int32,
        ]
        lib.jp2_write.restype = ctypes.c_int
        lib.jp2_write.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        lib.plg_polygonize.restype = ctypes.c_int64
        lib.plg_polygonize.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint8,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ]
        lib.plg_histogram.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
        ]
        lib.fl_unpack5_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
        ]
        _lib = lib
        return _lib
