"""ctypes bindings for the native (C++) video IO library.

Wraps native/libvideoio.so — the mmap + prefetch-ring frame loader with
exact fixed-point BGR→gray conversion.  Builds the library on first use
if the shared object is missing (g++ is part of the toolchain).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from btcs_pnes_optical_flow.dataio.video import VideoSource

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvideoio.so")

KIND_RAW_GRAY = 0
KIND_RAW_BGR = 1
KIND_Y4M = 2

_lib = None


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True)
    lib = ctypes.CDLL(_LIB_PATH)
    lib.vio_open.restype = ctypes.c_void_p
    lib.vio_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_double, ctypes.c_int]
    lib.vio_info.restype = ctypes.c_int
    lib.vio_info.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.vio_next.restype = ctypes.c_int
    lib.vio_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.vio_read.restype = ctypes.c_int
    lib.vio_read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
    lib.vio_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeSource(VideoSource):
    """Native mmap+prefetch source for raw .npy stacks and .y4m files."""

    def __init__(self, path: str, fps: Optional[float] = None, prefetch_depth: int = 4):
        lib = load_library()
        if path.endswith(".y4m"):
            kind = KIND_Y4M
        else:
            # Peek at the npy shape to distinguish gray vs BGR stacks.
            arr = np.load(path, mmap_mode="r")
            kind = KIND_RAW_BGR if arr.ndim == 4 else KIND_RAW_GRAY
            del arr
        self._h = lib.vio_open(path.encode(), kind, float(fps or 30.0), prefetch_depth)
        if not self._h:
            raise RuntimeError(f"vio_open failed: {path}")
        self._lib = lib
        t = ctypes.c_int()
        hh = ctypes.c_int()
        ww = ctypes.c_int()
        fr = ctypes.c_double()
        lib.vio_info(self._h, ctypes.byref(t), ctypes.byref(hh), ctypes.byref(ww), ctypes.byref(fr))
        self.n_frames = t.value
        self.height = hh.value
        self.width = ww.value
        self.fps = float(fps) if fps else fr.value

    def frames(self):
        buf = np.empty((self.height, self.width), np.uint8)
        ptr = buf.ctypes.data_as(ctypes.c_char_p)
        while True:
            idx = self._lib.vio_next(self._h, ptr)
            if idx < 0:
                break
            yield buf.copy(), None

    def read(self, idx: int) -> np.ndarray:
        buf = np.empty((self.height, self.width), np.uint8)
        r = self._lib.vio_read(self._h, idx, buf.ctypes.data_as(ctypes.c_char_p))
        if r < 0:
            raise IndexError(idx)
        return buf

    def close(self):
        if getattr(self, "_h", None):
            self._lib.vio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
