"""ctypes bindings for the native C++ I/O runtime (native/lbmio.cpp).

The reference performs all scene parsing and result dumping in native code
(C stdio, SerialCode/d2q9-bgk.c:460-613, 662-743).  This module binds our C++
equivalent — a fast obstacle parser and %.12E-formatted writers — and degrades
gracefully to the pure-Python implementations when the shared library has not
been built (``make native`` at the repo root builds it).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_LIB_NAME = "liblbmio.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_checked = False


def _find_library() -> str | None:
    here = os.path.dirname(os.path.abspath(__file__))
    repo_root = os.path.dirname(os.path.dirname(here))
    candidates = [
        os.environ.get("LBM_TPU_NATIVE_LIB", ""),
        os.path.join(repo_root, "native", "build", _LIB_NAME),
        os.path.join(repo_root, "native", _LIB_NAME),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_checked
    with _lock:
        if _lib_checked:
            return _lib
        _lib_checked = True
        path = _find_library()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
        lib.lbmio_load_obstacles.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, u8p,
        ]
        lib.lbmio_load_obstacles.restype = ctypes.c_int
        lib.lbmio_write_final_state.argtypes = [
            ctypes.c_char_p, f32p, f32p, f32p, f32p, u8p, ctypes.c_int, ctypes.c_int,
        ]
        lib.lbmio_write_final_state.restype = ctypes.c_int
        lib.lbmio_write_av_vels.argtypes = [ctypes.c_char_p, f32p, ctypes.c_long]
        lib.lbmio_write_av_vels.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def load_obstacles(path: str, nx: int, ny: int) -> np.ndarray | None:
    """Native obstacle parse; returns None if the library is unavailable.

    Raises SceneError on malformed input, mirroring the Python parser.
    """
    lib = _load()
    if lib is None:
        return None
    mask = np.zeros((ny, nx), dtype=np.uint8)
    rc = lib.lbmio_load_obstacles(path.encode(), nx, ny, mask)
    if rc != 0:
        from lbm_tpu_torch.io.scene import SceneError

        messages = {
            -1: "could not open input obstacles file",
            -2: "expected 3 values per line in obstacle file",
            -3: "obstacle x-coord out of range",
            -4: "obstacle y-coord out of range",
            -5: "obstacle blocked value should be 1",
        }
        raise SceneError(f"{path}: {messages.get(rc, f'native parser error {rc}')}")
    return mask.astype(bool)


def write_final_state(path, u_x, u_y, u, pressure, obstacles) -> bool:
    lib = _load()
    if lib is None:
        return False
    ny, nx = obstacles.shape
    rc = lib.lbmio_write_final_state(
        path.encode(),
        np.ascontiguousarray(u_x, dtype=np.float32),
        np.ascontiguousarray(u_y, dtype=np.float32),
        np.ascontiguousarray(u, dtype=np.float32),
        np.ascontiguousarray(pressure, dtype=np.float32),
        np.ascontiguousarray(obstacles, dtype=np.uint8),
        ny,
        nx,
    )
    if rc != 0:
        raise OSError(f"native final_state writer failed on {path!r} (rc={rc})")
    return True


def write_av_vels(path, av_vels) -> bool:
    lib = _load()
    if lib is None:
        return False
    av = np.ascontiguousarray(av_vels, dtype=np.float32)
    rc = lib.lbmio_write_av_vels(path.encode(), av, av.shape[0])
    if rc != 0:
        raise OSError(f"native av_vels writer failed on {path!r} (rc={rc})")
    return True
