"""Batched image loading for the device input pipeline.

Uses the native C++ loader (native/loader.cpp: multithreaded libjpeg decode
+ bilinear resize straight into the batch buffer) when it builds; falls
back to PIL otherwise. The library is built from native/ at first use into
build/ at the checkout root (listed in .gitignore). The batch buffer is
reused across calls so steady-state feeding does no Python-side allocation.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
_NATIVE_DIR = _ROOT / "native"
_SO = _ROOT / "build" / "_loader.so"


def _load_native():
    if not _SO.exists() and (_NATIVE_DIR / "loader.cpp").exists():
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)], check=True,
                capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            return None
    if not _SO.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    lib.i2s_decode_batch.restype = ctypes.c_int
    lib.i2s_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    return lib


_LIB = None
_LIB_TRIED = False


def native_available() -> bool:
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB = _load_native()
        _LIB_TRIED = True
    return _LIB is not None


def decode_batch(paths, height: int, width: int, out: np.ndarray | None = None,
                 n_threads: int = 0) -> np.ndarray:
    """Decode+resize a list of JPEG paths into a [B, H, W, 3] uint8 array."""
    n = len(paths)
    if out is None:
        out = np.empty((n, height, width, 3), np.uint8)
    assert out.shape == (n, height, width, 3) and out.dtype == np.uint8

    if native_available():
        arr = (ctypes.c_char_p * n)(*[os.fsencode(str(p)) for p in paths])
        ok = _LIB.i2s_decode_batch(
            arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            height, width, n_threads,
        )
        if ok == n:
            return out
        # fall through to PIL for robustness if any file failed

    from PIL import Image

    for i, p in enumerate(paths):
        img = Image.open(p).convert("RGB").resize((width, height), Image.BILINEAR)
        out[i] = np.asarray(img)
    return out
