"""ctypes loader for the native IQ deframer (builds on first use).

Falls back by raising ImportError so callers (io.capture) can use the NumPy
path when no C++ toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(__file__)
_SRC = os.path.join(_DIR, "native_src", "deframe.cpp")
# built from the tracked source into the checkout's build/ (gitignored)
_BUILD = os.path.join(_DIR, "..", "..", "build")
_SO = os.path.join(_BUILD, "libdeframe.so")

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-o", _SO, _SRC]
        try:
            os.makedirs(_BUILD, exist_ok=True)
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except Exception as e:  # no toolchain / compile error -> fallback
            raise ImportError(f"native deframe build failed: {e}") from e
    lib = ctypes.CDLL(_SO)
    lib.sc16_to_fc32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    lib.fc32_to_sc16.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    lib.block_power.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.block_power.restype = ctypes.c_double
    _lib = lib
    return lib


def deframe_sc16(raw: bytes) -> np.ndarray:
    """Interleaved int16 IQ bytes -> complex64 array (native convert)."""
    lib = _load()
    n = len(raw) // 4
    inbuf = np.frombuffer(raw, dtype=np.int16, count=2 * n)
    out = np.empty(2 * n, dtype=np.float32)
    lib.sc16_to_fc32(inbuf.ctypes.data, out.ctypes.data, n)
    return out.view(np.complex64)


def frame_sc16(samples: np.ndarray) -> bytes:
    """complex64 array -> interleaved int16 IQ bytes (native convert)."""
    lib = _load()
    n = len(samples)
    inbuf = np.ascontiguousarray(samples, dtype=np.complex64).view(np.float32)
    out = np.empty(2 * n, dtype=np.int16)
    lib.fc32_to_sc16(inbuf.ctypes.data, out.ctypes.data, n)
    return out.tobytes()


def block_power(samples: np.ndarray) -> float:
    """Mean |x|^2 of a complex64 block (native reduction; AGC feed)."""
    lib = _load()
    buf = np.ascontiguousarray(samples, dtype=np.complex64).view(np.float32)
    return float(lib.block_power(buf.ctypes.data, len(samples)))
