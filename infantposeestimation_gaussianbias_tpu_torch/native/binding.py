"""ctypes binding and build at first use of the native image decoder.

``ipe_loader.cpp`` is compiled with the system g++ against libjpeg (and
libpng where it links) into the port's git-ignored ``_build/`` directory,
named by a hash of the source, so a source change rebuilds.  Where g++ or
libjpeg is missing, ``load()`` returns None and callers fall back to cv2,
as in the JAX package's native loader.  ``IPE_NATIVE_LOADER=0`` turns it
off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "ipe_loader.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD, f"ipe_loader_{tag}.so")


def _build(path: str) -> bool:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    base = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", _SRC]
    # libpng is optional: without it PNG falls back to cv2
    for extra in (["-ljpeg", "-lpng", "-DIPE_HAVE_PNG"], ["-ljpeg"]):
        try:
            subprocess.run(base + extra + ["-o", tmp], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, path)  # atomic: concurrent builders race fine
        return True
    try:
        os.unlink(tmp)
    except OSError:
        pass
    return False


def load() -> Optional[ctypes.CDLL]:
    """The native library, built if needed; None where unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("IPE_NATIVE_LOADER", "").lower() in ("0", "off"):
            return None
        try:
            path = _lib_path()
            if not os.path.exists(path) and not _build(path):
                return None
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.ipe_has_png.restype = ctypes.c_int
        lib.ipe_image_dims.restype = ctypes.c_int
        lib.ipe_image_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.ipe_decode_rgb.restype = ctypes.c_int
        lib.ipe_decode_rgb.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def has_png() -> bool:
    """True when the build linked libpng (PNG decode supported)."""
    lib = load()
    return lib is not None and bool(lib.ipe_has_png())


def _lib_or_raise() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    return lib


def image_dims(data: bytes) -> Tuple[int, int]:
    """(width, height) from the JPEG/PNG header only."""
    lib = _lib_or_raise()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.ipe_image_dims(data, len(data), ctypes.byref(w), ctypes.byref(h)):
        raise ValueError("not a decodable JPEG/PNG")
    return w.value, h.value


def decode_rgb(data: bytes) -> np.ndarray:
    """Full JPEG/PNG decode to an (H, W, 3) uint8 RGB array (a PNG's alpha
    dropped, as cv2's IMREAD_COLOR does)."""
    lib = _lib_or_raise()
    w, h = image_dims(data)
    out = np.empty((h, w, 3), np.uint8)
    if lib.ipe_decode_rgb(data, len(data), out.ctypes.data):
        raise ValueError("JPEG/PNG decode failed")
    return out
