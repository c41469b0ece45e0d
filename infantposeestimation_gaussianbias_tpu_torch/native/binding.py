"""ctypes binding and build at first use of the native image loader.

Port of infantposeestimation_gaussianbias_tpu/native/binding.py.
``ipe_loader.cpp`` is compiled with the system g++ against libjpeg (and
libpng where it links) into the port's git-ignored ``_build/`` directory,
named by a hash of the source, so a source change rebuilds.  Where g++ or
libjpeg is missing, ``load()`` returns None: the serving entry points then
decode with cv2, and the training loader does so under
``data.native_loader="auto"`` and raises under ``"on"``.
``IPE_NATIVE_LOADER=0`` turns it off.

Where the system has no libjpeg to link (no ``-ljpeg``, no headers), the
build links the libjpeg-turbo that Pillow's wheel ships (the 62 ABI, as
the system libjpeg-turbo of Debian and Ubuntu) against the 62-ABI headers
kept in ``include/`` (libjpeg-turbo's, with their copyright file).  Both
are libjpeg-turbo: the same decoder and IDCT, so the same crops.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "ipe_loader.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_INCLUDE = os.path.join(_DIR, "include")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD, f"ipe_loader_{tag}.so")


def pillow_libjpeg() -> Optional[str]:
    """The libjpeg-turbo shared library of Pillow's wheel (62 ABI), or
    None."""
    try:
        import PIL
    except ImportError:
        return None
    found = sorted(glob.glob(os.path.join(
        os.path.dirname(PIL.__file__), os.pardir, "pillow.libs",
        "libjpeg-*.so.62*")))
    return os.path.realpath(found[0]) if found else None


def link_options() -> list:
    """g++ options to try, in order: the system libjpeg with libpng, and
    without it (PNG then decodes through cv2); then Pillow's
    libjpeg-turbo with the headers of ``include/``."""
    options = [["-ljpeg", "-lpng", "-DIPE_HAVE_PNG"], ["-ljpeg"]]
    lib = pillow_libjpeg()
    if lib is not None:
        options.append(["-I", _INCLUDE, lib,
                        f"-Wl,-rpath,{os.path.dirname(lib)}"])
    return options


def _build(path: str, options: Optional[list] = None) -> bool:
    """Compile the library to ``path`` with the first of ``options`` (by
    default ``link_options()``) that builds; False if none does."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    base = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
            _SRC]
    for extra in options if options is not None else link_options():
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
        path = _lib_path()
        if os.path.exists(path):
            try:
                _lib = open_library(path)
                return _lib
            except OSError:
                pass  # linked on another machine, its libjpeg not here
        if not _build(path):
            return None
        try:
            _lib = open_library(path)
        except OSError:
            return None
        return _lib


def open_library(path: str) -> ctypes.CDLL:
    """Load a build of ``ipe_loader.cpp`` with every entry declared."""
    lib = ctypes.CDLL(path)
    lib.ipe_has_png.restype = ctypes.c_int
    lib.ipe_image_dims.restype = ctypes.c_int
    lib.ipe_image_dims.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.ipe_decode_rgb.restype = ctypes.c_int
    lib.ipe_decode_rgb.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p]
    lib.ipe_decode_warp_batch.restype = ctypes.c_int
    lib.ipe_decode_warp_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int]
    return lib


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


def decode_warp_batch(jpegs: Sequence[bytes], mats: np.ndarray,
                      out_size: Tuple[int, int], nthreads: int = 0,
                      fast: bool = False) -> np.ndarray:
    """Fused decode + warp: N JPEG/PNG byte strings and N forward 2x3
    affines (source image -> crop, data/transforms.py's convention) ->
    (N, H, W, 3) uint8 RGB crops, on ``nthreads`` threads (0: one per
    core).  ``out_size`` is (width, height), as ``data.input_size``.
    ``fast``: DCT-scaled decode (training augmentation only; another
    low-pass resample).  A failed sample raises ValueError naming the
    first one."""
    lib = _lib_or_raise()
    n = len(jpegs)
    out_w, out_h = int(out_size[0]), int(out_size[1])
    mats = np.ascontiguousarray(mats, np.float32)
    if mats.shape != (n, 2, 3):
        raise ValueError(f"mats must be (n, 2, 3), got {mats.shape}")
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    if n == 0:
        return out
    bufs = (ctypes.c_char_p * n)(*jpegs)  # kept alive through the call
    lens = (ctypes.c_long * n)(*[len(b) for b in jpegs])
    statuses = (ctypes.c_int * n)()
    failed = lib.ipe_decode_warp_batch(
        bufs, lens, mats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, out_w, out_h, out.ctypes.data, statuses, int(nthreads),
        int(bool(fast)))
    if failed:
        bad = [i for i in range(n) if statuses[i] != 0]
        raise ValueError(
            f"native decode+warp failed for {failed} sample(s), first at "
            f"index {bad[0]} (status {statuses[bad[0]]})")
    return out


def decode_warp(jpeg: bytes, mat: np.ndarray, out_size: Tuple[int, int],
                fast: bool = False) -> np.ndarray:
    """One sample's decode + warp -> (H, W, 3) uint8 crop."""
    return decode_warp_batch([jpeg], np.asarray(mat, np.float32)[None],
                             out_size, nthreads=1, fast=fast)[0]
