"""Build the package's CUDA sources into one shared library, at first use.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for
Hopper (``sm_90a``), all started together, and the objects are linked into
one shared library with a plain C interface, which the kernel wrappers
load with ``ctypes``.  No PyTorch headers are included, so a build takes
seconds.  The library goes into ``_build/`` inside the package (listed in
``.gitignore``), named by a hash of the sources (``*.cu`` and ``*.cuh``)
and the compiler flags: a changed source builds anew, an unchanged one is
loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIB: Optional[ctypes.CDLL] = None
# Seconds the last build took (0.0 when the library was already built) and
# what nvcc printed, register and shared-memory use included.
BUILD_SECONDS = 0.0
BUILD_LOG = ""


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libipe_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> str:
    """Run the commands side by side; return their output, or raise with
    it if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return log


def build() -> Path:
    """Compile the sources unless a library for them exists; return its
    path.  Raises with nvcc's output if the compiler fails."""
    global BUILD_SECONDS, BUILD_LOG
    out = library_path()
    if out.is_file():
        BUILD_SECONDS = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile and link under private names and rename, so a concurrent
    # process never loads a half-written library.
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = find_nvcc()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    t0 = time.perf_counter()
    try:
        BUILD_LOG = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                          for src, obj in zip(sources(), objs)])
        BUILD_LOG += _run([[nvcc, "-shared", "-o", str(tmp),
                            *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        BUILD_SECONDS = time.perf_counter() - t0
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its C interface."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ipe_window_msa_fwd.argtypes = [p, p, p] + [i] * 6 + [
            ctypes.c_float, i, i, p]
        lib.ipe_window_msa_fwd.restype = i
        lib.ipe_window_msa_hm_fwd.argtypes = [p] * 5 + [i] * 4 + [
            ctypes.c_float, i, i, p]
        lib.ipe_window_msa_hm_fwd.restype = i
        lib.ipe_window_msa_ablate.argtypes = [i, p, p, p, i, i, i, i,
                                              ctypes.c_float, i, i, p]
        lib.ipe_window_msa_ablate.restype = i
        lib.ipe_window_msa_ablate_fits.argtypes = [i] * 5
        lib.ipe_window_msa_ablate_fits.restype = i
        lib.ipe_window_msa_bwd.argtypes = [p] * 6 + [i] * 6 + [
            ctypes.c_float, i, i, p]
        lib.ipe_window_msa_bwd.restype = i
        f = ctypes.c_float
        lib.ipe_fused_mlp_fwd.argtypes = [p] * 12 + [i] * 14 + [p]
        lib.ipe_fused_mlp_fwd.restype = i
        lib.ipe_fused_mlp_bwd.argtypes = [p] * 22 + [i] * 15 + [p]
        lib.ipe_fused_mlp_bwd.restype = i
        lib.ipe_fused_attn_fwd.argtypes = [p] * 13 + [i] * 10 + [f, i, p]
        lib.ipe_fused_attn_fwd.restype = i
        lib.ipe_fused_attn_bwd.argtypes = ([p] * 24 + [i] * 7 + [f]
                                           + [i] * 4 + [p])
        lib.ipe_fused_attn_bwd.restype = i
        lib.ipe_residual_chain.argtypes = [p] * 9 + [i] * 12 + [p]
        lib.ipe_residual_chain.restype = i
        lib.ipe_conv3x3_wgrad.argtypes = [p] * 4 + [i] * 10 + [p]
        lib.ipe_conv3x3_wgrad.restype = i
        # K9 and K10, and their variants with one phase compiled in, take
        # one packed struct (kernels/quant.py)
        for kind in ("qconv", "qdense"):
            for suffix in ("", "_stage_only", "_products_only",
                           "_epilogue_only"):
                entry = getattr(lib, f"ipe_{kind}{suffix}")
                entry.argtypes = [ctypes.c_char_p]
                entry.restype = i
        lib.ipe_cuda_error_string.argtypes = [i]
        lib.ipe_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def on_card(x, kernel: str) -> bool:
    """Whether a kernel wrapper launches its kernel for tensor ``x``: True
    on a CUDA device, False on the CPU (the wrapper takes its plain
    PyTorch version); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"no {kernel} kernel for device {x.device}")
    return True


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.ipe_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
