"""Phase ablation of K1 on the card: where one call's device time goes.

    python -m infantposeestimation_gaussianbias_tpu_torch.tools.ablate_k1

Copies this package into ``_build/k1_ablation/`` (git-ignored) with K1's
kernel (csrc/window_msa_fwd.cuh) patched to read a mode from the
environment variable ``IPE_K1_ABLATE`` at each launch, builds the copy's
kernels and times K1 in each mode:

  full        the kernel as it is;
  no-core     the staging copies and the conversion, no core, no output;
  core-only   the first window staged once, then the core on it for each
              window of the block (no copies, no conversion after it);
  copies-only the staging copies and their waits (no conversion, no core);
  empty       the loop, its barriers and the first window's staging.

So the copies cost about ``copies-only - empty``, the conversion
``no-core - copies-only`` and the core ``core-only - empty``; their sum
against ``full`` says how much of them overlaps.  Each mode's time is the
device time of one call (torch.profiler over ``RUNS`` calls), bf16, at
hrformer_base b0, b3 and b0 at window 8, b = 32 (the training batch and a
served pass), with the kernel's own grid plan (``window_msa.fwd_plan``);
the full mode's output is checked equal to the package's own K1 first.
Prints one line per (shape, mode) and a JSON line of them all.  Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import sys
from pathlib import Path

import torch

MODES = {"full": 0, "no-core": 1, "core-only": 2, "empty": 3,
         "copies-only": 1 | 4}
# (label, windows per image, N, heads, head dim): hrformer_base's b0 and
# b3 at window 7, b0 at window 8
SHAPES = [("base b0", 70, 49, 2, 39), ("base b3", 2, 49, 16, 39),
          ("base b0 ws8", 48, 64, 2, 39)]
BATCH = 32
RUNS = 7
ENV = "IPE_K1_ABLATE"
PACKAGE = Path(__file__).resolve().parent.parent

# The kernel's source, and (text of it, its replacement): the mode read at
# launch, passed to the kernel, and tested around the loop's phases.
SOURCE = "csrc/window_msa_fwd.cuh"
_PATCHES = [
    ("#include <cstdint>\n", "#include <cstdint>\n#include <cstdlib>\n"),
    ("                      T* __restrict__ out, int nW, int N, int C, int hd, float scale,\n"
     "                      int wpb) {",
     "                      T* __restrict__ out, int nW, int N, int C, int hd, float scale,\n"
     "                      int wpb, int mode) {"),
    ("    wstage::cp_async_wait_all();\n"
     "    __syncthreads();  // window w staged (the first time: the bias and the zeros too)\n"
     "    tiles(w, src);\n"
     "    wstage::convert<T, NI>(src, stage, opnd, N, hd, ld, term);\n"
     "    __syncthreads();  // the stage is free, the operands written\n"
     "    if (w + 1 < w_end) {  // in flight while this window computes\n",
     "    const bool again = !(mode & 2) || w == w_begin;\n"
     "    if (again) wstage::cp_async_wait_all();\n"
     "    __syncthreads();\n"
     "    tiles(w, src);\n"
     "    if (again && !(mode & 4)) wstage::convert<T, NI>(src, stage, opnd, N, hd, ld, term);\n"
     "    __syncthreads();\n"
     "    if (w + 1 < w_end && !(mode & 2)) {\n"),
    ("    } else if (warp < (N + 15) / 16) {",
     "    } else if (!(mode & 1) && warp < (N + 15) / 16) {"),
    ("      a, b, c, bias, out, nW, N, C, hd, scale, wpb);",
     "      a, b, c, bias, out, nW, N, C, hd, scale, wpb,\n"
     "      getenv(\"" + ENV + "\") ? atoi(getenv(\"" + ENV + "\")) : 0);"),
]


def patched_copy(root: Path) -> Path:
    """This package copied under ``root`` with K1's kernel patched; returns
    the directory to put first on ``sys.path``.  Raises if the kernel's
    text no longer holds a patched line.  K8's phases (csrc/
    window_msa_ablate.cu) instantiate the same kernel, so the copy's K8
    takes the mode too; only K1 is timed."""
    shutil.rmtree(root, ignore_errors=True)
    dst = root / PACKAGE.name
    shutil.copytree(PACKAGE, dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = dst / SOURCE
    text = src.read_text()
    for old, new in _PATCHES:
        if text.count(old) != 1:
            raise RuntimeError(f"{SOURCE} no longer holds {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return root


def device_ms(fn) -> float:
    """Device time of one call of ``fn``: every CUDA kernel's time under
    one torch.profiler over RUNS calls, divided by RUNS."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(RUNS):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / RUNS


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_k1 needs a CUDA card")
    own = importlib.import_module(PACKAGE.name + ".kernels.window_msa")
    root = patched_copy(PACKAGE / "_build" / "k1_ablation")
    for name in [m for m in sys.modules if m.split(".")[0] == PACKAGE.name]:
        del sys.modules[name]  # import the copy under the package's name
    sys.path.insert(0, str(root))
    wm = importlib.import_module(PACKAGE.name + ".kernels.window_msa")
    assert Path(wm.__file__).is_relative_to(root), wm.__file__
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, w, N, H, hd in SHAPES:
        nW = BATCH * w
        qkv = torch.randn(nW, N, 3 * H * hd, device="cuda", generator=g,
                          dtype=torch.bfloat16)
        bias = torch.randn(H, N, N, device="cuda", generator=g)
        os.environ[ENV] = "0"
        assert torch.equal(wm.window_attention_qkv(qkv, bias, H),
                           own.window_attention_qkv(qkv, bias, H)), label
        for mode, code in MODES.items():
            os.environ[ENV] = str(code)
            ms = device_ms(lambda: wm.window_attention_qkv(qkv, bias, H))
            rows.append(dict(shape=label, nW=nW, mode=mode, device_ms=ms))
            print(f"[k1-ablation] {label} nW={nW} bf16 {mode}: {ms:.4f} ms "
                  f"device", flush=True)
    os.environ.pop(ENV)
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
