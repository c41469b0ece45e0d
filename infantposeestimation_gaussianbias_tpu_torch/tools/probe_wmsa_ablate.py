"""In-kernel phase ablation of a W-MSA forward body on the card (K8).

    python -m infantposeestimation_gaussianbias_tpu_torch.tools.probe_wmsa_ablate

Port of infantposeestimation_gaussianbias_tpu/tools/probe_wmsa_ablate.py.
The variants (kernels/window_msa_ablate.py) stream the same bf16
(nW, N, 3C) qkv through the same grid and differ only in the body; the
first four are K1's own kernel with phases compiled out:

  empty    staging only: q, k, v into shared memory, out = q;
  gemmonly the two products, no bias and no softmax;
  softonly the softmax on a broadcast score tile, no products;
  full     K1 itself;
  packslim G windows stacked into G*N rows: all (G*N)^2 scores, the masked
           packed bias, softmax, PV.

So staging is about ``empty``, the products about ``gemmonly - empty`` and
the softmax about ``softonly - empty``.  They run in the order of the
TPU probe's ``main()``: ``empty`` and ``full`` at every windows-per-block
value of the sweep, then ``gemmonly`` and ``softonly`` at ``PROBE_GB``,
then ``packslim`` (which the TPU probe defines but does not run) at G
windows per block, on the bias packed once before it is timed.

Env: PROBE_SHAPE "nW,N,C,H" (default 8960,49,32,1: hrformer_small
branch 0 at 128 crops), PROBE_GB, the windows per block of ``gemmonly``
and ``softonly`` and the first of the sweep (default 1; the sweep adds
2, 4 and 8 where the block fits the card's shared memory, as every value
does since a block stages one window at a time).  Inputs from
``numpy.random.RandomState(0)``: qkv bf16, bias float32.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..kernels import window_msa_ablate as ablate
from ..models.pose_estimator import resolve_device

DEFAULT_SHAPE = "8960,49,32,1"


def chained_time(fn: Callable[[], object], device: torch.device,
                 k: int = 64, K0: int = 8, repeats: int = 5) -> float:
    """Seconds per call of ``fn`` by the probe's difference method: the
    median time of K0 + k back-to-back calls minus that of K0 calls,
    divided by k, which takes the fixed cost out.  On the card the calls
    are captured once in a CUDA graph and the graph's replays are timed
    with CUDA events, so the host's cost per launch (the TPU probe's
    ``fori_loop`` ran on the device too) stays out of the time; on the CPU
    the host clock times the calls themselves."""
    if device.type == "cuda":
        fn()  # opts the kernel in to its shared memory outside the capture
        torch.cuda.synchronize(device)

    def timed(n: int) -> float:
        if device.type == "cuda":
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(n):
                    fn()
            run = graph.replay
        else:
            def run():
                for _ in range(n):
                    fn()
        run()
        ts = []
        for _ in range(repeats):
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                run()
                ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    return (timed(K0 + k) - timed(K0)) / k


def make_inputs(nW: int, N: int, C: int, H: int, device) -> tuple:
    """The probe's inputs: qkv (nW, N, 3C) bf16 and bias (H, N, N) float32
    from ``numpy.random.RandomState(0)``, on ``device``."""
    rng = np.random.RandomState(0)
    qkv = torch.from_numpy(rng.randn(nW, N, 3 * C).astype(np.float32))
    bias = torch.from_numpy(rng.randn(H, N, N).astype(np.float32))
    return qkv.to(torch.bfloat16).to(device), bias.to(device)


def plan(nW: int, N: int, C: int, H: int, gb: int,
         fits: Callable[..., bool]) -> List[tuple]:
    """(variant, windows per block) in the probe's order, skipping what
    ``fits(variant, N, hd, windows_per_block, pack)`` refuses: on the card
    ``window_msa_ablate.fits``, a block's shared memory; the plain
    versions on the CPU have no such limit."""
    hd = C // H
    G = ablate.pack_factor(H, C, N)
    runs = []
    for wpb in dict.fromkeys((gb, *ablate.WINDOWS_PER_BLOCK)):
        for variant in ("empty", "full"):
            if fits(variant, N, hd, wpb):
                runs.append((variant, wpb))
    runs += [("gemmonly", gb), ("softonly", gb)]
    if G <= ablate.MAX_PACK and fits("packslim", N, hd, G, G):
        runs.append(("packslim", G))
    return runs


def run_variant(variant: str, qkv: torch.Tensor, bias: torch.Tensor, H: int,
                wpb: int) -> float:
    """Seconds per launch of one variant (its plain version on the CPU);
    prints one line.  packslim's bias is packed here, before the timing,
    as the TPU probe's ``run_variant`` packs it."""
    if variant == "packslim":
        _, N, C3 = qkv.shape
        bias = ablate.packed_bias(bias, ablate.pack_factor(H, C3 // 3, N))
    sec = chained_time(
        lambda: ablate.window_attention_ablate(variant, qkv, bias, H, wpb),
        qkv.device)
    print(f"{variant:10s} GB={wpb:3d} {sec * 1e3:8.3f} ms", flush=True)
    return sec


def main(argv: Optional[List[str]] = None, device="cuda") -> List[dict]:
    """Run the ablation at PROBE_SHAPE and PROBE_GB; returns one dict per
    (variant, windows per block) with its ms.  ``argv``: the command-line
    arguments, which take only ``--help`` (none if None);
    ``device="cpu"`` times the plain versions (for tests)."""
    argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="Env: PROBE_SHAPE=nW,N,C,H (default "
               f"{DEFAULT_SHAPE}), PROBE_GB (default 1).").parse_args(
        [] if argv is None else argv)
    nW, N, C, H = (int(v) for v in os.environ.get(
        "PROBE_SHAPE", DEFAULT_SHAPE).split(","))
    gb = int(os.environ.get("PROBE_GB", "1"))
    dev = resolve_device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions)")
    print(f"device={name} shape nW={nW} N={N} C={C} H={H}", flush=True)
    qkv, bias = make_inputs(nW, N, C, H, dev)
    rows = []
    fits = ablate.fits if dev.type == "cuda" else lambda *_: True
    for variant, wpb in plan(nW, N, C, H, gb, fits):
        sec = run_variant(variant, qkv, bias, H, wpb)
        rows.append(dict(variant=variant, windows_per_block=wpb,
                         ms=sec * 1e3, nW=nW, N=N, C=C, H=H))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
