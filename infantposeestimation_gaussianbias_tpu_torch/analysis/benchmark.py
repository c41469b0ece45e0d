"""Inference benchmark harness.

Port of infantposeestimation_gaussianbias_tpu/analysis/benchmark.py:
``measure_inference_time`` (warm-up, then N timed calls, each ended by a
device synchronise: the reference protocol of
nn_quantitative_viz.py:600-659), ``benchmark_pipeline`` (host data
throughput), ``profile_trace`` (``torch.profiler`` in place of XProf) and
``benchmark_model`` (the port's model, eval forward).  A call whose output
lies on the card ends in ``torch.cuda.synchronize``, the counterpart of
``block_until_ready``; on the CPU the host clock alone.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


def _cuda_devices(out, found: Optional[set] = None) -> set:
    """The CUDA devices of every tensor in a (nested) output."""
    found = set() if found is None else found
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


def block_until_ready(out):
    """Wait for the card to finish the work that produced ``out``; return
    it."""
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)
    return out


def measure_inference_time(fn: Callable, *args, warmup: int = 10,
                           runs: int = 100) -> Dict[str, float]:
    """Warm up, then time ``runs`` calls of fn; mean/std/median/min/max in
    ms, each call ended by a device synchronise."""
    block_until_ready(fn(*args))
    for _ in range(warmup):
        block_until_ready(fn(*args))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    t = np.asarray(times)
    return {
        "mean_ms": float(t.mean()),
        "std_ms": float(t.std()),
        "median_ms": float(np.median(t)),
        "min_ms": float(t.min()),
        "max_ms": float(t.max()),
        "runs": runs,
    }


def benchmark_pipeline(sample_fn: Callable[[int], object],
                       iterations: int = 100) -> Dict[str, float]:
    """Host data-pipeline throughput: ms/sample and samples/s (reference
    data/test_transforms.py:382-431)."""
    sample_fn(0)  # warm caches
    t0 = time.perf_counter()
    for i in range(iterations):
        sample_fn(i)
    dt = time.perf_counter() - t0
    return {
        "ms_per_sample": dt / iterations * 1e3,
        "samples_per_sec": iterations / dt,
        "iterations": iterations,
    }


def profile_trace(fn: Callable, *args, trace_dir: Optional[str] = None,
                  iters: int = 3) -> str:
    """Profile ``iters`` calls of fn with ``torch.profiler`` (CPU, and the
    card when the output lies there) after one call outside the trace;
    write a Chrome trace, ``trace.json``, into ``trace_dir`` (a new
    temporary directory if None) and return the directory."""
    out = block_until_ready(fn(*args))
    activities = [torch.profiler.ProfilerActivity.CPU]
    if _cuda_devices(out):
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    if trace_dir is None:
        trace_dir = tempfile.mkdtemp(prefix="ipe_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(iters):
            out = fn(*args)
        block_until_ready(out)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return trace_dir


def benchmark_model(cfg, batch_size: int = 64, warmup: int = 10,
                    runs: int = 100, device="cuda") -> Dict[str, float]:
    """Build the config's model (seeded weights, eval mode) on ``device``
    and time its forward on zero images under ``torch.no_grad``."""
    from ..models import build_model

    model = build_model(cfg, device=device)
    W, H = cfg.data.input_size
    x = torch.zeros((batch_size, H, W, 3), dtype=torch.float32,
                    device=next(model.parameters()).device)

    def fwd(v):
        with torch.no_grad():
            return model(v)

    stats = measure_inference_time(fwd, x, warmup=warmup, runs=runs)
    stats["images_per_sec"] = batch_size / (stats["median_ms"] / 1e3)
    stats["batch_size"] = batch_size
    stats["device"] = (torch.cuda.get_device_name(x.device)
                       if x.is_cuda else str(x.device))
    return stats
