#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for this port).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  0. device: refuse to run without CUDA; print the card's name and power
     limit (nvidia-smi), torch and CUDA versions;
  1. build every kernel from csrc/ (kernels/build.py) and time the build;
  2. K1 (CUDA W-MSA) against its plain PyTorch version on the card, at
     every hrformer_base branch shape at batch 64 (32 crops x flip), at
     hrformer_small's branch 0, at window 8 and without bias; float32
     (TF32 off) at atol 1e-4, bf16 at atol/rtol 2e-2; median times;
  3. the slice: PoseInference(hrformer_base) with seeded weights serves
     batches of 1, 3 and 8 uint8 frames; K1 must launch 88 times per
     flip-tested batch; then float32 on the card against the port on the
     CPU (plain path), same weights and frames;
  4. throughput: bf16 predict_batch at 32 crops per batch.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

F32_ATOL = 1e-4           # exact float32 maths, summation order differs
BF16_TOL = 2e-2           # a few bf16 ulps on the output cast
KEYPOINT_ATOL_PX = 1e-2   # float32 card vs CPU, frame pixels
HEATMAP_ATOL = 1e-4
# W-MSA calls per hrformer_base forward: (1*2 + 4*3 + 2*4) branches x 2 blocks
K1_CALLS_PER_FORWARD = 44


def log(*args) -> None:
    print(*args, flush=True)


def cuda_median_ms(fn, warmup: int = 3, runs: int = 25) -> float:
    """Median of per-call CUDA-event times."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def near_half_integer(coords: np.ndarray, tol: float = 1e-3) -> np.ndarray:
    """(B, K) mask of soft-argmax coordinates within tol of a half-integer,
    where round() sits on a tie and the local-refine window may move."""
    return (np.abs(coords % 1.0 - 0.5) < tol).any(axis=-1)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN")
    return smi


def phase_build() -> None:
    from infantposeestimation_gaussianbias_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load()
    log(f"[build] {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.BUILD_SECONDS:.2f} s)")
    for line in build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log("[build]", line.strip())


def phase_k1() -> dict:
    from infantposeestimation_gaussianbias_tpu_torch.kernels import window_msa

    # (label, nW, N, H, hd, bias)
    B = 64
    shapes = [
        ("base b0", B * 70, 49, 2, 39, True),
        ("base b1", B * 20, 49, 4, 39, True),
        ("base b2", B * 6, 49, 8, 39, True),
        ("base b3", B * 2, 49, 16, 39, True),
        ("small b0", B * 70, 49, 1, 32, True),
        ("base b0 ws8", B * 48, 64, 2, 39, True),
        ("base b0 no-bias", B * 70, 49, 2, 39, False),
    ]
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    record = None
    for label, nW, N, H, hd, with_bias in shapes:
        qkv32 = torch.randn(nW, N, 3 * H * hd, device="cuda", generator=g)
        bias = (torch.randn(H, N, N, device="cuda", generator=g)
                if with_bias else None)
        for dt in (torch.float32, torch.bfloat16):
            qkv = qkv32.to(dt)
            out = window_msa.window_attention_qkv(qkv, bias, H)
            torch.cuda.synchronize()
            ref = window_msa.window_attention_qkv_reference(qkv, bias, H)
            err = (out.float() - ref.float()).abs().max().item()
            if dt == torch.float32:
                torch.testing.assert_close(out, ref, atol=F32_ATOL, rtol=0)
            else:
                torch.testing.assert_close(out.float(), ref.float(),
                                           atol=BF16_TOL, rtol=BF16_TOL)
            worst = max(worst, err)
            ms = cuda_median_ms(
                lambda: window_msa.window_attention_qkv(qkv, bias, H))
            plain_ms = cuda_median_ms(
                lambda: window_msa.window_attention_qkv_reference(qkv, bias,
                                                                  H))
            name = "f32" if dt == torch.float32 else "bf16"
            log(f"[k1] {label:16s} nW={nW:5d} N={N} H={H:2d} hd={hd} "
                f"{name:4s} "
                f"max_abs_err={err:.3e} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f}")
            if label == "base b0" and dt == torch.bfloat16:
                record = dict(ms=ms, plain_ms=plain_ms,
                              shape=f"nW={nW},N={N},H={H},hd={hd},bf16")
    record["max_abs_err"] = worst
    return record


def make_requests(n: int, seed: int):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, 480, 640, 3)).astype(np.uint8)
    x0 = rng.uniform(0, 300, n)
    y0 = rng.uniform(0, 200, n)
    w = rng.uniform(120, 640 - x0)
    h = rng.uniform(160, 480 - y0)
    bboxes = np.stack([x0, y0, x0 + w, y0 + h], 1).astype(np.float32)
    return frames, bboxes


def phase_slice() -> tuple:
    from infantposeestimation_gaussianbias_tpu_torch import (PoseInference,
                                                              get_variant)
    from infantposeestimation_gaussianbias_tpu_torch.kernels import window_msa
    from infantposeestimation_gaussianbias_tpu_torch.ops import affine, decode

    cfg = get_variant("hrformer_base")
    assert cfg.model.compute_dtype == "bfloat16" and cfg.eval.flip_test
    inf = PoseInference(cfg, device="cuda")
    frames, bboxes = make_requests(8, seed=1)

    window_msa.LAUNCHES = 0
    for n in (1, 3, 8):
        before = window_msa.LAUNCHES
        t0 = time.perf_counter()
        kpts, scores = inf.predict_batch(frames[:n], bboxes[:n])
        dt = time.perf_counter() - t0
        grew = window_msa.LAUNCHES - before
        log(f"[slice] bf16 batch {n}: {dt * 1e3:.1f} ms, K1 launches {grew}")
        assert kpts.shape == (n, 17, 2) and scores.shape == (n, 17)
        assert np.isfinite(kpts).all() and np.isfinite(scores).all()
        assert grew == 2 * K1_CALLS_PER_FORWARD, grew
    launches = window_msa.LAUNCHES

    # float32 on the card against the port's plain path on the CPU
    cfg32 = get_variant("hrformer_base")
    cfg32.model.compute_dtype = "float32"
    sd = inf.model.state_dict()
    gpu = PoseInference(cfg32, state_dict=sd, device="cuda")
    cpu = PoseInference(cfg32, state_dict={k: v.cpu() for k, v in sd.items()},
                        device="cpu")
    n = 3
    k_gpu, s_gpu = gpu.predict_batch(frames[:n], bboxes[:n])
    k_cpu, s_cpu = cpu.predict_batch(frames[:n], bboxes[:n])
    centers = (bboxes[:n, :2] + bboxes[:n, 2:]) / 2
    scales = (bboxes[:n, 2:] - bboxes[:n, :2]) * cfg32.data.bbox_padding
    hms = {}
    for name, p in (("cuda", gpu), ("cpu", cpu)):
        with torch.inference_mode():
            crops = affine.crop_and_normalize(
                torch.from_numpy(frames[:n]).to(p.device),
                torch.from_numpy(centers).to(p.device),
                torch.from_numpy(scales).to(p.device), cfg32.data.input_size)
            hm = p.model(crops)["heatmaps"]
            hm_f = decode.flip_heatmaps(
                p.model(torch.flip(crops, [2]))["heatmaps"], p._flip_index)
            g, _ = decode.soft_argmax((hm + hm_f) * 0.5)
        hms[name] = (hm.cpu(), g.cpu().numpy())
    hm_err = (hms["cuda"][0] - hms["cpu"][0]).abs().max().item()
    log(f"[slice] f32 heatmaps card vs CPU: max_abs_err={hm_err:.3e} "
        f"(|hm| max {hms['cpu'][0].abs().max().item():.3e})")
    assert hm_err <= HEATMAP_ATOL, hm_err
    keep = ~(near_half_integer(hms["cuda"][1])
             | near_half_integer(hms["cpu"][1]))
    kp_err = float(np.abs(k_gpu - k_cpu)[keep].max())
    log(f"[slice] f32 keypoints card vs CPU: max_abs_err={kp_err:.3e} px, "
        f"left out {int((~keep).sum())} of {keep.size} near a half-integer "
        f"soft-argmax; scores max_abs_err="
        f"{float(np.abs(s_gpu - s_cpu).max()):.3e}")
    assert keep.any()
    assert kp_err <= KEYPOINT_ATOL_PX, kp_err
    return inf, launches


def phase_throughput(inf, smi: str) -> dict:
    frames, bboxes = make_requests(32, seed=2)
    for _ in range(3):
        inf.predict_batch(frames, bboxes)
    times = []
    for _ in range(12):
        t0 = time.perf_counter()
        kpts, _ = inf.predict_batch(frames, bboxes)
        times.append(time.perf_counter() - t0)
        assert np.isfinite(kpts).all()
    b1 = []
    for _ in range(10):
        t0 = time.perf_counter()
        inf.predict_batch(frames[:1], bboxes[:1])
        b1.append(time.perf_counter() - t0)
    med = float(np.median(times))
    result = dict(crops_per_s=32 / med, batch32_ms=med * 1e3,
                  batch1_ms=float(np.median(b1[2:])) * 1e3, card=smi)
    log(f"[throughput] bf16 predict_batch b=32 flip: "
        f"{result['crops_per_s']:.1f} crops/s (median {med * 1e3:.1f} ms over "
        f"{len(times)} batches); b=1: {result['batch1_ms']:.1f} ms; on {smi}")
    return result


def main() -> int:
    smi = phase_device()
    phase_build()
    k1 = phase_k1()
    inf, launches = phase_slice()
    thr = phase_throughput(inf, smi)
    assert not any(m.split(".")[0] in ("jax", "flax")
                   for m, v in sys.modules.items() if v is not None)
    log(json.dumps({"slice": thr}))
    log(json.dumps({"kernels": [{
        "name": "window_msa_fwd",
        "route": "cuda",
        "source": "infantposeestimation_gaussianbias_tpu_torch/csrc/"
                  "window_msa.cu",
        "replaces": "infantposeestimation_gaussianbias_tpu/ops/pallas/"
                    "window_msa.py:222",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "shape": k1["shape"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
