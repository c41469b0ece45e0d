#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for this port).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  0. device: refuse to run without CUDA; print the card's name and power
     limit (nvidia-smi), torch and CUDA versions;
  1. build every kernel from csrc/ (kernels/build.py) and time the build;
  2. K1 (CUDA W-MSA forward) against its plain PyTorch version on the card,
     at every hrformer_base branch shape at batch 64 (32 crops x flip), at
     hrformer_small's branch 0, at window 8 and without bias; float32
     (TF32 off) at atol 1e-4, bf16 at atol/rtol 2e-2; median kernel,
     plain and SDPA times and the bound;
  3. K2 (CUDA W-MSA backward) against its plain version at every training
     shape at batch 32 (hrformer_base's four branches, hrformer_small's
     branch 0, window 8), float32 and bf16, dqkv and dbias; median kernel,
     plain and SDPA-backward times and the bound;
  4. serving: PoseInference(hrformer_base) with seeded weights serves
     batches of 1, 3 and 8 uint8 frames; K1 must launch 88 times per
     flip-tested batch; then float32 on the card against the port on the
     CPU (plain path), same weights and frames;
  5. throughput: bf16 predict_batch at 32 crops per batch;
  6. training: one float32 step of hrformer_base at b=2 on the card
     against the same step on the CPU (plain path), same weights, batch and
     DropPath masks; then bf16 steps at b=32 on one seeded batch: finite
     terms, K1 and K2 44 launches each per step, a falling loss, step time,
     images/s and peak memory, and a profile of two steps by kernel; then
     one bf16 step with model.remat against one without.
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
import torch.nn.functional as F

F32_ATOL = 1e-4           # exact float32 maths, summation order differs
BF16_TOL = 2e-2           # a few bf16 ulps on the output cast
# K2's dbias is float32 in both dtypes and sums dS over up to 2,240
# windows in another order than the plain version: relative 1e-4.
DBIAS_TOL = 1e-4
KEYPOINT_ATOL_PX = 1e-2   # float32 card vs CPU, frame pixels
HEATMAP_ATOL = 1e-4
# Float32 train step, card vs CPU (TF32 off): the same maths in another
# summation order (cuDNN and cuBLAS against the CPU's kernels) through 44
# transformer blocks and 60 BatchNorms, forward and backward.  A ReLU
# input that the two orders put on either side of 0 flips one mask
# element, which moves the gradients of every layer below it by ~1e-3
# relative (the CPU tests show one such flip against JAX); the loss and
# the forward statistics have no such step.
STEP_LOSS_RTOL = 1e-4     # each loss term and grad_norm, relative
STEP_GRAD_RTOL = 1e-2     # |g_card - g_cpu| / |g_cpu| per RPE table, qkv weight
STEP_STAT_TOL = 1e-4      # BN running mean/var, atol and rtol
# W-MSA calls per hrformer_base forward: (1*2 + 4*3 + 2*4) branches x 2 blocks
K1_CALLS_PER_FORWARD = 44
TRAIN_BATCH = 32
# Least time of a kernel: its bytes (each input read once, each output
# written once) at the H100 SXM's 3.35 TB/s, or its float32 FLOPs at the
# 67 TFLOP/s of the CUDA cores (both kernels do all their maths in
# float32), whichever is longer (NVIDIA's H100 SXM data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# (label, nW, N, H, hd): hrformer_base's branches at 256x192 (windows per
# image 70/20/6/2), hrformer_small's branch 0, hrformer_base branch 0 at
# window 8 (48 windows per image).
BRANCH_SHAPES = [
    ("base b0", 70, 49, 2, 39),
    ("base b1", 20, 49, 4, 39),
    ("base b2", 6, 49, 8, 39),
    ("base b3", 2, 49, 16, 39),
    ("small b0", 70, 49, 1, 32),
    ("base b0 ws8", 48, 64, 2, 39),
]


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for the work of one call."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """(nW, N, H*hd) -> contiguous (nW, H, N, hd)."""
    nW, N, C = t.shape
    return t.reshape(nW, N, H, C // H).permute(0, 2, 1, 3).contiguous()


def phase_k1() -> dict:
    from infantposeestimation_gaussianbias_tpu_torch.kernels import window_msa

    B = 64
    shapes = [(label, B * w, N, H, hd, True)
              for label, w, N, H, hd in BRANCH_SHAPES]
    shapes.append(("base b0 no-bias", B * 70, 49, 2, 39, False))
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
            C = H * hd
            q, k, v = (_heads(qkv[..., i * C:(i + 1) * C], H)
                       for i in range(3))
            mask = None if bias is None else bias.to(dt)[None]
            lib_ms = cuda_median_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask))
            es = qkv.element_size()
            nbytes = nW * N * 4 * C * es + (H * N * N * 4 if with_bias else 0)
            b_ms, b_by = bound_ms(nbytes, 4 * N * N * hd * nW * H)
            name = "f32" if dt == torch.float32 else "bf16"
            log(f"[k1] {label:16s} nW={nW:5d} N={N} H={H:2d} hd={hd} "
                f"{name:4s} max_abs_err={err:.3e} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by})")
            if label == "base b0" and dt == torch.bfloat16:
                record = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by,
                              shape=f"nW={nW},N={N},H={H},hd={hd},bf16")
    record["max_abs_err"] = worst
    return record


def phase_k2() -> dict:
    from infantposeestimation_gaussianbias_tpu_torch.kernels import window_msa

    g = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    record = None
    for label, w, N, H, hd in BRANCH_SHAPES:
        nW, C = TRAIN_BATCH * w, H * hd
        qkv32 = torch.randn(nW, N, 3 * C, device="cuda", generator=g)
        dout32 = torch.randn(nW, N, C, device="cuda", generator=g)
        bias = torch.randn(H, N, N, device="cuda", generator=g)
        for dt in (torch.float32, torch.bfloat16):
            qkv, dout = qkv32.to(dt), dout32.to(dt)
            dqkv, dbias = window_msa.window_attention_qkv_bwd(qkv, bias, dout,
                                                              H)
            torch.cuda.synchronize()
            r_dqkv, r_dbias = window_msa.window_attention_qkv_bwd_reference(
                qkv, bias, dout, H)
            tol = F32_ATOL if dt == torch.float32 else BF16_TOL
            torch.testing.assert_close(dqkv.float(), r_dqkv.float(),
                                       atol=tol, rtol=tol)
            torch.testing.assert_close(dbias, r_dbias, atol=DBIAS_TOL,
                                       rtol=DBIAS_TOL)
            err_q = (dqkv.float() - r_dqkv.float()).abs().max().item()
            err_b = (dbias - r_dbias).abs().max().item()
            worst = max(worst, err_q, err_b)
            ms = cuda_median_ms(lambda: window_msa.window_attention_qkv_bwd(
                qkv, bias, dout, H))
            plain_ms = cuda_median_ms(
                lambda: window_msa.window_attention_qkv_bwd_reference(
                    qkv, bias, dout, H))
            # yardstick: autograd through SDPA with the bias as attn_mask
            q, k, v = (_heads(qkv[..., i * C:(i + 1) * C], H)
                       .requires_grad_() for i in range(3))
            mask = bias.to(dt).clone().requires_grad_()
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask.expand(nW, H, N, N))
            do = _heads(dout, H)
            lib_ms = cuda_median_ms(lambda: torch.autograd.grad(
                out, (q, k, v, mask), do, retain_graph=True))
            del out
            es = qkv.element_size()
            nbytes = nW * N * 7 * C * es + 2 * H * N * N * 4
            b_ms, b_by = bound_ms(nbytes, 10 * N * N * hd * nW * H)
            name = "f32" if dt == torch.float32 else "bf16"
            log(f"[k2] {label:12s} nW={nW:5d} N={N} H={H:2d} hd={hd} "
                f"{name:4s} dqkv_err={err_q:.3e} dbias_err={err_b:.3e} "
                f"(|dbias| max {r_dbias.abs().max().item():.3e}) "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
            if label == "base b0" and dt == torch.bfloat16:
                record = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by,
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


def make_train_batch(cfg, n: int, seed: int) -> dict:
    """Seeded synthetic batch: normalised crops, keypoints inside the input
    (a few off it), COCO visibility with some 0s."""
    rng = np.random.RandomState(seed)
    W, H = cfg.data.input_size
    K = cfg.data.num_keypoints
    kpts = rng.uniform(-8, 1, (n, K, 2)) + rng.uniform(0, 1, (n, K, 2)) * (
        np.array([W, H]) + 8)
    return {
        "image": torch.from_numpy(rng.randn(n, H, W, 3).astype(np.float32)),
        "keypoints": torch.from_numpy(kpts.astype(np.float32)),
        "visible": torch.from_numpy(
            rng.choice([0, 1, 2], (n, K), p=[0.1, 0.2, 0.7]).astype(
                np.float32)),
    }


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _output_grads(state, cfg, batch, masks) -> dict:
    """Gradient of the total loss w.r.t. the head's outputs, train mode."""
    from infantposeestimation_gaussianbias_tpu_torch.ops import heatmap
    from infantposeestimation_gaussianbias_tpu_torch.train import (
        make_loss_fn)

    dev = next(state.model.parameters()).device
    b = {k: v.to(dev) for k, v in batch.items()}
    target, weight = heatmap.generate_targets(
        b["keypoints"], b["visible"], cfg.data.heatmap_size,
        cfg.data.input_size, cfg.data.sigma)
    out = state.model.train()(b["image"], masks.to(dev))
    loss, _ = make_loss_fn(cfg)(out, b, target, weight)
    keys = ("heatmaps", "offsets", "variances")
    grads = torch.autograd.grad(loss, [out[k] for k in keys])
    return {k: g.cpu() for k, g in zip(keys, grads)}


def train_agreement_f32() -> None:
    """One float32 hrformer_base step at b=2, card against CPU."""
    from infantposeestimation_gaussianbias_tpu_torch import (
        create_train_state, get_variant, make_train_step)
    from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
        BatchNorm)
    from infantposeestimation_gaussianbias_tpu_torch.train import (
        draw_drop_masks)

    cfg = get_variant("hrformer_base")
    cfg.model.compute_dtype = "float32"
    cfg.train.warmup_epochs = 0
    gpu = create_train_state(cfg, device="cuda")
    cpu = create_train_state(cfg, device="cpu", state_dict={
        k: v.cpu() for k, v in gpu.model.state_dict().items()})
    batch = make_train_batch(cfg, 2, seed=3)
    masks = draw_drop_masks(cpu.model, 2, torch.Generator().manual_seed(4))
    # Where the gradients part: at the loss's inputs already?  (This extra
    # forward moves the running statistics once more on both sides.)
    g_out, c_out = (_output_grads(st, cfg, batch, masks) for st in (gpu, cpu))
    log("[train] f32 dloss/d(head outputs) card vs CPU, rel err: " + ", ".join(
        f"{k} {_rel(g_out[k], c_out[k]):.1e}" for k in g_out))
    step = make_train_step(cfg)
    t0 = time.perf_counter()
    _, m_gpu = step(gpu, batch, None, drop_masks=masks.cuda())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, m_cpu = step(cpu, batch, None, drop_masks=masks)
    t2 = time.perf_counter()
    log(f"[train] f32 b=2 step: card {(t1 - t0) * 1e3:.1f} ms (first call), "
        f"CPU {(t2 - t1) * 1e3:.1f} ms; DropPath kept "
        f"{int(masks.sum())} of {masks.numel()}")
    for k in m_cpu:
        a, b = m_gpu[k].item(), m_cpu[k].item()
        rel = abs(a - b) / max(abs(b), 1e-12)
        log(f"[train] f32 {k:14s} card {a:.7e} cpu {b:.7e} rel {rel:.2e}")
        assert np.isfinite(a) and rel <= STEP_LOSS_RTOL, (k, a, b)
    g_params = dict(gpu.model.named_parameters())
    errs = {"rpe_table": [], "qkv_weight": []}
    for name, p in cpu.model.named_parameters():
        if name.endswith("relative_position_bias_table"):
            errs["rpe_table"].append(_rel(g_params[name].grad.cpu(), p.grad))
        elif name.endswith("attn.qkv.weight"):
            errs["qkv_weight"].append(_rel(g_params[name].grad.cpu(), p.grad))
    for kind in ("rpe_table", "qkv_weight"):
        log(f"[train] f32 {kind} gradient rel err, block by block: "
            + " ".join(f"{e:.1e}" for e in errs[kind]))
    assert len(errs["rpe_table"]) == len(errs["qkv_weight"]) == 44
    assert max(errs["rpe_table"] + errs["qkv_weight"]) <= STEP_GRAD_RTOL
    g_mods = dict(gpu.model.named_modules())
    stat_err = 0.0
    for name, mod in cpu.model.named_modules():
        if isinstance(mod, BatchNorm):
            for buf in ("running_mean", "running_var"):
                a = getattr(g_mods[name], buf).cpu()
                b = getattr(mod, buf)
                torch.testing.assert_close(a, b, atol=STEP_STAT_TOL,
                                           rtol=STEP_STAT_TOL)
                stat_err = max(stat_err, (a - b).abs().max().item())
    log(f"[train] f32 BN running stats max_abs_err={stat_err:.3e}")


def train_bf16(smi: str) -> dict:
    """bf16 hrformer_base steps at b=32 on one seeded batch."""
    from infantposeestimation_gaussianbias_tpu_torch import (
        create_train_state, get_variant, make_train_step)
    from infantposeestimation_gaussianbias_tpu_torch.kernels import window_msa

    cfg = get_variant("hrformer_base")
    assert cfg.model.compute_dtype == "bfloat16"
    assert cfg.train.global_batch_size == TRAIN_BATCH
    cfg.train.warmup_epochs = 0  # else the lr stays near warmup_lr = 5e-7
    state = create_train_state(cfg, device="cuda")
    step = make_train_step(cfg)
    batch = {k: v.cuda() for k, v in
             make_train_batch(cfg, TRAIN_BATCH, seed=5).items()}
    gen = torch.Generator(device="cuda").manual_seed(6)
    warmup, timed = 3, 10
    losses, times = [], []
    fwd = bwd = 0
    torch.cuda.synchronize()
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.reset_peak_memory_stats()
        window_msa.LAUNCHES = window_msa.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        _, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        assert window_msa.LAUNCHES == K1_CALLS_PER_FORWARD, window_msa.LAUNCHES
        assert window_msa.BWD_LAUNCHES == K1_CALLS_PER_FORWARD, (
            window_msa.BWD_LAUNCHES)
        fwd += window_msa.LAUNCHES
        bwd += window_msa.BWD_LAUNCHES
        values = {k: v.item() for k, v in metrics.items()}
        assert all(np.isfinite(v) for v in values.values()), values
        losses.append(values["total_loss"])
        log(f"[train] bf16 b={TRAIN_BATCH} step {i}: "
            f"{times[-1] * 1e3:.1f} ms, K1 {window_msa.LAUNCHES} "
            f"K2 {window_msa.BWD_LAUNCHES} launches, "
            + " ".join(f"{k}={v:.4f}" for k, v in values.items()))
    peak = torch.cuda.max_memory_allocated()
    assert losses[-1] < losses[0], losses
    med = float(np.median(times[warmup:]))
    result = dict(step_ms=med * 1e3, images_per_s=TRAIN_BATCH / med,
                  peak_gib=peak / 2 ** 30, loss_first=losses[0],
                  loss_last=losses[-1], k1_launches=fwd, k2_launches=bwd,
                  card=smi)
    log(f"[train] bf16 b={TRAIN_BATCH}: median step {med * 1e3:.1f} ms over "
        f"{timed} steps after {warmup} warm-up, {result['images_per_s']:.1f} "
        f"images/s, peak memory {result['peak_gib']:.2f} GiB; total loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps; "
        f"on {smi}")
    result.update(profile_steps(step, state, batch, gen, result["step_ms"]))
    return result


def train_remat() -> dict:
    """One bf16 b=32 step with ``model.remat`` against one without, from
    the same weights, batch and DropPath masks: the same loss, gradients
    within the atomics' reordering, K1 launched once more per block for
    the recomputation, and the peak memory of each."""
    from infantposeestimation_gaussianbias_tpu_torch import (
        create_train_state, get_variant, make_train_step)
    from infantposeestimation_gaussianbias_tpu_torch.kernels import window_msa
    from infantposeestimation_gaussianbias_tpu_torch.train import (
        draw_drop_masks)

    batch = masks = None
    out = {}
    for remat in (False, True):
        cfg = get_variant("hrformer_base")
        cfg.model.remat = remat
        state = create_train_state(cfg, device="cuda")
        if batch is None:
            batch = {k: v.cuda() for k, v in
                     make_train_batch(cfg, TRAIN_BATCH, seed=7).items()}
            masks = draw_drop_masks(state.model, TRAIN_BATCH,
                                    torch.Generator().manual_seed(8), "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        window_msa.LAUNCHES = window_msa.BWD_LAUNCHES = 0
        _, metrics = make_train_step(cfg)(state, batch, None,
                                          drop_masks=masks)
        torch.cuda.synchronize()
        out[remat] = dict(
            loss=metrics["total_loss"].item(),
            grad_norm=metrics["grad_norm"].item(),
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            k1=window_msa.LAUNCHES, k2=window_msa.BWD_LAUNCHES,
            stats=torch.cat([b.flatten() for n, b in
                             state.model.named_buffers()
                             if n.endswith("running_var")]))
        del state
    off, on = out[False], out[True]
    log(f"[train] remat off/on, bf16 b={TRAIN_BATCH} one step: total_loss "
        f"{off['loss']:.6f}/{on['loss']:.6f}, grad_norm "
        f"{off['grad_norm']:.6f}/{on['grad_norm']:.6f}, K1 launches "
        f"{off['k1']}/{on['k1']}, K2 {off['k2']}/{on['k2']}, peak memory "
        f"{off['peak_gib']:.2f}/{on['peak_gib']:.2f} GiB")
    assert (off["k1"], on["k1"]) == (K1_CALLS_PER_FORWARD,
                                     2 * K1_CALLS_PER_FORWARD)
    assert off["k2"] == on["k2"] == K1_CALLS_PER_FORWARD
    # The same forward, kernel for kernel; the backward's sums (cuDNN's
    # weight gradients, the RPE-table scatter) may run in another order.
    assert abs(on["loss"] - off["loss"]) <= 1e-6 * abs(off["loss"])
    assert abs(on["grad_norm"] - off["grad_norm"]) <= 1e-3 * off["grad_norm"]
    # BatchNorm statistics move once per step, not again in the recompute
    # (a second move would shift them by ~0.1 of the batch statistics).
    torch.testing.assert_close(on["stats"], off["stats"], rtol=1e-6,
                               atol=1e-7)
    assert on["peak_gib"] < off["peak_gib"]
    return {"peak_gib_remat": on["peak_gib"]}


def profile_steps(step, state, batch, gen, step_ms: float,
                  n: int = 2) -> dict:
    """Device kernel time of ``n`` train steps, by kernel (torch.profiler),
    against the unprofiled median step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(state, batch, gen)
        torch.cuda.synchronize()

    def dev_us(e) -> float:
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return float(getattr(e, attr))
        return 0.0

    # device-side kernels and copies; a range that the profiler mirrors on
    # the device timeline (a user annotation) covers kernels counted already
    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3 / n
    kernels = sum(r[1] for r in rows) // n
    log(f"[profile] bf16 train step: {device_ms:.1f} ms of device kernels "
        f"({kernels} kernels) per step against the {step_ms:.1f} ms median "
        f"step: idle share {max(0.0, 1 - device_ms / step_ms):.1%}")
    for us, count, key in rows[:25]:
        log(f"[profile] {us / 1e3 / n:8.3f} ms/step "
            f"{us / 1e3 / n / device_ms:6.1%} x{count // n:5d}/step  "
            f"{key[:100]}")
    return dict(device_ms=device_ms, kernels_per_step=kernels)


def main() -> int:
    smi = phase_device()
    phase_build()
    k1 = phase_k1()
    k2 = phase_k2()
    inf, serve_launches = phase_slice()
    thr = phase_throughput(inf, smi)
    del inf
    train_agreement_f32()
    train = train_bf16(smi)
    train.update(train_remat())
    loaded = [m for m, v in sys.modules.items() if v is not None
              and m.split(".")[0] in ("jax", "flax",
                                      "infantposeestimation_gaussianbias_tpu")]
    assert not loaded, loaded
    log(json.dumps({"slice": thr, "train": train}))
    source = "infantposeestimation_gaussianbias_tpu_torch/csrc/"
    replaces = "infantposeestimation_gaussianbias_tpu/ops/pallas/window_msa.py"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    log(json.dumps({"kernels": [
        {"name": "window_msa_fwd", "route": "cuda",
         "source": source + "window_msa.cu", "replaces": replaces + ":222",
         "launches": serve_launches + train["k1_launches"],
         "launches_by_path": {"serve": serve_launches,
                              "train": train["k1_launches"]},
         **{k: k1[k] for k in keys}},
        {"name": "window_msa_bwd", "route": "cuda",
         "source": source + "window_msa_bwd.cu", "replaces": replaces + ":422",
         "launches": train["k2_launches"],
         "launches_by_path": {"train": train["k2_launches"]},
         **{k: k2[k] for k in keys}},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
