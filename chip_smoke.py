#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for this port).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  0. device: refuse to run without CUDA; print the card's name and power
     limit (nvidia-smi), torch and CUDA versions;
  1. build every kernel from csrc/ (kernels/build.py) and time the build;
  2. K1 (CUDA W-MSA forward, on the tensor-core forward core of
     csrc/wmsa_core.cuh) against its plain PyTorch version on the card,
     at every hrformer_base branch shape at batch 64 (32 crops x flip), at
     hrformer_small's branch 0, at window 8 and without bias; float32
     (TF32 off) at atol 1e-4, bf16 at atol/rtol 2e-2; the last head alone
     (a head range, as K3 launches it) equal to the whole launch's columns
     bit for bit; median kernel, plain and SDPA times and the bound; at
     b0 and b3 (bf16, b = 32) a ``[k1-split]`` line, as phase 3's;
  3. K2 (CUDA W-MSA backward, on the tensor-core core of
     csrc/wmsa_core.cuh) against its plain version at every training
     shape at batch 32 (hrformer_base's four branches, hrformer_small's
     branch 0, window 8), float32 and bf16, dqkv and dbias; median kernel,
     plain and SDPA-backward times and the bound; at three odd row widths
     (rows that start mid-word) against its plain version, the last head
     alone equal to the whole bit for bit; at b0 and b3 (bf16) a
     ``[k2-split]`` line: the launches and device ms per call of each
     kernel (the window kernel, the dbias reduction), the totals of seven
     calls under one torch.profiler over seven;
  4. serving: PoseInference(hrformer_base) with seeded weights (its
     default serving, BN-folded) serves
     batches of 1, 3 and 8 uint8 frames; K1 must launch 88 times per
     flip-tested batch; then float32 on the card against the port on the
     CPU (plain path), same weights and frames;
  5. throughput: bf16 predict_batch at 32 crops per batch;
  6. training: one float32 step of hrformer_base at b=2 on the card
     against the same step on the CPU (plain path), same weights, batch and
     DropPath masks; then bf16 steps at b=32 on one seeded batch: finite
     terms, K1 and K2 44 launches each per step, a falling loss, step time,
     images/s and peak memory, and a profile of two steps by kernel; then
     one bf16 step with model.remat against one without;
  7. K4 and K5 (CUDA fused attention and MLP half-blocks, forward and
     backward) against their plain versions at every hrformer_base branch
     shape: forward at the serving batch 64, forward and backward at the
     training batch 32, forward and backward at window 8 (N = 64) at
     the training batch, and forward and backward at batch 2 (one
     flip-tested frame served, or phase 9's float32 step), where K5's plan
     takes its smallest tile, float32 and bf16, every output (dx, dgamma,
     dbeta, each weight and bias gradient, drpe); kernel, plain and
     stock-PyTorch chain (LayerNorm, F.linear, SDPA or tanh GELU) times
     and the bound; at b0 and b3 (bf16,
     window 7, the training batch) ``[k4fwd-split]``, ``[k4bwd-split]``,
     ``[k5fwd-split]`` and ``[k5bwd-split]`` lines, as phase 3's, of one
     K4 forward (the weights' rows, (a) LayerNorm, (b) the attention per
     (chunk, head), (c) proj + residual), one K4 backward (stages (a)
     LayerNorm, (b) the core per (chunk, head), (c) dln and the LayerNorm
     backward, (d) the weight-gradient and partial-row reductions, and the
     wrapper's copies), one K5 forward (LayerNorm, fc1, fc2) and one K5
     backward (LayerNorm, the hidden stage, dln, the LayerNorm backward,
     the weight-gradient reductions);
  8. fused serving (IPE_FUSED_BLOCK=1): batches of 1, 3 and 8 frames, 88
     K4 and 88 K5 launches per flip-tested batch and no K1; under "auto"
     28 K1, 60 K4 and 60 K5; float32 card against the CPU; fused against
     unfused outputs from the same weights; bf16 crops/s at b=32;
  9. fused training (IPE_FUSED_BLOCK=1): a float32 step at b=2, card
     against CPU; bf16 steps at b=32 with 44 launches of each of K4 and
     K5 forward and backward per step, no K1 or K2, a falling loss, step
     time, images/s, peak memory and the profile by kernel; one bf16 step
     at window 8, 44 launches of each, finite terms;
 10. K7 (CUDA fused residual chain; bf16 weights on the halo-staged
     tensor-core conv) against its plain version at every hrnet_w32 and
     hrnet_w48 branch shape at the served batch 32, float32 (TF32 off) and
     bf16; kernel, plain and stock-chain (four eval BasicBlocks: cuDNN
     convs and BatchNorm) times, the bound and the bf16 plan; at hrnet_w32's
     branches in bf16 a ``[k7-split]`` line (the chain's launches and
     device ms per call) and the stock chain's device ms; every branch
     also at b = 1 and 2 in bf16 (the plan's input-channel parts);
 11. K6 (CUDA 3x3 weight gradient) against its plain version at every
     stride-1 3x3 conv shape of hrnet_w32 + fusion (found with hooks) at
     b=32, float32 and bf16; kernel, plain and cuDNN
     (torch.nn.grad.conv2d_weight) times and the bound; at the b0 (64x48
     32->32) and b3 (8x6 256->256) shapes in bf16 a ``[k6-split]`` line
     (the band kernel, the partials' sum);
 12. HRNet-W32 serving: PoseInference(Config(), fold=False) (heatmap
     head, quarter decode; unfolded, since the calibration and K7's hooks
     read the BatchNorms; phase 21 serves it folded) and the fusion head,
     their BatchNorm statistics calibrated
     by train-mode forwards on seeded crops, serve batches of 1, 3 and 8
     frames through no kernel of the HRFormer path; float32 card against
     CPU;
     bf16 crops/s at b=32 for each head; then a served bf16 batch of 32
     with hooks on every BasicBlock chain: K7 on the packed model
     parameters against the model's own chain, 26 launches per forward;
 13. HRNet-W32 training: a float32 step at b=2, card against CPU; bf16
     steps of Config() (heatmap head) at b=32 on one seeded batch: finite
     terms, a falling loss, step time, images/s, peak memory and the
     profile by kernel; one bf16 fusion-head step with finite terms and
     hooks on every stride-1 3x3 conv: K6 on each captured (x, dy)
     against that conv's weight.grad, one launch per conv;
 14. K1-hm (CUDA W-MSA forward on head-major operands) against its plain
     version at every K1 shape at b = 64, with and without bias, float32
     and bf16; kernel, plain, SDPA (batch H, mask bias[h]) ms and bound;
     then the window-major entry point (relayout copies + K1-hm) fed from
     the flat qkv equal to K1 on it bit for bit, with the time of each;
 15. K8 (CUDA phase ablation of K1's kernel: its phases compiled out,
     and packslim): every variant and windows-per-block value against its
     plain version (``empty`` equal), ``full`` equal to K1 bit for bit;
     the port's probe ``main()`` at its default shape and at
     hrformer_base b0-b3 (b = 64): each variant's ms, bound and plain ms,
     and K1's phase shares (staging, products, softmax);
 16. analysis: ``benchmark_model`` for Config() and hrformer_base (bf16,
     b = 32; K1 44 launches per HRFormer forward, none for HRNet);
     saliency (44 K1 and 44 K2 launches), Grad-CAM and occlusion on
     hrformer_base in float32, card against CPU; a ``profile_trace`` of
     one forward (44 K1 kernels among its device events); MC DropPath
     uncertainty (n = 4) leaving the BatchNorm statistics as they were;
 17. K3 (the sharded W-MSA) on a 2 x 2 grid of gloo ranks on the card
     (parallel.run_grid; the kernels built above, so the ranks only load
     them): at every hrformer_base branch shape at the global batch 32,
     float32 and bf16, each rank's output and dqkv against unsharded K1/K2
     on its windows (bit for bit) and the plain versions, dbias against
     K2 and the plain version over all windows; per rank, in turns, its
     K1 and K2 ms, the plain version's and SDPA's at the local shape, the
     bound, and the all-reduce ms;
 18. grid serving: hrformer_base + fusion over the grid, bf16, b = 32
     with flip: 88 K1 launches per rank, all through K3, every rank the
     whole batch, crops/s (4 ranks, 1 card, gloo); float32 heatmaps and
     keypoints against one process on the card;
 19. grid training: a float32 step over the grid at global b = 4 against
     one process's (loss terms, RPE-table and qkv-weight gradients, the
     global BatchNorm statistics); a bf16 step at global b = 32, 44 K1
     and 44 K2 launches per rank through K3, the same state on every rank.
 20. only with ``--parent DIR`` (DIR a checkout of the parent commit, e.g.
     from ``git archive``): K1 and K1-hm at every BRANCH_SHAPES row at
     b = 64 and 32, K1 on K3's rank-0 head range at hrformer_base's
     branches (b = 32), K2 and K4's backward at every training shape
     of phases 3 and 7, K4's forward at every hrformer_base branch at
     b = 64 and 32, window 7 and 8, K5's forward at every branch at b = 64
     and 32 and its backward at b = 32 (window 7; all float32 and bf16),
     K6 at every hrnet_w32 3x3 shape of phase 11 (b = 32, float32 and
     bf16), K7 at every hrnet_w32 branch (b = 32, float32 and bf16), K8's
     five variants at the probe's default shape and hrformer_base b0 (b =
     64) at 1 and 4 windows per block (packslim at G), the bf16 b = 32
     steps of phases 6 and 9 (step ms, device ms,
     peak memory) and one fused (IPE_FUSED_BLOCK=1) and one unfused served
     bf16 batch of 32 with flip (batch ms, device ms, K4 and K1
     launches), K9 at every distinct int8 conv call of a served hrnet_w32
     + fusion forward and K10 at every wide Dense call of hrformer_base's
     (b = 64, bf16; event ms, their sums and the worst shape logged; the
     host µs of a call at the record shapes), one served int8 bf16 batch
     of 32 with flip of hrnet_w32 + heatmap and of hrformer_base beside
     the folded one (batch ms, crops/s, device ms and its split by kernel,
     kernels, K9 and K10 launches), the
     parent's against
     this checkout's, each in a fresh
     subprocess that imports its checkout's package and builds its
     kernels, in turns: parent, change, change, parent (``[parent]``
     lines); the K1, K1-hm, K2, K4, K6, K7 and K8 records take the
     parent's ms at the record shape (b0 bf16; K1, K1-hm and K4's forward
     at b = 64, K6 64x48 32->32, K7 hrnet_w32 b0 at b = 32, K8 ``full`` at
     the probe's default shape) as ``parent_ms`` and this checkout's,
     timed the same way, as ``fresh_ms``, the K5 records the same at b3
     bf16 b = 32, its worst branch (``parent_shape``; all null without
     ``--parent``), K9 and K10 at their record shapes and over all their
     shapes (``sum_parent_ms``, ``sum_fresh_ms``); and the outputs of K1, K1-hm, K2 and K4 at
     hrformer_base b0 (b = 32, float32 and bf16) must hash the same in
     the parent and this checkout (``[parent] bits`` lines).
 21. BN-fold serving: hrnet_w32 + heatmap (Config(), BatchNorm
     calibrated as in phase 12) and hrformer_base + fusion (BatchNorm
     perturbed), b = 32 with flip: float32 folded against unfolded on the
     card (heatmaps FOLD_F32_REL_TOL, keypoints KEYPOINT_ATOL_PX off decode
     ties) and folded on the card against folded on the CPU (phase 4's
     bounds); bf16 folded against unfolded and against float32 (bound:
     the unfolded bf16 model's own distance from float32 plus
     FOLD_BF16_REL_TOL), K1 88
     launches a folded hrformer_base batch and none for HRNet, batch ms
     and a profile (device ms, kernels, idle share) folded and unfolded;
 22. the HTTP server (cli.serve.make_server on 127.0.0.1), hrformer_base +
     fusion, folded: float32, 8 concurrent .npy requests of 480x640 frames,
     each answer against predict_batch of that frame alone (1e-2 px off
     ties, scores 1e-4); bf16, max_batch 32, 64 requests from 16 client
     threads (every answer 200, K1 launches 88 x the dispatched batches,
     requests/s, p50/p99 latency, /healthz) and 16 requests from 8
     threads under IPE_FUSED_BLOCK=1 (K4 and K5 88 x batches); a request
     with a 1 ms deadline answers 504; a full queue (depth 1, the card held
     by a gate) answers 503 with Retry-After;
 23. predict_stream, hrformer_base bf16 folded: 4 batches of 32 uint8
     crops and one of 5, two in flight: every batch equal bit for bit to
     crops_pipeline on the same crops (the prefetch's copy is ordered
     before the compute that reads it), K1 88 launches a batch, crops/s;
 24. graft_entry.entry (the twin of __graft_entry__.entry): the example's
     shapes, float32 coords and scores card against CPU from one set of
     weights (BatchNorm calibrated), one bf16 call finite;
 25. temporal_smooth (gaussian, moving average, One-Euro),
     postprocess_predictions, nms_pose, the rotated affine matrices,
     transform_points and crop_and_normalize(rots=...) on card tensors
     against the CPU (float32, POST_RTOL; the rotated crop ROT_CROP_ATOL).
 26. the training loop: a set of 480x640 JPEGs written by the repo's
     generator; the host loader alone (build_dataloader, training
     augmentation, 8 threads, b = 32, 256x192), native against cv2,
     images/s; hrformer_base + fusion bf16 b = 32 through
     ``train/loop.train`` with ``data.native_loader="on"``: 2 epochs with
     validation after each (K1 and K2 44 launches each per step, K1 132
     per validation batch: the flip test's two forwards and the loss's
     one; no cv2 sample; finite terms, a falling loss), the loop's
     images/s against phase 6's bare step, a checkpoint's save and restore
     seconds, the resume to epoch 3 from ``latest`` (its steps profiled:
     device ms and idle share of a loop step), a preemption set through
     ``_PREEMPTED`` in epoch 3 (``latest`` stamped epoch 2 and
     ``preempted``) and its resume (epoch 3 replayed); the same 2 epochs
     under IPE_FUSED_BLOCK=1 (K4 and K5, forward and backward, 44 each
     per step, no K1 or K2); ``preemie`` (hrnet_w32 + heatmap, infant13,
     256x256, jitter 0.2, its heatmaps at the model's stride 4): an epoch
     of 2 steps, every crop moved by the jitter; the pipeline proof
     (tools/pipeline_proof.py) on the card, AP held to PROOF_AP_MIN.
 27. int8 PTQ serving (K9, the int8 conv, and K10, the int8 Dense, of
     csrc/qgemm.cu and csrc/qdense.cu): hrnet_w32 with the heatmap and the
     fusion head
     (BatchNorm calibrated as in phase 12) and hrformer_base + fusion
     (BatchNorm perturbed), each quantized by PoseInference(quantize=True)
     on 32 calibration crops.  K9 at every distinct int8 conv call of a
     served hrnet_w32 + fusion forward at b = 64 (32 crops with flip) and
     K10 at every wide Dense call of hrformer_base's, each equal to its
     plain version bit for bit, with kernel, plain and library ms (cuDNN
     bf16 conv, and at K9's 1x1 stride-1 shapes padded torch._int_mm,
     which computes the same int32 product; for K10 torch._int_mm on
     operands padded to multiples of 8 and a bf16 matmul) and the bound
     (int8 tensor cores or bytes); at K9_SPLIT_SHAPES and
     K10_SPLIT_SHAPES ``[k9-split]`` and ``[k10-split]`` lines: the device
     ms of a launch of the serving kernel and of its variants with
     staging, the products or the epilogue alone compiled in
     (quant._qconv_ablate, quant._qdense_ablate), each from a profile
     that kept one record for every call, and the host microseconds of
     one wrapper call; K9 and K10 launched from INT8_THREADS host threads
     at once (two on the default stream, the others on streams of their
     own), every output equal to its plain version; served int8
     batches of 32 frames with flip and of 1, exactly 2 x the model's
     QConvNorms K9 launches (610 heatmap, 620 fusion), 2 x its QDense K10
     launches (268) and 88 K1 (hrformer) a batch; float32 int8 against
     float32 float heatmaps (cosine >= INT8_COS_MIN on the JAX int8
     test's weights, logged on the served ones) and against the CPU
     on the same crops and int8 state (INT8_CARD_CPU_* bounds);
     crops/s, b = 1 ms and a profile of the bf16 int8 batch beside the
     folded bf16 batch; ``cli.serve --int8 --calibration-dir`` in its own
     process answering a burst (/healthz "int8-ptq"), ``cli.infer --int8``
     and ``cli.validate --int8`` (AP, no loss).
 28. LiteHRNet and the remaining heads (no hand-written kernel on this
     path; every launch count stays 0): the lightweight config
     (litehrnet + heatmap, 192x192, BatchNorm calibrated as in phase 12)
     serves batches of 1, 3 and 8, float32 card against CPU, bf16 crops/s
     at b = 32 with flip and at b = 1 with the served batch's device ms,
     kernels and idle share; a float32 step at b = 2 card against CPU (as
     phase 13's) and 20 bf16 steps at b = 64 (a falling loss, step ms,
     images/s, peak memory); litehrnet at 256x192 with the fusion, fused
     and SimCC heads: a float32 step card against CPU (loss terms) and a
     bf16 step at b = 32 each, the SimCC head served without flip (float32
     card against CPU); CBAM, TransformerNeck and a deconv heatmap head on
     hrnet_w32's stride-4 features at b = 32, float32 card against CPU;
     the pipeline proof at its litehrnet default (AP held to
     PROOF_AP_MIN) and the overfit check (OVERFIT_STEPS steps).
 29. the last surfaces: four served pipelines exported by
     tools/export_model.py (torch.export; the served kernels as the
     registered operators of kernels/ops.py), saved, loaded and called at
     b = 32 frames with flip: (a) hrformer_base + fusion folded (K1), (b)
     the same under IPE_FUSED_BLOCK=1 (K4, K5), (c) hrnet_w32 + heatmap
     int8 (K9), (d) hrformer_base + fusion int8 (K10 and K1); each against
     the live PoseInference pipeline on the same inputs (int8 bit for bit;
     float keypoints within KEYPOINT_ATOL_PX off decode ties, scores
     EXPORT_SCORE_ATOL) with exactly its launches (88 K1; 88 K4 and 88
     K5; 610 K9; 268 K10 and 88 K1), the blob's MB, export and load
     seconds and crops/s beside predict_batch's; cli/analyze's computing
     half on hrformer_base (its files, K1 and K2 launches counted);
     validate_reference_checkpoint --dry-run at hrnet_w32 + fusion, float
     and --int8; tools/probe_serve_http (16 clients x 8 requests, folded
     hrnet_w32 + fusion: requests/s, latency percentiles, the batches
     formed); predict_video on a short synthetic video and
     viz/clinical.create_video_with_pose over it; the host microseconds
     of a K1, K9 and K10 call through the registered operator against the
     wrapper (``[operator]`` lines).
Phases 21-29 run after 19 and before 20.  ``--phases N,N,...`` runs the
chosen phases alone (and what they need: 5 and 8 need 4, 23 needs 22, 26
needs 6 and 9; 0 and 1 always run); the default is every phase.
The ranks import no JAX (each asserts it).
Every phase's seconds and the whole run's are printed.  Each fused phase
sets IPE_FUSED_BLOCK itself and restores it after.  The
last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

F32_ATOL = 1e-4           # float32 inputs, products exact or in split-bf16
                          # terms (csrc/wmsa_core.cuh); order differs
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
SERVE_BATCH = 64  # crops through the model per served batch of 32: flip test
SMALL_BATCH = 2  # crops through the model for one flip-tested frame
FUSED_ENV = "IPE_FUSED_BLOCK"
# Fused blocks per hrformer_base forward under IPE_FUSED_BLOCK=auto: the
# blocks of width >= 128 (branches 1-3: 14 + 12 + 4), the rest unfused.
AUTO_FUSED_PER_FORWARD = 30
# K4/K5 against their plain versions on the card: both round the same
# activations to bf16 and accumulate in float32, in other orders, and a
# sum on the other side of a bf16 rounding boundary moves that operand by
# 2^-8.  Per output tensor, the relative norm of the difference: float32
# inputs, such flips only (measured <= 1.2e-4); bf16, plus one bf16 ulp on
# the output cast (2^-8 = 3.9e-3 of an element).  And no element further
# off than FUSED_LOCAL_TOL of the tensor's largest magnitude (a few bf16
# ulps of it).
FUSED_REL_TOL = {torch.float32: 1e-3, torch.bfloat16: 4e-3}
FUSED_LOCAL_TOL = 2.0 ** -4
# Fused float32 model, card against CPU: the same bf16 roundings flip in
# other places through 44 blocks (each flip 2^-8 of one operand), so the
# card-vs-CPU bounds of the unfused path do not apply.  Measured on the
# H100 (PERF.md): heatmaps 4.9e-4, keypoints 2.6e-3 px, loss terms <= 6.6e-6
# and grad_norm 2.9e-4 relative, BN running stats 2.4e-3; bounds ~4x that.
# The per-block RPE-table and qkv-weight gradients differ by 2.4-7.1e-2:
# the unfused path already turns a forward agreement of ~1e-6 into 1-5e-3
# there (ReLU ties, above); the fused path's forward agrees to ~5e-4, and
# a backward from the CPU's own head-output gradients differs as much
# (1.5-4e-2), so it is the forward's roundings, not the backward kernels
# (held to <= 6e-4 against their plain twins, phase 7).  Bound 2x that.
FUSED_HEATMAP_ATOL = 2e-3
FUSED_KEYPOINT_ATOL_PX = 1e-2
FUSED_STEP_LOSS_RTOL = 1e-3
FUSED_STEP_GRAD_RTOL = 0.15
FUSED_STEP_STAT_TOL = 1e-2
# Fused against unfused bf16 outputs from the same weights: the JAX
# package's tolerance for the same comparison (tests/test_fused_block.py,
# a bf16 block with tanh GELU against exact GELU), relative to the
# heatmaps' largest magnitude here, since 44 blocks add up.
FUSED_VS_UNFUSED_TOL = 4e-2
# Least time of a kernel: its bytes (each input read once, each output
# written once) at the H100 SXM's 3.35 TB/s, or its FLOPs at the peak rate
# for their type, whichever is longer (NVIDIA's H100 SXM data sheet):
# float32 inputs at 67 TFLOP/s of the CUDA cores, bf16 inputs at the 989
# TFLOP/s dense bf16 tensor-core rate (the least time for the work, even
# where a kernel, as K1 and K2 do, computes in float32).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12

# hrnet_w32's branches at 256x192: (label, map H, map W, C); the served
# forward runs b = 32 (a batch of 32 crops, twice for the flip test).
HRNET_MAPS = [
    ("w32 b0", 64, 48, 32),
    ("w32 b1", 32, 24, 64),
    ("w32 b2", 16, 12, 128),
    ("w32 b3", 8, 6, 256),
]
# hrnet_w48's branches, the same maps at 48/96/192/384 channels.
HRNET_W48_MAPS = [
    ("w48 b0", 64, 48, 48),
    ("w48 b1", 32, 24, 96),
    ("w48 b2", 16, 12, 192),
    ("w48 b3", 8, 6, 384),
]
HRNET_SERVE_BATCH = 32
# BasicBlock chains per hrnet_w32 forward: 1*2 + 4*3 + 3*4 branches.
K7_CHAINS_PER_FORWARD = 26
# K7 against its plain version on the card, per output, relative norm of
# the difference and largest element error over the largest magnitude.
# Float32: the same float32 maths in another summation order through 8
# convs (measured <= 1.6e-6).  bf16: both round every conv input to bf16
# from float32 values that agree to ~1e-6, a value on the other side of a
# rounding boundary moves by 2^-8, and the output is bf16: elements differ
# by up to one bf16 ulp, 2^-7 of their magnitude at most (measured: one
# ulp at the largest element, relative norm <= 3.4e-3).
K7_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0 ** -7, 2.0 ** -4)}
# K7 against the model's own bf16 chain: the eval BasicBlocks round to
# bf16 after each conv, BatchNorm affine and residual add (about six
# roundings of 2^-9 per block, compounding through 8 convs), where K7
# carries float32; relative norm of the difference per chain.
K7_MODEL_REL_TOL = 3e-2
# K6 against its plain version: relative norm and largest element error
# over the largest.  Float32: FMAs in another order over B*H*W rows
# (measured <= 4e-6).  bf16: the products are exact in both, but the
# tensor cores' float32 accumulation truncates where an FMA rounds, a bias
# of up to 2^-23 per k16 step that grows with a chunk's rows (24,576 at
# 64x48 256->256, where 4 chunks fill the card: <= 1.8e-4): measured
# 2.8e-5 there on random data, 1.05e-4 on a train step's own tensors.
K6_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.5e-4, 1e-3)}
# K6 against a bf16 conv's weight.grad: cuDNN's weight gradient is rounded
# to bf16 once (2^-9 of each element at most; 2^-8 in norm covers it).
K6_GRAD_REL_TOL = 2.0 ** -8
# HRNet-W32 float32 step, card against CPU: the loss and the BatchNorm
# statistics are forward quantities; the gradients are not smooth in the
# forward's roundings: a ReLU input on the other side of 0 on the card
# (the CPU tests find one per step against JAX at the tiny size) moves
# every gradient below it, by more on the small branch-3 maps (8x6 at
# b=2).  Whole gradient vector relative norm and grad_norm.
HRNET_STEP_GRAD_RTOL = 2e-2
HRNET_STEP_NORM_RTOL = 1e-3

# hrformer_base's branches at 256x192: (label, map H, map W, C, heads);
# window 7, so 70 / 20 / 6 / 2 windows per image.
BASE_MAPS = [
    ("base b0", 64, 48, 78, 2),
    ("base b1", 32, 24, 156, 4),
    ("base b2", 16, 12, 312, 8),
    ("base b3", 8, 6, 624, 16),
]

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


@contextlib.contextmanager
def env_var(name: str, value: str):
    """Environment variable ``name`` set to value inside the block, its old
    value after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def fused_blocks(flag: str):
    """IPE_FUSED_BLOCK=flag inside the block, its old value after."""
    return env_var(FUSED_ENV, flag)


def reset_launches() -> None:
    """Every kernel's launch count to 0."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import (
        conv_wgrad, fused_block, quant, residual_block, window_msa,
        window_msa_ablate)

    quant.CONV_LAUNCHES = quant.DENSE_LAUNCHES = 0
    window_msa.LAUNCHES = window_msa.BWD_LAUNCHES = 0
    window_msa.SHARDED_LAUNCHES = window_msa.SHARDED_BWD_LAUNCHES = 0
    window_msa.HM_LAUNCHES = window_msa_ablate.ABLATE_LAUNCHES = 0
    fused_block.ATTN_LAUNCHES = fused_block.ATTN_BWD_LAUNCHES = 0
    fused_block.MLP_LAUNCHES = fused_block.MLP_BWD_LAUNCHES = 0
    conv_wgrad.LAUNCHES = residual_block.LAUNCHES = 0


def launches() -> dict:
    """Launches since the last reset: K1, K2, K4 (fwd, bwd), K5 (fwd, bwd),
    K6, K7, K1-hm, K8, K3's K1 and K2 (counted in K1 and K2 too), K9 and
    K10."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import (
        conv_wgrad as cw, fused_block as fb, quant as qk, residual_block as rb,
        window_msa as wm, window_msa_ablate as ab)

    return dict(k1=wm.LAUNCHES, k2=wm.BWD_LAUNCHES, k4=fb.ATTN_LAUNCHES,
                k4b=fb.ATTN_BWD_LAUNCHES, k5=fb.MLP_LAUNCHES,
                k5b=fb.MLP_BWD_LAUNCHES, k6=cw.LAUNCHES, k7=rb.LAUNCHES,
                k1hm=wm.HM_LAUNCHES, k8=ab.ABLATE_LAUNCHES,
                k3=wm.SHARDED_LAUNCHES, k3b=wm.SHARDED_BWD_LAUNCHES,
                k9=qk.CONV_LAUNCHES, k10=qk.DENSE_LAUNCHES)


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


def graph_ms(fn, calls: int = 10, runs: int = 7) -> float:
    """Device ms of one call of ``fn`` without the host: ``calls`` calls
    captured in one CUDA graph (after one call outside it: a kernel's
    first launch loads it and opts it in to its shared memory), the
    median of ``runs`` replays timed by CUDA events, divided by
    ``calls``."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_median_ms(graph.replay, warmup=1, runs=runs) / calls
    del graph
    return ms


def _kernel_name(name: str) -> str:
    """A profiler's kernel name without return type, namespace and
    arguments: ``atb_kernel``, ``core_kernel<bf16>``,
    ``window_msa_fwd_kernel<bf16, Layout 0>``."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    name = re.sub(r"\((\w+)\)(\d+)", r"\1 \2", name)  # (Layout)0
    return name.split("(")[0].replace("__nv_bfloat16", "bf16")


def launch_split(fn, runs: int = 7) -> list:
    """Device time of each kernel (and copy) name that one call of ``fn``
    launches, in order of first launch: [(name, launches per call, ms per
    call)], the totals of ``runs`` calls under one torch.profiler divided
    by ``runs``.  Records the profiler drops lower a total and show as
    fewer launches per call than ``fn`` makes; it fails nothing (this is
    a measurement, not a check), and a caller that needs a whole reading
    checks the launches (``one_launch_ms``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    totals: dict = {}
    for e in sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)),
                    key=lambda e: e.time_range.start):
        n, us = totals.get(_kernel_name(e.name), (0, 0.0))
        totals[_kernel_name(e.name)] = (n + 1, us + e.time_range.elapsed_us())
    return [(name, n / runs, us / 1e3 / runs)
            for name, (n, us) in totals.items()]


def log_split(tag: str, label: str, fn) -> list:
    """``[tag] label: total | each kernel name`` from ``launch_split``."""
    split = launch_split(fn)
    log(f"[{tag}] {label}: {sum(ms for *_, ms in split):.4f} ms device in "
        f"{sum(n for _, n, _ in split):g} launches: "
        + (" | ".join(f"{name} x{n:g} {ms:.4f}" for name, n, ms in split)
           or "no device records"))
    return split


def one_launch_ms(tag: str, label: str, fn, runs: int = 7,
                  tries: int = 3) -> Optional[float]:
    """Device ms of the one kernel launch that a call of ``fn`` makes, from
    ``launch_split``: counted only when the profile kept one record of it
    for each of the ``runs`` calls; after ``tries`` profiles that did not,
    None (not measured), never 0.  Logs each profile, and each one that
    kept fewer records, as ``[tag] label``."""
    for _ in range(tries):
        split = launch_split(fn, runs)
        if len(split) == 1 and split[0][1] == 1:
            return split[0][2]
        log(f"[{tag}] {label}: the profile kept "
            f"{[(name, round(n * runs)) for name, n, _ in split]} records "
            f"of {runs} calls; again")
    log(f"[{tag}] {label}: not measured ({tries} profiles without one "
        f"record a call)")
    return None


def flop_rate(dtype: torch.dtype) -> float:
    """The card's peak FLOP/s for products of inputs of this type."""
    return BF16_TC_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S


def bound_ms(nbytes: float, flops: float,
             flop_rate: float = F32_FLOP_PER_S) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for the work of one call."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flop_rate
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
    kernel = ""
    for line in build.BUILD_LOG.splitlines():
        if "entry function" in line:  # the mangled name holds the kernel's
            kernel = _mangled_kernel(line)
        if "registers" in line or "spill" in line:
            log("[build]", kernel, line.strip())


def _mangled_kernel(line: str) -> str:
    """A kernel's name from ptxas's mangled one (each identifier is
    <length><name>), with its element type and, for the staged product's
    tiles (csrc/mlp_gemm.cuh ``Cfg``), BM x BN x BK, the warps and the
    weight terms."""
    name = line.split("'")[1][:60]
    for m in re.finditer(r"\d+", line):  # a length may follow other digits
        lengths = [int(m.group()[i:]) for i in range(len(m.group()))]
        found = [line[m.end():m.end() + n] for n in lengths
                 if line[m.end():m.end() + n].endswith("_kernel")]
        if found and re.fullmatch(r"[A-Za-z_]\w*", found[-1]):
            name = found[-1]
            break
    cfg = re.search(r"CfgILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E"
                    r"EELi(\d+)E", line)
    if cfg:
        bm, bn, bk, wm, wn, _, nb = cfg.groups()
        name += f" <{bm}x{bn}x{bk}, {wm}x{wn} warps, {nb} term(s)>"
    vec = re.search(r"atb_kernelILi(\d+)E", line)
    if vec:  # the weight-gradient reduction's copy width
        name += f" <{2 * int(vec.group(1))}-byte copies>"
    core = re.search(r"attn_fwd_core_kernelILi(\d+)ELi(\d+)E", line)
    if core:  # K4's forward stage (b): its qkv tile width, weight terms
        name += f" <64x{core.group(1)} qkv tile, {core.group(2)} term(s)>"
    band = re.search(r"wgrad_band_kernelILi(\d+)ELi(\d+)E", line)
    if band:  # K6's bf16 kernel: its tile, its copy width
        name += (f" <32x{band.group(1)} tile, {2 * int(band.group(2))}-byte "
                 f"copies>")
    layout = re.search(r"window_msa_fwd_kernelI.*?6LayoutE(\d)E(?:Li(\d)E)?",
                       line)
    if layout:  # K1 (flat qkv) or K1-hm (head-major); K8's phases
        name += " <flat qkv>" if layout.group(1) == "0" else " <head-major>"
        phase = ("full", "empty", "gemmonly", "softonly")[
            int(layout.group(2) or 0)]
        name += "" if phase == "full" else f" <{phase}>"
    tc = re.search(r"conv_tc_kernelILi(\d+)ELb([01])E", line)
    if tc:  # K7's bf16 conv: its slab width, its weights whole or a ring
        name += (f" <TCO {tc.group(1)}, "
                 f"{'whole slab' if tc.group(2) == '1' else 'ring'}>")
    qc = re.search(r"qconv_kernelILi(\d+)ELi(\d)ELb([01])ELi(\d)ELi(\d)E",
                   line)
    if qc:  # K9: its N tile, warpgroups, staging route, ring, phases
        name += (f" <BN {qc.group(1)}, {qc.group(2)} warpgroup(s), "
                 f"{'bytes' if qc.group(3) == '1' else '16-byte copies'}, "
                 f"{qc.group(4)}-slice ring{_qgemm_phases(qc.group(5))}>")
    qd = re.search(r"qdense_kernelILi([01])ELi(\d)ELi(\d)E", line)
    if qd:  # K10: its rows' type, warpgroups of products, phases
        name += (f" <{'bf16' if qd.group(1) == '1' else 'float32'} rows, "
                 f"{qd.group(2)} warpgroup(s){_qgemm_phases(qd.group(3))}>")
    targ = re.search(r"_kernelI(f|13__nv_bfloat16)", line)
    if targ:  # a template's element type
        name += " (float)" if targ.group(1) == "f" else " (bf16)"
    return name


def _qgemm_phases(phases: str) -> str:
    """K9's or K10's compiled phases as a name's suffix: nothing for the
    serving kernel (7), else the one phase of a measurement variant."""
    return {"7": "", "1": ", staging only", "2": ", products only",
            "4": ", epilogue only"}[phases]


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
            # the last head alone (K3's head range): its columns of the
            # whole launch bit for bit, zeros elsewhere
            last = window_msa.window_attention_qkv(qkv, bias, H,
                                                   heads=(H - 1, 1))
            torch.cuda.synchronize()
            ref = window_msa.window_attention_qkv_reference(qkv, bias, H)
            err = (out.float() - ref.float()).abs().max().item()
            if dt == torch.float32:
                torch.testing.assert_close(out, ref, atol=F32_ATOL, rtol=0)
            else:
                torch.testing.assert_close(out.float(), ref.float(),
                                           atol=BF16_TOL, rtol=BF16_TOL)
            cut = (H - 1) * hd
            assert torch.equal(last[..., cut:], out[..., cut:]), label
            assert not last[..., :cut].any(), label
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
            b_ms, b_by = bound_ms(nbytes, 4 * N * N * hd * nW * H,
                                  flop_rate(dt))
            name = "f32" if dt == torch.float32 else "bf16"
            log(f"[k1] {label:16s} nW={nW:5d} N={N} H={H:2d} hd={hd} "
                f"{name:4s} max_abs_err={err:.3e} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}); head {H - 1} alone bit for "
                f"bit")
            if label == "base b0" and dt == torch.bfloat16:
                record = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by,
                              shape=f"nW={nW},N={N},H={H},hd={hd},bf16")
    record["max_abs_err"] = worst
    # device time of one call by kernel at the training and served-pass
    # batch (32 crops), b0 and b3
    for label, w, N, H, hd in BRANCH_SHAPES:
        if label in ("base b0", "base b3"):
            nW = TRAIN_BATCH * w
            qkv = torch.randn(nW, N, 3 * H * hd, device="cuda", generator=g,
                              dtype=torch.bfloat16)
            bias = torch.randn(H, N, N, device="cuda", generator=g)
            log_split("k1-split", f"{label} nW={nW} bf16",
                      lambda: window_msa.window_attention_qkv(qkv, bias, H))
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
            b_ms, b_by = bound_ms(nbytes, 10 * N * N * hd * nW * H,
                                  flop_rate(dt))
            name = "f32" if dt == torch.float32 else "bf16"
            log(f"[k2] {label:12s} nW={nW:5d} N={N} H={H:2d} hd={hd} "
                f"{name:4s} dqkv_err={err_q:.3e} dbias_err={err_b:.3e} "
                f"(|dbias| max {r_dbias.abs().max().item():.3e}) "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
            if label in ("base b0", "base b3") and dt == torch.bfloat16:
                log_split("k2-split", f"{label} nW={nW} bf16",
                          lambda: window_msa.window_attention_qkv_bwd(
                              qkv, bias, dout, H))
            if label == "base b0" and dt == torch.bfloat16:
                record = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by,
                              shape=f"nW={nW},N={N},H={H},hd={hd},bf16")
    # Odd row widths (no model has one): bf16 rows that start mid-word,
    # alternating, and N = 16 (one slab); a head range equals the whole.
    for nW, N, H, hd in ((70, 49, 1, 33), (35, 49, 3, 39), (7, 16, 5, 9)):
        C = H * hd
        for dt in (torch.float32, torch.bfloat16):
            qkv = torch.randn(nW, N, 3 * C, device="cuda", generator=g).to(dt)
            dout = torch.randn(nW, N, C, device="cuda", generator=g).to(dt)
            bias = torch.randn(H, N, N, device="cuda", generator=g)
            dqkv, dbias = window_msa.window_attention_qkv_bwd(qkv, bias, dout,
                                                              H)
            part, _ = window_msa.window_attention_qkv_bwd(
                qkv, bias, dout, H, heads=(H - 1, 1))
            torch.cuda.synchronize()
            r_dqkv, r_dbias = window_msa.window_attention_qkv_bwd_reference(
                qkv, bias, dout, H)
            tol = F32_ATOL if dt == torch.float32 else BF16_TOL
            torch.testing.assert_close(dqkv.float(), r_dqkv.float(),
                                       atol=tol, rtol=tol)
            torch.testing.assert_close(dbias, r_dbias, atol=DBIAS_TOL,
                                       rtol=DBIAS_TOL)
            last = [slice(t * C + (H - 1) * hd, (t + 1) * C) for t in range(3)]
            assert all(torch.equal(part[..., c], dqkv[..., c]) for c in last)
            log(f"[k2] odd width nW={nW} N={N} H={H} hd={hd} "
                f"{'f32' if dt == torch.float32 else 'bf16'}: dqkv_err="
                f"{(dqkv.float() - r_dqkv.float()).abs().max().item():.3e}, "
                f"last head alone bit for bit")
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

    cfg = get_variant("hrformer_base")
    assert cfg.model.compute_dtype == "bfloat16" and cfg.eval.flip_test
    inf = PoseInference(cfg, device="cuda")
    frames, bboxes = make_requests(8, seed=1)

    reset_launches()
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
    count = window_msa.LAUNCHES
    fused = launches()
    assert fused["k4"] == fused["k5"] == fused["k2"] == 0, fused
    compare_f32_serving(inf.model.state_dict(), frames, bboxes, "slice",
                        HEATMAP_ATOL, KEYPOINT_ATOL_PX)
    return inf, count


def _unsure_keypoints(hm: torch.Tensor, head: str) -> np.ndarray:
    """(B, K) keypoints whose decode of the flip-averaged heatmaps ``hm``
    sits on a tie that a 1e-6 difference may break either way: for the
    fusion head a soft-argmax within 1e-3 of a half-integer (round() moves
    the refine window); for the heatmap head's quarter decode a runner-up
    within 1e-5 of the peak's magnitude, or a neighbour difference within
    that of 0 (the sign of the 0.25 px shift)."""
    from infantposeestimation_gaussianbias_tpu_torch.ops import decode

    if head == "fusion":
        g, _ = decode.soft_argmax(hm)
        return near_half_integer(g.cpu().numpy())
    B, H, W, K = hm.shape
    tol = 1e-5 * hm.abs().amax(dim=(1, 2))
    top2 = hm.permute(0, 3, 1, 2).reshape(B, K, H * W).topk(2, dim=-1).values
    coords, _ = decode.argmax_decode(hm)
    xi, yi = coords[..., 0].long(), coords[..., 1].long()
    g = decode._gather_hm
    dx = g(hm, xi + 1, yi) - g(hm, xi - 1, yi)
    dy = g(hm, xi, yi + 1) - g(hm, xi, yi - 1)
    return ((top2[..., 0] - top2[..., 1] < tol) | (dx.abs() < tol)
            | (dy.abs() < tol)).cpu().numpy()


def compare_f32_serving(sd, frames, bboxes, tag: str, hm_tol: float,
                        kp_tol: float, cfg32=None, fold=None) -> None:
    """float32 serving (hrformer_base unless ``cfg32`` says otherwise) from
    the state dict ``sd`` on the card against the port's plain path on the
    CPU: 3 frames' heatmaps (flip-averaged) and keypoints.  ``fold``:
    PoseInference's (None, the default, folds where the model allows)."""
    from infantposeestimation_gaussianbias_tpu_torch import (PoseInference,
                                                              get_variant)
    from infantposeestimation_gaussianbias_tpu_torch.ops import affine, decode

    if cfg32 is None:
        cfg32 = get_variant("hrformer_base")
        cfg32.model.compute_dtype = "float32"
    assert cfg32.model.compute_dtype == "float32"
    gpu = PoseInference(cfg32, state_dict=sd, device="cuda", fold=fold)
    cpu = PoseInference(cfg32, state_dict={k: v.cpu() for k, v in sd.items()},
                        device="cpu", fold=fold)
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
            unsure = _unsure_keypoints((hm + hm_f) * 0.5,
                                       cfg32.model.head_type)
        hms[name] = (hm.cpu(), unsure)
    hm_err = (hms["cuda"][0] - hms["cpu"][0]).abs().max().item()
    log(f"[{tag}] f32 heatmaps card vs CPU: max_abs_err={hm_err:.3e} "
        f"(|hm| max {hms['cpu'][0].abs().max().item():.3e})")
    assert hm_err <= hm_tol, hm_err
    keep = ~(hms["cuda"][1] | hms["cpu"][1])
    kp_err = float(np.abs(k_gpu - k_cpu)[keep].max())
    log(f"[{tag}] f32 keypoints card vs CPU: max_abs_err={kp_err:.3e} px, "
        f"left out {int((~keep).sum())} of {keep.size} on a decode tie; "
        f"scores max_abs_err={float(np.abs(s_gpu - s_cpu).max()):.3e}")
    assert keep.any()
    assert kp_err <= kp_tol, kp_err


def phase_throughput(inf, smi: str, tag: str = "throughput") -> dict:
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
    log(f"[{tag}] bf16 predict_batch b=32 flip: "
        f"{result['crops_per_s']:.1f} crops/s (median {med * 1e3:.1f} ms over "
        f"{len(times)} batches); b=1: {result['batch1_ms']:.1f} ms; on {smi}")
    return result


# -- K4 and K5, the fused half-blocks -------------------------------------------

def _half_inputs(Hm: int, Wm: int, C: int, heads: int, B: int, dt, g,
                 ws: int = 7) -> dict:
    """Seeded inputs of both halves of one hrformer_base block on an
    (Hm, Wm) map at batch B, windows of ws (7 or 8), a DropPath vector
    that drops about a fifth of the samples."""
    N = ws * ws
    nwin = -(-Hm // ws) * -(-Wm // ws)
    nW, Hd = B * nwin, 4 * C

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * scale

    return dict(
        xw=rn(nW, N, C).to(dt), gamma=1 + 0.2 * rn(C), beta=0.1 * rn(C),
        wqkv=rn(C, 3 * C, scale=C ** -0.5).to(dt), bqkv=0.1 * rn(3 * C),
        rpe=rn(heads, N, N), wproj=rn(C, C, scale=C ** -0.5).to(dt),
        bproj=0.1 * rn(C), w1=rn(C, Hd, scale=C ** -0.5).to(dt),
        b1=0.1 * rn(Hd), w2=rn(Hd, C, scale=Hd ** -0.5).to(dt),
        b2=0.1 * rn(C),
        dp=(torch.rand(B, device="cuda", generator=g) > 0.2).float() / 0.8,
        dy=rn(nW, N, C).to(dt), heads=heads, geom=(Hm, Wm, ws),
        tps=nwin * N, nW=nW, C=C, Hd=Hd, N=N)


def _attn_args(a: dict) -> tuple:
    return (a["xw"], a["gamma"], a["beta"], a["wqkv"], a["bqkv"], a["rpe"],
            a["wproj"], a["bproj"], a["dp"])


def _mlp_args(a: dict) -> tuple:
    return (a["xw"].reshape(-1, a["C"]), a["gamma"], a["beta"], a["w1"],
            a["b1"], a["w2"], a["b2"], a["dp"])


def mlp_chain(x2, gamma, beta, w1, b1, w2, b2, dp, tps):
    """K5's function as stock PyTorch ops in x's dtype (the yardstick):
    LayerNorm, F.linear, tanh GELU, F.linear, DropPath residual."""
    dt, C = x2.dtype, x2.shape[1]
    rows = dp[torch.arange(x2.shape[0], device=x2.device) // tps][:, None]
    h = F.linear(F.layer_norm(x2, (C,), gamma.to(dt), beta.to(dt), 1e-5),
                 w1.t(), b1.to(dt))
    o = F.linear(F.gelu(h, approximate="tanh"), w2.t(), b2.to(dt))
    return x2 + rows.to(dt) * o


def attn_chain(xw, gamma, beta, wqkv, bqkv, rpe, wproj, bproj, dp, heads,
               geom):
    """K4's function as stock PyTorch ops in x's dtype (the yardstick):
    LayerNorm, F.linear, the pad tokens' bias rows, SDPA with the relative
    position bias as its mask, F.linear, DropPath residual."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import (
        fused_block as fb)

    nW, N, C = xw.shape
    dt = xw.dtype
    nwin = fb.window_geometry(geom)[0]
    valid = fb.valid_tokens(nW, N, geom, xw.device)
    qkv = torch.where(valid, F.linear(
        F.layer_norm(xw, (C,), gamma.to(dt), beta.to(dt), 1e-5), wqkv.t(),
        bqkv.to(dt)), bqkv.to(dt))
    q, k, v = qkv.reshape(nW, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(
        q, k, v, attn_mask=rpe.to(dt)[None].expand(nW, heads, N, N))
    po = F.linear(o.transpose(1, 2).reshape(nW, N, C), wproj.t(),
                  bproj.to(dt))
    rows = dp[torch.arange(nW, device=xw.device) // nwin][:, None, None]
    return xw + rows.to(dt) * po


def _grad_fn(fn, args, n_leaves, extra, dy):
    """A call of autograd's backward through ``fn`` (graph built once)."""
    leaves = [t.detach().clone().requires_grad_() if i < n_leaves else t
              for i, t in enumerate(args)]
    out = fn(*leaves, *extra)
    return lambda: torch.autograd.grad(out, leaves[:n_leaves], dy,
                                       retain_graph=True)


def _err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float, float]:
    """(max abs error, relative norm of the difference, largest |ref|)."""
    a, b = out.float(), ref.float()
    assert a.shape == b.shape and bool(torch.isfinite(a).all())
    d = a - b
    return (d.abs().max().item(),
            (d.norm() / b.norm().clamp_min(1e-30)).item(),
            b.abs().max().item())


def _compare(tag: str, names, outs, refs, dt) -> tuple[float, float]:
    """Each output against the plain version's (FUSED_REL_TOL,
    FUSED_LOCAL_TOL); returns the worst (max abs, relative norm) error."""
    worst_abs = worst_rel = 0.0
    for name, a, b in zip(names, outs, refs):
        err, rel, big = _err(a, b)
        assert rel <= FUSED_REL_TOL[dt] and err <= FUSED_LOCAL_TOL * big, (
            tag, name, rel, err, big)
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    return worst_abs, worst_rel


def phase_fused_kernels() -> dict:
    """K4 and K5, forward and backward, against their plain versions at
    every hrformer_base branch shape: forward at the serving batch, forward
    and backward at the training batch, float32 and bf16; kernel, plain
    and stock-chain times and the bound (bf16 tensor-core rate)."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import (
        fused_block as fb)

    g = torch.Generator(device="cuda").manual_seed(9)
    rec = {k: dict(max_abs_err=0.0, max_rel_err=0.0)
           for k in ("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd")}
    fwd_names = ["y"]
    attn_names = ["dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "drpe",
                  "dwproj", "dbproj"]
    mlp_names = ["dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"]

    def measure(key, label, what, fn, plain, chain, names, nbytes, flops, dt,
                record):
        outs = fn()
        torch.cuda.synchronize()
        outs = outs if isinstance(outs, tuple) else (outs,)
        refs = plain()
        refs = refs if isinstance(refs, tuple) else (refs,)
        err, rel = _compare(f"{key} {label}", names, outs, refs, dt)
        ms = cuda_median_ms(fn, warmup=2, runs=10)
        plain_ms = cuda_median_ms(plain, warmup=2, runs=10)
        lib_ms = cuda_median_ms(chain, warmup=2, runs=10)
        b_ms, b_by = bound_ms(nbytes, flops, BF16_TC_FLOP_PER_S)
        log(f"[{key}] {label} {what}: max_abs_err={err:.3e} rel={rel:.2e} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
        r = rec[key]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["max_rel_err"] = max(r["max_rel_err"], rel)
        if record:
            r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=b_ms, bound_by=b_by, shape=label)

    # hrformer_base's branches at window 7 (serving and training batch),
    # then at window 8 (N = 64, the training batch; F2 in ROADMAP.md).
    runs = [(label, Hm, Wm, C, heads, B, train, 7)
            for label, Hm, Wm, C, heads in BASE_MAPS
            for B, train in ((SERVE_BATCH, False), (TRAIN_BATCH, True))]
    runs += [(f"{label} ws8", Hm, Wm, C, heads, TRAIN_BATCH, True, 8)
             for label, Hm, Wm, C, heads in BASE_MAPS]
    # batch 2: one flip-tested frame served, or the float32 step of phase 9;
    # K5's plan takes its 64 x 64 tile there (never at the batches above)
    runs += [(label, Hm, Wm, C, heads, SMALL_BATCH, True, 7)
             for label, Hm, Wm, C, heads in BASE_MAPS]
    for label, Hm, Wm, C, heads, B, train, ws in runs:
        for dt in (torch.float32, torch.bfloat16):
            a = _half_inputs(Hm, Wm, C, heads, B, dt, g, ws)
            nW, Hd, geom, N = a["nW"], a["Hd"], a["geom"], a["N"]
            M, es = nW * N, a["xw"].element_size()
            nm = "f32" if dt == torch.float32 else "bf16"
            shape = f"{label} b={B} nW={nW} M={M} C={C} H={heads} {nm}"
            b0_bf16 = (label == "base b0" and dt == torch.bfloat16
                       and B != SMALL_BATCH)
            aa, ma = _attn_args(a), _mlp_args(a)
            vec = 4 * (heads * N * N + 6 * C)
            measure("attn_fwd", shape, "y",
                    lambda: fb.fused_attn_half_fwd(*aa, heads, geom),
                    lambda: fb.fused_attn_half_reference(*aa, heads,
                                                         geom),
                    lambda: attn_chain(*aa, heads, geom), fwd_names,
                    2 * M * C * es + 4 * C * C * es + vec,
                    8 * M * C * C + 4 * nW * N * N * C, dt,
                    b0_bf16 and not train)
            measure("mlp_fwd", shape, "y",
                    lambda: fb.fused_mlp_half_fwd(*ma, a["tps"]),
                    lambda: fb.fused_mlp_half_reference(*ma, a["tps"]),
                    lambda: mlp_chain(*ma, a["tps"]), fwd_names,
                    2 * M * C * es + 2 * C * Hd * es + 4 * (Hd + 3 * C),
                    4 * M * C * Hd, dt, b0_bf16 and not train)
            split_shape = (B == TRAIN_BATCH and ws == 7
                           and dt == torch.bfloat16
                           and label in ("base b0", "base b3"))
            if split_shape:
                log_split("k4fwd-split", shape,
                          lambda: fb.fused_attn_half_fwd(*aa, heads, geom))
                log_split("k5fwd-split", shape,
                          lambda: fb.fused_mlp_half_fwd(*ma, a["tps"]))
            if train:
                dy, dy2 = a["dy"], a["dy"].reshape(-1, C)
                measure("attn_bwd", shape, "all gradients",
                        lambda: fb.fused_attn_half_bwd(*aa, dy, heads,
                                                       geom),
                        lambda: fb.fused_attn_half_bwd_reference(
                            *aa, dy, heads, geom),
                        _grad_fn(attn_chain, aa, 8, (heads, geom), dy),
                        attn_names,
                        3 * M * C * es + 8 * C * C * es + 2 * vec,
                        22 * M * C * C + 12 * nW * N * N * C, dt,
                        b0_bf16)
                if split_shape:
                    log_split("k4bwd-split", shape,
                              lambda: fb.fused_attn_half_bwd(*aa, dy, heads,
                                                             geom))
                measure("mlp_bwd", shape, "all gradients",
                        lambda: fb.fused_mlp_half_bwd(*ma, dy2, a["tps"]),
                        lambda: fb.fused_mlp_half_bwd_reference(
                            *ma, dy2, a["tps"]),
                        _grad_fn(mlp_chain, ma, 7, (a["tps"],), dy2),
                        mlp_names,
                        3 * M * C * es + 4 * C * Hd * es
                        + 8 * (Hd + 3 * C),
                        10 * M * C * Hd, dt, b0_bf16)
                if split_shape:
                    log_split("k5bwd-split", shape,
                              lambda: fb.fused_mlp_half_bwd(*ma, dy2,
                                                            a["tps"]))
            del a, aa, ma
    return rec


def phase_fused_serving(inf, smi: str) -> tuple:
    """The served model with IPE_FUSED_BLOCK=1 and =auto: launches per
    flip-tested batch, float32 card vs CPU, fused vs unfused outputs from
    the same weights, and bf16 crops/s."""
    from infantposeestimation_gaussianbias_tpu_torch.ops import affine

    frames, bboxes = make_requests(8, seed=1)
    per_forward = {"1": dict(k1=0, k4=K1_CALLS_PER_FORWARD,
                             k5=K1_CALLS_PER_FORWARD),
                   "auto": dict(k1=K1_CALLS_PER_FORWARD
                                - AUTO_FUSED_PER_FORWARD,
                                k4=AUTO_FUSED_PER_FORWARD,
                                k5=AUTO_FUSED_PER_FORWARD)}
    total = dict(k1=0, k4=0, k5=0)
    for flag, want in per_forward.items():
        with fused_blocks(flag):
            for n in (1, 3, 8):
                reset_launches()
                t0 = time.perf_counter()
                kpts, scores = inf.predict_batch(frames[:n], bboxes[:n])
                dt = time.perf_counter() - t0
                got = launches()
                log(f"[fused-serve] IPE_FUSED_BLOCK={flag} bf16 batch {n}: "
                    f"{dt * 1e3:.1f} ms, launches K1 {got['k1']} K4 "
                    f"{got['k4']} K5 {got['k5']}")
                assert kpts.shape == (n, 17, 2) and scores.shape == (n, 17)
                assert np.isfinite(kpts).all() and np.isfinite(scores).all()
                assert all(got[k] == 2 * v for k, v in want.items()), got
                assert got["k2"] == got["k4b"] == got["k5b"] == 0, got
                for k in total:
                    total[k] += got[k]
    with fused_blocks("1"):
        compare_f32_serving(inf.model.state_dict(), frames, bboxes,
                            "fused-serve", FUSED_HEATMAP_ATOL,
                            FUSED_KEYPOINT_ATOL_PX)
    # fused against unfused bf16 heatmaps, same weights and crops
    n = 8
    centers = (bboxes[:n, :2] + bboxes[:n, 2:]) / 2
    scales = (bboxes[:n, 2:] - bboxes[:n, :2]) * inf.cfg.data.bbox_padding
    with torch.inference_mode():
        crops = affine.crop_and_normalize(
            torch.from_numpy(frames[:n]).cuda(),
            torch.from_numpy(centers).cuda(), torch.from_numpy(scales).cuda(),
            inf.cfg.data.input_size)
        hms = {}
        for flag in ("0", "1"):
            with fused_blocks(flag):
                hms[flag] = inf.model(crops)["heatmaps"].float()
    diff = (hms["1"] - hms["0"]).abs().max().item()
    big = hms["0"].abs().max().item()
    log(f"[fused-serve] bf16 heatmaps fused vs unfused, same weights: "
        f"max_abs_diff={diff:.3e} (|hm| max {big:.3e}, relative "
        f"{diff / big:.3e})")
    assert diff <= FUSED_VS_UNFUSED_TOL * big, (diff, big)
    with fused_blocks("1"):
        thr = phase_throughput(inf, smi, "fused-throughput")
    return thr, total


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


def train_agreement_f32(tag: str = "train", loss_rtol: float = STEP_LOSS_RTOL,
                        grad_rtol: float = STEP_GRAD_RTOL,
                        stat_tol: float = STEP_STAT_TOL) -> None:
    """One float32 hrformer_base step at b=2, card against CPU."""
    from infantposeestimation_gaussianbias_tpu_torch import (
        create_train_state, get_variant, make_train_step)
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
    log(f"[{tag}] f32 dloss/d(head outputs) card vs CPU, rel err: " + ", ".join(
        f"{k} {_rel(g_out[k], c_out[k]):.1e}" for k in g_out))
    step = make_train_step(cfg)
    t0 = time.perf_counter()
    _, m_gpu = step(gpu, batch, None, drop_masks=masks.cuda())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, m_cpu = step(cpu, batch, None, drop_masks=masks)
    t2 = time.perf_counter()
    log(f"[{tag}] f32 b=2 step: card {(t1 - t0) * 1e3:.1f} ms (first call), "
        f"CPU {(t2 - t1) * 1e3:.1f} ms; DropPath kept "
        f"{int(masks.sum())} of {masks.numel()}")
    for k in m_cpu:
        a, b = m_gpu[k].item(), m_cpu[k].item()
        rel = abs(a - b) / max(abs(b), 1e-12)
        log(f"[{tag}] f32 {k:14s} card {a:.7e} cpu {b:.7e} rel {rel:.2e}")
        assert np.isfinite(a) and rel <= loss_rtol, (k, a, b)
    g_params = dict(gpu.model.named_parameters())
    errs = {"rpe_table": [], "qkv_weight": []}
    for name, p in cpu.model.named_parameters():
        if name.endswith("relative_position_bias_table"):
            errs["rpe_table"].append(_rel(g_params[name].grad.cpu(), p.grad))
        elif name.endswith("attn.qkv.weight"):
            errs["qkv_weight"].append(_rel(g_params[name].grad.cpu(), p.grad))
    for kind in ("rpe_table", "qkv_weight"):
        log(f"[{tag}] f32 {kind} gradient rel err, block by block: "
            + " ".join(f"{e:.1e}" for e in errs[kind]))
    assert len(errs["rpe_table"]) == len(errs["qkv_weight"]) == 44
    assert max(errs["rpe_table"] + errs["qkv_weight"]) <= grad_rtol
    compare_bn_stats(gpu.model, cpu.model, stat_tol, tag)


def compare_bn_stats(gpu, cpu, tol: float, tag: str) -> None:
    """Every BatchNorm's running statistics, card model against CPU model,
    atol and rtol ``tol``."""
    from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
        BatchNorm)

    g_mods = dict(gpu.named_modules())
    stat_err = 0.0
    for name, mod in cpu.named_modules():
        if isinstance(mod, BatchNorm):
            for buf in ("running_mean", "running_var"):
                a = getattr(g_mods[name], buf).cpu()
                b = getattr(mod, buf)
                torch.testing.assert_close(a, b, atol=tol, rtol=tol)
                stat_err = max(stat_err, (a - b).abs().max().item())
    log(f"[{tag}] f32 BN running stats max_abs_err={stat_err:.3e}")


def hrformer_cfg():
    from infantposeestimation_gaussianbias_tpu_torch import get_variant

    cfg = get_variant("hrformer_base")
    cfg.train.warmup_epochs = 0  # else the lr stays near warmup_lr = 5e-7
    return cfg


def no_launches() -> dict:
    return dict(k1=0, k2=0, k4=0, k4b=0, k5=0, k5b=0, k6=0, k7=0, k1hm=0,
                k8=0, k3=0, k3b=0, k9=0, k10=0)


def train_bf16(smi: str, cfg, tag: str, want: dict, batch_size: int =
               TRAIN_BATCH, warmup: int = 3, timed: int = 10) -> dict:
    """bf16 steps of ``cfg`` at b = ``batch_size`` (32) on one seeded
    batch: finite terms, exactly the kernel launches ``want`` in every
    step, a loss that falls over the ``warmup`` + ``timed`` steps, step
    time, images/s, peak memory and the profile by kernel.  HRFormer runs
    through K1/K2, or K4/K5 in every block under IPE_FUSED_BLOCK=1 (which
    the caller sets); HRNet and LiteHRNet through no kernel of the
    port."""
    from infantposeestimation_gaussianbias_tpu_torch import (
        create_train_state, make_train_step)
    assert cfg.model.compute_dtype == "bfloat16"
    assert cfg.train.global_batch_size == batch_size
    state = create_train_state(cfg, device="cuda")
    step = make_train_step(cfg)
    batch = {k: v.cuda() for k, v in
             make_train_batch(cfg, batch_size, seed=5).items()}
    gen = torch.Generator(device="cuda").manual_seed(6)
    losses, times = [], []
    total = no_launches()
    torch.cuda.synchronize()
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        _, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = launches()
        assert got == want, got
        for k in total:
            total[k] += got[k]
        values = {k: v.item() for k, v in metrics.items()}
        assert all(np.isfinite(v) for v in values.values()), values
        losses.append(values["total_loss"])
        log(f"[{tag}] bf16 b={batch_size} step {i}: "
            f"{times[-1] * 1e3:.1f} ms, launches "
            + " ".join(f"{k.upper()} {v}" for k, v in got.items() if v)
            + ", " + " ".join(f"{k}={v:.6g}" for k, v in values.items()))
    peak = torch.cuda.max_memory_allocated()
    assert losses[-1] < losses[0], losses
    med = float(np.median(times[warmup:]))
    result = dict(step_ms=med * 1e3, images_per_s=batch_size / med,
                  peak_gib=peak / 2 ** 30, loss_first=losses[0],
                  loss_last=losses[-1], launches=total, card=smi)
    log(f"[{tag}] bf16 b={batch_size}: median step {med * 1e3:.1f} ms over "
        f"{timed} steps after {warmup} warm-up, {result['images_per_s']:.1f} "
        f"images/s, peak memory {result['peak_gib']:.2f} GiB; total loss "
        f"{losses[0]:.6g} -> {losses[-1]:.6g} over {len(losses)} steps; "
        f"on {smi}")
    result.update(profile_steps(lambda: step(state, batch, gen),
                                result["step_ms"], tag=tag))
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


def fused_train_ws8() -> dict:
    """One fused bf16 hrformer_base step at window 8 (N = 64) at b = 32,
    the configuration ROADMAP.md's F2 said could not train: 44 launches of
    each of K4 and K5, forward and backward, and finite terms."""
    from infantposeestimation_gaussianbias_tpu_torch import (
        create_train_state, make_train_step)

    cfg = hrformer_cfg()
    cfg.model.hrformer_window_size = 8
    state = create_train_state(cfg, device="cuda")
    batch = {k: v.cuda() for k, v in
             make_train_batch(cfg, TRAIN_BATCH, seed=5).items()}
    gen = torch.Generator(device="cuda").manual_seed(6)
    reset_launches()
    t0 = time.perf_counter()
    _, metrics = make_train_step(cfg)(state, batch, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = launches()
    values = {k: v.item() for k, v in metrics.items()}
    log(f"[fused-train] window 8 bf16 b={TRAIN_BATCH} one step: {ms:.1f} ms "
        f"(first call), launches "
        + " ".join(f"{k.upper()} {v}" for k, v in got.items() if v)
        + ", " + " ".join(f"{k}={v:.6g}" for k, v in values.items()))
    n = K1_CALLS_PER_FORWARD
    assert got == dict(no_launches(), k4=n, k4b=n, k5=n, k5b=n), got
    assert all(np.isfinite(v) for v in values.values()), values
    return dict(first_step_ms=ms, launches=got)


def launch_device_ms(fn, runs: int = 10) -> float:
    """Device time of one call of ``fn`` (one kernel), the median over
    ``runs`` calls: CUDA events around the call, queued behind a spin
    kernel so that the host's cost of issuing the call passes while the
    card is busy and not between the events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)  # ~0.5 ms of clock cycles
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profile_steps(run, step_ms: float, n: int = 2, tag: str = "train",
                  what: str = "step") -> dict:
    """Device kernel time of ``n`` calls of ``run`` (a train step or a
    served batch), by kernel (torch.profiler), against the unprofiled
    median time of one call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
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
    log(f"[profile] bf16 {tag} {what}: {device_ms:.1f} ms of device kernels "
        f"({kernels} kernels) per {what} against the {step_ms:.1f} ms median "
        f"{what}: idle share {max(0.0, 1 - device_ms / step_ms):.1%}")
    for us, count, key in rows[:25]:
        log(f"[profile] {tag} {us / 1e3 / n:8.3f} ms/{what} "
            f"{us / 1e3 / n / device_ms:6.1%} x{count // n:5d}/{what}  "
            f"{key[:100]}")
    return dict(device_ms=device_ms, kernels_per_step=kernels)


# -- K7 and K6, the HRNet kernels, and HRNet-W32 ------------------------------

def _random_blocks(C: int, dt, g, n: int = 4) -> list:
    """``n`` eval BasicBlocks of width C in compute dtype ``dt`` on the
    card, kaiming-scaled seeded weights and non-trivial BatchNorms."""
    from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
        BasicBlock)

    def rn(shape):
        return torch.randn(shape, device="cuda", generator=g)

    blocks = [BasicBlock(C, compute_dtype=dt).cuda().eval() for _ in range(n)]
    with torch.no_grad():
        for blk in blocks:
            for conv, bn in ((blk.conv1, blk.bn1), (blk.conv2, blk.bn2)):
                conv.weight.copy_(rn(conv.weight.shape) * (2 / (9 * C)) ** 0.5)
                bn.weight.copy_(1 + 0.2 * rn((C,)))
                bn.bias.copy_(0.1 * rn((C,)))
                bn.running_mean.copy_(0.1 * rn((C,)))
                bn.running_var.copy_(
                    torch.rand((C,), device="cuda", generator=g) + 0.5)
    return blocks


def _chain_bound(x: torch.Tensor, w: torch.Tensor, n: int):
    """K7's least time: x read and the output written once, the weights
    and affines read once; 2n convs of 2 * pixels * 9C * C FLOPs at the
    weights' rate (bf16 tensor cores or float32 CUDA cores)."""
    B, H, W, C = x.shape
    nbytes = (2 * x.numel() * x.element_size() + w.numel() * w.element_size()
              + 2 * n * 2 * C * 4)
    return bound_ms(nbytes, 2 * n * 2 * B * H * W * 9 * C * C,
                    flop_rate(w.dtype))


def phase_k7() -> dict:
    """K7 against its plain version at every hrnet_w32 and hrnet_w48
    branch shape at the served batch, float32 and bf16; kernel, plain and
    stock-chain times (four eval BasicBlocks) and the bound; at hrnet_w32's
    branches in bf16 a ``[k7-split]`` line (the conv launches' device ms
    per chain call) and the stock chain's device ms beside its event ms."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import (
        residual_block as rb)

    g = torch.Generator(device="cuda").manual_seed(10)
    record, worst, worst_rel = None, 0.0, 0.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, H, W, C in HRNET_MAPS + HRNET_W48_MAPS:
        x32 = torch.randn(HRNET_SERVE_BATCH, H, W, C, device="cuda",
                          generator=g)
        for dt in (torch.float32, torch.bfloat16):
            blocks = _random_blocks(C, dt, g)
            w, ab = rb.pack_basic_block_params(blocks, dtype=dt)
            x = x32.to(dt)
            out = rb.fused_residual_chain(x, w, ab, 4)
            torch.cuda.synchronize()
            ref = rb.fused_residual_chain_reference(x, w, ab, 4)
            err, rel, big = _err(out, ref)
            rel_tol, local_tol = K7_TOL[dt]
            assert rel <= rel_tol and err <= local_tol * big, (
                label, dt, rel, err, big)

            def stock():
                with torch.no_grad():
                    y = x
                    for blk in blocks:
                        y = blk(y)
                return y

            _, rel_stock, _ = _err(out, stock())
            if dt == torch.float32:  # the same function, no roundings
                assert rel_stock <= rel_tol, (label, rel_stock)
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
            runs = 25 if label.startswith("w32") else 10
            ms = cuda_median_ms(lambda: rb.fused_residual_chain(x, w, ab, 4),
                                runs=runs)
            plain_ms = cuda_median_ms(
                lambda: rb.fused_residual_chain_reference(x, w, ab, 4),
                runs=runs)
            lib_ms = cuda_median_ms(stock, runs=runs)
            b_ms, b_by = _chain_bound(x, w, 4)
            name = "f32" if dt == torch.float32 else "bf16"
            shape = f"{label} b={HRNET_SERVE_BATCH} {H}x{W}x{C} {name}"
            plan = (rb.chain_plan(HRNET_SERVE_BATCH, H, W, C, sms)
                    if dt == torch.bfloat16 else None)
            log(f"[k7] {shape}: max_abs_err={err:.3e} rel={rel:.2e} "
                f"(vs stock chain rel {rel_stock:.2e}) kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by})"
                + ("" if plan is None else
                   f"; plan rows={plan['rows']} slots={plan['slots']} "
                   f"tco={plan['tco']} parts={plan['parts']} "
                   f"whole={plan['whole']} blocks={plan['blocks']} "
                   f"smem={plan['smem']}"))
            dev_ms = stock_dev_ms = None
            if label.startswith("w32") and dt == torch.bfloat16:
                split = log_split("k7-split", shape,
                                  lambda: rb.fused_residual_chain(x, w, ab, 4))
                # the 8 conv launches of a chain at their mean device time
                # (a record the profiler drops does not lower it)
                conv = [(n, t) for name, n, t in split
                        if name.startswith("conv_tc_kernel")]
                dev_ms = (8 * sum(t for _, t in conv)
                          / max(sum(n for n, _ in conv), 1e-9))
                stock_split = launch_split(stock)
                stock_dev_ms = sum(t for *_, t in stock_split)
                log(f"[k7-split] {shape}: stock chain {stock_dev_ms:.4f} ms "
                    f"device in {sum(n for _, n, _ in stock_split):g} "
                    f"launches (event {lib_ms:.4f} ms); K7 {dev_ms:.4f} ms "
                    f"device (event {ms:.4f} ms)")
            if label == "w32 b0" and dt == torch.bfloat16:
                record = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by, shape=shape,
                              device_ms=dev_ms,
                              library_device_ms=stock_dev_ms)
        # a served frame (b = 1, 2 with flip): the plan's finest tilings
        # and its input-channel parts, bf16
        blocks = _random_blocks(C, torch.bfloat16, g)
        w, ab = rb.pack_basic_block_params(blocks, dtype=torch.bfloat16)
        for B in (1, SMALL_BATCH):
            x = x32[:B].to(torch.bfloat16).contiguous()
            out = rb.fused_residual_chain(x, w, ab, 4)
            torch.cuda.synchronize()
            err, rel, big = _err(
                out, rb.fused_residual_chain_reference(x, w, ab, 4))
            rel_tol, local_tol = K7_TOL[torch.bfloat16]
            assert rel <= rel_tol and err <= local_tol * big, (
                label, B, rel, err, big)
            plan = rb.chain_plan(B, H, W, C, sms)
            log(f"[k7] {label} b={B} {H}x{W}x{C} bf16: max_abs_err="
                f"{err:.3e} rel={rel:.2e}; plan rows={plan['rows']} "
                f"slots={plan['slots']} tco={plan['tco']} "
                f"parts={plan['parts']} blocks={plan['blocks']}")
    record.update(max_abs_err=worst, max_rel_err=worst_rel)
    return record


def hrnet_conv3x3_shapes(head: str = "fusion", device: str = "cuda") -> list:
    """(H, W, Ci, Co) of every distinct stride-1 3x3 conv of hrnet_w32 +
    ``head`` at 256x192, in the order the forward meets them (hooks on a
    forward at b=1 on ``device``)."""
    from infantposeestimation_gaussianbias_tpu_torch import Config
    from infantposeestimation_gaussianbias_tpu_torch.models import (
        build_model)
    from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
        Conv2d)

    cfg = Config()
    cfg.model.head_type = head
    model = build_model(cfg, device)
    shapes = []

    def hook(mod, inp, out):
        shape = (*inp[0].shape[1:], mod.out_channels)
        if shape not in shapes:
            shapes.append(shape)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, Conv2d) and m.kernel_size == (3, 3)
               and m.stride == (1, 1)]
    W, H = cfg.data.input_size
    with torch.no_grad():
        model(torch.zeros((1, H, W, 3), device=device))
    for h in handles:
        h.remove()
    return shapes


def _wgrad_bound(x: torch.Tensor, dy: torch.Tensor):
    """K6's least time: x and dy read once, dW written once (float32);
    2 * pixels * 9 Ci * Co FLOPs at the inputs' rate."""
    B, H, W, Ci = x.shape
    Co = dy.shape[-1]
    nbytes = (x.numel() + dy.numel()) * x.element_size() + 9 * Ci * Co * 4
    return bound_ms(nbytes, 2 * B * H * W * 9 * Ci * Co, flop_rate(x.dtype))


def phase_k6() -> tuple:
    """K6 against its plain version at every stride-1 3x3 conv shape of
    hrnet_w32 + fusion at b=32, float32 and bf16; kernel, plain and cuDNN
    (conv2d_weight) times and the bound.  Returns (record, shapes)."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import (
        conv_wgrad as cw)

    shapes = hrnet_conv3x3_shapes()
    log(f"[k6] {len(shapes)} stride-1 3x3 conv shapes (H, W, Ci, Co): "
        f"{shapes}")
    g = torch.Generator(device="cuda").manual_seed(11)
    record, worst, worst_rel = None, 0.0, 0.0
    B = TRAIN_BATCH
    for H, W, Ci, Co in shapes:
        x32 = torch.randn(B, H, W, Ci, device="cuda", generator=g)
        dy32 = torch.randn(B, H, W, Co, device="cuda", generator=g)
        for dt in (torch.float32, torch.bfloat16):
            x, dy = x32.to(dt), dy32.to(dt)
            out = cw.conv3x3_wgrad(x, dy)
            torch.cuda.synchronize()
            ref = cw.conv3x3_wgrad_reference(x, dy)
            err, rel, big = _err(out, ref)
            rel_tol, local_tol = K6_TOL[dt]
            assert rel <= rel_tol and err <= local_tol * big, (
                H, W, Ci, Co, dt, rel, err, big)
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
            xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
            wshape = (Co, Ci, 3, 3)
            runs = 25 if Ci * Co <= 64 * 64 else 7
            ms = cuda_median_ms(lambda: cw.conv3x3_wgrad(x, dy), runs=runs)
            plain_ms = cuda_median_ms(
                lambda: cw.conv3x3_wgrad_reference(x, dy), runs=runs)
            lib_ms = cuda_median_ms(lambda: torch.nn.grad.conv2d_weight(
                xn, wshape, dyn, padding=1), runs=runs)
            b_ms, b_by = _wgrad_bound(x, dy)
            name = "f32" if dt == torch.float32 else "bf16"
            shape = f"b={B} {H}x{W} {Ci}->{Co} {name}"
            log(f"[k6] {shape}: max_abs_err={err:.3e} rel={rel:.2e} "
                f"(|dW| max {big:.3e}) kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by})")
            if ((H, W, Ci, Co) in ((64, 48, 32, 32), (8, 6, 256, 256))
                    and dt == torch.bfloat16):
                log_split("k6-split", shape,
                          lambda: cw.conv3x3_wgrad(x, dy))
            if (H, W, Ci, Co) == (64, 48, 32, 32) and dt == torch.bfloat16:
                record = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by, shape=shape)
    record.update(max_abs_err=worst, max_rel_err=worst_rel)
    return record, shapes


def hrnet_cfg(head: str, dtype: str = "bfloat16"):
    from infantposeestimation_gaussianbias_tpu_torch import Config

    cfg = Config()
    assert cfg.model.backbone == "hrnet_w32"
    cfg.model.head_type = head
    cfg.model.compute_dtype = dtype
    cfg.train.warmup_epochs = 0  # else the lr stays near warmup_lr = 5e-7
    return cfg


def calibrate_batch_stats(model, cfg, steps: int = 20, batch: int = 8,
                          seed: int = 16) -> None:
    """BatchNorm running statistics from ``steps`` train-mode forwards on
    seeded random crops, then eval mode: with the fresh statistics (mean 0,
    var 1) nothing normalises the eval forward of a randomly initialised
    HRNet and its maps grow to ~1e6 through the residual chains.  Momentum
    0.9: the statistics move 1 - 0.9^20 = 88% of the way."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    W, H = cfg.data.input_size
    model.train()
    with torch.no_grad():
        for _ in range(steps):
            model(torch.randn((batch, H, W, 3), device="cuda", generator=g))
    model.eval()


def phase_hrnet_serving(smi: str) -> dict:
    """HRNet-W32 serving with each head: batches of 1, 3 and 8 through no
    kernel of the HRFormer path, float32 card vs CPU, bf16 crops/s at
    b=32; then K7 on every BasicBlock chain of a served batch."""
    from infantposeestimation_gaussianbias_tpu_torch import PoseInference

    frames, bboxes = make_requests(8, seed=12)
    out = {}
    for head in ("heatmap", "fusion"):
        cfg = hrnet_cfg(head)
        assert cfg.eval.flip_test and cfg.eval.decode == "quarter"
        # unfolded: the calibration and K7's hooks read the BatchNorms
        inf = PoseInference(cfg, device="cuda", fold=False)
        calibrate_batch_stats(inf.model, cfg)
        reset_launches()
        for n in (1, 3, 8):
            t0 = time.perf_counter()
            kpts, scores = inf.predict_batch(frames[:n], bboxes[:n])
            dt = time.perf_counter() - t0
            log(f"[hrnet-serve] {head} bf16 batch {n}: {dt * 1e3:.1f} ms")
            assert kpts.shape == (n, 17, 2) and scores.shape == (n, 17)
            assert np.isfinite(kpts).all() and np.isfinite(scores).all()
        assert not any(launches().values()), launches()
        cfg32 = hrnet_cfg(head, "float32")
        compare_f32_serving(inf.model.state_dict(), frames, bboxes,
                            f"hrnet-serve {head}", HEATMAP_ATOL,
                            KEYPOINT_ATOL_PX, cfg32, fold=False)
        out[head] = phase_throughput(inf, smi, f"hrnet-{head}-throughput")
        frames32, bboxes32 = make_requests(32, seed=2)
        out[head].update(profile_steps(
            lambda: inf.predict_batch(frames32, bboxes32),
            out[head]["batch32_ms"], tag=f"hrnet-{head}-serve",
            what="batch"))
        if head == "heatmap":
            out["k7"] = served_chains_k7(inf)
        del inf
    return out


def served_chains_k7(inf) -> dict:
    """One served bf16 batch of 32 with a hook on every BasicBlock chain
    (each branch of each HRModule): K7 on the chain's input with the
    model's packed parameters, against the model's own chain output and
    against K7's plain version.  26 launches per forward, 52 per batch
    (flip test)."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import (
        residual_block as rb)
    from infantposeestimation_gaussianbias_tpu_torch.models.hrnet import (
        HRModule)

    chains = [br for m in inf.model.modules() if isinstance(m, HRModule)
              for br in m.branches]
    assert len(chains) == K7_CHAINS_PER_FORWARD, len(chains)
    packed = {br: rb.pack_basic_block_params(list(br), torch.bfloat16)
              for br in chains}
    stats = dict(model_rel=0.0, plain_rel=0.0, plain_abs=0.0)

    def hook(mod, inp, out):
        x = inp[0].contiguous()
        y = rb.fused_residual_chain(x, *packed[mod], len(mod))
        _, rel_model, _ = _err(y, out)
        err, rel, big = _err(y, rb.fused_residual_chain_reference(
            x, *packed[mod], len(mod)))
        rel_tol, local_tol = K7_TOL[torch.bfloat16]
        assert rel <= rel_tol and err <= local_tol * big, (rel, err, big)
        assert rel_model <= K7_MODEL_REL_TOL, rel_model
        stats["model_rel"] = max(stats["model_rel"], rel_model)
        stats["plain_rel"] = max(stats["plain_rel"], rel)
        stats["plain_abs"] = max(stats["plain_abs"], err)

    handles = [br.register_forward_hook(hook) for br in chains]
    frames, bboxes = make_requests(HRNET_SERVE_BATCH, seed=2)
    try:
        reset_launches()
        kpts, _ = inf.predict_batch(frames, bboxes)
        got = launches()
    finally:
        for h in handles:
            h.remove()
    assert np.isfinite(kpts).all()
    log(f"[hrnet-serve] K7 on every chain of a served bf16 batch of "
        f"{HRNET_SERVE_BATCH} (flip test): {got['k7']} launches; against "
        f"the model's own chains rel <= {stats['model_rel']:.2e}; against "
        f"the plain version rel <= {stats['plain_rel']:.2e}, max_abs_err "
        f"{stats['plain_abs']:.3e}")
    assert got == dict(dict.fromkeys(got, 0),
                       k7=2 * K7_CHAINS_PER_FORWARD), got
    return dict(launches=got["k7"], **stats)


def conv_train_agreement_f32(cfg, tag: str) -> None:
    """One float32 step of a conv net (hrnet_w32 + heatmap in phase 13,
    the lightweight config in phase 28) at b=2, card against CPU: each
    loss term, grad_norm, the whole gradient vector by HRNet's bound and
    the BatchNorm statistics."""
    from infantposeestimation_gaussianbias_tpu_torch import (
        create_train_state, make_train_step)

    assert cfg.model.compute_dtype == "float32"
    gpu = create_train_state(cfg, device="cuda")
    cpu = create_train_state(cfg, device="cpu", state_dict={
        k: v.cpu() for k, v in gpu.model.state_dict().items()})
    batch = make_train_batch(cfg, 2, seed=13)
    step = make_train_step(cfg)
    t0 = time.perf_counter()
    _, m_gpu = step(gpu, batch, None)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, m_cpu = step(cpu, batch, None)
    t2 = time.perf_counter()
    log(f"[{tag}] f32 b=2 step: card {(t1 - t0) * 1e3:.1f} ms (first "
        f"call), CPU {(t2 - t1) * 1e3:.1f} ms")
    for k in m_cpu:
        a, b = m_gpu[k].item(), m_cpu[k].item()
        rel = abs(a - b) / max(abs(b), 1e-12)
        log(f"[{tag}] f32 {k:14s} card {a:.7e} cpu {b:.7e} "
            f"rel {rel:.2e}")
        tol = HRNET_STEP_NORM_RTOL if k == "grad_norm" else STEP_LOSS_RTOL
        assert np.isfinite(a) and rel <= tol, (k, a, b)
    g_params = dict(gpu.model.named_parameters())
    diff = ref = 0.0
    per = []
    for name, p in cpu.model.named_parameters():
        d = (g_params[name].grad.cpu() - p.grad).norm().item()
        diff, ref = diff + d * d, ref + p.grad.norm().item() ** 2
        per.append((d / max(p.grad.norm().item(), 1e-30), name))
    rel = (diff / ref) ** 0.5
    per.sort()
    log(f"[{tag}] f32 gradient card vs CPU: whole-vector rel {rel:.2e}; "
        f"per tensor median {per[len(per) // 2][0]:.1e}, largest "
        + ", ".join(f"{n} {e:.1e}" for e, n in per[-3:]))
    assert rel <= HRNET_STEP_GRAD_RTOL, rel
    compare_bn_stats(gpu.model, cpu.model, STEP_STAT_TOL, tag)


def hrnet_fusion_step_k6() -> dict:
    """One bf16 hrnet_w32 + fusion step at b=32 with hooks on every
    stride-1 3x3 conv: finite loss terms; then K6 on each conv's captured
    (input, output gradient) against that conv's weight.grad and against
    K6's plain version, one launch per conv."""
    from infantposeestimation_gaussianbias_tpu_torch import (
        create_train_state, make_train_step)
    from infantposeestimation_gaussianbias_tpu_torch.kernels import (
        conv_wgrad as cw)
    from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
        Conv2d)

    cfg = hrnet_cfg("fusion")
    assert cfg.train.grad_clip_norm == 0 and cfg.train.grad_accum_steps == 1
    state = create_train_state(cfg, device="cuda")
    convs = [(n, m) for n, m in state.model.named_modules()
             if isinstance(m, Conv2d) and m.kernel_size == (3, 3)
             and m.stride == (1, 1)]
    captured = {}

    def hook(mod, inp, out):
        x = inp[0].to(mod.compute_dtype).contiguous()
        out.register_hook(
            lambda g: captured.__setitem__(mod, (x, g.contiguous())))

    handles = [m.register_forward_hook(hook) for _, m in convs]
    batch = make_train_batch(cfg, TRAIN_BATCH, seed=15)
    try:
        _, metrics = make_train_step(cfg)(state, batch, None)
    finally:
        for h in handles:
            h.remove()
    values = {k: v.item() for k, v in metrics.items()}
    assert all(np.isfinite(v) for v in values.values()), values
    assert len(values) == 8, values  # six terms, total_loss, grad_norm
    log("[hrnet-train] bf16 fusion b=32 step: "
        + " ".join(f"{k}={v:.6f}" for k, v in values.items()))
    assert len(captured) == len(convs), (len(captured), len(convs))
    reset_launches()
    outs = [cw.conv3x3_wgrad(*captured[m]) for _, m in convs]
    got = launches()
    assert got == dict(dict.fromkeys(got, 0), k6=len(convs)), got
    worst_grad = worst_plain = 0.0
    for (name, m), dw in zip(convs, outs):
        g = m.weight.grad.permute(2, 3, 1, 0)
        _, rel_grad, _ = _err(dw, g)
        err, rel, big = _err(dw, cw.conv3x3_wgrad_reference(*captured[m]))
        rel_tol, local_tol = K6_TOL[torch.bfloat16]
        assert rel <= rel_tol and err <= local_tol * big, (name, rel, err)
        assert rel_grad <= K6_GRAD_REL_TOL, (name, rel_grad)
        worst_grad = max(worst_grad, rel_grad)
        worst_plain = max(worst_plain, rel)
    log(f"[hrnet-train] K6 on the captured (x, dy) of {len(convs)} stride-1 "
        f"3x3 convs of a bf16 fusion step: {got['k6']} launches; against "
        f"weight.grad rel <= {worst_grad:.2e}; against the plain version "
        f"rel <= {worst_plain:.2e}")
    return dict(launches=got["k6"], convs=len(convs), grad_rel=worst_grad,
                plain_rel=worst_plain)


# -- K1-hm, K8 and the analysis path (phases 14-16) ---------------------------

def phase_k1_hm() -> dict:
    """K1-hm against its plain version at every BRANCH_SHAPES row at
    b = 64, head-major, with and without bias, float32 and bf16; then the
    window-major entry point (relayouts + K1-hm) against flat K1."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import window_msa

    B = 64
    g = torch.Generator(device="cuda").manual_seed(14)
    worst = 0.0
    record = None
    for label, w, N, H, hd in BRANCH_SHAPES:
        nW = B * w
        qkv32 = [torch.randn(H, nW, N, hd, device="cuda", generator=g)
                 for _ in range(3)]
        bias_full = torch.randn(H, N, N, device="cuda", generator=g)
        for with_bias in (True, False):
            bias = bias_full if with_bias else None
            for dt in (torch.float32, torch.bfloat16):
                q, k, v = (x.to(dt) for x in qkv32)
                out = window_msa.window_attention_hm(q, k, v, bias)
                torch.cuda.synchronize()
                ref = window_msa.window_attention_hm_reference(q, k, v, bias)
                if dt == torch.float32:
                    torch.testing.assert_close(out, ref, atol=F32_ATOL,
                                               rtol=0)
                else:
                    torch.testing.assert_close(out.float(), ref.float(),
                                               atol=BF16_TOL, rtol=BF16_TOL)
                err = (out.float() - ref.float()).abs().max().item()
                worst = max(worst, err)
                name = "f32" if dt == torch.float32 else "bf16"
                if not with_bias:
                    log(f"[k1-hm] {label:12s} nW={nW:5d} N={N} H={H:2d} "
                        f"hd={hd} {name:4s} no bias max_abs_err={err:.3e}")
                    continue
                ms = cuda_median_ms(
                    lambda: window_msa.window_attention_hm(q, k, v, bias))
                plain_ms = cuda_median_ms(
                    lambda: window_msa.window_attention_hm_reference(
                        q, k, v, bias))
                # yardstick: SDPA on the head-major tensors, batch H,
                # mask bias[h] broadcast over the windows
                mask = bias.to(dt)[:, None]
                lib_ms = cuda_median_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask))
                nbytes = 4 * H * nW * N * hd * q.element_size() + H * N * N * 4
                b_ms, b_by = bound_ms(nbytes, 4 * N * N * hd * nW * H,
                                      flop_rate(q.dtype))
                log(f"[k1-hm] {label:12s} nW={nW:5d} N={N} H={H:2d} hd={hd} "
                    f"{name:4s} max_abs_err={err:.3e} kernel_ms={ms:.4f} "
                    f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                    f"bound_ms={b_ms:.4f} ({b_by})")
                if label == "base b0" and dt == torch.bfloat16:
                    record = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                  bound_ms=b_ms, bound_by=b_by,
                                  shape=f"H={H},nW={nW},N={N},hd={hd},bf16")
    record["max_abs_err"] = worst
    record.update(relayout_vs_flat())
    return record


def relayout_vs_flat() -> dict:
    """The window-major entry point ``window_attention_wm`` fed from the
    model's flat qkv (split views, relayout copies to head-major, K1-hm,
    the output back to (nW, N, C)) against K1 on the flat qkv at every
    BRANCH_SHAPES row at b = 64, float32 and bf16: the card's reading of
    the TPU finding that the relayout copies cost more than the fusion
    saved (window_msa.py:232-235).  The path equals K1 bit for bit (one
    kernel, two stagings of the same operands).  K1-hm's launches on this
    path are the record's count."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import window_msa

    def wm_path(qkv, bias, H):
        nW, N, C3 = qkv.shape
        C = C3 // 3
        q, k, v = qkv.view(nW, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        out = window_msa.window_attention_wm(q, k, v, bias)
        return out.permute(0, 2, 1, 3).reshape(nW, N, C)

    g = torch.Generator(device="cuda").manual_seed(15)
    cases = []
    for label, w, N, H, hd in BRANCH_SHAPES:
        qkv32 = torch.randn(64 * w, N, 3 * H * hd, device="cuda", generator=g)
        bias = torch.randn(H, N, N, device="cuda", generator=g)
        for dt in (torch.float32, torch.bfloat16):
            cases.append((label, qkv32.to(dt), bias, H))
    reset_launches()
    outs = [wm_path(qkv, bias, H) for _, qkv, bias, H in cases]
    torch.cuda.synchronize()
    hm_launches = window_msa.HM_LAUNCHES
    assert hm_launches == len(cases), hm_launches
    rows = []
    for (label, qkv, bias, H), out in zip(cases, outs):
        flat = window_msa.window_attention_qkv(qkv, bias, H)
        torch.cuda.synchronize()
        same = torch.equal(out, flat)
        assert same, f"window-major path is not K1 bit for bit at {label}"
        nW, N, C3 = qkv.shape
        qh, kh, vh = (qkv.view(nW, N, 3, H, C3 // 3 // H)[:, :, i]
                      .permute(2, 0, 1, 3).contiguous() for i in range(3))
        flat_ms = cuda_median_ms(
            lambda: window_msa.window_attention_qkv(qkv, bias, H))
        wm_ms = cuda_median_ms(lambda: wm_path(qkv, bias, H))
        hm_ms = cuda_median_ms(
            lambda: window_msa.window_attention_hm(qh, kh, vh, bias))
        name = "f32" if qkv.dtype == torch.float32 else "bf16"
        log(f"[relayout] {label:12s} {name:4s} flat K1 {flat_ms:.4f} ms; "
            f"window-major path {wm_ms:.4f} ms = K1-hm {hm_ms:.4f} + "
            f"relayouts {wm_ms - hm_ms:.4f}; path/flat "
            f"{wm_ms / flat_ms:.2f}x; bit-equal to K1: {same}")
        rows.append(dict(shape=label, dtype=name, flat_ms=flat_ms,
                         wm_path_ms=wm_ms, hm_ms=hm_ms, bit_equal=same))
    return dict(relayout=rows, path_launches=hm_launches)


def k8_flops(variant: str, nW: int, N: int, H: int, hd: int) -> float:
    """A variant's useful float32 operations: the products 4 N^2 hd per
    (window, head), the softmax 5 N^2 (bias add, max, subtract, exp, sum),
    the normalisation N hd; packslim's useful work is full's (its
    cross-window scores are thrown away)."""
    products, softmax, norm = 4 * N * N * hd, 5 * N * N, N * hd
    per = {"empty": 0, "gemmonly": products, "softonly": softmax + norm,
           "full": products + softmax + norm,
           "packslim": products + softmax + norm}[variant]
    return float(per * nW * H)


def phase_k8() -> dict:
    """K8: every variant of the plan against its plain version, ``full``
    equal to K1 bit for bit (K1's own kernel); then the port's probe
    ``main()`` at its default shape and at hrformer_base b0-b3 at b = 64
    (launches counted over those runs: the probe captures its launches in
    CUDA graphs, so a graph's replays add none), the phase shares of K1's
    kernel, the bound and the plain version's time of each variant, and
    each variant's device time per launch beside the probe's time."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import (
        window_msa, window_msa_ablate as ablate)
    from infantposeestimation_gaussianbias_tpu_torch.tools import (
        probe_wmsa_ablate as probe)

    shapes = [("default", probe.DEFAULT_SHAPE)] + [
        (label, f"{64 * w},{N},{H * hd},{H}")
        for label, w, N, H, hd in BRANCH_SHAPES[:4]]

    def bias_of(variant, bias, H, N, C):
        """The bias a variant takes: packslim's packed once, as the probe
        packs it."""
        return (ablate.packed_bias(bias, ablate.pack_factor(H, C, N))
                if variant == "packslim" else bias)

    # The kernel's own shared-memory reckoning: a block stages one window
    # (packslim one group of G) at a time, so every windows-per-block value
    # fits at 49 tokens and hd 32 (K1's ~40 KB; packslim's 196 rows ~94 KB).
    assert all(ablate.fits("full", 49, 32, wpb)
               for wpb in ablate.WINDOWS_PER_BLOCK)
    assert ablate.fits("packslim", 49, 32, 4, 4)
    worst = 0.0
    for label, shape in shapes:
        nW, N, C, H = (int(v) for v in shape.split(","))
        qkv, bias = probe.make_inputs(nW, N, C, H, "cuda")
        k1 = window_msa.window_attention_qkv(qkv, bias, H)
        for variant, wpb in probe.plan(nW, N, C, H, 1, ablate.fits):
            b = bias_of(variant, bias, H, N, C)
            out = ablate.window_attention_ablate(variant, qkv, b, H, wpb)
            torch.cuda.synchronize()
            ref = ablate.ablate_reference(variant, qkv, b, H)
            err = (out.float() - ref.float()).abs().max().item()
            if variant == "empty":
                assert torch.equal(out, ref), (label, variant, wpb)
            else:
                torch.testing.assert_close(out.float(), ref.float(),
                                           atol=BF16_TOL, rtol=BF16_TOL)
            if variant == "full":  # K1's own instantiation
                assert torch.equal(out, k1), (label, wpb)
            worst = max(worst, err)
            vs_k1 = (out.float() - k1.float()).abs().max().item()
            log(f"[k8] {label:8s} {variant:8s} wpb={wpb} max_abs_err={err:.3e}"
                + (f" vs K1 {vs_k1:.3e} (bit-equal: {torch.equal(out, k1)})"
                   if variant == "full" else ""))
    reset_launches()
    runs = []
    for label, shape in shapes:
        with env_var("PROBE_SHAPE", shape):
            runs.append((label, shape, probe.main()))
    launches = ablate.ABLATE_LAUNCHES
    assert launches > 0
    per_shape = []
    for label, shape, rows in runs:
        nW, N, C, H = (int(v) for v in shape.split(","))
        hd = C // H
        qkv, bias = probe.make_inputs(nW, N, C, H, "cuda")
        ms = {(r["variant"], r["windows_per_block"]): r["ms"] for r in rows}
        nbytes = nW * N * 4 * C * qkv.element_size()
        G = ablate.pack_factor(H, C, N)
        bounds, plain, device = {}, {}, {}
        for variant in ablate.VARIANTS:
            b = bias_of(variant, bias, H, N, C)
            bounds[variant] = bound_ms(nbytes, k8_flops(variant, nW, N, H,
                                                        hd),
                                       flop_rate(qkv.dtype))[0]
            plain[variant] = cuda_median_ms(
                lambda: ablate.ablate_reference(variant, qkv, b, H),
                runs=10)
            wpb = G if variant == "packslim" else 1
            if (variant, wpb) in ms:
                device[variant] = launch_device_ms(
                    lambda: ablate.window_attention_ablate(variant, qkv, b,
                                                           H, wpb))
        e, f = ms[("empty", 1)], ms[("full", 1)]
        shares = {"staging": e, "products": ms[("gemmonly", 1)] - e,
                  "softmax": ms[("softonly", 1)] - e}
        sets = max(shares, key=shares.get)
        log(f"[k8-phases] {label:8s} nW={nW} N={N} C={C} H={H}: staging "
            f"{shares['staging']:.4f} ms, products {shares['products']:.4f}, "
            f"softmax {shares['softmax']:.4f}, full {f:.4f}, packslim "
            f"(G={G}) {ms.get(('packslim', G), float('nan')):.4f}; "
            f"{sets} sets the time of K1's kernel")
        log(f"[k8-bounds] {label:8s} " + " ".join(
            f"{v}={bounds[v]:.4f}/plain {plain[v]:.4f}"
            for v in ablate.VARIANTS))
        log(f"[k8-device] {label:8s} probe (graph replays) / one launch "
            "behind a spin kernel, ms: " + ", ".join(
                f"{v} {ms[(v, G if v == 'packslim' else 1)]:.4f} / {t:.4f}"
                for v, t in device.items()))
        per_shape.append(dict(shape=label, nW=nW, N=N, C=C, H=H, G=G,
                              ms={f"{v}@{w}": t for (v, w), t in ms.items()},
                              bound_ms=bounds, plain_ms=plain,
                              device_ms=device, shares=shares, sets=sets))
    rec = per_shape[0]
    nW, N, C, H = rec["nW"], rec["N"], rec["C"], rec["H"]
    qkv, bias = probe.make_inputs(nW, N, C, H, "cuda")
    q, k, v = (_heads(qkv[..., i * C:(i + 1) * C], H) for i in range(3))
    mask = bias.to(qkv.dtype)[None]
    lib_ms = cuda_median_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask))
    b_ms, b_by = bound_ms(nW * N * 4 * C * 2, k8_flops("full", nW, N, H,
                                                         C // H),
                          flop_rate(qkv.dtype))
    record = dict(ms=rec["ms"]["full@1"], plain_ms=rec["plain_ms"]["full"],
                  library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                  max_abs_err=worst,
                  shape=f"nW={nW},N={N},C={C},H={H},bf16 (full@1)",
                  variants_ms=rec["ms"], variants_bound_ms=rec["bound_ms"],
                  variants_plain_ms=rec["plain_ms"],
                  variants_device_ms=rec["device_ms"])
    return dict(record=record, launches=launches, per_shape=per_shape)


# Saliency card vs CPU (float32, TF32 off): the input gradient of a heatmap
# peak through 44 blocks and the stem's BatchNorms, in another summation
# order; a ReLU input on the other side of 0 moves every gradient below it
# by ~1e-3 relative (ROADMAP Queue 3, ReLU ties).  Relative norm.
SALIENCY_RTOL = 1e-2
# Grad-CAM: features from the forward (card vs CPU ~1e-6) weighted by the
# head's gradient (a few convs, BatchNorms and ReLUs, the same ties), the
# map normalised to 1; largest element difference.
CAM_ATOL = 5e-3
# Occlusion: differences of forward peaks, each agreeing to ~1e-6 of the
# heatmaps' scale (HEATMAP_ATOL above is the served maps' bound).
OCCLUSION_ATOL = HEATMAP_ATOL


def phase_analysis(smi: str) -> dict:
    """benchmark_model for Config() and hrformer_base (bf16, b = 32) with
    launch counts; saliency, Grad-CAM and occlusion on hrformer_base in
    float32, card against the port on the CPU; MC DropPath uncertainty
    with the BatchNorm statistics unchanged."""
    from infantposeestimation_gaussianbias_tpu_torch import Config
    from infantposeestimation_gaussianbias_tpu_torch.analysis import (
        benchmark_model, grad_cam, mc_droppath_uncertainty,
        occlusion_sensitivity, profile_trace, saliency_map)
    from infantposeestimation_gaussianbias_tpu_torch.models import build_model

    out = {}
    warmup, runs = 3, 10
    for name, cfg, k1_per in (("hrnet_w32", Config(), 0),
                              ("hrformer_base", hrformer_cfg(),
                               K1_CALLS_PER_FORWARD)):
        assert cfg.model.compute_dtype == "bfloat16"
        reset_launches()
        stats = benchmark_model(cfg, batch_size=32, warmup=warmup, runs=runs)
        got = launches()
        want = dict(no_launches(), k1=k1_per * (1 + warmup + runs))
        assert got == want, (name, got)
        log(f"[analysis] benchmark_model {name} bf16 b=32: median "
            f"{stats['median_ms']:.2f} ms (mean {stats['mean_ms']:.2f}, min "
            f"{stats['min_ms']:.2f}, max {stats['max_ms']:.2f}), "
            f"{stats['images_per_sec']:.1f} images/s, K1 "
            f"{got['k1'] // (1 + warmup + runs)} per forward; on {smi}")
        out[f"benchmark_{name}"] = dict(stats, k1_per_forward=k1_per)

    cfg = hrformer_cfg()
    cfg.model.compute_dtype = "float32"
    gpu = build_model(cfg, device="cuda")
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    W, H = cfg.data.input_size
    rng = np.random.RandomState(16)
    crop = rng.randn(H, W, 3).astype(np.float32)
    kp = 5
    reset_launches()
    sal = saliency_map(gpu, crop, kp)
    got = launches()
    assert got == dict(no_launches(), k1=K1_CALLS_PER_FORWARD,
                       k2=K1_CALLS_PER_FORWARD), got
    out["saliency_launches"] = got
    sal_cpu = saliency_map(cpu, crop, kp)
    assert sal.shape == (H, W) and np.isfinite(sal).all()
    rel = float(np.linalg.norm(sal - sal_cpu) / np.linalg.norm(sal_cpu))
    log(f"[analysis] saliency f32 card vs CPU: rel {rel:.3e} (bound "
        f"{SALIENCY_RTOL:g}); K1 {got['k1']}, K2 {got['k2']} launches")
    assert rel <= SALIENCY_RTOL, rel

    reset_launches()
    cam = grad_cam(gpu, crop, kp)
    got = launches()
    assert got == dict(no_launches(), k1=K1_CALLS_PER_FORWARD), got
    cam_cpu = grad_cam(cpu, crop, kp)
    cam_err = float(np.abs(cam - cam_cpu).max())
    log(f"[analysis] grad_cam f32 {cam.shape} card vs CPU: max_abs_err "
        f"{cam_err:.3e} (bound {CAM_ATOL:g}); K1 {got['k1']} launches")
    assert np.isfinite(cam).all() and cam_err <= CAM_ATOL, cam_err

    t0 = time.perf_counter()
    occ = occlusion_sensitivity(gpu, crop, kp, patch=64, stride=64)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    occ_cpu = occlusion_sensitivity(cpu, crop, kp, patch=64, stride=64)
    t_cpu = time.perf_counter() - t0
    occ_err = float(np.abs(occ - occ_cpu).max())
    log(f"[analysis] occlusion f32 {occ.shape} (patch 64, stride 64) card vs "
        f"CPU: max_abs_err {occ_err:.3e} (bound {OCCLUSION_ATOL:g}); "
        f"{t_gpu:.2f} s on the card, {t_cpu:.2f} s on the CPU")
    assert occ_err <= OCCLUSION_ATOL, occ_err

    # profile_trace on the card: a Chrome trace (in a temporary directory,
    # removed after) whose device events include K1.
    x = torch.from_numpy(crop[None]).cuda()
    with torch.no_grad():
        trace_dir = profile_trace(gpu, x, iters=1)
    try:
        with open(os.path.join(trace_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(trace_dir)
    k1_events = [e for e in events if e.get("cat") == "kernel"
                 and "window_msa_fwd" in e.get("name", "")]
    log(f"[analysis] profile_trace: {len(events)} events, "
        f"{sum(e.get('cat') == 'kernel' for e in events)} device kernels, "
        f"{len(k1_events)} of them K1")
    assert len(k1_events) == K1_CALLS_PER_FORWARD, len(k1_events)

    stats_before = {k: v.clone() for k, v in gpu.state_dict().items()
                    if "running" in k or "num_batches" in k}
    crops = rng.randn(2, H, W, 3).astype(np.float32)
    reset_launches()
    mc = mc_droppath_uncertainty(gpu, crops, torch.Generator().manual_seed(17),
                                 n_samples=4)
    got = launches()
    assert got == dict(no_launches(), k1=4 * K1_CALLS_PER_FORWARD), got
    after = gpu.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in stats_before.items())
    assert np.isfinite(mc["mean"]).all() and np.isfinite(mc["std"]).all()
    assert mc["std"].max() > 0, "DropPath moved nothing"
    assert not gpu.training
    log(f"[analysis] mc_droppath_uncertainty n=4 {mc['mean'].shape}: std "
        f"mean {mc['std'].mean():.3e} max {mc['std'].max():.3e}; "
        f"{len(stats_before)} BatchNorm buffers unchanged")
    out.update(saliency_rel=rel, grad_cam_err=cam_err, occlusion_err=occ_err,
               occlusion_cpu_s=t_cpu)
    return out


# -- K3 and the process grid (phases 17-19) ----------------------------------

# (data, model) ranks: four processes on the one card, gloo (NCCL refuses
# two ranks on one device).  hrformer_base's heads (2/4/8/16) all divide 2,
# so K3 splits the heads at every branch.  A correctness path: the four
# ranks share the card and gloo copies every all-reduce through the host,
# so no time here is a scaling figure.
GRID = (2, 2)
GRID_LABEL = "4 ranks, 1 card, gloo"
GRID_F32_BATCH = 4  # the float32 step against one process (2 rows a rank)
# Tensor parallelism over the model axis (parallel/tensor.py): at model
# axis 2 every hrformer_base Dense and both shared convs of the fusion head
# are cut.  The assembly all-reduces are timed by layer kind beside K3's
# output all-reduce, on one float32 batch of GRID_F32_BATCH frames with
# flip (a diagnosis: gloo copies each through the host, four ranks share
# the card).
GRID_TP_TABLE = 4 * 2 * (1 * 2 + 4 * 3 + 2 * 4) + 2
GRID_TP_KINDS = (("attn.qkv", "qkv"), ("attn.proj", "proj"),
                 ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2"),
                 ("shared_layers", "shared conv"))
# int8 over the grid against one process on the same crops, float32
# compute.  Calibration: each data rank runs its float model on its 2 of
# the 4 crops (other batch shapes for cuBLAS and cuDNN than one process's
# 4), so an abs-max may part by float32 rounding before the maximum over
# the data group: the scales are held to 1e-5 of their value.  Serving:
# one process serving the grid's int8 state (install_quantized) against
# the grid (GRID_INT8_MAP_ATOL).  hrnet_w32 + heatmap has no tensor that
# the model axis cuts, and K9 is exact in int32 row by row: its maps must
# be equal bit for bit.  hrformer_base + fusion cuts only the fusion
# head's two shared 3x3 convs (JAX's rule cuts no int8 w_int8, so K10's
# weights stay whole): float32 cuDNN convs on half the output channels
# may round an ulp apart from the whole conv, after the last requantize,
# so its maps are held to phase 4's float32 HEATMAP_ATOL.  Both read 0 on
# the H100 (PERF.md, PR 18).  The maps of one process's own calibration
# are logged beside them and not bounded: on the seeded weights (identity
# BatchNorm, activations ~1e6) a scale 1e-6 apart moves many int8 values
# and the maps part by percents.
GRID_INT8_SCALE_RTOL = 1e-5
GRID_INT8_MAP_ATOL = {"hrnet_w32 heatmap": 0.0,
                      "hrformer_base fusion": HEATMAP_ATOL}


def jax_modules() -> list:
    """Modules of JAX, flax or the JAX package this process has loaded."""
    return [m for m, v in sys.modules.items() if v is not None
            and m.split(".")[0] in ("jax", "flax",
                                    "infantposeestimation_gaussianbias_tpu")]


def _grid_rank_setup() -> None:
    """In a grid rank (a process run_grid spawned): TF32 off, no JAX."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loaded = jax_modules()
    assert not loaded, loaded


def _in_turns(grid, fn):
    """fn() on each rank in turn while the others wait at a barrier, so
    that a rank's kernel times do not include the others' kernels on the
    shared card; returns this rank's result."""
    import torch.distributed as dist

    out = None
    for r in range(grid.size):
        dist.barrier()
        if grid.rank == r:
            out = fn()
    dist.barrier()
    return out


def _allreduce_ms(t: torch.Tensor, group, runs: int = 5) -> float:
    """Median host time of an all-reduce of t over group, card work before
    and after synchronised; every rank of the group calls it."""
    import torch.distributed as dist

    times = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(t, group=group)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times[1:])) * 1e3


def k3_rank(grid) -> dict:
    """Phase 17 on one rank: K3 forward and backward at every
    hrformer_base branch shape at the global training batch, float32 and
    bf16, on this rank's windows (data) and heads (model); its output and
    dqkv against unsharded K1/K2 on the same windows (the same per-head
    arithmetic: equal bit for bit) and against the plain versions; its
    dbias against unsharded K2 and the plain version over all windows.
    Then, in turns, K1 and K2 of this rank's shard, the plain version and
    SDPA at the same local shape; the all-reduces, all ranks together."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import (
        window_msa as wm)
    from infantposeestimation_gaussianbias_tpu_torch.parallel import (
        shard_batch)

    _grid_rank_setup()
    dev = grid.device
    rows = []
    for label, w, N, H, hd in BRANCH_SHAPES[:4]:
        nW, C = TRAIN_BATCH * w, H * hd
        g = torch.Generator(device=dev).manual_seed(17)
        qkv32 = torch.randn(nW, N, 3 * C, device=dev, generator=g)
        dout32 = torch.randn(nW, N, C, device=dev, generator=g)
        bias = torch.randn(H, N, N, device=dev, generator=g)
        heads = wm.head_range(H, grid)
        h0, hl = heads or (0, H)
        for dt in (torch.float32, torch.bfloat16):
            qkv, dout = qkv32.to(dt), dout32.to(dt)
            q_l, d_l = shard_batch(qkv, grid), shard_batch(dout, grid)
            nWl = q_l.shape[0]
            reset_launches()
            x = q_l.clone().requires_grad_()
            b = bias.clone().requires_grad_()
            y = wm.window_attention_sharded(x, b, H, grid)
            y.backward(d_l)
            torch.cuda.synchronize()
            got = launches()
            assert (got["k3"], got["k3b"], got["k1"], got["k2"]) == (1, 1, 1, 1)
            k1 = wm.window_attention_qkv(q_l, bias, H)
            k2_dq, _ = wm.window_attention_qkv_bwd(q_l, bias, d_l, H)
            _, k2_db = wm.window_attention_qkv_bwd(qkv, bias, dout, H)
            p_y = wm.window_attention_qkv_reference(q_l, bias, H)
            p_dq, _ = wm.window_attention_qkv_bwd_reference(q_l, bias, d_l, H)
            _, p_db = wm.window_attention_qkv_bwd_reference(qkv, bias, dout,
                                                            H)
            torch.testing.assert_close(y, k1, atol=0, rtol=0)
            torch.testing.assert_close(x.grad, k2_dq, atol=0, rtol=0)
            torch.testing.assert_close(b.grad, k2_db, atol=DBIAS_TOL,
                                       rtol=DBIAS_TOL)
            tol = F32_ATOL if dt == torch.float32 else BF16_TOL
            rtol = 0 if dt == torch.float32 else BF16_TOL
            torch.testing.assert_close(y.float(), p_y.float(), atol=tol,
                                       rtol=rtol)
            torch.testing.assert_close(x.grad.float(), p_dq.float(),
                                       atol=tol, rtol=tol)
            torch.testing.assert_close(b.grad, p_db, atol=DBIAS_TOL,
                                       rtol=DBIAS_TOL)
            err = max((y.float() - p_y.float()).abs().max().item(),
                      (x.grad.float() - p_dq.float()).abs().max().item(),
                      (b.grad - p_db).abs().max().item())
            db_err = (b.grad - k2_db).abs().max().item()

            def timings():
                k1_ms = cuda_median_ms(lambda: wm.window_attention_qkv(
                    q_l, bias, H, heads), warmup=2, runs=10)
                k2_ms = cuda_median_ms(lambda: wm.window_attention_qkv_bwd(
                    q_l, bias, d_l, H, heads), warmup=2, runs=10)
                plain_ms = cuda_median_ms(lambda: (
                    wm.window_attention_qkv_reference(q_l, bias, H, heads),
                    wm.window_attention_qkv_bwd_reference(q_l, bias, d_l, H,
                                                          heads)),
                    warmup=2, runs=10)
                q, k, v = (_heads(q_l[..., i * C + h0 * hd:
                                      i * C + (h0 + hl) * hd], hl)
                           .requires_grad_() for i in range(3))
                mask = bias[h0:h0 + hl].to(dt).clone().requires_grad_()
                do = _heads(d_l[..., h0 * hd:(h0 + hl) * hd], hl)

                def sdpa():
                    o = F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask.expand(nWl, hl, N, N))
                    return torch.autograd.grad(o, (q, k, v, mask), do)

                lib_ms = cuda_median_ms(sdpa, warmup=2, runs=10)
                return k1_ms, k2_ms, plain_ms, lib_ms

            k1_ms, k2_ms, plain_ms, lib_ms = _in_turns(grid, timings)
            if heads is None:
                ar = dict(dbias=_allreduce_ms(torch.zeros_like(bias),
                                              grid.data_group))
            else:
                ar = dict(
                    out=_allreduce_ms(torch.zeros_like(d_l), grid.model_group),
                    dqkv=_allreduce_ms(torch.zeros_like(q_l),
                                       grid.model_group),
                    dbias=_allreduce_ms(torch.zeros_like(bias),
                                        grid.world_group))
            es, cl = qkv.element_size(), hl * hd
            f_bytes = nWl * N * 4 * cl * es + hl * N * N * 4
            f_ops = 4 * N * N * hd * nWl * hl
            b_bytes = nWl * N * 7 * cl * es + 2 * hl * N * N * 4
            b_ops = 10 * N * N * hd * nWl * hl
            k1_bound, _ = bound_ms(f_bytes, f_ops, flop_rate(dt))
            b_ms, b_by = bound_ms(f_bytes + b_bytes, f_ops + b_ops,
                                  flop_rate(dt))
            rows.append(dict(
                label=label, dtype="f32" if dt == torch.float32 else "bf16",
                nW_local=nWl, heads=(h0, hl), max_abs_err=err,
                dbias_vs_k2=db_err, k1_ms=k1_ms, k2_ms=k2_ms,
                ms=k1_ms + k2_ms, plain_ms=plain_ms, library_ms=lib_ms,
                k1_bound_ms=k1_bound, bound_ms=b_ms, bound_by=b_by,
                allreduce_ms=ar, launches=got))
    return dict(rank=grid.rank, coords=(grid.data_index, grid.model_index),
                rows=rows)


def phase_k3() -> dict:
    """K3 on a 2 x 2 grid of gloo ranks on the one card (k3_rank): every
    rank's errors, times, bound and launches; the record is rank 0's at
    hrformer_base b0, bf16 (one forward and one backward of its shard)."""
    from infantposeestimation_gaussianbias_tpu_torch.parallel import run_grid

    results = run_grid(k3_rank, *GRID, "gloo", device="cuda", timeout=600)
    worst, record = 0.0, None
    for r in results:
        for row in r["rows"]:
            h0, hl = row["heads"]
            log(f"[k3] rank {r['rank']} (data {r['coords'][0]}, model "
                f"{r['coords'][1]}) {row['label']} {row['dtype']:4s} "
                f"nW_local={row['nW_local']} heads [{h0},{h0 + hl}) "
                f"max_abs_err={row['max_abs_err']:.3e} (vs plain; out, dqkv "
                f"equal to unsharded K1/K2, dbias within "
                f"{row['dbias_vs_k2']:.2e}) K1_ms={row['k1_ms']:.4f} "
                f"K2_ms={row['k2_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"sdpa_ms={row['library_ms']:.4f} K1_bound_ms="
                f"{row['k1_bound_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                f"({row['bound_by']}) allreduce_ms(" + ", ".join(
                    f"{k} {v:.3f}" for k, v in row["allreduce_ms"].items())
                + f"; {GRID_LABEL}) launches K1 {row['launches']['k1']} K2 "
                f"{row['launches']['k2']}")
            worst = max(worst, row["max_abs_err"])
            if r["rank"] == 0 and row["label"] == "base b0" \
                    and row["dtype"] == "bf16":
                record = dict(row, shape=(
                    f"rank 0 of {GRID[0]}x{GRID[1]}: nW={row['nW_local']},"
                    f"N=49,H={hl} of 2,hd=39,bf16, fwd+bwd"))
    record["max_abs_err"] = worst
    return record


def grid_serve_rank(grid, frames, bboxes) -> dict:
    """Phase 18 on one rank: hrformer_base + fusion, bf16, served over the
    grid (every rank handed the whole request): one batch of 32 with flip,
    its launches, then 1 warm-up and 4 timed batches; then the float32
    model (the same seeded weights as one process's) on 4 frames, with
    this data rank's heatmaps of their crops."""
    from infantposeestimation_gaussianbias_tpu_torch import (PoseInference,
                                                              get_variant)
    from infantposeestimation_gaussianbias_tpu_torch.ops import affine
    from infantposeestimation_gaussianbias_tpu_torch.parallel import (
        shard_batch)

    _grid_rank_setup()
    cfg = get_variant("hrformer_base")
    assert cfg.model.compute_dtype == "bfloat16" and cfg.eval.flip_test
    inf = PoseInference(cfg, device="cuda", mesh=grid)
    reset_launches()
    kpts, scores = inf.predict_batch(frames, bboxes)
    torch.cuda.synchronize()
    got = launches()
    assert kpts.shape == (32, 17, 2) and scores.shape == (32, 17)
    assert np.isfinite(kpts).all() and np.isfinite(scores).all()
    times = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inf.predict_batch(frames, bboxes)
        if i >= 1:
            times.append(time.perf_counter() - t0)
    del inf
    cfg32 = get_variant("hrformer_base")
    cfg32.model.compute_dtype = "float32"
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    inf32 = PoseInference(cfg32, device="cuda", mesh=grid)
    replicated_bytes = torch.cuda.memory_allocated() - m0
    n = GRID_F32_BATCH
    k32, s32 = inf32.predict_batch(frames[:n], bboxes[:n])
    centers = (bboxes[:n, :2] + bboxes[:n, 2:]) / 2
    scales = (bboxes[:n, 2:] - bboxes[:n, :2]) * cfg32.data.bbox_padding
    with torch.inference_mode():
        crops = affine.crop_and_normalize(
            torch.from_numpy(frames[:n]).to(grid.device),
            torch.from_numpy(centers).to(grid.device),
            torch.from_numpy(scales).to(grid.device), cfg32.data.input_size)
        hm = inf32.model(shard_batch(crops, grid))["heatmaps"].cpu().numpy()
    t0 = time.perf_counter()
    tp = grid_tp_serve(grid, inf32, frames[:n], bboxes[:n], crops, m0,
                       replicated_bytes)
    del inf32
    t1 = time.perf_counter()
    int8 = grid_int8_serve(grid, frames[:n], bboxes[:n])
    return dict(rank=grid.rank, kpts=kpts, scores=scores, launches=got,
                batch_s=times, k32=k32, s32=s32, hm32=hm, tp=tp, int8=int8,
                seconds=dict(tp=t1 - t0, int8=time.perf_counter() - t1))


def _assembly_timer(model, tensor_mod, wm):
    """Time every all-reduce of one forward by what it assembles: the
    tensor-parallel layers' outputs by layer kind (GRID_TP_KINDS), K3's
    output ("K3 out"); card work synchronised before and after each.
    Returns (start, stop): stop() restores the collectives and the hooks
    and returns {kind: [ms, ...]}."""
    current, times, hooks = [None], {}, []

    class Timed:
        def __init__(self, real, kind):
            self.real, self.kind = real, kind

        def __getattr__(self, name):
            return getattr(self.real, name)

        def all_reduce(self, t, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.real.all_reduce(t, *a, **kw)
            torch.cuda.synchronize()
            times.setdefault(self.kind(), []).append(
                (time.perf_counter() - t0) * 1e3)
            return out

    real = tensor_mod.dist, wm.dist

    def start():
        for name, m in model.named_modules():
            if getattr(m, "tp", None) is None:
                continue
            kind = next(k for key, k in GRID_TP_KINDS if key in name)
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args, kind=kind: current.__setitem__(0, kind)))
            hooks.append(m.register_forward_hook(
                lambda mod, args, out: current.__setitem__(0, None)))
        tensor_mod.dist = Timed(real[0], lambda: current[0])
        wm.dist = Timed(real[1], lambda: "K3 out")

    def stop():
        tensor_mod.dist, wm.dist = real
        for h in hooks:
            h.remove()
        return times

    return start, stop


def grid_tp_serve(grid, tp, frames, bboxes, crops, m0, replicated_bytes
                  ) -> dict:
    """Phase 18's tensor-parallel half on one rank: the float32 grid
    PoseInference ``tp`` (hrformer_base + fusion, folded) cut over the
    grid's model axis in place (``shard_params``, as
    ``PoseInference(tensor_parallel=True)`` cuts its model once its weights
    are loaded); its parameter memory against the replicated model's (both
    from ``m0``); one flip-tested batch of the frames with its launches and
    its assembly all-reduces timed by layer kind; this data rank's
    heatmaps of their crops; and ``predict_stream`` over the grid on two
    batches of uint8 crops (the second ragged against the data axis; the
    parent holds them to one process's stream)."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import (
        window_msa as wm)
    from infantposeestimation_gaussianbias_tpu_torch.parallel import (
        shard_batch, shard_params, sharding_table, tensor as tensor_mod)

    shard_params(tp.model, grid, tensor_parallel=True)
    tp.tensor_parallel = True
    torch.cuda.synchronize()
    tp_bytes = torch.cuda.memory_allocated() - m0
    table = sharding_table(tp.model)
    start, stop = _assembly_timer(tp.model, tensor_mod, wm)
    reset_launches()
    start()
    try:
        kpts, scores = tp.predict_batch(frames, bboxes)
    finally:
        assembly = stop()
    torch.cuda.synchronize()
    got = launches()
    with torch.inference_mode():
        hm = tp.model(shard_batch(crops, grid))["heatmaps"].cpu().numpy()
    streamed = list(tp.predict_stream(
        iter(grid_stream_batches(tp.cfg, bboxes)), max_in_flight=2))
    return dict(kpts=kpts, scores=scores, launches=got, hm32=hm,
                table=len(table), param_bytes=(replicated_bytes, tp_bytes),
                assembly={k: (len(v), float(np.sum(v)))
                          for k, v in assembly.items()},
                stream=streamed)


def grid_stream_batches(cfg, bboxes) -> list:
    """Two batches of seeded uint8 crops at the input size (4, then 3
    rows: ragged against the 2-rank data axis) with centers and scales."""
    rng = np.random.RandomState(18)
    W, H = cfg.data.input_size
    return [{"image_u8": rng.randint(0, 256, (b, H, W, 3)).astype(np.uint8),
             "center": bboxes[:b, :2] + 20.0 * i,
             "scale": bboxes[:b, 2:] - bboxes[:b, :2]}
            for i, b in enumerate((4, 3))]


def _int8_cfgs():
    from infantposeestimation_gaussianbias_tpu_torch import get_variant

    hr = get_variant("hrformer_base")
    hr.model.compute_dtype = "float32"
    return (("hrnet_w32 heatmap", hrnet_cfg("heatmap", "float32")),
            ("hrformer_base fusion", hr))


def grid_int8_serve(grid, frames, bboxes) -> dict:
    """Phase 18's int8 half on one rank, for hrnet_w32 + heatmap and
    hrformer_base + fusion (seeded weights, float32 compute), with
    tensor parallelism: calibrated on the crops of ``frames`` (each data
    rank on its rows, the abs-max over the data group), its calibrated
    scales and a digest of its whole int8 state, one flip-tested batch's
    launches, and this data rank's heatmaps of the crops."""
    import hashlib

    from infantposeestimation_gaussianbias_tpu_torch import PoseInference
    from infantposeestimation_gaussianbias_tpu_torch.parallel import (
        full_state_dict, shard_batch)

    out = {}
    for label, cfg in _int8_cfgs():
        crops = normalized_crops(cfg, frames, bboxes)
        q = PoseInference(cfg, device="cuda", mesh=grid, tensor_parallel=True,
                          quantize=True, calibration_crops=crops.cpu().numpy())
        sd = full_state_dict(q.model)
        reset_launches()
        kpts, scores = q.predict_batch(frames, bboxes)
        torch.cuda.synchronize()
        got = launches()
        with torch.inference_mode():
            hm = q.model(shard_batch(crops, grid))["heatmaps"].cpu().numpy()
        out[label] = dict(
            state=({k: v.cpu() for k, v in sd.items()} if grid.rank == 0
                   else None),
            scales={k: v.item() for k, v in sd.items() if v.ndim == 0
                    and v.is_floating_point()},
            digest=hashlib.sha256(b"".join(
                v.cpu().numpy().tobytes() for v in sd.values())).hexdigest(),
            launches=got, hm=hm, finite=bool(np.isfinite(kpts).all()
                                             and np.isfinite(scores).all()))
        del q
    return out


def phase_grid_serving(smi: str) -> dict:
    """Grid serving (grid_serve_rank): every rank returns the same whole
    batch, 88 K1 launches per rank through K3, crops/s; float32 heatmaps
    and keypoints against one process on the card under phase 4's bounds."""
    from infantposeestimation_gaussianbias_tpu_torch import (PoseInference,
                                                              get_variant)
    from infantposeestimation_gaussianbias_tpu_torch.ops import affine, decode
    from infantposeestimation_gaussianbias_tpu_torch.parallel import run_grid

    frames, bboxes = make_requests(32, seed=2)
    results = run_grid(grid_serve_rank, *GRID, "gloo", device="cuda",
                       args=(frames, bboxes), timeout=600)
    n2 = 2 * K1_CALLS_PER_FORWARD
    for r in results:
        assert r["launches"] == dict(no_launches(), k1=n2, k3=n2), r["launches"]
        np.testing.assert_array_equal(r["kpts"], results[0]["kpts"])
        np.testing.assert_array_equal(r["scores"], results[0]["scores"])
    cfg32 = get_variant("hrformer_base")
    cfg32.model.compute_dtype = "float32"
    one = PoseInference(cfg32, device="cuda")
    n = GRID_F32_BATCH
    k_one, s_one = one.predict_batch(frames[:n], bboxes[:n])
    centers = (bboxes[:n, :2] + bboxes[:n, 2:]) / 2
    scales = (bboxes[:n, 2:] - bboxes[:n, :2]) * cfg32.data.bbox_padding
    with torch.inference_mode():
        crops = affine.crop_and_normalize(
            torch.from_numpy(frames[:n]).cuda(),
            torch.from_numpy(centers).cuda(), torch.from_numpy(scales).cuda(),
            cfg32.data.input_size)
        hm = one.model(crops)["heatmaps"]
        hm_f = decode.flip_heatmaps(
            one.model(torch.flip(crops, [2]))["heatmaps"], one._flip_index)
        unsure = _unsure_keypoints((hm + hm_f) * 0.5, "fusion")
    hm_grid = np.concatenate([results[0]["hm32"],
                              results[GRID[1]]["hm32"]])
    hm_err = float(np.abs(hm_grid - hm.cpu().numpy()).max())
    keep = ~unsure
    kp_err = float(np.abs(results[0]["k32"] - k_one)[keep].max())
    s_err = float(np.abs(results[0]["s32"] - s_one).max())
    log(f"[grid-serve] f32 grid vs one process on the card, {n} frames: "
        f"heatmaps max_abs_err={hm_err:.3e}, keypoints {kp_err:.3e} px "
        f"(left out {int(unsure.sum())} of {unsure.size} on a decode tie), "
        f"scores {s_err:.3e}")
    assert hm_err <= HEATMAP_ATOL and keep.any() and kp_err <= KEYPOINT_ATOL_PX
    tp = grid_tp_check(results, hm.cpu().numpy(), k_one, s_one, keep,
                       grid_stream_check(one, bboxes[:n]), smi)
    t0 = time.perf_counter()
    int8 = grid_int8_check(results, frames[:n], bboxes[:n], smi)
    log(f"[time] 18's rank 0: tensor parallel "
        f"{results[0]['seconds']['tp']:.1f} s, int8 "
        f"{results[0]['seconds']['int8']:.1f} s; the parent's int8 "
        f"{time.perf_counter() - t0:.1f} s")
    med = float(np.median(results[0]["batch_s"]))
    out = dict(crops_per_s=32 / med, batch32_ms=med * 1e3,
               launches=results[0]["launches"]["k3"], label=GRID_LABEL,
               card=smi, tp=tp, int8=int8)
    log(f"[grid-serve] bf16 b=32 flip over the {GRID[0]}x{GRID[1]} grid: "
        f"K1 launches per rank {results[0]['launches']['k1']} (all through "
        f"K3), every rank the same {results[0]['kpts'].shape} keypoints; "
        f"{out['crops_per_s']:.1f} crops/s (median {med * 1e3:.1f} ms over "
        f"{len(results[0]['batch_s'])} batches, {GRID_LABEL}: a correctness "
        f"path, not a scaling figure); on {smi}")
    return out


def grid_stream_check(one, bboxes) -> tuple:
    """One process's ``predict_stream`` of grid_stream_batches and, per
    batch, which keypoints sit on a decode tie of its flip-averaged
    heatmaps (left out of the comparison, as phase 18's)."""
    from infantposeestimation_gaussianbias_tpu_torch.ops import decode

    batches = grid_stream_batches(one.cfg, bboxes)
    ref = list(one.predict_stream(iter(batches), max_in_flight=2))
    mean = torch.tensor(one.cfg.data.pixel_mean, device="cuda") * 255.0
    std = torch.tensor(one.cfg.data.pixel_std, device="cuda") * 255.0
    unsure = []
    with torch.inference_mode():
        for b in batches:
            crops = (torch.from_numpy(b["image_u8"]).cuda().float() - mean
                     ) / std
            hm = one.model(crops)["heatmaps"]
            hm_f = decode.flip_heatmaps(one.model(torch.flip(
                crops, [2]))["heatmaps"], one._flip_index)
            unsure.append(_unsure_keypoints((hm + hm_f) * 0.5, "fusion"))
    return ref, unsure


def grid_tp_check(results, hm_one, k_one, s_one, keep, stream_one, smi
                  ) -> dict:
    """Phase 18's tensor-parallel checks (grid_tp_serve): every rank the
    same keypoints, 88 K1 launches a batch a rank, all through K3, 178
    tensors cut; float32 heatmaps and keypoints against one process on the
    card under phase 4's bounds (the decode ties of phase 18 left out);
    the stream over the grid, every rank the same, against one process's
    stream (``stream_one``: grid_stream_check) under the same bounds;
    parameter memory and the assembly all-reduces, logged."""
    n2 = 2 * K1_CALLS_PER_FORWARD
    tp0 = results[0]["tp"]
    for r in results:
        tp = r["tp"]
        assert tp["launches"] == dict(no_launches(), k1=n2, k3=n2), (
            r["rank"], tp["launches"])
        np.testing.assert_array_equal(tp["kpts"], tp0["kpts"])
        np.testing.assert_array_equal(tp["scores"], tp0["scores"])
        assert tp["table"] == GRID_TP_TABLE, tp["table"]
        for (c, s), (c0, s0) in zip(tp["stream"], tp0["stream"]):
            np.testing.assert_array_equal(c, c0)
            np.testing.assert_array_equal(s, s0)
    ref, unsure = stream_one
    assert [c.shape[0] for c, _ in tp0["stream"]] == [c.shape[0]
                                                      for c, _ in ref]
    st_kp = max(float(np.abs(c - rc)[~u].max())
                for (c, _), (rc, _), u in zip(tp0["stream"], ref, unsure))
    st_s = max(float(np.abs(s - rs).max())
               for (_, s), (_, rs) in zip(tp0["stream"], ref))
    hm_tp = np.concatenate([tp0["hm32"], results[GRID[1]]["tp"]["hm32"]])
    hm_err = float(np.abs(hm_tp - hm_one).max())
    kp_err = float(np.abs(tp0["kpts"] - k_one)[keep].max())
    s_err = float(np.abs(tp0["scores"] - s_one).max())
    mem = {r["rank"]: r["tp"]["param_bytes"] for r in results}
    asm = tp0["assembly"]
    log(f"[grid-tp] hrformer_base + fusion f32, tensor parallel over the "
        f"model axis of the {GRID[0]}x{GRID[1]} grid ({tp0['table']} tensors "
        f"cut): vs one process on the card, {GRID_F32_BATCH} frames: "
        f"heatmaps max_abs_err={hm_err:.3e}, keypoints {kp_err:.3e} px, "
        f"scores {s_err:.3e}; K1 launches per rank {tp0['launches']['k1']} "
        f"(all through K3); predict_stream over the grid ("
        f"{[c.shape[0] for c, _ in tp0['stream']]} crops) vs one process's: "
        f"keypoints {st_kp:.3e} px (left out "
        f"{sum(int(u.sum()) for u in unsure)} on a decode tie), scores "
        f"{st_s:.3e}; parameter "
        f"memory per rank replicated -> tensor parallel (MB): "
        + ", ".join(f"rank {k} {a / 1e6:.1f} -> {b / 1e6:.1f}"
                    for k, (a, b) in sorted(mem.items()))
        + f"; all-reduces of one batch of {GRID_F32_BATCH} frames with flip "
        f"on rank 0 by kind (count, ms): "
        + ", ".join(f"{k} {c} {ms:.1f}" for k, (c, ms) in sorted(asm.items()))
        + f" ({GRID_LABEL}; host-timed, synchronised); on {smi}")
    assert hm_err <= HEATMAP_ATOL and kp_err <= KEYPOINT_ATOL_PX, (hm_err,
                                                                   kp_err)
    assert s_err <= HEATMAP_ATOL, s_err
    assert st_kp <= KEYPOINT_ATOL_PX and st_s <= HEATMAP_ATOL, (st_kp, st_s)
    return dict(launches=tp0["launches"]["k3"], tensors=tp0["table"],
                hm_err=hm_err, kpt_err_px=kp_err, param_mb={
                    k: (a / 1e6, b / 1e6) for k, (a, b) in mem.items()},
                assembly_ms={k: ms for k, (_, ms) in asm.items()},
                assembly_calls={k: c for k, (c, _) in asm.items()})


def grid_int8_check(results, frames, bboxes, smi) -> dict:
    """Phase 18's int8 checks (grid_int8_serve): the scales and the whole
    int8 state the same on every rank, the scales against one process's
    calibration on the same crops within GRID_INT8_SCALE_RTOL, the maps
    against one process serving the grid's int8 state within
    GRID_INT8_MAP_ATOL (hrnet_w32 bit for bit; against one process's own
    calibration: logged), exact K9, K10 and K1 launches per rank."""
    from infantposeestimation_gaussianbias_tpu_torch import PoseInference

    n2 = 2 * K1_CALLS_PER_FORWARD
    out = {}
    for label, cfg in _int8_cfgs():
        hrnet = label.startswith("hrnet")
        want = (dict(no_launches(), k9=2 * HRNET_W32_QCONVS) if hrnet else
                dict(no_launches(), k10=2 * HRFORMER_BASE_QDENSE, k1=n2,
                     k3=n2))
        r0 = results[0]["int8"][label]
        for r in results:
            got = r["int8"][label]
            assert got["launches"] == want, (label, r["rank"],
                                             got["launches"])
            assert got["finite"] and got["scales"] == r0["scales"], label
            assert got["digest"] == r0["digest"], (label, r["rank"])
        crops = normalized_crops(cfg, frames, bboxes)
        one = PoseInference(cfg, device="cuda", quantize=True,
                            calibration_crops=crops.cpu().numpy())
        scales = {k: v.item() for k, v in one.model.state_dict().items()
                  if v.ndim == 0 and v.is_floating_point()}
        with torch.inference_mode():
            hm_own = one.model(crops)["heatmaps"].cpu().numpy()
            one.install_quantized(r0["state"])
            hm_one = one.model(crops)["heatmaps"].cpu().numpy()
        del one
        assert set(scales) == set(r0["scales"]), label
        scale_err = max(abs(r0["scales"][k] - v) / max(abs(v), 1e-30)
                        for k, v in scales.items())
        hm = np.concatenate([r0["hm"], results[GRID[1]]["int8"][label]["hm"]])
        peak = float(np.abs(hm_one).max())
        map_err = float(np.abs(hm - hm_one).max())
        own_err = float(np.abs(hm - hm_own).max())
        log(f"[grid-int8] {label} f32, over the {GRID[0]}x{GRID[1]} grid "
            f"(tensor parallel), calibrated on {len(frames)} crops (each data "
            f"rank its rows, abs-max over the data group): {len(scales)} "
            f"scales the same on every rank, vs one process's calibration "
            f"max rel err {scale_err:.3e}; int8 state digest equal on all "
            f"{len(results)} ranks; heatmaps vs one process serving that "
            f"state max_abs_err {map_err:.3e} of peak {peak:.3e}"
            f"{' (bit for bit)' if map_err == 0 else ''}, vs one process's "
            f"own calibration {own_err:.3e}; launches per rank "
            + ", ".join(f"{k.upper()} {v}" for k, v in r0["launches"].items()
                        if v)
            + f"; on {smi}")
        assert scale_err <= GRID_INT8_SCALE_RTOL, (label, scale_err)
        assert map_err <= GRID_INT8_MAP_ATOL[label], (label, map_err, peak)
        out[label] = dict(scale_rel_err=scale_err, map_abs_err=map_err,
                          own_calibration_map_abs_err=own_err, peak=peak,
                          launches=r0["launches"])
    return out


def _state_digest(model) -> str:
    """sha256 of a model's state dict (parameters and BatchNorm
    statistics), byte for byte."""
    import hashlib

    return hashlib.sha256(b"".join(
        t.detach().cpu().numpy().tobytes()
        for t in model.state_dict().values())).hexdigest()


def grid_train_rank(grid, batch4, masks4, batch32) -> dict:
    """Phase 19 on one rank: a float32 hrformer_base step over the grid at
    global b = 4 with given DropPath masks (rank 0 returns its RPE-table
    and qkv-weight gradients and BatchNorm statistics); then a bf16 step at
    global b = 32: its launches, terms, and after each step a digest of
    the state dict (parameters and BatchNorm statistics)."""
    from infantposeestimation_gaussianbias_tpu_torch import (
        create_train_state, get_variant, make_train_step)

    _grid_rank_setup()
    dev = grid.device
    cfg = get_variant("hrformer_base")
    cfg.model.compute_dtype = "float32"
    cfg.train.warmup_epochs = 0
    state = create_train_state(cfg, device="cuda", grid=grid)
    _, m = make_train_step(cfg, grid)(state, batch4, None,
                                      drop_masks=masks4.to(dev))
    out = dict(rank=grid.rank, f32={k: v.item() for k, v in m.items()},
               f32_digest=_state_digest(state.model))
    if grid.rank == 0:
        out["grads"] = {
            n: p.grad.cpu() for n, p in state.model.named_parameters()
            if n.endswith(("relative_position_bias_table",
                           "attn.qkv.weight"))}
        out["stats"] = {n: b.cpu() for n, b in state.model.named_buffers()
                        if n.endswith(("running_mean", "running_var"))}
    del state
    t0 = time.perf_counter()
    out["tp"] = grid_tp_train(grid, batch4, masks4)
    out["tp_s"] = time.perf_counter() - t0
    cfg = hrformer_cfg()
    state = create_train_state(cfg, device="cuda", grid=grid)
    gen = torch.Generator(device=dev).manual_seed(6)
    batch = {k: v.to(dev) for k, v in batch32.items()}
    step = make_train_step(cfg, grid)
    reset_launches()
    t0 = time.perf_counter()
    _, metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    out.update(step_ms=(time.perf_counter() - t0) * 1e3, launches=launches(),
               bf16={k: v.item() for k, v in metrics.items()},
               digest=_state_digest(state.model))
    return out


def _replicated_digest(state) -> str:
    """sha256 of the parameters that tensor parallelism leaves whole and of
    the BatchNorm statistics."""
    import hashlib

    from infantposeestimation_gaussianbias_tpu_torch.parallel import (
        sharded_parameters)

    cut = sharded_parameters(state.model)
    kept = [p for p in state.model.parameters() if id(p) not in cut]
    kept += [b for n, b in state.model.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    return hashlib.sha256(b"".join(
        t.detach().cpu().numpy().tobytes() for t in kept)).hexdigest()


def grid_tp_train(grid, batch4, masks4) -> dict:
    """Phase 19's tensor-parallel half on one rank: the float32
    hrformer_base step of grid_train_rank with ``cfg.parallel.
    tensor_parallel`` (the same seeded weights, batch and masks): its
    terms, the RPE-table and qkv-weight gradients (the cut ones
    assembled) and BatchNorm statistics on rank 0, the shapes the cut
    weights and their AdamW moments keep, a digest of what is replicated;
    then a second step of the same state in bf16 at the same batch: its
    launches, terms and digest."""
    from infantposeestimation_gaussianbias_tpu_torch import (
        create_train_state, get_variant, make_train_step)
    from infantposeestimation_gaussianbias_tpu_torch.parallel import (
        sharded_parameters, tensor as tensor_mod)

    dev = grid.device
    cfg = get_variant("hrformer_base")
    cfg.model.compute_dtype = "float32"
    cfg.train.warmup_epochs = 0
    cfg.parallel.tensor_parallel = True
    state = create_train_state(cfg, device="cuda", grid=grid)
    _, m = make_train_step(cfg, grid)(state, batch4, None,
                                      drop_masks=masks4.to(dev))
    cut = sharded_parameters(state.model)
    named = dict(state.model.named_parameters())
    grads = {n: (tensor_mod.assemble_rows(p.grad, cut[id(p)])
                 if id(p) in cut else p.grad).cpu()
             for n, p in named.items()
             if n.endswith(("relative_position_bias_table",
                            "attn.qkv.weight"))}
    out = dict(f32={k: v.item() for k, v in m.items()},
               f32_digest=_replicated_digest(state),
               cut={n: (tuple(p.shape),
                        tuple(state.optimizer.state[p]["exp_avg"].shape))
                    for n, p in named.items() if id(p) in cut})
    if grid.rank == 0:
        out["grads"] = grads
        out["stats"] = {n: b.cpu() for n, b in state.model.named_buffers()
                        if n.endswith(("running_mean", "running_var"))}
    # a second step of the same state in bf16: every layer reads its
    # compute_dtype when it runs, so this is the bf16 model
    for module in state.model.modules():
        if hasattr(module, "compute_dtype"):
            module.compute_dtype = torch.bfloat16
    cfg = hrformer_cfg()
    cfg.parallel.tensor_parallel = True
    reset_launches()
    _, metrics = make_train_step(cfg, grid)(
        state, {k: v.to(dev) for k, v in batch4.items()},
        torch.Generator(device=dev).manual_seed(6))
    torch.cuda.synchronize()
    out.update(launches=launches(), bf16={k: v.item()
                                          for k, v in metrics.items()},
               digest=_replicated_digest(state))
    return out


def grid_tp_train_check(results, m_one, one, smi) -> dict:
    """Phase 19's tensor-parallel checks (grid_tp_train): the float32 step
    against one process's under phase 6's bounds, every rank the same
    terms and replicated bits, each cut weight and its moments out / 2
    rows; the bf16 step: finite, 44 K1 and 44 K2 launches per rank through
    K3, replicated bits equal."""
    r0 = results[0]["tp"]
    for k, v in m_one.items():
        a, b = r0["f32"][k], v.item()
        rel = abs(a - b) / max(abs(b), 1e-12)
        log(f"[grid-tp-train] f32 b={GRID_F32_BATCH} {k:14s} tensor parallel "
            f"{a:.7e} one process {b:.7e} rel {rel:.2e}")
        assert np.isfinite(a) and rel <= STEP_LOSS_RTOL, (k, a, b)
    params = dict(one.model.named_parameters())
    full = {n: tuple(p.shape) for n, p in params.items()}
    for r in results:
        tp = r["tp"]
        assert tp["f32"] == r0["f32"] and tp["f32_digest"] == r0["f32_digest"]
        assert tp["digest"] == r0["digest"], "replicated parameters differ"
        assert len(tp["cut"]) == GRID_TP_TABLE
        for n, (shape, moment) in tp["cut"].items():
            assert shape == moment == (full[n][0] // 2, *full[n][1:]), n
    errs = {n: _rel(g, params[n].grad.cpu()) for n, g in r0["grads"].items()}
    assert len(errs) == 2 * K1_CALLS_PER_FORWARD
    assert max(errs.values()) <= STEP_GRAD_RTOL, max(errs.values())
    bufs = dict(one.model.named_buffers())
    for name, b in r0["stats"].items():
        torch.testing.assert_close(b, bufs[name].cpu(), atol=STEP_STAT_TOL,
                                   rtol=STEP_STAT_TOL)
    n1 = K1_CALLS_PER_FORWARD
    for r in results:
        assert r["tp"]["launches"] == dict(no_launches(), k1=n1, k2=n1, k3=n1,
                                           k3b=n1), r["tp"]["launches"]
        assert all(np.isfinite(v) for v in r["tp"]["bf16"].values())
    log(f"[grid-tp-train] f32 RPE-table and qkv-weight gradients (the cut "
        f"qkv assembled), tensor parallel vs one process: max rel err "
        f"{max(errs.values()):.2e} over {len(errs)}; {GRID_TP_TABLE} cut "
        f"weights and their AdamW moments keep out/2 rows; replicated "
        f"parameters identical on all {len(results)} ranks; bf16 b="
        f"{GRID_F32_BATCH} step: launches per rank K1 {r0['launches']['k1']} "
        f"K2 {r0['launches']['k2']} (all through K3), "
        + " ".join(f"{k}={v:.6g}" for k, v in r0["bf16"].items())
        + f"; {GRID_LABEL}, on {smi}")
    return dict(launches=r0["launches"]["k3"] + r0["launches"]["k3b"],
                grad_rel_err=max(errs.values()),
                loss=r0["bf16"]["total_loss"])


def phase_grid_training(smi: str) -> dict:
    """Grid training (grid_train_rank): the float32 step against one
    process's step on the card (same weights, batch and masks) under
    phase 6's bounds, BatchNorm statistics global; the bf16 step: finite
    terms, 44 K1 and 44 K2 launches per rank (all through K3), the same
    parameters on every rank."""
    from infantposeestimation_gaussianbias_tpu_torch import (
        create_train_state, get_variant, make_train_step)
    from infantposeestimation_gaussianbias_tpu_torch.parallel import run_grid
    from infantposeestimation_gaussianbias_tpu_torch.train import (
        draw_drop_masks)

    cfg = get_variant("hrformer_base")
    cfg.model.compute_dtype = "float32"
    cfg.train.warmup_epochs = 0
    n = GRID_F32_BATCH
    batch4 = make_train_batch(cfg, n, seed=3)
    one = create_train_state(cfg, device="cuda")
    masks4 = draw_drop_masks(one.model, n, torch.Generator().manual_seed(4))
    _, m_one = make_train_step(cfg)(one, batch4, None,
                                    drop_masks=masks4.cuda())
    batch32 = make_train_batch(hrformer_cfg(), TRAIN_BATCH, seed=5)
    results = run_grid(grid_train_rank, *GRID, "gloo", device="cuda",
                       args=(batch4, masks4, batch32), timeout=600)
    r0 = results[0]
    for k, v in m_one.items():
        a, b = r0["f32"][k], v.item()
        rel = abs(a - b) / max(abs(b), 1e-12)
        log(f"[grid-train] f32 b={n} {k:14s} grid {a:.7e} one process "
            f"{b:.7e} rel {rel:.2e}")
        assert np.isfinite(a) and rel <= STEP_LOSS_RTOL, (k, a, b)
    for r in results:
        assert r["f32"] == r0["f32"], (r["rank"], r["f32"])
        assert r["f32_digest"] == r0["f32_digest"], "f32 states differ"
    params = dict(one.model.named_parameters())
    errs = {n: _rel(g, params[n].grad.cpu()) for n, g in r0["grads"].items()}
    log(f"[grid-train] f32 RPE-table and qkv-weight gradients, grid vs one "
        f"process: max rel err {max(errs.values()):.2e} over {len(errs)}")
    assert len(errs) == 2 * K1_CALLS_PER_FORWARD
    assert max(errs.values()) <= STEP_GRAD_RTOL
    bufs = dict(one.model.named_buffers())
    stat_err = 0.0
    for name, b in r0["stats"].items():
        torch.testing.assert_close(b, bufs[name].cpu(), atol=STEP_STAT_TOL,
                                   rtol=STEP_STAT_TOL)
        stat_err = max(stat_err, (b - bufs[name].cpu()).abs().max().item())
    log(f"[grid-train] f32 BN running stats (global over the data ranks) "
        f"grid vs one process: max_abs_err={stat_err:.3e}")
    tp = grid_tp_train_check(results, m_one, one, smi)
    log(f"[time] 19's rank 0: tensor parallel {r0['tp_s']:.1f} s")
    del one
    n1 = K1_CALLS_PER_FORWARD
    for r in results:
        assert r["launches"] == dict(no_launches(), k1=n1, k2=n1, k3=n1,
                                     k3b=n1), r["launches"]
        assert all(np.isfinite(v) for v in r["bf16"].values()), r["bf16"]
        assert r["digest"] == r0["digest"], "parameters differ across ranks"
    log(f"[grid-train] bf16 global b={TRAIN_BATCH} step over the "
        f"{GRID[0]}x{GRID[1]} grid: {r0['step_ms']:.1f} ms (first call, "
        f"{GRID_LABEL}), launches per rank K1 {r0['launches']['k1']} K2 "
        f"{r0['launches']['k2']} (all through K3), parameters identical on "
        f"all {len(results)} ranks (sha256 {r0['digest'][:16]}), "
        + " ".join(f"{k}={v:.6g}" for k, v in r0["bf16"].items())
        + f"; on {smi}")
    return dict(launches=r0["launches"]["k3"] + r0["launches"]["k3b"],
                first_step_ms=r0["step_ms"], loss=r0["bf16"]["total_loss"],
                tp=tp)


# -- phases 21-25: the serving path's surfaces (BN-fold serving, the HTTP
# server, the stream, the graft entry twin, post-processing and the rotated
# crop) -----------------------------------------------------------------------

# Folded against unfolded float32 serving on the card (TF32 off): the same
# affine applied once to the weights (W * a in float32) instead of to each
# conv output; float32 roundings of each conv's sum apart (~1e-6 of a
# layer's scale).  Relative to the heatmaps' largest magnitude.
FOLD_F32_REL_TOL = 1e-4
# Folded against unfolded bf16: folding rounds W * a to bf16 once and adds
# b inside the conv's float32 accumulation, where the unfolded model
# rounds each conv's output to bf16 before its bf16 affine (x * a + b).
# Each bf16 model strays from the float32 one by its own roundings, and
# through HRNet-W32's ~300 convs on random weights with calibrated
# statistics that is far more than bf16's 2^-8 of the heatmaps' largest
# magnitude (~2e-1 for both, measured on the H100: the heatmaps' scale,
# ~0.14, is small against the residual chains' maps).  So the two bf16
# models are held to each other and to float32 by how far the unfolded
# one (the path served before the fold) strays: on each of |folded -
# unfolded| and |folded - float32| (heatmaps, relative to the largest
# magnitude) the unfolded model's distance from float32, plus
# FOLD_BF16_REL_TOL, the bound of fused against unfused bf16
# (FUSED_VS_UNFUSED_TOL).
FOLD_BF16_REL_TOL = FUSED_VS_UNFUSED_TOL
# Smoothers and post-processing, card against CPU, float32: elementwise
# maths and short sums in another order; relative to the largest value.
POST_RTOL = 1e-5
# The rotated crop, card against CPU: cos, sin and the sample positions
# one float32 ulp apart (~6e-5 px at 640 px), times steps of up to 255
# between neighbouring pixels, over the normalisation's std * 255 (~57).
ROT_CROP_ATOL = 2e-4
SERVER_TIMEOUT_S = 120.0


def perturb_bn(model, seed: int) -> None:
    """Seeded BatchNorm parameters and statistics away from the identity
    (weight 1 +- 0.1, bias and running mean N(0, 0.1), running variance in
    [0.75, 1.25)), so that folding moves every conv."""
    from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
        BatchNorm)

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                C = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(C, generator=g))
                m.bias.copy_(0.1 * torch.randn(C, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(C, generator=g))
                m.running_var.copy_(0.75 + 0.5 * torch.rand(C, generator=g))


def fold_models():
    """[(label, head, cfg(dtype), float state dict on the card)]:
    hrnet_w32 + heatmap (Config()), BatchNorm calibrated as in phase 12,
    and hrformer_base + fusion, BatchNorm perturbed (perturb_bn)."""
    from infantposeestimation_gaussianbias_tpu_torch import get_variant
    from infantposeestimation_gaussianbias_tpu_torch.models import (
        build_model)

    def hrformer(dtype: str = "bfloat16"):
        cfg = get_variant("hrformer_base")
        cfg.model.compute_dtype = dtype
        return cfg

    out = []
    for label, head, make in (("hrnet_w32", "heatmap",
                               lambda d="bfloat16": hrnet_cfg("heatmap", d)),
                              ("hrformer_base", "fusion", hrformer)):
        model = build_model(make(), "cuda")
        if label == "hrnet_w32":
            calibrate_batch_stats(model, make())
        else:
            perturb_bn(model, seed=22)
        out.append((label, head, make, {k: v.clone() for k, v in
                                        model.state_dict().items()}))
        del model
    return out


def flip_heatmaps_of(inf, frames, bboxes) -> torch.Tensor:
    """The flip-averaged heatmaps that ``inf`` decodes for these frames."""
    from infantposeestimation_gaussianbias_tpu_torch.ops import affine, decode

    cfg = inf.cfg
    centers = (bboxes[:, :2] + bboxes[:, 2:]) / 2
    scales = (bboxes[:, 2:] - bboxes[:, :2]) * cfg.data.bbox_padding
    with torch.inference_mode():
        crops = affine.crop_and_normalize(
            torch.from_numpy(frames).to(inf.device),
            torch.from_numpy(centers).to(inf.device),
            torch.from_numpy(scales).to(inf.device), cfg.data.input_size)
        hm = inf.model(crops)["heatmaps"]
        hm_f = decode.flip_heatmaps(
            inf.model(torch.flip(crops, [2]))["heatmaps"], inf._flip_index)
        return ((hm + hm_f) * 0.5).float()


def rel_max(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max |a - ref| over max |ref|."""
    return ((a - ref).abs().max() / ref.abs().max()).item()


def fold_against_unfolded(pair: dict, frames, bboxes, head: str) -> tuple:
    """(heatmaps' max difference relative to their largest magnitude,
    keypoints' max difference off decode ties in px, keypoints left out,
    the heatmaps {fold: flip-averaged heatmaps}) of the folded (True) and
    unfolded (False) PoseInference in ``pair``."""
    hms = {f: flip_heatmaps_of(inf, frames, bboxes) for f, inf in
           pair.items()}
    rel = rel_max(hms[True], hms[False])
    unsure = _unsure_keypoints(hms[False], head) | _unsure_keypoints(
        hms[True], head)
    kp = {f: inf.predict_batch(frames, bboxes)[0] for f, inf in pair.items()}
    keep = ~unsure
    assert keep.any()
    kp_err = float(np.abs(kp[True] - kp[False])[keep].max())
    return rel, kp_err, int(unsure.sum()), hms


def timed_batches(inf, frames, bboxes, warmup: int = 1, runs: int = 5
                  ) -> float:
    """Median wall ms of ``runs`` predict_batch calls after ``warmup``."""
    for _ in range(warmup):
        inf.predict_batch(frames, bboxes)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        inf.predict_batch(frames, bboxes)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def phase_fold(smi: str) -> dict:
    """BN-fold serving on the card: hrnet_w32 + heatmap and hrformer_base +
    fusion at b = 32 with flip.  Float32: folded against unfolded on the
    card, and the card's folded against the port's folded on the CPU
    (compare_f32_serving).  bf16: folded against unfolded and against the
    float32 heatmaps, within the unfolded model's own distance from them
    plus FOLD_BF16_REL_TOL; K1 launches of each served batch (88 for
    hrformer_base, none for HRNet), batch ms and a profile of each."""
    from infantposeestimation_gaussianbias_tpu_torch import PoseInference
    from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
        BatchNorm)

    frames, bboxes = make_requests(32, seed=21)
    out = {}
    for label, head, make, sd in fold_models():
        cfg32 = make("float32")
        pair = {f: PoseInference(cfg32, state_dict=sd, device="cuda",
                                 fold=f) for f in (False, True)}
        assert pair[True].fold and not any(
            isinstance(m, BatchNorm) for m in pair[True].model.modules())
        rel, kp_err, left, hm32 = fold_against_unfolded(pair, frames[:4],
                                                        bboxes[:4], head)
        log(f"[fold] {label} f32 folded vs unfolded on the card, 4 frames: "
            f"heatmaps {rel:.3e} of their largest, keypoints {kp_err:.3e} "
            f"px (left out {left} of {4 * 17} on a decode tie)")
        assert rel <= FOLD_F32_REL_TOL and kp_err <= KEYPOINT_ATOL_PX
        compare_f32_serving(pair[True].model.state_dict(), frames, bboxes,
                            f"fold {label}", HEATMAP_ATOL, KEYPOINT_ATOL_PX,
                            cfg32)
        del pair
        cfg = make()
        pair = {f: PoseInference(cfg, state_dict=sd, device="cuda", fold=f)
                for f in (False, True)}
        rel, kp_err, left, hm16 = fold_against_unfolded(pair, frames[:4],
                                                        bboxes[:4], head)
        to32 = {f: rel_max(hm16[f], hm32[True]) for f in (False, True)}
        bound = to32[False] + FOLD_BF16_REL_TOL
        log(f"[fold] {label} bf16 folded vs unfolded: heatmaps {rel:.3e} of "
            f"their largest, keypoints {kp_err:.3e} px apart off ties; from "
            f"the float32 model's heatmaps: folded {to32[True]:.3e}, "
            f"unfolded {to32[False]:.3e} (bound on both differences "
            f"{bound:.3e}: unfolded's own + {FOLD_BF16_REL_TOL})")
        assert rel <= bound and to32[True] <= bound
        want_k1 = 2 * K1_CALLS_PER_FORWARD if head == "fusion" else 0
        out[label] = {}
        for f, inf in pair.items():
            reset_launches()
            kpts, scores = inf.predict_batch(frames, bboxes)
            got = launches()
            assert np.isfinite(kpts).all() and np.isfinite(scores).all()
            assert got == dict(no_launches(), k1=want_k1), got
            ms = timed_batches(inf, frames, bboxes)
            side = "folded" if f else "unfolded"
            prof = profile_steps(lambda: inf.predict_batch(frames, bboxes),
                                 ms, tag=f"fold-{label}-{side}", what="batch")
            out[label][side] = dict(batch_ms=ms, k1=got["k1"], **prof)
        del pair
        fo, un = out[label]["folded"], out[label]["unfolded"]
        log(f"[fold] {label} bf16 b=32 flip: folded {fo['device_ms']:.2f} ms "
            f"device in {fo['kernels_per_step']} kernels, "
            f"{fo['batch_ms']:.1f} ms a batch; unfolded {un['device_ms']:.2f} ms device in "
            f"{un['kernels_per_step']} kernels, {un['batch_ms']:.1f} ms; K1 "
            f"{fo['k1']} launches a folded batch; on {smi}")
    return out


class CountedInference:
    """A PoseInference that records each batch it dispatches and, with a
    ``gate``, holds every batch until the gate opens (a saturated card)."""

    def __init__(self, inf, gate=None):
        self._inf = inf
        self.gate = gate
        self.batches: list = []

    def __getattr__(self, name):
        return getattr(self._inf, name)

    def predict_batch(self, frames, bboxes):
        if self.gate is not None:
            self.gate.wait(SERVER_TIMEOUT_S)
        self.batches.append(len(frames))
        return self._inf.predict_batch(frames, bboxes)


def post_npy(base: str, frame: np.ndarray, bbox=None,
             timeout: float = SERVER_TIMEOUT_S) -> tuple:
    """POST one frame as .npy to ``base``/predict: (status, payload,
    headers)."""
    import io
    import urllib.error
    import urllib.request

    buf = io.BytesIO()
    np.save(buf, frame)
    query = "" if bbox is None else "?bbox=" + ",".join(
        repr(float(v)) for v in bbox)
    req = urllib.request.Request(base + "/predict" + query,
                                 data=buf.getvalue(),
                                 headers={"Content-Type": "application/x-npy"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


@contextlib.contextmanager
def serving(inf, **kw):
    """make_server on 127.0.0.1 (an ephemeral port) in a thread: yields
    (base URL, batcher); shuts down, and waits for in-flight batches, on
    leaving."""
    import threading

    from infantposeestimation_gaussianbias_tpu_torch.cli.serve import (
        make_server)

    srv, batcher = make_server(inf, host="127.0.0.1", port=0, **kw)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", batcher
    finally:
        srv.shutdown()
        batcher.stop()
        batcher._pool.shutdown(wait=True)
        srv.server_close()
        thread.join(timeout=10)
        torch.cuda.synchronize()


def burst(base: str, frames, bboxes, n: int, threads: int) -> tuple:
    """``n`` requests (frame i % len(frames)) from ``threads`` client
    threads at once: (responses, latencies in s, wall s)."""
    from concurrent.futures import ThreadPoolExecutor

    results, lat = [None] * n, [0.0] * n

    def call(i):
        t0 = time.perf_counter()
        j = i % len(frames)
        results[i] = post_npy(base, frames[j], bboxes[j])
        lat[i] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(call, range(n)))
    return results, lat, time.perf_counter() - t0


def phase_server(smi: str) -> tuple:
    """The HTTP server (cli.serve.make_server) on hrformer_base + fusion,
    folded.  Float32: 8 concurrent requests, each answer against
    predict_batch of that frame alone.  bf16, max_batch 32: 64 requests
    from 16 client threads, every answer 200, K1 launches 88 x the
    dispatched batches, requests/s and p50/p99 latency, /healthz; the same
    burst's 16 requests under IPE_FUSED_BLOCK=1 (K4 and K5 88 x batches);
    504 for a request past its deadline; 503 with Retry-After from a full
    queue.  Returns (record, the bf16 PoseInference)."""
    import threading
    import urllib.request

    from infantposeestimation_gaussianbias_tpu_torch import (PoseInference,
                                                              get_variant)

    cfg32 = get_variant("hrformer_base")
    cfg32.model.compute_dtype = "float32"
    inf32 = CountedInference(PoseInference(cfg32, device="cuda"))
    assert inf32.fold
    frames, bboxes = make_requests(8, seed=23)
    with serving(inf32, max_batch=8, window_ms=20.0) as (base, _):
        results, _, _ = burst(base, frames, bboxes, 8, 8)
    assert all(r[0] == 200 for r in results), [r[:2] for r in results]
    server_batches = list(inf32.batches)
    alone = [inf32.predict_batch(frames[i:i + 1], bboxes[i:i + 1])
             for i in range(8)]
    unsure = np.concatenate([_unsure_keypoints(flip_heatmaps_of(
        inf32, frames[i:i + 1], bboxes[i:i + 1]), "fusion")
        for i in range(8)])
    kp = np.stack([np.asarray(r[1]["keypoints"]) for r in results])
    sc = np.stack([np.asarray(r[1]["scores"]) for r in results])
    k_alone = np.concatenate([a[0] for a in alone])
    s_alone = np.concatenate([a[1] for a in alone])
    keep = ~unsure
    kp_err = float(np.abs(kp - k_alone)[keep].max())
    s_err = float(np.abs(sc - s_alone).max())
    log(f"[server] f32 folded, 8 concurrent requests in batches "
        f"{server_batches}: answers vs predict_batch of each frame "
        f"alone, keypoints {kp_err:.3e} px (answers rounded to 0.01; left "
        f"out {int(unsure.sum())} of {unsure.size} on a decode tie), scores "
        f"{s_err:.3e} (rounded to 1e-4)")
    assert keep.any() and kp_err <= KEYPOINT_ATOL_PX and s_err <= 1e-4
    del inf32

    inf = CountedInference(PoseInference(get_variant("hrformer_base"),
                                         device="cuda"))
    assert inf.fold and inf.cfg.model.compute_dtype == "bfloat16"
    frames, bboxes = make_requests(16, seed=24)
    for n in (1, 2, 4, 8, 16, 32):  # every bucket's plans, before timing
        inf.predict_batch(np.resize(frames, (n, *frames.shape[1:])),
                          np.resize(bboxes, (n, 4)))
    out = {}
    with serving(inf, max_batch=32, window_ms=5.0) as (base, _):
        for flag, n, threads in (("0", 64, 16), ("1", 16, 8)):
            with fused_blocks(flag):
                inf.batches.clear()
                reset_launches()
                results, lat, wall = burst(base, frames, bboxes, n, threads)
                torch.cuda.synchronize()
                got = launches()
            assert all(r[0] == 200 for r in results), [r[:2] for r in results]
            b = len(inf.batches)
            per = 2 * K1_CALLS_PER_FORWARD * b
            want = (dict(no_launches(), k1=per) if flag == "0" else
                    dict(no_launches(), k4=per, k5=per))
            assert got == want, (got, inf.batches)
            assert sum(inf.batches) == n
            p50, p99 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 99))
            out[flag] = dict(requests=n, client_threads=threads,
                             requests_per_s=n / wall, p50_ms=p50, p99_ms=p99,
                             batches=list(inf.batches), launches=got)
            log(f"[server] bf16 folded max_batch 32, IPE_FUSED_BLOCK={flag}: "
                f"{n} requests of 480x640 .npy frames from {threads} client "
                f"threads in {wall:.2f} s: {n / wall:.1f} requests/s, "
                f"latency p50 {p50:.1f} ms p99 {p99:.1f} ms; {b} batches "
                f"{inf.batches}; launches K1 {got['k1']} K4 {got['k4']} K5 "
                f"{got['k5']}; on {smi}")
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["fold"] is True, health
    # a request past its deadline: 504
    with serving(inf, max_batch=32, window_ms=0.0,
                 request_timeout=1e-3) as (base, _):
        status, payload, _ = post_npy(base, frames[0], bboxes[0])
    log(f"[server] a request with a 1 ms deadline: {status} {payload}")
    assert status == 504, (status, payload)
    # a full queue: 503 with Retry-After, the card held by a gate
    gate = threading.Event()
    gated = CountedInference(inf._inf, gate)
    with serving(gated, max_batch=1, window_ms=0.0, depth=1,
                 queue_depth=1) as (base, _):
        results = [None] * 8

        def call(i):
            results[i] = post_npy(base, frames[i], bboxes[i])

        clients = [threading.Thread(target=call, args=(i,))
                   for i in range(8)]
        for c in clients:
            c.start()
        deadline = time.monotonic() + 30
        while (not any(r and r[0] == 503 for r in results)
               and time.monotonic() < deadline):
            time.sleep(0.02)
        gate.set()
        for c in clients:
            c.join(timeout=SERVER_TIMEOUT_S)
    codes = [r[0] for r in results]
    shed = [r for r in results if r[0] == 503]
    log(f"[server] queue depth 1, one batch in flight, 8 requests at once: "
        f"status codes {codes}; Retry-After "
        f"{[r[2].get('Retry-After') for r in shed]}")
    assert shed and 200 in codes and set(codes) <= {200, 503}, codes
    assert all(r[2].get("Retry-After") for r in shed)
    record = dict(out["0"], fused=out["1"], serve_http_k1=out["0"][
        "launches"]["k1"], serve_http_k4=out["1"]["launches"]["k4"],
        serve_http_k5=out["1"]["launches"]["k5"], card=smi)
    return record, inf._inf


def stream_batches(sizes, seed: int) -> list:
    """Seeded batches of uint8 crops at 256x192 with centres and scales,
    the eval loader's contract."""
    rng = np.random.RandomState(seed)
    return [{"image_u8": rng.randint(0, 256, (n, 256, 192, 3)).astype(
                np.uint8),
             "center": rng.uniform(100, 500, (n, 2)).astype(np.float32),
             "scale": rng.uniform(150, 400, (n, 2)).astype(np.float32)}
            for n in sizes]


def phase_stream(inf, smi: str) -> dict:
    """predict_stream on hrformer_base bf16 (folded): 4 batches of 32 uint8
    crops and one of 5, two in flight; every yielded batch equal bit for
    bit to the same crops through crops_pipeline, K1 88 launches a
    batch."""
    sizes = (32, 32, 32, 32, 5)
    batches = stream_batches(sizes, seed=25)
    list(inf.predict_stream(iter(stream_batches((32, 5), seed=26))))  # plans
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    got = list(inf.predict_stream(iter(batches), max_in_flight=2))
    wall = time.perf_counter() - t0
    counts = launches()
    assert counts == dict(no_launches(),
                          k1=2 * K1_CALLS_PER_FORWARD * len(sizes)), counts
    assert len(got) == len(sizes)
    for b, (c, s) in zip(batches, got):
        rc, rs = inf.crops_pipeline(*(torch.from_numpy(b[k]).cuda() for k in
                                      ("image_u8", "center", "scale")))
        assert c.shape == (len(b["center"]), 17, 2)
        np.testing.assert_array_equal(c, rc.cpu().numpy())
        np.testing.assert_array_equal(s, rs.cpu().numpy())
    crops = sum(sizes)
    log(f"[stream] bf16 folded predict_stream, batches {list(sizes)}, two in "
        f"flight: every batch equal bit for bit to crops_pipeline on the "
        f"same crops; K1 {counts['k1']} launches; {crops} crops in "
        f"{wall * 1e3:.1f} ms, {crops / wall:.1f} crops/s; on {smi}")
    return dict(k1=counts["k1"], crops_per_s=crops / wall, batches=sizes,
                card=smi)


def phase_graft() -> dict:
    """graft_entry.entry on the card: the example's shapes; float32 coords
    and scores of 4 seeded images against entry("cpu") from the same
    weights (HRNet's BatchNorm calibrated as in phase 12), KEYPOINT_ATOL_PX
    off decode ties and 1e-4 of the largest score; one bf16 call finite."""
    from infantposeestimation_gaussianbias_tpu_torch.graft_entry import (
        entry, flagship_cfg)
    from infantposeestimation_gaussianbias_tpu_torch.models import (
        build_model)

    cfg32 = flagship_cfg("float32")
    model = build_model(cfg32, "cuda")
    calibrate_batch_stats(model, cfg32)
    sd = model.state_dict()
    images = torch.randn((4, 256, 192, 3),
                         generator=torch.Generator().manual_seed(27))
    with torch.inference_mode():
        unsure = _unsure_keypoints(model(images.cuda())["heatmaps"], "fusion")
    fn, (example,) = entry("cuda", state_dict=sd, compute_dtype="float32")
    assert example.shape == (4, 256, 192, 3) and example.is_cuda
    c, s = fn(images.cuda())
    assert c.shape == (4, 17, 2) and s.shape == (4, 17) and c.is_cuda
    fn_cpu, _ = entry("cpu", state_dict={k: v.cpu() for k, v in sd.items()},
                      compute_dtype="float32")
    c_cpu, s_cpu = fn_cpu(images)
    keep = ~unsure
    kp_err = float((c.cpu() - c_cpu).abs().numpy()[keep].max())
    s_err = ((s.cpu() - s_cpu).abs().max() / s_cpu.abs().max()).item()
    fn16, _ = entry("cuda", state_dict=sd)
    c16, s16 = fn16(images.cuda())
    finite = bool(torch.isfinite(c16).all() and torch.isfinite(s16).all())
    log(f"[graft] entry() hrnet_w32 + fusion 256x192: f32 card vs CPU, 4 "
        f"images: coords {kp_err:.3e} heatmap px (left out "
        f"{int(unsure.sum())} of {unsure.size} on a decode tie), scores "
        f"{s_err:.3e} of the largest; bf16 call finite: {finite}")
    assert keep.any() and kp_err <= KEYPOINT_ATOL_PX and s_err <= 1e-4
    assert finite
    return dict(coords_err=kp_err, scores_rel_err=s_err)


def phase_postprocess() -> dict:
    """The smoothers, postprocess_predictions, nms_pose and the rotated
    crop on card tensors against the same calls on the CPU (float32)."""
    from infantposeestimation_gaussianbias_tpu_torch import postprocess
    from infantposeestimation_gaussianbias_tpu_torch.ops import affine, decode

    g = torch.Generator().manual_seed(28)
    errs = {}

    def check(name, card, cpu, tol, scale=None):
        card, cpu = card.cpu().float(), cpu.float()
        scale = cpu.abs().max().item() if scale is None else scale
        err = (card - cpu).abs().max().item()
        errs[name] = err / max(scale, 1e-30)
        assert err <= tol * max(scale, 1e-30), (name, err, scale)

    t = torch.arange(64.0)[:, None, None]
    traj = (300 + 40 * torch.sin(t / 7 + 6 * torch.rand((1, 17, 2),
                                                         generator=g))
            + 2 * torch.randn((64, 17, 2), generator=g))
    for method in ("gaussian", "moving_average", "one_euro"):
        check(f"temporal_smooth {method}",
              decode.temporal_smooth(traj.cuda(), 5, method, fps=25.0),
              decode.temporal_smooth(traj, 5, method, fps=25.0), POST_RTOL)
    B, H, W, K = 32, 64, 48, 17
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    peaks = torch.rand((B, 1, 1, K, 2), generator=g) * torch.tensor([W, H])
    amp = 0.1 + 0.9 * torch.rand((B, 1, 1, K), generator=g)
    hm = amp * torch.exp(-((xs[..., None] - peaks[..., 0]) ** 2
                           + (ys[..., None] - peaks[..., 1]) ** 2) / 4.0)
    hm = hm + 0.01 * torch.rand(hm.shape, generator=g)
    meta = {"center": 100 + 300 * torch.rand((B, 2), generator=g),
            "scale": 100 + 200 * torch.rand((B, 2), generator=g)}
    outputs = {"heatmaps": hm, "coords": torch.rand((B, K, 2), generator=g)}
    card = postprocess.postprocess_predictions(
        {k: v.cuda() for k, v in outputs.items()},
        {k: v.cuda() for k, v in meta.items()})
    cpu = postprocess.postprocess_predictions(outputs, meta)
    for k in ("preds", "maxvals"):
        check(f"postprocess {k}", card[k], cpu[k], POST_RTOL)
    assert torch.equal(card["mask"].cpu(), cpu["mask"])
    pts = cpu["preds"]
    kept, keep = postprocess.nms_pose(pts.cuda(), cpu["maxvals"].cuda(), 20.0)
    kept_cpu, keep_cpu = postprocess.nms_pose(pts, cpu["maxvals"], 20.0)
    assert torch.equal(keep.cpu(), keep_cpu)
    assert 0 < keep_cpu.sum() < keep_cpu.numel()
    check("nms_pose", kept, kept_cpu, POST_RTOL)
    frames, bboxes = make_requests(8, seed=29)
    centers = torch.from_numpy((bboxes[:, :2] + bboxes[:, 2:]) / 2)
    scales = torch.from_numpy((bboxes[:, 2:] - bboxes[:, :2]) * 1.25)
    rots = torch.linspace(-80.0, 80.0, 8)  # |rot| > 63 deg: the joint gather
    mats = affine.get_affine_matrix(centers, scales, (192, 256), rots)
    check("rotated matrices", affine.get_affine_matrix(
        centers.cuda(), scales.cuda(), (192, 256), rots.cuda()), mats,
        POST_RTOL)
    pts = torch.rand((8, 17, 2), generator=g) * 640
    check("transform_points", affine.transform_points(pts.cuda(),
                                                      mats.cuda()),
          affine.transform_points(pts, mats), POST_RTOL)
    f = torch.from_numpy(frames)
    check("rotated crop_and_normalize", affine.crop_and_normalize(
        f.cuda(), centers.cuda(), scales.cuda(), (192, 256),
        rots=rots.cuda()), affine.crop_and_normalize(
        f, centers, scales, (192, 256), rots=rots), ROT_CROP_ATOL, scale=1.0)
    log("[post] card vs CPU, float32, max error relative to the largest "
        "value: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + " (the rotated crop's in normalised units)")
    return errs


# -- phase 26: the training loop --------------------------------------------------

LOOP_TRAIN_IMAGES = 256   # 8 steps an epoch at b = 32
LOOP_VAL_IMAGES = 64      # 2 served batches of 32 a validation
LOOP_THREADS = 8          # the loader's threads (DataLoader's default)
# K1 launches per validation batch: the flip test's two forwards and the
# eval step's loss forward, 44 each
VAL_FORWARDS = 3
# Pipeline proof: hrnet_w32's widths at stage modules (1, 1, 1), b = 16,
# 128x128, on 64 rendered images (tools/pipeline_proof.py).
PROOF_EPOCHS = 60
# Its first run on the card reached AP 0.632 (AP50 1.0) in 240 steps
# (PERF.md §6); the untrained model scores 0.  A broken augmentation,
# target, decode, back-projection or evaluator leaves it near 0; the bound
# leaves room for the run-to-run spread of cuDNN's atomic sums.
PROOF_AP_MIN = 0.4


def machine_libraries() -> dict:
    """What the machine offers the loader: cv2, g++ and a libjpeg to link
    (the system's, or the one Pillow ships), and what the native build
    linked."""
    from infantposeestimation_gaussianbias_tpu_torch import native
    from infantposeestimation_gaussianbias_tpu_torch.native import binding

    out = {}
    try:
        import cv2
        out["cv2"] = cv2.__version__
    except ImportError:
        out["cv2"] = None
    out["g++"] = shutil.which("g++")
    out["system_libjpeg_headers"] = os.path.exists("/usr/include/jpeglib.h")
    out["pillow_libjpeg"] = binding.pillow_libjpeg()
    out["native"] = native.available()
    ldd = subprocess.run(["ldd", binding._lib_path()], capture_output=True,
                         text=True).stdout if out["native"] else ""
    out["native_links"] = [line.split()[0] for line in ldd.splitlines()
                           if "jpeg" in line or "png" in line]
    log("[train-loop] machine: " + ", ".join(f"{k} {v}"
                                             for k, v in out.items()))
    return out


def write_jpeg_set(root: str, split: str, n: int, seed: int, schema) -> dict:
    """n synthetic 480x640 JPEGs (uniform noise, the repo's generator) and
    their COCO annotation file under root; returns the COCO dict."""
    from infantposeestimation_gaussianbias_tpu_torch.data import (
        synthetic_coco_dataset)

    os.makedirs(os.path.join(root, split), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    gt = synthetic_coco_dataset(
        num_images=n, num_keypoints=schema.num_keypoints,
        image_dir=os.path.join(root, split), seed=seed, height=480,
        width=640, keypoint_names=schema.keypoint_names,
        skeleton=schema.skeleton)
    with open(os.path.join(root, "annotations", f"{split}.json"), "w") as f:
        json.dump(gt, f)
    return gt


def loop_cfg(root: str, name: str, cfg=None):
    """``cfg`` (hrformer_base + fusion, bf16, b = 32 by default) reading
    the JPEG set under root through the native loader ("on"), validating
    every epoch, checkpoints and logs under root/name."""
    cfg = cfg or hrformer_cfg()
    d = cfg.data
    d.data_root = root
    d.train_ann, d.val_ann = "annotations/train.json", "annotations/val.json"
    d.train_img_prefix, d.val_img_prefix = "train/", "val/"
    d.native_loader = "on"
    cfg.train.val_interval = 1
    cfg.train.save_every = 0
    cfg.eval.batch_size = TRAIN_BATCH
    cfg.train.checkpoint_dir = os.path.join(root, name, "ck")
    cfg.log_dir = os.path.join(root, name, "logs")
    return cfg


def loader_rate(cfg, mode: str, epochs: int = 2) -> tuple:
    """Images/s of the host loader alone (build_dataloader, training
    augmentation, LOOP_THREADS threads) under native_loader=mode, over
    ``epochs`` epochs after one that warms the page cache, and the
    samples each decode path made."""
    from infantposeestimation_gaussianbias_tpu_torch.data import (
        build_dataloader)

    cfg.data.native_loader = mode
    loader = build_dataloader(cfg, is_train=True)
    loader.num_threads = LOOP_THREADS
    for _ in loader.epoch(0):
        pass
    t0 = time.perf_counter()
    n = sum(b["image_u8"].shape[0] for e in range(1, epochs + 1)
            for b in loader.epoch(e))
    return n / (time.perf_counter() - t0), dict(loader.ds.decoded)


class LoopProbe:
    """Wraps the loop's train step and validate: the kernel launches each
    step and each validation made (counts read before and after; no
    reset), each step's entry time on the host clock and terms (device
    tensors, read after the run), and each validation's seconds, AP and
    loss."""

    def __init__(self):
        self.steps, self.vals = [], []

    def __enter__(self):
        from infantposeestimation_gaussianbias_tpu_torch.train import loop

        self._loop = loop
        self._make, self._validate = loop.make_train_step, loop.validate

        def make_train_step(cfg, grid=None):
            step = self._make(cfg, grid)

            def probed(state, batch, generator, **kw):
                t, before = time.perf_counter(), launches()
                state, metrics = step(state, batch, generator, **kw)
                after = launches()
                self.steps.append(dict(
                    t=t, metrics=metrics,
                    launches={k: after[k] - before[k] for k in after}))
                return state, metrics

            return probed

        def validate(*args, **kw):
            t, before = time.perf_counter(), launches()
            out = self._validate(*args, **kw)
            after = launches()
            self.vals.append(dict(
                s=time.perf_counter() - t, AP=out["AP"],
                val_loss=out["val_loss"],
                launches={k: after[k] - before[k] for k in after}))
            return out

        loop.make_train_step, loop.validate = make_train_step, validate
        return self

    def __exit__(self, *exc):
        self._loop.make_train_step = self._make
        self._loop.validate = self._validate
        return False

    def losses(self) -> list:
        return [s["metrics"]["total_loss"].item() for s in self.steps]


def run_loop(cfg, epochs: int, want_step: dict, want_val: dict,
             loaders=None, **kw) -> dict:
    """train(cfg) through its entry points (build_dataloader, the card),
    ``epochs`` epochs, every kernel count set to 0 just before and read
    just after; each step must launch ``want_step``, each validation batch
    ``want_val``, and the totals must add up."""
    from infantposeestimation_gaussianbias_tpu_torch.data import (
        build_dataloader)
    from infantposeestimation_gaussianbias_tpu_torch.train import loop

    if loaders is None:
        loaders = (build_dataloader(cfg, is_train=True),
                   build_dataloader(cfg, is_train=False))
    train_loader, val_loader = loaders
    with open(os.path.join(cfg.data.data_root, cfg.data.val_ann)) as f:
        gt = json.load(f)
    with LoopProbe() as probe:
        reset_launches()
        t0 = time.perf_counter()
        state = loop.train(cfg, train_loader, val_loader, gt,
                           max_epochs=epochs, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = launches()
    val_batches = len(val_loader)
    for s in probe.steps:
        assert s["launches"] == want_step, s["launches"]
    for v in probe.vals:
        assert v["launches"] == {k: n * val_batches
                                 for k, n in want_val.items()}, v
    assert total == {k: want_step[k] * len(probe.steps)
                     + want_val[k] * val_batches * len(probe.vals)
                     for k in total}, total
    values = [{k: v.item() for k, v in s["metrics"].items()}
              for s in probe.steps]
    assert all(np.isfinite(v) for m in values for v in m.values()), values
    return dict(state=state, probe=probe, wall=wall, launches=total,
                losses=[m["total_loss"] for m in values])


def step_gaps_ms(probe, steps_per_epoch: int, first: int) -> list:
    """The intervals between the entries of consecutive steps of one
    epoch, over the epochs from step ``first`` on, in ms: the loop's own
    step (loader wait, device batch, the step's host work, and the device
    where it holds the host back)."""
    times = [s["t"] for s in probe.steps]
    return [(times[i + 1] - times[i]) * 1e3
            for i in range(first, len(times) - 1)
            if (i + 1) % steps_per_epoch]


def trace_device_ms(path: str, steps: int) -> float:
    """Device kernel, copy and set time per step in a Chrome trace of
    ``steps`` steps (the union of their intervals)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3 / steps


class StopAt:
    """A loader that sets the loop's preemption flag as it hands out batch
    ``at[1]`` of epoch ``at[0]`` (the step that takes it still runs)."""

    def __init__(self, loader, at):
        from infantposeestimation_gaussianbias_tpu_torch.train import loop

        self.loader, self.at, self.flag = loader, at, loop._PREEMPTED

    def __len__(self):
        return len(self.loader)

    def epoch(self, epoch):
        for i, batch in enumerate(self.loader.epoch(epoch)):
            if (epoch, i) == self.at:
                self.flag.set()
            yield batch


def latest_meta(cfg) -> dict:
    with open(os.path.join(cfg.train.checkpoint_dir,
                           "latest.meta.json")) as f:
        return json.load(f)


def phase_train_loop(smi: str, bare: float, bare_fused: float) -> dict:
    """Phase 26, the training loop: the host loader alone (native against
    cv2), hrformer_base + fusion bf16 b = 32 through train() with
    validation (unfused: 2 epochs, the resume to 3, a preemption and its
    resume; fused: 2 epochs), preemie with jitter, the pipeline proof."""
    import logging
    import tempfile

    from infantposeestimation_gaussianbias_tpu_torch import get_variant
    from infantposeestimation_gaussianbias_tpu_torch.data import (
        build_dataloader)
    from infantposeestimation_gaussianbias_tpu_torch.train import (
        loop as tloop, step as tstep)
    from infantposeestimation_gaussianbias_tpu_torch.train.checkpoint import (
        CheckpointManager)
    from infantposeestimation_gaussianbias_tpu_torch.train.step import (
        create_train_state)
    from infantposeestimation_gaussianbias_tpu_torch.tools import (
        pipeline_proof)

    out = {"machine": machine_libraries(), "card": smi}
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    tloop.log.addHandler(handler)
    tloop.log.setLevel(logging.INFO)
    n = K1_CALLS_PER_FORWARD
    unfused_step = dict(no_launches(), k1=n, k2=n)
    unfused_val = dict(no_launches(), k1=VAL_FORWARDS * n)
    fused_step = dict(no_launches(), k4=n, k4b=n, k5=n, k5b=n)
    fused_val = dict(no_launches(), k4=VAL_FORWARDS * n,
                     k5=VAL_FORWARDS * n)
    spe = LOOP_TRAIN_IMAGES // TRAIN_BATCH
    try:
        with tempfile.TemporaryDirectory() as root:
            schema = hrformer_cfg().data.keypoint_schema
            t0 = time.perf_counter()
            write_jpeg_set(root, "train", LOOP_TRAIN_IMAGES, 1, schema)
            write_jpeg_set(root, "val", LOOP_VAL_IMAGES, 2, schema)
            log(f"[train-loop] wrote {LOOP_TRAIN_IMAGES} + {LOOP_VAL_IMAGES} "
                f"480x640 JPEGs in {time.perf_counter() - t0:.1f} s")

            # the host loader alone, b = 32, 256x192, training augmentation
            rates = {}
            for mode in ("on", "off"):
                rate, decoded = loader_rate(loop_cfg(root, "rate"), mode)
                rates[mode] = rate
                log(f"[train-loop] loader native_loader={mode}: "
                    f"{rate:.1f} images/s, {LOOP_THREADS} threads, b = "
                    f"{TRAIN_BATCH}, 256x192; samples by path {decoded}")
                assert decoded["cv2" if mode == "on" else "native"] == 0
            out.update(loader_native_images_per_s=rates["on"],
                       loader_cv2_images_per_s=rates["off"])

            # hrformer_base + fusion, unfused: 2 epochs with validation
            cfg = loop_cfg(root, "unfused")
            loaders = (build_dataloader(cfg, is_train=True),
                       build_dataloader(cfg, is_train=False))
            assert len(loaders[0]) == spe
            with fused_blocks("0"):
                run = run_loop(cfg, 2, unfused_step, unfused_val, loaders)
            losses = run["losses"]
            vals = run["probe"].vals
            log(f"[train-loop] unfused 2 epochs: {len(losses)} steps, "
                f"launches {run['launches']}, total loss " + " ".join(
                    f"{v:.5g}" for v in losses) + "; validation loss "
                + " -> ".join(f"{v['val_loss']:.5g}" for v in vals))
            # the loss on the same validation crops falls from epoch to epoch
            assert vals[-1]["val_loss"] < vals[0]["val_loss"], vals
            assert run["state"].step == 2 * spe
            assert loaders[0].ds.decoded["cv2"] == 0
            gaps = step_gaps_ms(run["probe"], spe, spe)
            loop_rate = TRAIN_BATCH / float(np.median(gaps)) * 1e3
            out.update(loop_images_per_s=loop_rate, bare_images_per_s=bare,
                       loop_step_gaps_ms=gaps,
                       val_s=[v["s"] for v in vals],
                       val_AP=[v["AP"] for v in vals],
                       val_loss=[v["val_loss"] for v in vals],
                       unfused_launches=run["launches"],
                       unfused_losses=losses, unfused_wall_s=run["wall"])
            log(f"[train-loop] loop {loop_rate:.1f} images/s (epoch 1: "
                f"median of the steps' intervals " + " ".join(
                    f"{g:.1f}" for g in gaps) + f" ms) against the bare "
                f"step's {bare:.1f} (phase 6); "
                f"validation of {LOOP_VAL_IMAGES} crops with flip and loss: "
                + ", ".join(f"{v['s']:.2f} s (AP {v['AP']:.4f})"
                            for v in vals) + f"; loader samples "
                f"{loaders[0].ds.decoded} train, {loaders[1].ds.decoded} val"
                f"; on {smi}")

            # a checkpoint's save and restore
            mgr = CheckpointManager(cfg.train.checkpoint_dir)
            state = run["state"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr._save("timing", state, {"epoch": 1})
            save_s = time.perf_counter() - t0
            fresh = create_train_state(cfg, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fresh, _ = mgr.restore(fresh, "timing")
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            size = os.path.getsize(os.path.join(cfg.train.checkpoint_dir,
                                                "timing"))
            for (name, a), b in zip(state.model.state_dict().items(),
                                    fresh.model.state_dict().values()):
                assert torch.equal(a, b), name
            assert fresh.step == state.step
            out.update(checkpoint_save_s=save_s,
                       checkpoint_restore_s=restore_s,
                       checkpoint_mb=size / 2 ** 20)
            log(f"[train-loop] checkpoint of hrformer_base + AdamW "
                f"({size / 2 ** 20:.1f} MiB): save {save_s:.2f} s, restore "
                f"{restore_s:.2f} s")
            del fresh

            # the resume to epoch 3 from latest, its steps profiled
            messages.clear()
            with fused_blocks("0"):
                res = run_loop(cfg, 3, unfused_step, unfused_val, loaders,
                               profile_steps=(1, 3))
            assert any("resumed from epoch 2" in m for m in messages)
            assert res["state"].step == 3 * spe
            assert len(res["probe"].steps) == spe
            trace = os.path.join(cfg.log_dir, "profile", "steps_1_3.json")
            device_ms = trace_device_ms(trace, 2)
            period_ms = TRAIN_BATCH / loop_rate * 1e3
            out.update(loop_device_ms=device_ms,
                       loop_idle_share=max(0.0, 1 - device_ms / period_ms))
            log(f"[train-loop] resumed from epoch 2: {spe} steps of epoch "
                f"2; loop step {device_ms:.1f} ms of device kernels "
                f"(torch.profiler, steps [1, 3) of the resume) against the "
                f"{period_ms:.1f} ms loop step: idle share "
                f"{out['loop_idle_share']:.1%}")

            # a preemption in epoch 3 and its resume
            stop = StopAt(loaders[0], (3, 1))
            try:
                with fused_blocks("0"):
                    pre = run_loop(cfg, 4, unfused_step, unfused_val,
                                   (stop, loaders[1]))
            finally:
                tloop._PREEMPTED.clear()
            assert pre["state"].step == 3 * spe + 2
            meta = latest_meta(cfg)
            assert meta["epoch"] == 2.0 and meta["preempted"] == 1.0, meta
            with fused_blocks("0"):
                post = run_loop(cfg, 4, unfused_step, unfused_val, loaders)
            assert post["state"].step == 4 * spe + 2
            assert len(post["probe"].steps) == spe
            meta = latest_meta(cfg)
            assert meta["epoch"] == 3.0 and "preempted" not in meta
            log(f"[train-loop] preempted at epoch 3 step 2: latest stamped "
                f"epoch 2, preempted, step {pre['state'].step}; the resume "
                f"replayed epoch 3: step {post['state'].step}")
            unfused_total = {k: run["launches"][k] + res["launches"][k]
                             + pre["launches"][k] + post["launches"][k]
                             for k in run["launches"]}
            del run, res, pre, post, state
            torch.cuda.empty_cache()

            # the same under IPE_FUSED_BLOCK=1
            fcfg = loop_cfg(root, "fused")
            with fused_blocks("1"):
                frun = run_loop(fcfg, 2, fused_step, fused_val)
            flosses = frun["losses"]
            fvals = frun["probe"].vals
            assert fvals[-1]["val_loss"] < fvals[0]["val_loss"], fvals
            fgaps = step_gaps_ms(frun["probe"], spe, spe)
            fused_rate = TRAIN_BATCH / float(np.median(fgaps)) * 1e3
            out.update(fused_loop_images_per_s=fused_rate,
                       fused_step_gaps_ms=fgaps,
                       bare_fused_images_per_s=bare_fused,
                       fused_launches=frun["launches"],
                       fused_losses=flosses,
                       fused_val_s=[v["s"] for v in fvals],
                       fused_val_loss=[v["val_loss"] for v in fvals])
            log(f"[train-loop] fused 2 epochs: launches "
                f"{frun['launches']}; loop {fused_rate:.1f} images/s (epoch "
                f"1's intervals " + " ".join(f"{g:.1f}" for g in fgaps)
                + f" ms) against "
                f"the bare fused step's {bare_fused:.1f} (phase 9); total "
                f"loss " + " ".join(f"{v:.5g}" for v in flosses)
                + "; validation loss " + " -> ".join(
                    f"{v['val_loss']:.5g}" for v in fvals))
            del frun
            torch.cuda.empty_cache()
            out["unfused_total_launches"] = unfused_total

            # preemie: hrnet_w32 + heatmap, infant13, 256x256, jitter 0.2
            pcfg = get_variant("preemie")
            # the model's stride-4 maps: the config's 128x128 presumes a
            # stride-2 head that neither package has
            pcfg.data.heatmap_size = (64, 64)
            pcfg.train.warmup_epochs = 0
            pcfg.train.global_batch_size = TRAIN_BATCH
            proot = os.path.join(root, "preemie_data")
            write_jpeg_set(proot, "train", 2 * TRAIN_BATCH, 3,
                           pcfg.data.keypoint_schema)
            write_jpeg_set(proot, "val", TRAIN_BATCH, 4,
                           pcfg.data.keypoint_schema)
            pcfg = loop_cfg(proot, "preemie", pcfg)
            pcfg.train.save_latest_interval = 0
            seen = []
            jitter = tstep.photometric.color_jitter_normalized

            def recording(images, *a, **kw):
                res = jitter(images, *a, **kw)
                seen.append((res - images).abs().amax(dim=(1, 2, 3)))
                return res

            tstep.photometric.color_jitter_normalized = recording
            try:
                prun = run_loop(pcfg, 1, no_launches(), no_launches())
            finally:
                tstep.photometric.color_jitter_normalized = jitter
            moved = torch.stack(seen).min().item()
            assert len(seen) == 2 and moved > 1e-3, moved
            out.update(preemie_losses=prun["losses"],
                       preemie_jitter_min_change=moved)
            log(f"[train-loop] preemie (hrnet_w32 + heatmap, infant13, "
                f"256x256, jitter 0.2) bf16 b = {TRAIN_BATCH}: "
                f"{len(prun['losses'])} steps, total loss "
                + " ".join(f"{v:.5g}" for v in prun["losses"])
                + f"; every jittered crop moved by >= {moved:.3f} "
                f"(normalised units) from its unjittered self")
            del prun

            # the pipeline proof on rendered images
            t0 = time.perf_counter()
            proof = pipeline_proof.run(
                epochs=PROOF_EPOCHS, ap_threshold=PROOF_AP_MIN,
                backbone="hrnet_w32", hrnet_stage_modules=(1, 1, 1),
                device="cuda", verbose=False)
            out["pipeline_proof"] = dict(proof,
                                         seconds=time.perf_counter() - t0)
            log(f"[train-loop] pipeline proof (hrnet_w32 widths, stage "
                f"modules 1/1/1, 128x128, b = 16, {PROOF_EPOCHS} epochs of "
                f"64 rendered images, {int(proof['steps'])} steps): AP "
                f"{proof['AP']:.4f} (bound {PROOF_AP_MIN}), AP50 "
                f"{proof['AP50']:.4f}; training {proof['train_s']:.1f} s, "
                f"validation {proof['val_s']:.2f} s")
    finally:
        tloop.log.removeHandler(handler)
    log("[train-loop] " + json.dumps({k: v for k, v in out.items()
                                      if not isinstance(v, list)}))
    return out


# -- phase 27: int8 PTQ serving, K9 and K10 -------------------------------------

INT8_OP_PER_S = 1979e12   # H100 SXM int8 tensor cores, dense
# int8 against float32 heatmaps on the card, flip-averaged: the JAX
# package's own bound (tests/test_quant.py:147-159), held in that test's
# conditions (jax_test_state: the seeded init, its BatchNorm statistics
# nudged as there, where the untrained maps grow through the residual
# chains).  The served models' BatchNorm is calibrated (phase 12), which
# keeps every layer's activations near unit scale: per-tensor int8 noise
# then adds up over HRNet's ~100 requantized layers in a row, and the
# cosine of those random-weight maps is logged, not bounded (the port's
# int8 layers equal the JAX package's bit for bit on the CPU).
INT8_COS_MIN = 0.995
INT8_CALIB_CROPS = 32     # PoseInference.MIN_SELF_CALIB_CROPS
# int8 serving in float32 compute, card against CPU on the same crops and
# the same quantized state: K9 and K10 equal their plain versions bit for
# bit, so int8 values part only where a float32 step before a requantize
# (the fuse's bilinear resize, cuDNN's float convs of HRFormer's trunk)
# rounds an ulp apart on the two devices and moves a value across a .5
# boundary; the maps then agree to INT8_CARD_CPU_REL of their largest.
INT8_CARD_CPU_REL = 1e-2        # heatmaps, of their largest magnitude
INT8_KEYPOINT_ATOL_PX = 0.5     # frame pixels, off decode ties
# K9 per forward: stem 2, layer1 13, transitions 2 + 1 + 1, exchange
# modules 18 + 4 x 31 + 3 x 48; the fusion head adds 5.  K10: the wide
# Dense layers of hrformer_base (C >= 128: qkv, proj, fc1, fc2; C = 78:
# fc2) over its 44 blocks.
HRNET_W32_QCONVS = 2 + 13 + 2 + 18 + 1 + 4 * 31 + 1 + 3 * 48
HRFORMER_BASE_QDENSE = 2 * (1 + 4) + 4 * 2 * (1 + 4 + 4) + 2 * 2 * (1 + 3 * 4)


def int8_models():
    """[(label, head, make(dtype) -> cfg, float state dict on the card)]:
    hrnet_w32 with the heatmap head (Config()) and with the fusion head,
    BatchNorm calibrated as in phase 12, and hrformer_base + fusion,
    BatchNorm perturbed (perturb_bn)."""
    from infantposeestimation_gaussianbias_tpu_torch import get_variant
    from infantposeestimation_gaussianbias_tpu_torch.models import (
        build_model)

    def hrformer(dtype: str = "bfloat16"):
        cfg = get_variant("hrformer_base")
        cfg.model.compute_dtype = dtype
        return cfg

    out = []
    for label, head, make in (
            ("hrnet_w32 heatmap", "heatmap",
             lambda d="bfloat16": hrnet_cfg("heatmap", d)),
            ("hrnet_w32 fusion", "fusion",
             lambda d="bfloat16": hrnet_cfg("fusion", d)),
            ("hrformer_base fusion", "fusion", hrformer)):
        model = build_model(make(), "cuda")
        if label.startswith("hrnet"):
            calibrate_batch_stats(model, make())
        else:
            perturb_bn(model, seed=22)
        out.append((label, head, make, {k: v.clone() for k, v in
                                        model.state_dict().items()}))
        del model
    return out


def jax_test_state(label: str, make) -> dict:
    """The float32 weights of the JAX package's own int8 agreement tests
    (tests/test_quant.py): the seeded init; for HRNet its BatchNorm running
    statistics nudged by 0.01 i / n, i = 0..n-1, as that test's
    ``fusion_setup`` does; HRFormer's left as initialised, as its
    ``test_hrformer_dense_ptq_model_agreement``."""
    from infantposeestimation_gaussianbias_tpu_torch.models import (
        build_model)
    from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
        BatchNorm)

    model = build_model(make("float32"), "cuda")
    if label.startswith("hrnet"):
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    n = m.running_mean.numel()
                    step = 0.01 * torch.arange(n, device="cuda") / n
                    m.running_mean.add_(step)
                    m.running_var.add_(step)
    return {k: v.clone() for k, v in model.state_dict().items()}


def int8_cosine(cfg32, sd, calib, frames, bboxes) -> tuple:
    """(cosine of the flip-averaged heatmaps of the float32 int8 model,
    calibrated on ``calib``, and the float32 float model, both from ``sd``
    on the card; the int8 PoseInference)."""
    from infantposeestimation_gaussianbias_tpu_torch import PoseInference

    inf = PoseInference(cfg32, state_dict=sd, device="cuda", quantize=True,
                        calibration_crops=calib)
    flt = PoseInference(cfg32, state_dict=sd, device="cuda", fold=False)
    hq = flip_heatmaps_of(inf, frames, bboxes).double().flatten()
    hf = flip_heatmaps_of(flt, frames, bboxes).double().flatten()
    return (hq @ hf / (hq.norm() * hf.norm())).item(), inf


def normalized_crops(cfg, frames, bboxes, device="cuda") -> torch.Tensor:
    """The normalised crops predict_batch makes of these frames."""
    from infantposeestimation_gaussianbias_tpu_torch.ops import affine

    centers = (bboxes[:, :2] + bboxes[:, 2:]) / 2
    scales = (bboxes[:, 2:] - bboxes[:, :2]) * cfg.data.bbox_padding
    with torch.no_grad():
        return affine.crop_and_normalize(
            torch.from_numpy(frames).to(device),
            torch.from_numpy(centers).to(device),
            torch.from_numpy(scales).to(device), cfg.data.input_size,
            mean=cfg.data.pixel_mean, std=cfg.data.pixel_std)


@contextlib.contextmanager
def captured(module, name: str, store: dict, key_fn):
    """``module.name`` wrapped to keep the (cloned) arguments of the first
    call of each ``key_fn(*args, **kw)`` in ``store``."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        key = key_fn(*args, **kw)
        if key not in store:
            store[key] = ([a.clone() if torch.is_tensor(a) else a
                           for a in args],
                          {k: v.clone() if torch.is_tensor(v) else v
                           for k, v in kw.items()})
        return fn(*args, **kw)

    setattr(module, name, wrapper)
    try:
        yield store
    finally:
        setattr(module, name, fn)


def _qconv_key(x, x_scale, w, eff_scale, eff_bias, stride=1, relu=False,
               out_scale=None, residual=None, res_scale=None):
    return (tuple(x.shape), tuple(w.shape), stride, relu,
            out_scale is not None,
            None if residual is None else str(residual.dtype))


def _qdense_key(x, w, *args):
    return (x.reshape(-1, x.shape[-1]).shape[0], w.shape[1], w.shape[0],
            str(x.dtype))


def k9_shape(args, kw) -> str:
    """Phase 27's and phase 20's name of a K9 call: batch x map, channels,
    kernel, stride, the epilogue's options."""
    x, w = args[0], args[2]
    B, H, W, C = x.shape
    Co, k = w.shape[0], w.shape[1]
    stride = args[5] if len(args) > 5 else kw.get("stride", 1)
    res = kw.get("residual")
    return (f"{B}x{H}x{W} {C}->{Co} {k}x{k} s{stride}"
            f"{' relu' if kw.get('relu') else ''}"
            f"{' int8-out' if kw.get('out_scale') is not None else ''}"
            f"{'' if res is None else ' +' + str(res.dtype)[6:]}")


def k10_shape(args, kw) -> str:
    x, w = args[0], args[1]
    return f"M{x.numel() // w.shape[1]} {w.shape[1]}->{w.shape[0]} {str(x.dtype)[6:]}"


def int_mm_ms(a: torch.Tensor, b: torch.Tensor, tag: str):
    """Median ms of ``torch._int_mm`` of int8 a (M, K) and b (N, K)^T on
    operands padded to multiples of 8 (M to at least 17), as a yardstick:
    it computes the same int32 product without the epilogue; None (logged)
    where this torch refuses it."""
    pad = lambda n: -(-n // 8) * 8  # noqa: E731
    (M, K), N = a.shape, b.shape[0]
    aq = torch.zeros(max(M, 17), pad(K), dtype=torch.int8, device=a.device)
    bq = torch.zeros(pad(N), pad(K), dtype=torch.int8, device=a.device)
    aq[:M, :K] = a
    bq[:N, :K] = b
    try:
        return cuda_median_ms(lambda: torch._int_mm(aq, bq.t()))
    except RuntimeError as e:  # a yardstick only: log why it is missing
        log(f"[{tag}] torch._int_mm at {tuple(aq.shape)} x "
            f"{tuple(bq.t().shape)} refused: {str(e).splitlines()[0]}")
        return None


def k9_record(args, kw, smi: str) -> dict:
    """K9 against its plain version (bit for bit), its ms, the plain
    version's, cuDNN bf16's at the same conv shape and, at 1x1 stride-1
    shapes, padded ``torch._int_mm``'s (the same int32 product), and the
    bound."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import quant as qk

    x, w = args[0], args[2]
    got = qk.qconv(*args, **kw)
    want = qk.qconv_reference(*args, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert torch.equal(got, want), (x.shape, w.shape, err)
    B, H, W, C = x.shape
    Co, k = w.shape[0], w.shape[1]
    stride = args[5] if len(args) > 5 else kw.get("stride", 1)
    M = got.numel() // Co
    res = kw.get("residual")
    nbytes = (x.numel() + w.numel() + 8 * Co + got.numel() * got.element_size()
              + (0 if res is None else res.numel() * res.element_size()))
    b_ms, b_by = bound_ms(nbytes, 2.0 * M * Co * k * k * C, INT8_OP_PER_S)
    xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    wb = w.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    lib = cuda_median_ms(lambda: F.conv2d(xb, wb, stride=stride,
                                          padding=k // 2))
    int_mm = (int_mm_ms(x.reshape(-1, C), w.reshape(Co, C), "k9")
              if k == 1 and stride == 1 else None)
    return dict(shape=k9_shape(args, kw),
                max_abs_err=err, ms=cuda_median_ms(lambda: qk.qconv(*args,
                                                                    **kw)),
                plain_ms=cuda_median_ms(lambda: qk.qconv_reference(*args,
                                                                   **kw),
                                        warmup=1, runs=5),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                library_int_mm_ms=int_mm,
                library="cuDNN bf16 conv (F.conv2d), channels_last; at 1x1 "
                        "stride 1 also torch._int_mm, padded")


def k10_record(args, kw) -> dict:
    """K10 against its plain version (bit for bit), its ms, the plain
    version's, ``torch._int_mm`` on operands padded to multiples of 8 and
    a bf16 matmul at the same shape, and the bound."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import quant as qk

    x, w = args[0], args[1]
    got = qk.qdense(*args, **kw)
    want = qk.qdense_reference(*args, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert torch.equal(got, want), (x.shape, w.shape, err)
    K, N = w.shape[1], w.shape[0]
    M = x.numel() // K
    nbytes = (x.numel() * x.element_size() + w.numel() + 8 * N
              + got.numel() * got.element_size())
    b_ms, b_by = bound_ms(nbytes, 2.0 * M * N * K, INT8_OP_PER_S)
    g = torch.Generator(device=x.device).manual_seed(M + K + N)
    int_mm = int_mm_ms(torch.randint(-127, 128, (M, K), dtype=torch.int8,
                                     device=x.device, generator=g), w, "k10")
    xb = x.reshape(M, K).to(torch.bfloat16)
    wb = w.to(torch.bfloat16).t()
    return dict(shape=k10_shape(args, kw), max_abs_err=err,
                ms=cuda_median_ms(lambda: qk.qdense(*args, **kw)),
                plain_ms=cuda_median_ms(lambda: qk.qdense_reference(
                    *args, **kw), warmup=1, runs=5),
                bound_ms=b_ms, bound_by=b_by, library_ms=int_mm,
                library_bf16_ms=cuda_median_ms(lambda: torch.matmul(xb, wb)),
                library="torch._int_mm, operands padded to multiples of 8")


# The shapes of phase 27's [k9-split] and [k10-split] lines: the record
# shapes of K9 (a 32-channel branch conv, int8 out), its widest 3x3 (256
# channels, the tensor cores' bound), a 1x1 with float32 output (bytes),
# the 8x6 3x3 (split over the depth); of K10 the record shape and the
# two Dense layers of the widest branch (N split over blocks).
K9_SPLIT_SHAPES = ("64x64x48 32->32 3x3 s1 relu int8-out",
                   "64x64x48 256->256 3x3 s1 relu int8-out",
                   "64x64x48 64->256 1x1 s1",
                   "64x8x6 256->256 3x3 s1 relu int8-out +int8")
K10_SPLIT_SHAPES = ("M62720 156->468 bfloat16", "M3072 624->2496 bfloat16",
                    "M3072 2496->624 bfloat16")
# The serving kernel (None) and its variants with one phase compiled in
# (kernels/quant.py ABLATED_PHASES): where a launch's time goes (a
# variant's output is meaningless)
QGEMM_PHASES = (("full", None), ("staging only", 1), ("products only", 2),
                ("epilogue only", 4))


def host_us(fn, n: int = 100) -> float:
    """Host microseconds of one call of a kernel wrapper: n calls queued
    without a synchronize (fewer than the launch queue holds), timed on
    the host clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def qgemm_split(kind: str, label: str, call) -> dict:
    """``[k9-split]`` / ``[k10-split]`` lines of one wrapper call,
    ``call(phase)``: the device ms of one launch of the serving kernel
    (``phase`` None) and of its variants with staging, the products or the
    epilogue alone (1, 2, 4), and the host microseconds of one call of the
    serving wrapper.  A reading counts only when the profile kept one
    record of the one kernel for every call; after three profiles that
    did not, the figure is None (not measured), never 0."""
    out = {}
    for name, phase in QGEMM_PHASES:
        out[name] = one_launch_ms(f"{kind}-split", f"{label} {name}",
                                  lambda: call(phase))
        log(f"[{kind}-split] {label} {name}: "
            + ("not measured" if out[name] is None
               else f"{out[name]:.4f} ms device a launch"))
    out["host_us"] = host_us(lambda: call(None))
    log(f"[{kind}-split] {label}: host {out['host_us']:.1f} us a call")
    return out


def int8_sass() -> dict:
    """``[k9-sass]`` lines: the number of integer warpgroup products
    (IGMMA) in each of K9's and K10's compiled kernels, from ``cuobjdump
    --dump-sass`` of the built library; every kernel compiled with the
    products (the serving kernels and the products-only variants) must
    have some.  Returns those kernels' counts."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(build.library_path())],
                          check=True, capture_output=True, text=True,
                          timeout=600).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            if "qconv_kernel" in fn or "qdense_kernel" in fn:
                counts[fn] = 0
        elif fn in counts and "IGMMA" in line:
            counts[fn] += 1
    for fn, n in counts.items():
        log(f"[k9-sass] {_mangled_kernel(repr(fn))}: {n} IGMMA")
    products = {fn: n for fn, n in counts.items()
                if re.search(r"_kernelI(?:L[ib]\d+E)+Li[72]EE", fn)}
    assert products and all(products.values()), counts
    return products


def phase_int8_kernels(smi: str, models) -> dict:
    """K9 at every distinct int8 conv call of a served hrnet_w32 + fusion
    forward at b = 64 (32 crops with flip) and K10 at every wide Dense call
    of a served hrformer_base forward at b = 64, each held to its plain
    version bit for bit, with its times and bound."""
    from infantposeestimation_gaussianbias_tpu_torch import PoseInference
    from infantposeestimation_gaussianbias_tpu_torch.kernels import quant as qk

    frames, bboxes = make_requests(SERVE_BATCH, seed=27)
    out = {"sass_igmma": int8_sass()}
    for label, kind, fn, key_fn, record in (
            ("hrnet_w32 fusion", "k9", "qconv", _qconv_key,
             lambda a, k: k9_record(a, k, smi)),
            ("hrformer_base fusion", "k10", "qdense", _qdense_key,
             k10_record)):
        _, _, make, sd = next(m for m in models if m[0] == label)
        cfg = make()
        crops = normalized_crops(cfg, frames, bboxes)
        inf = PoseInference(cfg, state_dict=sd, device="cuda", quantize=True,
                            calibration_crops=crops[:INT8_CALIB_CROPS])
        with torch.inference_mode(), captured(qk, fn, {}, key_fn) as calls:
            inf.model(crops)
        rows = []
        for (args, kw) in calls.values():
            with torch.inference_mode():
                rows.append(record(args, kw))
            r = rows[-1]
            log(f"[{kind}] {label} b={SERVE_BATCH} {r['shape']}: equal to "
                f"the plain version bit for bit; {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f}, library {r['library_ms']}"
                + (f", bf16 matmul {r['library_bf16_ms']:.4f}"
                   if 'library_bf16_ms' in r else "")
                + (f", torch._int_mm {r['library_int_mm_ms']:.4f}"
                   if r.get('library_int_mm_ms') is not None else "")
                + f"; bound {r['bound_ms']:.4f} ({r['bound_by']}); on {smi}")
        shape_of = k9_shape if kind == "k9" else k10_shape
        for args, kw in calls.values():
            name = shape_of(args, kw)
            if name in (K9_SPLIT_SHAPES if kind == "k9" else K10_SPLIT_SHAPES):
                with torch.inference_mode():
                    split = qgemm_split(kind, name, lambda phase: (
                        getattr(qk, fn)(*args, **kw) if phase is None else
                        getattr(qk, f"_{fn}_ablate")(phase, *args, **kw)))
                next(r for r in rows if r["shape"] == name)["split"] = split
        out[kind] = rows
        del inf
    return out


def int8_served(inf, frames, bboxes, want_k9: int, want_k10: int,
                want_k1: int) -> dict:
    """One served batch of each size: exactly the wanted launches per
    batch (two forwards, flip)."""
    got = {}
    for n in (SERVE_BATCH // 2, 1):
        reset_launches()
        kpts, scores = inf.predict_batch(frames[:n], bboxes[:n])
        torch.cuda.synchronize()
        launched = launches()
        assert np.isfinite(kpts).all() and np.isfinite(scores).all()
        want = dict(no_launches(), k9=2 * want_k9, k10=2 * want_k10,
                    k1=2 * want_k1)
        assert launched == want, (n, launched, want)
        got[n] = launched
    return got


def int8_layer_outputs(model, x: torch.Tensor) -> tuple:
    """The outputs of every QConvNorm and residual block of an int8 model's
    forward on ``x``, in call order, on the CPU, and its heatmaps."""
    from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
        BasicBlock, Bottleneck, QConvNorm)
    from infantposeestimation_gaussianbias_tpu_torch.ops.quant import QTensor

    outs, hooks = [], []
    for name, m in model.named_modules():
        if isinstance(m, QConvNorm) or (isinstance(m, (BasicBlock,
                                                      Bottleneck))
                                        and m.quant):
            hooks.append(m.register_forward_hook(
                lambda m, i, o, name=name: outs.append((name, (
                    o.data if isinstance(o, QTensor) else o).cpu()))))
    try:
        with torch.inference_mode():
            hm = model(x)["heatmaps"]
    finally:
        for h in hooks:
            h.remove()
    return outs, hm


def int8_card_against_cpu(label: str, head: str, cfg32, inf32, frames,
                          bboxes, bounded: bool) -> dict:
    """float32 int8 serving on the card against the port on the CPU with
    the card's quantized state, on the same crops.  HRNet: every int8 conv
    and block output in call order, bit for bit up to the first fuse (K9
    against its plain version, the requantizes alike); where they first
    part (the fuse's float32 bilinear resize rounds an ulp apart on the
    two devices and an int8 value crosses a .5 boundary), and the share
    of the backbone's int8 output that differs at the end.  Then the
    flip-averaged heatmaps and the keypoints off decode ties, held to the
    INT8_CARD_CPU bounds when ``bounded``."""
    from infantposeestimation_gaussianbias_tpu_torch import PoseInference

    cpu = PoseInference(cfg32, device="cpu", quantize=True)
    cpu.install_quantized({k: v.cpu() for k, v in
                           inf32.model.state_dict().items()})
    n = 1  # one frame: the full-width int8 model runs on the CPU too
    crops = normalized_crops(cfg32, frames[:n], bboxes[:n], "cpu")
    layers, hms = {}, {}
    for name, p in (("cuda", inf32), ("cpu", cpu)):
        x = crops.to(p.device)
        layers[name], hm = int8_layer_outputs(p.model, x)
        with torch.inference_mode():
            hms[name] = ((hm + decode_flip(p, x)) * 0.5).float().cpu()
    rec = {}
    if layers["cpu"]:
        names = [k for k, _ in layers["cpu"]]
        assert names == [k for k, _ in layers["cuda"]]
        same = [torch.equal(a, b) for (_, a), (_, b) in zip(layers["cuda"],
                                                            layers["cpu"])]
        first = same.index(False) if False in same else len(same)
        last_fuse = max(i for i, k in enumerate(names)
                        if k.startswith("backbone.stage2.0.fuse_layers"))
        a, b = layers["cuda"][-1][1], layers["cpu"][-1][1]
        rec.update(equal_prefix=first, layers=len(same),
                   first_difference=names[first] if first < len(same) else None,
                   int8_mismatch=(a != b).float().mean().item(),
                   int8_max_diff=(a.int() - b.int()).abs().max().item())
        assert first > last_fuse, rec
    rec["heatmap_rel"] = rel_max(hms["cuda"], hms["cpu"])
    unsure = _unsure_keypoints(hms["cuda"], head) | _unsure_keypoints(
        hms["cpu"], head)
    k_gpu, _ = inf32.predict_batch(frames[:n], bboxes[:n])
    k_cpu, _ = cpu.predict_batch(frames[:n], bboxes[:n])
    keep = ~unsure
    rec["keypoint_err_px"] = float(np.abs(k_gpu - k_cpu)[keep].max())
    rec["left_out"] = int(unsure.sum())
    log(f"[int8] {label} f32 card vs CPU, same crops and int8 state: "
        + (f"{rec['equal_prefix']} of {rec['layers']} int8 layer outputs "
           f"equal bit for bit before the first difference "
           f"({rec['first_difference']}); at the end "
           f"{rec['int8_mismatch']:.2e} of the backbone's int8 outputs "
           f"differ (max {rec['int8_max_diff']} lsb); "
           if "layers" in rec else "")
        + f"heatmaps {rec['heatmap_rel']:.3e} of their largest; keypoints "
        f"{rec['keypoint_err_px']:.3e} px off decode ties (left out "
        f"{rec['left_out']} of {unsure.size})"
        + ("" if bounded else " (logged, not bounded)"))
    assert keep.any()
    if bounded:
        assert rec["heatmap_rel"] <= INT8_CARD_CPU_REL, rec
        assert rec["keypoint_err_px"] <= INT8_KEYPOINT_ATOL_PX, rec
    return rec


def decode_flip(inf, crops: torch.Tensor) -> torch.Tensor:
    """The un-mirrored heatmaps of the mirrored crops."""
    from infantposeestimation_gaussianbias_tpu_torch.ops import decode

    return decode.flip_heatmaps(inf.model(torch.flip(crops, [2]))[
        "heatmaps"], inf._flip_index)


def phase_int8_serving(smi: str, models) -> dict:
    """int8 PoseInference for each model: launches per served batch (b = 32
    with flip and b = 1), the float32 int8 model against the float32 float
    model (heatmap cosine) and against the CPU, crops/s and the profile of
    the bf16 int8 batch beside the folded bf16 batch."""
    from infantposeestimation_gaussianbias_tpu_torch import PoseInference
    from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
        QConvNorm, QDense)

    frames, bboxes = make_requests(SERVE_BATCH // 2, seed=28)
    calib_frames, calib_boxes = make_requests(INT8_CALIB_CROPS, seed=29)
    out = {}
    for label, head, make, sd in models:
        hrnet = label.startswith("hrnet")
        cfg = make()
        calib = normalized_crops(cfg, calib_frames, calib_boxes)
        inf = PoseInference(cfg, state_dict=sd, device="cuda", quantize=True,
                            calibration_crops=calib)
        n9 = sum(isinstance(m, QConvNorm) for m in inf.model.modules())
        n10 = sum(isinstance(m, QDense) for m in inf.model.modules())
        assert (n9, n10) == ((HRNET_W32_QCONVS + 5 * (head == "fusion"), 0)
                             if hrnet else (0, HRFORMER_BASE_QDENSE)), (n9,
                                                                        n10)
        launched = int8_served(inf, frames, bboxes, n9, n10,
                               0 if hrnet else K1_CALLS_PER_FORWARD)
        rec = dict(qconvs=n9, qdense=n10, launches=launched[SERVE_BATCH // 2],
                   launches_b1=launched[1])
        rec["int8"] = phase_throughput(inf, smi, f"int8 {label}")
        rec["int8"].update(profile_steps(
            lambda: inf.predict_batch(frames, bboxes),
            rec["int8"]["batch32_ms"], tag=f"int8-{label}", what="batch"))
        del inf
        folded = PoseInference(cfg, state_dict=sd, device="cuda")
        assert folded.fold
        rec["folded"] = phase_throughput(folded, smi, f"folded {label}")
        rec["folded"].update(profile_steps(
            lambda: folded.predict_batch(frames, bboxes),
            rec["folded"]["batch32_ms"], tag=f"folded-{label}", what="batch"))
        del folded
        cfg32 = make("float32")
        calib32 = normalized_crops(cfg32, calib_frames, calib_boxes)
        rec["cos_int8_float"], inf32 = int8_cosine(cfg32, sd, calib32,
                                                   frames[:8], bboxes[:8])
        # HRNet's served weights amplify an ulp's flip (see INT8_COS_MIN):
        # card against CPU bounded on the JAX test's weights
        rec["card_cpu"] = int8_card_against_cpu(label, head, cfg32, inf32,
                                                frames, bboxes, not hrnet)
        rec["cos_int8_float_jax_test"], inf32 = int8_cosine(
            cfg32, jax_test_state(label, make), calib32, frames[:8],
            bboxes[:8])
        if hrnet:
            rec["card_cpu_jax_test"] = int8_card_against_cpu(
                label + " (JAX test weights)", head, cfg32, inf32, frames,
                bboxes, True)
        del inf32
        i8, fo = rec["int8"], rec["folded"]
        log(f"[int8] {label}: {n9} K9 and {n10} K10 layers a forward; a served "
            f"batch of {SERVE_BATCH // 2} with flip launched K9 "
            f"{rec['launches']['k9']}, K10 {rec['launches']['k10']}, K1 "
            f"{rec['launches']['k1']} (b = 1: {rec['launches_b1']['k9']}, "
            f"{rec['launches_b1']['k10']}, {rec['launches_b1']['k1']}); "
            f"heatmap cosine int8 vs float32 "
            f"{rec['cos_int8_float_jax_test']:.5f} on the JAX test's weights "
            f"(bound {INT8_COS_MIN}), {rec['cos_int8_float']:.5f} on the "
            f"served ones; bf16 b=32 int8 {i8['crops_per_s']:.1f} "
            f"crops/s, {i8['device_ms']:.2f} ms device in "
            f"{i8['kernels_per_step']} kernels, b=1 {i8['batch1_ms']:.1f} ms; "
            f"folded {fo['crops_per_s']:.1f} crops/s, {fo['device_ms']:.2f} "
            f"ms device in {fo['kernels_per_step']} kernels, b=1 "
            f"{fo['batch1_ms']:.1f} ms; on {smi}")
        assert rec["cos_int8_float_jax_test"] >= INT8_COS_MIN, rec
        out[label] = rec
    return out


def phase_int8_clis(smi: str, models) -> dict:
    """``cli.serve --int8 --calibration-dir`` in its own process answering
    a burst (/healthz reporting int8-ptq), ``cli.infer --int8`` on an
    image and ``cli.validate --int8`` on a COCO directory of JPEGs."""
    import io
    import socket
    import tempfile
    import threading
    import urllib.request

    import cv2

    from infantposeestimation_gaussianbias_tpu_torch import Config
    from infantposeestimation_gaussianbias_tpu_torch.cli import (
        infer as cli_infer, validate as cli_validate)

    _, _, _, sd = models[0]  # hrnet_w32 + heatmap: Config()
    out = {}
    with tempfile.TemporaryDirectory() as root:
        ckpt = os.path.join(root, "hrnet_w32.pt")
        torch.save({k: v.cpu() for k, v in sd.items()}, ckpt)
        calib_dir = os.path.join(root, "calib")
        os.makedirs(calib_dir)
        frames, bboxes = make_requests(16, seed=30)
        for i, f in enumerate(frames):
            cv2.imwrite(os.path.join(calib_dir, f"{i:02d}.jpg"),
                        cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        cmd = [sys.executable, "-m",
               "infantposeestimation_gaussianbias_tpu_torch.cli.serve",
               "--int8", "--calibration-dir", calib_dir, "--checkpoint", ckpt,
               "--host", "127.0.0.1", "--port", str(port),
               "--max-batch", "16"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                cwd=os.path.dirname(os.path.abspath(__file__)))
        lines = []
        try:
            ready = threading.Event()

            def read():
                for line in proc.stdout:
                    lines.append(line.rstrip())
                    if line.startswith("serving "):
                        ready.set()

            reader = threading.Thread(target=read, daemon=True)
            reader.start()
            assert ready.wait(SERVER_TIMEOUT_S), "\n".join(lines)
            start_s = time.perf_counter() - t0
            base = f"http://127.0.0.1:{port}"
            results, lat, wall = burst(base, frames, bboxes, 32, 8)
            with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
                health = json.loads(r.read())
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        codes = [r[0] for r in results]
        failed = [r[:2] for r in results if r[0] != 200]
        log(f"[int8-serve] cli.serve --int8 --calibration-dir (16 JPEGs), "
            f"up in {start_s:.1f} s: {' | '.join(lines[:2])}; 32 requests "
            f"from 8 threads: {32 / wall:.1f} requests/s, p50 "
            f"{np.percentile(lat, 50) * 1e3:.1f} ms, codes {set(codes)}; "
            f"/healthz {health}; on {smi}")
        assert all(c == 200 for c in codes), (codes, failed[:3])
        assert health["precision"] == "int8-ptq" and not health["fold"], health
        assert any(line.startswith("calibrating int8 PTQ on 16 crops")
                   for line in lines), lines
        out["serve"] = dict(requests_per_s=32 / wall, start_s=start_s,
                            p50_ms=float(np.percentile(lat, 50)) * 1e3)

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_infer.main(["--input", os.path.join(calib_dir, "00.jpg"),
                            "--int8", "--checkpoint", ckpt])
        printed = buf.getvalue().splitlines()
        log(f"[int8-infer] cli.infer --int8: {printed[0]} ... "
            f"({len(printed)} lines)")
        assert len(printed) == 17, printed

        schema = Config().data.keypoint_schema
        write_jpeg_set(root, "val", 16, seed=31, schema=schema)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli_validate.main(["--int8", "--set", f"data.data_root={root}",
                               "data.val_ann=annotations/val.json",
                               "data.val_img_prefix=val/",
                               "eval.batch_size=16"])
        printed = buf.getvalue()
        log(f"[int8-validate] cli.validate --int8 on 16 JPEGs in "
            f"{time.perf_counter() - t0:.1f} s: "
            + " | ".join(printed.split("\n")[:5]))
        assert "AP:" in printed and "val_loss" not in printed, printed
    return out


# Phase 27's host threads (int8_threads): threads launching K9 and K10 at
# once, as the server's dispatch threads do, and the rounds each makes.
INT8_THREADS = 4
INT8_THREAD_ROUNDS = 40


def int8_threads(smi: str) -> dict:
    """K9 and K10 launched from INT8_THREADS host threads at once: threads
    0 and 1 on the default stream (as the server's dispatch threads), the
    others each on a stream of its own.  Each round launches one K9
    kernel (the 8x6 256->256 3x3 conv, its depth split over blocks)
    without a residual and with an int8 and a float32 one (three shared
    memory sizes), and one K10 kernel at K = 624 and 2,496 (two sizes),
    then holds every output to its plain version under torch.equal."""
    import threading

    from infantposeestimation_gaussianbias_tpu_torch.kernels import quant as qk

    g = torch.Generator(device="cuda").manual_seed(31)
    dev = "cuda"

    def i8(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=dev,
                             generator=g)

    def pos(*shape):
        return torch.rand(shape, device=dev, generator=g) * 1e-3 + 1e-3

    x, w = i8(64, 8, 6, 256), i8(256, 3, 3, 256)
    conv = (x, torch.tensor(0.02, device=dev), w, pos(256),
            torch.randn(256, device=dev, generator=g))
    conv_kw = dict(relu=True, out_scale=torch.tensor(0.7, device=dev))
    res8 = dict(conv_kw, residual=i8(64, 8, 6, 256),
                res_scale=torch.tensor(0.03, device=dev))
    res32 = dict(conv_kw, residual=torch.randn(64, 8, 6, 256, device=dev,
                                               generator=g))
    cases = {"k9": ("qconv", conv, conv_kw), "k9 +int8": ("qconv", conv, res8),
             "k9 +float32": ("qconv", conv, res32)}
    for K, N in ((624, 2496), (2496, 624)):
        rows = torch.randn(3072, K, device=dev, generator=g) * 2
        dense = (rows.to(torch.bfloat16), i8(N, K), pos(N),
                 torch.randn(N, device=dev, generator=g),
                 torch.tensor(0.03, device=dev))
        cases[f"k10 {K}->{N}"] = ("qdense", dense,
                                  dict(out_dtype=torch.bfloat16))
    want = {name: getattr(qk, f"{fn}_reference")(*a, **kw)
            for name, (fn, a, kw) in cases.items()}
    torch.cuda.synchronize()
    start, errors, unequal = threading.Barrier(INT8_THREADS), [], []

    def work(t: int) -> None:
        try:
            stream = (torch.cuda.default_stream() if t < 2
                      else torch.cuda.Stream())
            stream.wait_stream(torch.cuda.default_stream())
            start.wait()
            with torch.cuda.stream(stream), torch.inference_mode():
                for _ in range(INT8_THREAD_ROUNDS):
                    got = {name: getattr(qk, fn)(*a, **kw)
                           for name, (fn, a, kw) in cases.items()}
                    unequal.extend((t, name) for name, out in got.items()
                                   if not torch.equal(out, want[name]))
        except Exception as e:  # re-raised below, with the thread's number
            errors.append((t, repr(e)))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=work, args=(t,))
               for t in range(INT8_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    assert not errors, errors
    assert not unequal, unequal[:8]
    n = INT8_THREADS * INT8_THREAD_ROUNDS * len(cases)
    log(f"[int8-threads] {INT8_THREADS} host threads (2 on the default "
        f"stream, {INT8_THREADS - 2} on streams of their own) x "
        f"{INT8_THREAD_ROUNDS} rounds of {', '.join(cases)}: {n} launches, "
        f"each equal to its plain version bit for bit, in {seconds:.1f} s; "
        f"on {smi}")
    return dict(threads=INT8_THREADS, rounds=INT8_THREAD_ROUNDS, launches=n,
                seconds=seconds)


def phase_int8(smi: str) -> dict:
    """Phase 27: K9 and K10 at every shape of the int8 path, launched from
    several host threads at once, the int8 served batches and the three
    int8 CLIs."""
    models = int8_models()
    kernels = phase_int8_kernels(smi, models)
    threads = int8_threads(smi)
    serving = phase_int8_serving(smi, models)
    clis = phase_int8_clis(smi, models)
    return dict(kernels=kernels, threads=threads, serving=serving, clis=clis)


# -- phase 28: LiteHRNet, the fused and SimCC heads, the add-ons, the tools --

LITE_TRAIN_BATCH = 64      # the lightweight config's global batch
LITE_TRAIN_STEPS = 20      # bf16 steps over which its loss must fall
# The pipeline proof's litehrnet default (tools/pipeline_proof.py), b = 16,
# 128x128, on 64 rendered images; held to phase 26's PROOF_AP_MIN.  On the
# card LiteHRNet's steps are host-bound (~4,500 kernels, 110-150 ms a
# step): 100 epochs reached AP 0.451, 150 epochs 0.623 twice (PERF.md
# §6); 125 epochs keeps the bound clear in ~70 s.
LITE_PROOF_EPOCHS = 125
# The overfit check (tools/overfit_check.py): its 2,000 steps of
# litehrnet + fusion at 256x192, b = 16, take ~260 s at ~130 ms a step, more
# than the phase's budget; it runs OVERFIT_STEPS, its assertion (e1 <
# 0.3 e0) unchanged: 250 steps left 29.8 of 64.5 px (not yet overfit),
# 500 steps 4.1 px.
OVERFIT_STEPS = 500
# float32 card against CPU of the add-ons on hrnet_w32's stride-4
# features (b = 32, 64 x 48 x 32): of each output's largest magnitude.
ADDON_REL_TOL = 1e-4


def lite_cfg(head: str = "heatmap", dtype: str = "bfloat16"):
    """``get_variant("lightweight")`` (litehrnet + heatmap, 192x192, b =
    64) for the heatmap head; for the others Config()'s 256x192 with the
    litehrnet backbone and that head."""
    from infantposeestimation_gaussianbias_tpu_torch import (Config,
                                                              get_variant)

    cfg = get_variant("lightweight") if head == "heatmap" else Config()
    cfg.model.backbone = "litehrnet"
    cfg.model.head_type = head
    cfg.model.compute_dtype = dtype
    cfg.train.warmup_epochs = 0  # else the lr stays near warmup_lr
    return cfg


def lite_serving(smi: str) -> dict:
    """The lightweight config served: BatchNorm calibrated, batches of 1,
    3 and 8 through no kernel of the port, float32 card against CPU, bf16
    crops/s at b = 32 with flip and b = 1, the served batch's profile."""
    from infantposeestimation_gaussianbias_tpu_torch import PoseInference

    cfg = lite_cfg()
    assert (cfg.eval.flip_test, cfg.eval.decode) == (True, "quarter")
    assert tuple(cfg.data.input_size) == (192, 192)
    inf = PoseInference(cfg, device="cuda")
    assert inf.fold is False  # LiteHRNet does not fold
    calibrate_batch_stats(inf.model, cfg)
    frames, bboxes = make_requests(8, seed=30)
    reset_launches()
    for n in (1, 3, 8):
        t0 = time.perf_counter()
        kpts, scores = inf.predict_batch(frames[:n], bboxes[:n])
        dt = time.perf_counter() - t0
        log(f"[lite-serve] bf16 batch {n}: {dt * 1e3:.1f} ms")
        assert kpts.shape == (n, 17, 2) and np.isfinite(kpts).all()
        assert np.isfinite(scores).all()
    assert not any(launches().values()), launches()
    compare_f32_serving(inf.model.state_dict(), frames, bboxes,
                        "lite-serve", HEATMAP_ATOL, KEYPOINT_ATOL_PX,
                        lite_cfg(dtype="float32"))
    out = phase_throughput(inf, smi, "lite-throughput")
    frames32, bboxes32 = make_requests(32, seed=2)
    reset_launches()
    out.update(profile_steps(lambda: inf.predict_batch(frames32, bboxes32),
                             out["batch32_ms"], tag="lite-serve",
                             what="batch"))
    out["launches"] = sum(launches().values())
    assert out["launches"] == 0, launches()
    out["idle_share"] = max(0.0, 1 - out["device_ms"] / out["batch32_ms"])
    log(f"[lite-serve] lightweight bf16 b=32 flip: {out['crops_per_s']:.1f} "
        f"crops/s, batch {out['batch32_ms']:.2f} ms, device "
        f"{out['device_ms']:.2f} ms ({out['kernels_per_step']} kernels), "
        f"idle share {out['idle_share']:.1%}; b=1 {out['batch1_ms']:.2f} ms;"
        f" hand-written kernel launches {out['launches']}; on {smi}")
    return out


def lite_heads(smi: str) -> dict:
    """litehrnet at 256x192 with the fusion, fused and SimCC heads: a
    float32 step at b = 2, card against CPU (every loss term within
    STEP_LOSS_RTOL), and a bf16 step at b = 32 (finite terms); the SimCC
    head also serves without flip, float32 card against CPU."""
    from infantposeestimation_gaussianbias_tpu_torch import (
        PoseInference, create_train_state, make_train_step)

    out = {}
    for head in ("fusion", "fused", "simcc"):
        cfg = lite_cfg(head, "float32")
        assert tuple(cfg.data.input_size) == (192, 256)
        gpu = create_train_state(cfg, device="cuda")
        cpu = create_train_state(cfg, device="cpu", state_dict={
            k: v.cpu() for k, v in gpu.model.state_dict().items()})
        batch = make_train_batch(cfg, 2, seed=31)
        step = make_train_step(cfg)
        _, m_gpu = step(gpu, batch, None)
        _, m_cpu = step(cpu, batch, None)
        worst = 0.0
        for k in m_cpu:
            if k == "grad_norm":
                continue
            a, b = m_gpu[k].item(), m_cpu[k].item()
            rel = abs(a - b) / max(abs(b), 1e-12)
            worst = max(worst, rel)
            assert np.isfinite(a) and rel <= STEP_LOSS_RTOL, (head, k, a, b)
        log(f"[lite-heads] {head} f32 b=2 step card vs CPU: terms "
            + " ".join(f"{k}={m_cpu[k].item():.6g}" for k in m_cpu)
            + f"; largest rel err {worst:.2e}")
        del gpu, cpu
        cfg16 = lite_cfg(head)
        cfg16.train.global_batch_size = TRAIN_BATCH
        state = create_train_state(cfg16, device="cuda")
        step16 = make_train_step(cfg16)
        batch16 = {k: v.cuda() for k, v in
                   make_train_batch(cfg16, TRAIN_BATCH, seed=32).items()}
        reset_launches()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = step16(state, batch16, None)
            values = {k: v.item() for k, v in m.items()}
            times.append(time.perf_counter() - t0)
            assert all(np.isfinite(v) for v in values.values()), values
        assert not any(launches().values()), launches()
        out[head] = dict(f32_worst_rel=worst, step_ms=times[-1] * 1e3,
                         terms=values, card=smi)
        log(f"[lite-heads] {head} bf16 b={TRAIN_BATCH} step: "
            f"{times[-1] * 1e3:.1f} ms (third step), terms "
            + " ".join(f"{k}={v:.6g}" for k, v in values.items())
            + f"; on {smi}")
        del state
    cfg = lite_cfg("simcc", "float32")
    cfg.eval.flip_test = False
    inf = PoseInference(cfg, device="cuda")
    calibrate_batch_stats(inf.model, cfg)
    sd = {k: v.cpu() for k, v in inf.model.state_dict().items()}
    cpu = PoseInference(cfg, state_dict=sd, device="cpu")
    frames, bboxes = make_requests(8, seed=33)
    k_gpu, s_gpu = inf.predict_batch(frames, bboxes)
    k_cpu, s_cpu = cpu.predict_batch(frames, bboxes)
    kp_err = float(np.abs(k_gpu - k_cpu).max())
    s_err = float(np.abs(s_gpu - s_cpu).max())
    log(f"[lite-heads] simcc served without flip, f32 card vs CPU (8 "
        f"frames): keypoints max_abs_err {kp_err:.3e} px, scores "
        f"{s_err:.3e}")
    assert np.isfinite(k_gpu).all() and kp_err <= KEYPOINT_ATOL_PX, kp_err
    out["simcc_serve_kp_err"] = kp_err
    return out


def lite_addons(smi: str) -> dict:
    """CBAM, TransformerNeck (2 layers, 4 heads) and a HeatmapHead with a
    two-layer deconv stack (kernels 4 and 3, 32 filters) on hrnet_w32's
    stride-4 features (BatchNorm calibrated; b = 32, 64 x 48 x 32),
    float32 card against CPU, each output within ADDON_REL_TOL of its
    largest magnitude; the card's ms of each."""
    from infantposeestimation_gaussianbias_tpu_torch.models import (
        CBAM, TransformerNeck, build_model)
    from infantposeestimation_gaussianbias_tpu_torch.models.heads import (
        HeatmapHead)
    from infantposeestimation_gaussianbias_tpu_torch.weights import (
        init_weights)

    cfg = hrnet_cfg("heatmap", "float32")
    model = build_model(cfg, "cuda")
    calibrate_batch_stats(model, cfg)
    x = torch.randn((32, 256, 192, 3), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(34))
    with torch.no_grad():
        feats = model.backbone(x)
    del model
    assert feats.shape == (32, 64, 48, 32), feats.shape
    mods = {"cbam": CBAM(32),
            "neck": TransformerNeck(32, (64, 48), num_layers=2, num_heads=4),
            "deconv_head": HeatmapHead(32, 17, num_deconv_layers=2,
                                       deconv_filters=(32, 32),
                                       deconv_kernels=(4, 3))}
    out = {}
    for i, (name, mod) in enumerate(mods.items()):
        init_weights(mod, seed=35 + i).eval()
        with torch.no_grad():
            y_cpu = mod(feats.cpu())
            mod.cuda()
            y = mod(feats)
        if isinstance(y, dict):
            y, y_cpu = y["heatmaps"], y_cpu["heatmaps"]
        err = (y.cpu() - y_cpu).abs().max().item()
        big = y_cpu.abs().max().item()
        with torch.no_grad():
            ms = cuda_median_ms(lambda: mod(feats), warmup=2, runs=10)
        log(f"[lite-addons] {name} f32 b=32 on 64x48x32 features -> "
            f"{tuple(y.shape)}: card vs CPU max_abs_err {err:.3e} (|y| max "
            f"{big:.3e}); {ms:.3f} ms on {smi}")
        assert torch.isfinite(y).all() and err <= ADDON_REL_TOL * big, (
            name, err, big)
        out[name] = dict(max_abs_err=err, max_abs=big, ms=ms, card=smi)
    return out


def lite_tools(smi: str) -> dict:
    """The tools that default to LiteHRNet: the pipeline proof (AP held
    to PROOF_AP_MIN) and the overfit check (OVERFIT_STEPS steps)."""
    from infantposeestimation_gaussianbias_tpu_torch.tools import (
        overfit_check, pipeline_proof)

    t0 = time.perf_counter()
    proof = pipeline_proof.run(epochs=LITE_PROOF_EPOCHS,
                               ap_threshold=PROOF_AP_MIN, device="cuda",
                               verbose=False)
    proof["seconds"] = time.perf_counter() - t0
    log(f"[lite-tools] pipeline proof (litehrnet + heatmap, 128x128, b = "
        f"16, {LITE_PROOF_EPOCHS} epochs of 64 rendered images, "
        f"{int(proof['steps'])} steps): AP {proof['AP']:.4f} (bound "
        f"{PROOF_AP_MIN}), AP50 {proof['AP50']:.4f}; training "
        f"{proof['train_s']:.1f} s, validation {proof['val_s']:.2f} s; "
        f"on {smi}")
    over = overfit_check.run(steps=OVERFIT_STEPS, device="cuda",
                             verbose=False)
    log(f"[lite-tools] overfit check (litehrnet + fusion, 256x192, b = 16, "
        f"bf16, {OVERFIT_STEPS} steps): keypoint error {over['e0']:.2f} -> "
        f"{over['e1']:.2f} px (bound 0.3 x), final loss {over['loss']:.4g}, "
        f"{over['train_s']:.1f} s ({over['train_s'] / OVERFIT_STEPS * 1e3:.1f}"
        f" ms a step); on {smi}")
    return dict(pipeline_proof=proof, overfit=over)


def phase_lite(smi: str) -> dict:
    """Phase 28: the lightweight config (LiteHRNet + heatmap) served and
    trained, litehrnet with the fusion, fused and SimCC heads, the
    attention add-ons and the deconv head, and the tools that default to
    LiteHRNet.  No hand-written kernel lies on this path: every launch
    count stays 0."""
    out = dict(serving=lite_serving(smi))
    conv_train_agreement_f32(lite_cfg(dtype="float32"), "lite-train")
    cfg = lite_cfg()
    assert cfg.train.global_batch_size == LITE_TRAIN_BATCH
    out["train"] = train_bf16(smi, cfg, "lite-train", no_launches(),
                              batch_size=LITE_TRAIN_BATCH, warmup=3,
                              timed=LITE_TRAIN_STEPS - 3)
    out["heads"] = lite_heads(smi)
    out["addons"] = lite_addons(smi)
    out["tools"] = lite_tools(smi)
    t = out["train"]
    log(f"[lite] lightweight bf16 training b={LITE_TRAIN_BATCH}: "
        f"{t['step_ms']:.2f} ms a step, {t['images_per_s']:.1f} images/s, "
        f"peak memory {t['peak_gib']:.2f} GiB, device {t['device_ms']:.2f} "
        f"ms a step; on {smi}")
    return out


# -- phase 20 (with --parent): this checkout's backward kernels and steps
# against the parent commit's, in turns ------------------------------------------

def serve_times(smi: str, flag: str) -> dict:
    """One served bf16 batch of 32 frames with flip through hrformer_base
    under IPE_FUSED_BLOCK=flag ("1" fused, "0" unfused): the median batch
    ms over 8 batches after 3 warm-up, the device ms of one batch
    (torch.profiler, two batches), its K4 and K1 launches, and whether
    the checkout's default serving folds BatchNorm (``folded``: 1.0 or
    0.0; a checkout without BN-fold serving reads 0.0)."""
    from infantposeestimation_gaussianbias_tpu_torch import (PoseInference,
                                                              get_variant)

    inf = PoseInference(get_variant("hrformer_base"), device="cuda")
    frames, bboxes = make_requests(32, seed=2)
    tag = "times-serve-" + ("fused" if flag == "1" else "unfused")
    with fused_blocks(flag):
        for _ in range(3):
            inf.predict_batch(frames, bboxes)
        times = []
        for _ in range(8):
            t0 = time.perf_counter()
            inf.predict_batch(frames, bboxes)
            times.append(time.perf_counter() - t0)
        reset_launches()
        inf.predict_batch(frames, bboxes)
        got = launches()
        batch_ms = float(np.median(times)) * 1e3
        prof = profile_steps(lambda: inf.predict_batch(frames, bboxes),
                             batch_ms, tag=tag, what="batch")
    # the parent's PoseInference has no fold; this checkout's folds
    return dict(batch_ms=batch_ms, device_ms=prof["device_ms"], k4=got["k4"],
                k1=got["k1"], folded=float(getattr(inf, "fold", False)))


def bwd_times(smi: str) -> dict:
    """Median ms of K2 at every training shape of phase 3, of K4's
    backward at every training shape of phase 7, of K4's forward at every
    hrformer_base branch at b = 64 and 32, window 7 and 8, of K5's forward
    at every branch at b = 64 and 32 and of its backward at b = 32 (window
    7; all float32 and bf16), of K6 at every hrnet_w32 3x3 shape at b = 32
    (float32 and bf16); K1 and K1-hm at every BRANCH_SHAPES row at b = 64
    and 32, and K1 on the head range of K3's rank 0 (b = 32, half the
    windows and heads) at hrformer_base's branches (float32 and bf16); the
    bf16 b = 32 steps of phases 6 (unfused) and 9 (fused): step ms, device
    ms, peak memory; one fused and one unfused served bf16 batch
    (``serve_times``); K9 and K10 at every shape of the int8 path and the
    int8 served batches beside the folded ones (``int8_times``).  Runs
    whichever package ``sys.path``
    finds first, so that a parent commit's checkout can be timed by the
    same code."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import (
        conv_wgrad as cw, fused_block as fb, window_msa)

    g = torch.Generator(device="cuda").manual_seed(11)
    kernels = {}
    for label, w, N, H, hd in BRANCH_SHAPES:
        for B in (SERVE_BATCH, TRAIN_BATCH):
            nW, C = B * w, H * hd
            qkv32 = torch.randn(nW, N, 3 * C, device="cuda", generator=g)
            bias = torch.randn(H, N, N, device="cuda", generator=g)
            for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                qkv = qkv32.to(dt)
                qh, kh, vh = (qkv.view(nW, N, 3, H, hd)[:, :, i]
                              .permute(2, 0, 1, 3).contiguous()
                              for i in range(3))
                kernels[f"k1 {label} b={B} {name}"] = cuda_median_ms(
                    lambda: window_msa.window_attention_qkv(qkv, bias, H))
                kernels[f"k1hm {label} b={B} {name}"] = cuda_median_ms(
                    lambda: window_msa.window_attention_hm(qh, kh, vh, bias))
                if B == TRAIN_BATCH and label.count(" ") == 1 \
                        and label.startswith("base"):
                    # K3's forward on rank 0 of the 2 x 2 grid (phase 17):
                    # half the batch, the first half of the heads
                    half, hl = qkv[:nW // GRID[0]].contiguous(), H // GRID[1]
                    kernels[f"k3fwd {label} {name}"] = cuda_median_ms(
                        lambda: window_msa.window_attention_qkv(
                            half, bias, H, (0, hl)))
                del qkv, qh, kh, vh
            del qkv32
    for label, w, N, H, hd in BRANCH_SHAPES:
        nW, C = TRAIN_BATCH * w, H * hd
        qkv32 = torch.randn(nW, N, 3 * C, device="cuda", generator=g)
        dout32 = torch.randn(nW, N, C, device="cuda", generator=g)
        bias = torch.randn(H, N, N, device="cuda", generator=g)
        for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            qkv, dout = qkv32.to(dt), dout32.to(dt)
            kernels[f"k2 {label} {name}"] = cuda_median_ms(
                lambda: window_msa.window_attention_qkv_bwd(qkv, bias, dout,
                                                            H))
    for label, Hm, Wm, C, heads in BASE_MAPS:
        for ws in (7, 8):
            for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                a = _half_inputs(Hm, Wm, C, heads, TRAIN_BATCH, dt, g, ws)
                aa, dy, geom = _attn_args(a), a["dy"], a["geom"]
                tag = f"{label}{' ws8' if ws == 8 else ''}"
                kernels[f"k4bwd {tag} {name}"] = cuda_median_ms(
                    lambda: fb.fused_attn_half_bwd(*aa, dy, heads, geom),
                    warmup=2, runs=10)
                del a, aa, dy
                for B in (SERVE_BATCH, TRAIN_BATCH):
                    a = _half_inputs(Hm, Wm, C, heads, B, dt, g, ws)
                    aa, geom = _attn_args(a), a["geom"]
                    kernels[f"k4fwd {tag} b={B} {name}"] = cuda_median_ms(
                        lambda: fb.fused_attn_half_fwd(*aa, heads, geom),
                        warmup=2, runs=10)
                    del a, aa
        for B in (SERVE_BATCH, TRAIN_BATCH):
            for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                a = _half_inputs(Hm, Wm, C, heads, B, dt, g)
                ma, dy2, tps = _mlp_args(a), a["dy"].reshape(-1, C), a["tps"]
                kernels[f"k5fwd {label} b={B} {name}"] = cuda_median_ms(
                    lambda: fb.fused_mlp_half_fwd(*ma, tps), warmup=2,
                    runs=10)
                if B == TRAIN_BATCH:
                    kernels[f"k5bwd {label} b={B} {name}"] = cuda_median_ms(
                        lambda: fb.fused_mlp_half_bwd(*ma, dy2, tps),
                        warmup=2, runs=10)
                del a, ma, dy2
    for H, W, Ci, Co in hrnet_conv3x3_shapes():
        x32 = torch.randn(TRAIN_BATCH, H, W, Ci, device="cuda", generator=g)
        dy32 = torch.randn(TRAIN_BATCH, H, W, Co, device="cuda", generator=g)
        for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x, dy = x32.to(dt), dy32.to(dt)
            kernels[f"k6 {H}x{W} {Ci}->{Co} {name}"] = cuda_median_ms(
                lambda: cw.conv3x3_wgrad(x, dy), runs=10)
        del x32, dy32, x, dy
    kernels.update(k7_k8_times(g))
    n = K1_CALLS_PER_FORWARD
    steps = {}
    for flag, tag, want in (
            ("0", "unfused", dict(no_launches(), k1=n, k2=n)),
            ("1", "fused", dict(no_launches(), k4=n, k4b=n, k5=n, k5b=n))):
        with fused_blocks(flag):
            r = train_bf16(smi, hrformer_cfg(), f"times-{tag}", want)
        steps[tag] = {k: r[k] for k in ("step_ms", "device_ms", "peak_gib")}
        torch.cuda.empty_cache()
    steps["serve_fused"] = serve_times(smi, "1")
    steps["serve_unfused"] = serve_times(smi, "0")
    int8_kernels, int8_steps = int8_times(smi)
    kernels.update(int8_kernels)
    steps.update(int8_steps)
    return dict(kernels=kernels, steps=steps, digests=kernel_digests())


def int8_times(smi: str) -> tuple:
    """Phase 20's int8 keys: K9 at every distinct int8 conv call of a
    served hrnet_w32 + fusion forward at b = 64 (32 crops with flip) and
    K10 at every wide Dense call of hrformer_base's (bf16), each call's
    arguments captured from the calibrated int8 model (median event ms,
    ``k9``/``k10`` keys; the ms of one call replayed in a CUDA graph,
    ``k9graph``/``k10graph``, the device's time without the host's; at the
    record shapes the host µs of one wrapper call, ``k9host``/``k10host``);
    and one served bf16 int8 batch of 32 frames with flip of hrnet_w32 +
    heatmap and of hrformer_base, each beside the folded model's: batch
    ms, device ms, kernels, K9 and K10 launches.  Uses only what the int8
    path has had from its first version on, so that a parent checkout
    runs it."""
    from infantposeestimation_gaussianbias_tpu_torch import (PoseInference,
                                                              get_variant)
    from infantposeestimation_gaussianbias_tpu_torch.kernels import quant as qk

    frames, bboxes = make_requests(SERVE_BATCH, seed=27)
    kernels, steps = {}, {}
    for name, head, fn, key_fn, kind, shape_of in (
            ("hrnet_w32", "fusion", "qconv", _qconv_key, "k9", k9_shape),
            ("hrformer_base", "fusion", "qdense", _qdense_key, "k10",
             k10_shape)):
        cfg = get_variant(name)
        cfg.model.head_type = head
        crops = normalized_crops(cfg, frames, bboxes)
        inf = PoseInference(cfg, device="cuda", quantize=True,
                            calibration_crops=crops[:INT8_CALIB_CROPS])
        with torch.inference_mode(), captured(qk, fn, {}, key_fn) as calls:
            inf.model(crops)
        with torch.inference_mode():
            for args, kw in calls.values():
                call = lambda: getattr(qk, fn)(*args, **kw)  # noqa: E731
                name = shape_of(args, kw)
                kernels[f"{kind} {name}"] = cuda_median_ms(call)
                kernels[f"{kind}graph {name}"] = graph_ms(call)
                if name in (K9_RECORD_SHAPE, K10_RECORD_SHAPE):
                    # host microseconds of one wrapper call, as "ms" keys
                    # hold them: phase 20 logs every key alike
                    kernels[f"{kind}host {name}"] = host_us(call)
        del inf, calls, crops
    for name, head in (("hrnet_w32", "heatmap"), ("hrformer_base", "fusion")):
        cfg = get_variant(name)
        cfg.model.head_type = head
        calib = normalized_crops(cfg, *make_requests(INT8_CALIB_CROPS,
                                                     seed=29))
        for mode, inf in (("int8", PoseInference(
                cfg, device="cuda", quantize=True, calibration_crops=calib)),
                          ("folded", PoseInference(cfg, device="cuda"))):
            f32, b32 = frames[:32], bboxes[:32]
            for _ in range(3):
                inf.predict_batch(f32, b32)
            times = []
            for _ in range(8):
                t0 = time.perf_counter()
                inf.predict_batch(f32, b32)
                times.append(time.perf_counter() - t0)
            reset_launches()
            inf.predict_batch(f32, b32)
            got = launches()
            batch_ms = float(np.median(times)) * 1e3
            prof = profile_steps(lambda: inf.predict_batch(f32, b32),
                                 batch_ms, tag=f"times-serve-{mode}-{name}",
                                 what="batch")
            steps[f"serve_{mode} {name}"] = dict(
                batch_ms=batch_ms, crops_per_s=32e3 / batch_ms,
                device_ms=prof["device_ms"],
                kernels=float(prof["kernels_per_step"]), k9=got["k9"],
                k10=got["k10"])
            del inf
            torch.cuda.empty_cache()
    return kernels, steps


# K8's shapes in phase 20: the probe's default and hrformer_base b0 at
# b = 64 ("nW,N,C,H"), and the windows per block both the parent (K1's
# first body, which fits 4 windows of 49 tokens at hd 32 and 39 but not 8)
# and this checkout take; packslim at G.
K8_TIMED_SHAPES = [("default", "8960,49,32,1"), ("base b0", "4480,49,78,2")]
K8_TIMED_WPB = (1, 4)


def k7_k8_times(g) -> dict:
    """Phase 20's K7 and K8 keys: K7 (4 blocks) at every hrnet_w32 branch
    at b = 32, float32 and bf16 (median event ms); K8's five variants at
    K8_TIMED_SHAPES, each at K8_TIMED_WPB windows per block (packslim at
    G), timed as the probe times them (CUDA-graph replays, ms)."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import (
        residual_block as rb, window_msa_ablate as ablate)
    from infantposeestimation_gaussianbias_tpu_torch.tools import (
        probe_wmsa_ablate as probe)

    out = {}
    for label, H, W, C in HRNET_MAPS:
        x32 = torch.randn(HRNET_SERVE_BATCH, H, W, C, device="cuda",
                          generator=g)
        for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            w, ab = rb.pack_basic_block_params(_random_blocks(C, dt, g), dt)
            x = x32.to(dt)
            out[f"k7 {label} b={HRNET_SERVE_BATCH} {name}"] = cuda_median_ms(
                lambda: rb.fused_residual_chain(x, w, ab, 4), runs=15)
    for label, shape in K8_TIMED_SHAPES:
        nW, N, C, H = (int(v) for v in shape.split(","))
        qkv, bias = probe.make_inputs(nW, N, C, H, "cuda")
        G = ablate.pack_factor(H, C, N)
        pbias = ablate.packed_bias(bias, G)
        for variant in ablate.VARIANTS:
            for wpb in ((G,) if variant == "packslim" else K8_TIMED_WPB):
                b = pbias if variant == "packslim" else bias
                sec = probe.chained_time(
                    lambda: ablate.window_attention_ablate(variant, qkv, b,
                                                           H, wpb),
                    qkv.device)
                out[f"k8 {label} {variant}@{wpb}"] = 1e3 * sec
    return out


def kernel_digests() -> dict:
    """sha256 of the outputs of K1, K1-hm, K2 and K4 (forward and backward)
    at hrformer_base b0, b = 32, float32 and bf16, on inputs from a seeded
    generator: phase 20 holds the parent's against this checkout's, since
    this checkout's kernels share csrc/wmsa_core.cuh and K1's kernel with
    K8.  Each is taken twice; where the two differ (a kernel whose bits
    are not reproducible in one process) the key holds None, and phase 20
    reports it instead of comparing."""
    import hashlib

    from infantposeestimation_gaussianbias_tpu_torch.kernels import (
        fused_block as fb, window_msa)

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
        return h.hexdigest()[:16]

    g = torch.Generator(device="cuda").manual_seed(20)
    _, w, N, H, hd = BRANCH_SHAPES[0]
    _, Hm, Wm, C, heads = BASE_MAPS[0]
    nW = TRAIN_BATCH * w
    qkv32 = torch.randn(nW, N, 3 * H * hd, device="cuda", generator=g)
    dout32 = torch.randn(nW, N, H * hd, device="cuda", generator=g)
    bias = torch.randn(H, N, N, device="cuda", generator=g)
    out = {}
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        qkv, dout = qkv32.to(dt), dout32.to(dt)
        qh, kh, vh = (qkv.view(nW, N, 3, H, hd)[:, :, i].permute(2, 0, 1, 3)
                      .contiguous() for i in range(3))
        a = _half_inputs(Hm, Wm, C, heads, TRAIN_BATCH, dt, g)
        aa, dy, geom = _attn_args(a), a["dy"], a["geom"]
        calls = {
            "k1": lambda: window_msa.window_attention_qkv(qkv, bias, H),
            "k1hm": lambda: window_msa.window_attention_hm(qh, kh, vh, bias),
            "k2": lambda: window_msa.window_attention_qkv_bwd(qkv, bias,
                                                              dout, H),
            "k4fwd": lambda: fb.fused_attn_half_fwd(*aa, heads, geom),
            "k4bwd": lambda: fb.fused_attn_half_bwd(*aa, dy, heads, geom),
        }
        for key, fn in calls.items():
            first, again = digest(*_tensors(fn())), digest(*_tensors(fn()))
            out[f"{key} {name}"] = first if first == again else None
    return out


def _tensors(x) -> list:
    """The tensors of a kernel wrapper's result, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in _tensors(item)]
    return []


def phase_parent(parent: str) -> dict:
    """``bwd_times`` of the parent checkout ``parent`` and of this one, each
    in a fresh subprocess that imports that checkout's package and builds
    its kernels, in turns: parent, change, change, parent.  Logs each pair;
    returns per key the means {"parent_ms", "ms"} and the steps of both."""
    here = os.path.dirname(os.path.abspath(__file__))

    def run(root: str, side: str, profile: bool = False) -> dict:
        proc = subprocess.run(
            [sys.executable, os.path.join(here, "chip_smoke.py"),
             "--bwd-times", "--package-root", os.path.abspath(root)],
            capture_output=True, text=True, timeout=900)
        if proc.returncode:
            log(proc.stdout[-4000:], proc.stderr[-4000:])
            raise RuntimeError(f"timing {root} failed ({proc.returncode})")
        lines = proc.stdout.strip().splitlines()
        if profile:  # the served batches' device time by kernel
            for line in lines:
                if "times-serve-" in line:
                    log(f"[parent] {side}: {line}")
        return json.loads(lines[-1])

    p1, c1 = run(parent, "parent", True), run(here, "change", True)
    c2, p2 = run(here, "change"), run(parent, "parent")
    kernels = {}
    for key in p1["kernels"]:
        ps = [r["kernels"][key] for r in (p1, p2)]
        cs = [r["kernels"][key] for r in (c1, c2)]
        kernels[key] = dict(parent_ms=float(np.mean(ps)), ms=float(np.mean(cs)))
        unit = "us" if "host " in key else "ms"
        log(f"[parent] {key}: parent {ps[0]:.4f}/{ps[1]:.4f} {unit}, change "
            f"{cs[0]:.4f}/{cs[1]:.4f} {unit}, change/parent "
            f"{kernels[key]['ms'] / kernels[key]['parent_ms']:.3f}")
    for kind, name in (("k9", "K9"), ("k10", "K10"),
                       ("k9graph", "K9 in graph replays"),
                       ("k10graph", "K10 in graph replays")):
        keys = [k for k in kernels if k.startswith(kind + " ")]
        if keys:
            ps = sum(kernels[k]["parent_ms"] for k in keys)
            cs = sum(kernels[k]["ms"] for k in keys)
            worst = max(keys, key=lambda k: kernels[k]["ms"]
                        / kernels[k]["parent_ms"])
            kernels[f"{kind} sum"] = dict(parent_ms=ps, ms=cs)
            log(f"[parent] {name} over its {len(keys)} shapes: parent "
                f"{ps:.4f} ms, change {cs:.4f} ms, change/parent "
                f"{cs / ps:.3f}; the worst shape {worst}: change/parent "
                f"{kernels[worst]['ms'] / kernels[worst]['parent_ms']:.3f}")
    for key, want in p1["digests"].items():
        got = [r["digests"].get(key) for r in (p2, c1, c2)]
        log(f"[parent] bits {key}: parent {want}, change {got[1]}")
        if want is None or None in got:
            log(f"[parent] bits {key}: not reproducible in one process; "
                "not compared")
        else:
            assert got == [want] * 3, (key, want, got)
    steps = {}
    for tag, values in p1["steps"].items():
        steps[tag] = {}
        what = "served batch" if tag.startswith("serve") else "step"
        for k in values:
            ps = [r["steps"][tag][k] for r in (p1, p2)]
            cs = [r["steps"][tag][k] for r in (c1, c2)]
            steps[tag][k] = dict(parent=float(np.mean(ps)),
                                 change=float(np.mean(cs)))
            log(f"[parent] bf16 b={TRAIN_BATCH} {tag} {what} {k}: parent "
                f"{ps[0]:.4f}/{ps[1]:.4f}, change {cs[0]:.4f}/{cs[1]:.4f}")
        if "folded" in values:
            sides = {side: "folded" if steps[tag]["folded"][side] else
                     "unfolded" for side in ("parent", "change")}
            log(f"[parent] {tag}: the parent serves {sides['parent']}, this "
                f"checkout {sides['change']} (its default, BN-fold): the "
                f"served batches' difference includes the fold's")
    return dict(kernels=kernels, steps=steps)


# -- phase 29: the last surfaces ------------------------------------------------

EXPORT_BATCH = 32          # frames a call of an exported program (flip test on)
EXPORT_FRAME_HW = (480, 640)
# Float exported programs run the live pipeline's ATen ops and kernels in
# the same order: off decode ties their keypoints may differ only by the
# float32 card bounds of phase 4 (KEYPOINT_ATOL_PX) and their scores by
# EXPORT_SCORE_ATOL; int8 programs must equal the live pipeline bit for
# bit (every int8 step exact), as JAX's int8 export round trip does.
EXPORT_SCORE_ATOL = 1e-4
# (label, variant, head, IPE_FUSED_BLOCK, int8, the kernels a call
# launches: K1 a block and pass; K4 and K5 a block and pass; K9 each
# int8 ConvNorm and pass; K10 each quantized Dense and pass, with K1)
EXPORTS = (
    ("a", "hrformer_base", "fusion", "0", False,
     dict(k1=2 * K1_CALLS_PER_FORWARD)),
    ("b", "hrformer_base", "fusion", "1", False,
     dict(k4=2 * K1_CALLS_PER_FORWARD, k5=2 * K1_CALLS_PER_FORWARD)),
    ("c", "hrnet_w32", "heatmap", "0", True, dict(k9=2 * HRNET_W32_QCONVS)),
    ("d", "hrformer_base", "fusion", "0", True,
     dict(k1=2 * K1_CALLS_PER_FORWARD, k10=2 * HRFORMER_BASE_QDENSE)),
)
VIDEO_FRAMES = 16
EXPORT_WORKER_TIMEOUT_S = 600.0
PROBE_ENV = dict(PROBE_CLIENTS="16", PROBE_REQS="8", PROBE_QUANT="0")


def export_inference(variant: str, head: str, int8: bool):
    """The live PoseInference an exported program is made from: seeded
    weights, BatchNorm calibrated (HRNet, as phase 12) or perturbed
    (HRFormer), BN-folded, or int8 calibrated on INT8_CALIB_CROPS crops."""
    from infantposeestimation_gaussianbias_tpu_torch import (PoseInference,
                                                              get_variant)
    from infantposeestimation_gaussianbias_tpu_torch.models import (
        build_model)

    cfg = hrnet_cfg(head) if variant == "hrnet_w32" else get_variant(variant)
    cfg.model.head_type = head
    model = build_model(cfg, "cuda")
    if variant == "hrnet_w32":
        calibrate_batch_stats(model, cfg)
    else:
        perturb_bn(model, seed=29)
    calib = None
    if int8:
        calib = normalized_crops(cfg, *make_requests(INT8_CALIB_CROPS,
                                                     seed=29))
    inf = PoseInference(cfg, state_dict=model.state_dict(), device="cuda",
                        quantize=int8, calibration_crops=calib)
    assert inf.fold != int8
    return inf


def export_case(label: str, variant: str, head: str, int8: bool,
                want: dict, smi: str, turn=contextlib.nullcontext) -> dict:
    """Export, save, load and call the served pipeline of one model at
    EXPORT_BATCH frames; the loaded program against the live pipeline on
    the same inputs, launch for launch; its blob size, export and load
    seconds, and its crops/s beside predict_batch's (printed only), timed
    inside ``turn()`` (the card and the host to itself)."""
    from infantposeestimation_gaussianbias_tpu_torch.tools import (
        export_model)

    inf = export_inference(variant, head, int8)
    frames, bboxes = make_requests(EXPORT_BATCH, seed=30)
    centers = (bboxes[:, :2] + bboxes[:, 2:]) / 2
    scales = (bboxes[:, 2:] - bboxes[:, :2]) * inf.cfg.data.bbox_padding
    t0 = time.perf_counter()
    blob = export_model.export_serving(
        export_model.ServingPipeline(inf, EXPORT_FRAME_HW), EXPORT_BATCH)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    program = export_model.load_pipeline(blob)
    load_s = time.perf_counter() - t0
    assert program.device == torch.device("cuda", 0), program.device
    args = tuple(torch.from_numpy(a).cuda() for a in (frames, centers,
                                                      scales))
    reset_launches()
    k, s = program.call(*args)
    torch.cuda.synchronize()
    got = launches()
    reset_launches()
    live_k, live_s = inf._pipeline(*args)
    torch.cuda.synchronize()
    live = launches()
    assert got == live == dict(no_launches(), **want), (label, got, live)
    assert k.shape == (EXPORT_BATCH, 17, 2) and s.shape == (EXPORT_BATCH, 17)
    assert torch.isfinite(k).all() and torch.isfinite(s).all()
    equal = torch.equal(k, live_k) and torch.equal(s, live_s)
    kp_err = float((k - live_k).abs().max())
    score_err = float((s - live_s).abs().max())
    if int8:
        assert equal, (label, kp_err, score_err)
        left = 0
    else:
        unsure = _unsure_keypoints(flip_heatmaps_of(inf, frames, bboxes),
                                   head)
        off = (k - live_k).abs().amax(-1).cpu().numpy()
        kp_err = float(off[~unsure].max())
        left = int(unsure.sum())
        assert kp_err <= KEYPOINT_ATOL_PX and score_err <= EXPORT_SCORE_ATOL, (
            label, kp_err, score_err)

    def program_batch():
        kk, ss = program.call(*(torch.from_numpy(a).cuda()
                                for a in (frames, centers, scales)))
        return kk.cpu(), ss.cpu()

    ms = {}
    with turn():
        for name, fn in (("program", program_batch),
                         ("predict_batch",
                          lambda: inf.predict_batch(frames, bboxes))):
            fn()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[name] = float(np.median(times))
    rec = dict(variant=variant, head=head, int8=int8, blob_mb=len(blob) / 1e6,
               export_s=export_s, load_s=load_s, launches=got,
               bit_equal=equal, max_kp_err=kp_err, max_score_err=score_err,
               ties_left_out=left,
               crops_per_s=EXPORT_BATCH / ms["program"] * 1e3,
               predict_batch_crops_per_s=EXPORT_BATCH / ms["predict_batch"]
               * 1e3, batch_ms=ms["program"],
               predict_batch_ms=ms["predict_batch"])
    log(f"[export] ({label}) {variant} + {head} "
        f"{'int8' if int8 else 'folded'}"
        f"{' IPE_FUSED_BLOCK=1' if 'k4' in want else ''} b={EXPORT_BATCH} "
        f"flip: {rec['blob_mb']:.1f} MB, export {export_s:.1f} s, load "
        f"{load_s:.1f} s; launches a call {dict((k_, v) for k_, v in got.items() if v)} "
        f"= the live pipeline's; against it: "
        f"{'bit for bit' if equal else f'keypoints {kp_err:.3e} px off {left} ties, scores {score_err:.3e}'}; "
        f"{rec['crops_per_s']:.1f} crops/s ({ms['program']:.1f} ms a batch) "
        f"against predict_batch's {rec['predict_batch_crops_per_s']:.1f} "
        f"({ms['predict_batch']:.1f} ms); on {smi}")
    return rec


def surfaces_analyze() -> dict:
    """cli/analyze's computing half on hrformer_base (bf16, seeded):
    parameters.txt, activations.json, three finite maps; K1 and K2
    launches: the activation capture's forward, the saliency map's forward
    and backward, Grad-CAM's backbone forward, occlusion's base image and
    its occluded images OCCLUSION_BATCH at a time."""
    import tempfile

    from infantposeestimation_gaussianbias_tpu_torch.analysis.introspection import (
        OCCLUSION_BATCH)
    from infantposeestimation_gaussianbias_tpu_torch.cli import analyze

    cfg = hrformer_cfg()
    W, H = cfg.data.input_size
    patch = max(H // 8, 8)
    occluded = len(range(0, H - patch + 1, patch)) * len(
        range(0, W - patch + 1, patch))
    forwards = 1 + 1 + 1 + 1 + -(-occluded // OCCLUSION_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        t0 = time.perf_counter()
        out = analyze.analyze_model(cfg, tmp, device="cuda")
        secs = time.perf_counter() - t0
        got = launches()
        files = sorted(os.listdir(tmp))
    assert files == ["activations.json", "parameters.txt"], files
    want = dict(no_launches(), k1=forwards * K1_CALLS_PER_FORWARD,
                k2=K1_CALLS_PER_FORWARD)
    assert got == want, got
    shapes = {k: v.shape for k, v in out["maps"].items()}
    assert shapes == {"saliency": (H, W), "gradcam": (H // 4, W // 4),
                      "occlusion": (H // patch, W // patch)}, shapes
    assert all(np.isfinite(v).all() for v in out["maps"].values())
    log(f"[analyze] cli.analyze.analyze_model hrformer_base bf16: "
        f"{out['activations']} activations, {len(out['dead_layers'])} layers "
        f"> 20% dead, maps {shapes}; K1 {got['k1']}, K2 {got['k2']} launches; "
        f"{secs:.1f} s")
    return dict(launches=got, seconds=secs, activations=out["activations"])


def surfaces_validate() -> dict:
    """validate_reference_checkpoint --dry-run at hrnet_w32 + fusion,
    256x192, float and --int8 (4 synthetic images, batch 2, flip test):
    the table printed, AP in [0, 1]; the int8 run's K9 launches: two
    batches of two passes."""
    from infantposeestimation_gaussianbias_tpu_torch.tools import (
        validate_reference_checkpoint as vrc)

    out = {}
    for int8 in (False, True):
        reset_launches()
        t0 = time.perf_counter()
        res = vrc.main(["--dry-run", "--device", "cuda"]
                       + (["--int8"] if int8 else []))
        secs = time.perf_counter() - t0
        got = launches()
        results = res[1] if int8 else res
        assert 0.0 <= results["AP"] <= 1.0, results
        want = dict(no_launches(),
                    k9=2 * 2 * (HRNET_W32_QCONVS + 5) if int8 else 0)
        assert got == want, got
        key = "int8" if int8 else "float"
        out[key] = dict(AP=results["AP"], seconds=secs, launches=got)
        log(f"[validate] dry run hrnet_w32 + fusion {key}: AP "
            f"{results['AP']:.4f}, K9 {got['k9']} launches, {secs:.1f} s")
    return out


def surfaces_probe(smi: str) -> dict:
    """tools/probe_serve_http against cli.serve on folded hrnet_w32 +
    fusion (16 clients x 8 requests): every answer a 200."""
    from infantposeestimation_gaussianbias_tpu_torch.tools import (
        probe_serve_http)

    with contextlib.ExitStack() as stack:
        for k, v in PROBE_ENV.items():
            stack.enter_context(env_var(k, v))
        reset_launches()
        out = probe_serve_http.main(device="cuda")
        got = launches()
    assert out["requests_ok"] == 16 * 8, out
    assert out["errors"] == out["shed_503"] == out["timeout_504"] == 0, out
    assert out["precision"] == "bfloat16-fold", out
    log(f"[probe] HTTP probe, folded hrnet_w32 + fusion, 16 clients x 8 "
        f"requests: {out['requests_per_sec']:.1f} requests/s, latency p50 "
        f"{out['latency_ms_p50']:.1f} / p95 {out['latency_ms_p95']:.1f} / "
        f"p99 {out['latency_ms_p99']:.1f} ms, {out['num_device_batches']} "
        f"batches (sizes {out['batch_sizes']}, mean "
        f"{out['mean_device_batch']:.1f}), predict_batch p50 "
        f"{out['batch_ms_p50']:.1f} ms, {out['batch_ms_sum']:.0f} ms of "
        f"{out['wall_s'] * 1e3:.0f} ms wall in predict_batch; port kernels "
        f"launched {dict((k, v) for k, v in got.items() if v) or 'none'} "
        f"(folded HRNet runs cuDNN); on {smi}")
    return dict(out, launches=got)


def surfaces_video(inf) -> dict:
    """A short synthetic video (cv2) served through ``inf.predict_video``
    (hrformer_base, folded, bf16: K1 88 launches a batch), then
    viz/clinical.create_video_with_pose: every frame written, drawn on."""
    import tempfile

    import cv2

    from infantposeestimation_gaussianbias_tpu_torch.viz.clinical import (
        create_video_with_pose)

    rng = np.random.RandomState(31)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "clip.avi")
        writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                                 (320, 240))
        for _ in range(VIDEO_FRAMES):
            writer.write(rng.randint(0, 255, (240, 320, 3)).astype(np.uint8))
        writer.release()
        reset_launches()
        traj, scores, fps = inf.predict_video(src)
        got = launches()
        out = os.path.join(tmp, "drawn.mp4")
        t0 = time.perf_counter()
        create_video_with_pose(src, traj, scores, out, inf.schema, fps=fps)
        secs = time.perf_counter() - t0
        cap = cv2.VideoCapture(out)
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
    assert traj.shape == (VIDEO_FRAMES, 17, 2) and np.isfinite(traj).all()
    assert got == dict(no_launches(), k1=2 * K1_CALLS_PER_FORWARD), got
    assert n == VIDEO_FRAMES, n
    log(f"[video] predict_video {VIDEO_FRAMES} frames (K1 {got['k1']}), "
        f"create_video_with_pose wrote {n} frames in {secs:.2f} s")
    return dict(launches=got, frames=n)


def export_worker(i: int, smi: str, barrier, lock, results) -> None:
    """EXPORTS[i]'s ``export_case`` in a process of its own (phase 29 runs
    the four at once: tracing and loading a program is single-threaded
    host work, tens of seconds each); the timed section waits until every
    worker has loaded its program, then takes the card and the host in
    turns.  Puts (i, record, None) or (i, None, traceback) on
    ``results``."""
    import traceback

    from infantposeestimation_gaussianbias_tpu_torch.kernels import build

    @contextlib.contextmanager
    def turn():
        barrier.wait(timeout=EXPORT_WORKER_TIMEOUT_S)
        with lock:
            yield

    label, variant, head, flag, int8, want = EXPORTS[i]
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        os.environ[FUSED_ENV] = flag
        build.load()  # built by the parent's phase 1
        results.put((i, export_case(label, variant, head, int8, want, smi,
                                    turn), None))
    except BaseException:
        barrier.abort()  # the others' waits raise instead of hanging
        results.put((i, None, traceback.format_exc()))



def operator_host_us(smi: str) -> dict:
    """Host microseconds of one call of K1, K9 and K10 through the
    registered operator (kernels/ops.py, the exported programs' route)
    against the direct wrapper call (eager serving's), at small shapes
    whose device work hides under the host's: the price of the dispatcher
    hop (ROADMAP Queue 2 item 15).  In turns: wrapper, operator, operator,
    wrapper; the mean of each side's two."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import (
        ops, quant, window_msa)

    g = torch.Generator(device="cuda").manual_seed(32)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device="cuda",
                             dtype=torch.int8)

    def f32(*shape):
        return torch.rand(shape, generator=g, device="cuda") * 0.01

    cases = {
        "k1": (window_msa.window_attention_qkv, ops.window_attention_qkv,
               (torch.randn(8, 49, 3 * 78, generator=g, device="cuda",
                            dtype=torch.bfloat16),
                torch.randn(2, 49, 49, generator=g, device="cuda"), 2)),
        "k9": (quant.qconv, ops.qconv,
               (i8(2, 16, 12, 32), torch.tensor(0.02, device="cuda"),
                i8(32, 3, 3, 32), f32(32), f32(32), 1, True,
                torch.tensor(0.05, device="cuda"), None, None)),
        "k10": (quant.qdense, ops.qdense,
                (torch.randn(98, 156, generator=g, device="cuda",
                             dtype=torch.bfloat16), i8(468, 156), f32(468),
                 f32(468), torch.tensor(0.05, device="cuda"),
                 torch.bfloat16)),
    }
    out = {}
    for k, (wrapper, op, args) in cases.items():
        assert torch.equal(wrapper(*args), op(*args)), k
        times = {"wrapper": [], "operator": []}
        for side in ("wrapper", "operator", "operator", "wrapper"):
            fn = wrapper if side == "wrapper" else op
            times[side].append(host_us(lambda: fn(*args), n=200))
        out[k] = {side: float(np.mean(v)) for side, v in times.items()}
        log(f"[operator] {k}: host {out[k]['operator']:.1f} us a call "
            f"through the operator, {out[k]['wrapper']:.1f} us through the "
            f"wrapper (+{out[k]['operator'] - out[k]['wrapper']:.1f} us); "
            f"on {smi}")
    return out


def phase_surfaces(smi: str) -> dict:
    """Phase 29: the exported programs (a)-(d), one process each (spawned,
    run at once, timed in turns), cli/analyze, the validator's dry run,
    the HTTP probe, the video overlay."""
    import multiprocessing

    from infantposeestimation_gaussianbias_tpu_torch import (PoseInference,
                                                              get_variant)

    ctx = multiprocessing.get_context("spawn")
    barrier, lock, results = ctx.Barrier(len(EXPORTS)), ctx.Lock(), ctx.Queue()
    procs = [ctx.Process(target=export_worker,
                         args=(i, smi, barrier, lock, results))
             for i in range(len(EXPORTS))]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:  # drain the queue before joining
            i, rec, err = results.get(timeout=EXPORT_WORKER_TIMEOUT_S)
            got[i] = (rec, err)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    errors = [err for rec, err in got.values() if err]
    assert not errors and len(got) == len(EXPORTS), "\n".join(errors)
    out = {"exports": {EXPORTS[i][0]: got[i][0] for i in sorted(got)},
           "operator_host_us": operator_host_us(smi)}
    with fused_blocks("0"):
        out["analyze"] = surfaces_analyze()
        out["validate"] = surfaces_validate()
        out["probe"] = surfaces_probe(smi)
        out["video"] = surfaces_video(PoseInference(
            get_variant("hrformer_base"), device="cuda"))
    return out


PHASE_SECONDS: dict = {}
# Every phase in the order main runs them, and what a phase needs run
# before it when --phases chooses it (the served model of 4, the server's
# PoseInference of 22, the bare steps' images/s of 6 and 9).
ALL_PHASES = (2, 3, 4, 5, 7, 8, 6, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
              21, 22, 23, 24, 25, 26, 27, 28, 29, 20)
PHASE_NEEDS = {5: {4}, 8: {4}, 23: {22}, 26: {6, 9}}


def timed(name: str, fn, *args, **kwargs):
    """fn(*args, **kwargs), its seconds logged and kept under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    log(f"[time] {name}: {PHASE_SECONDS[name]:.1f} s")
    return out


CSRC = "infantposeestimation_gaussianbias_tpu_torch/csrc/"
JAX_PKG = "infantposeestimation_gaussianbias_tpu/"
RECORD_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "shape")
RECORD_EXTRA = ("max_rel_err", "variants_ms", "variants_bound_ms",
                "variants_plain_ms", "variants_device_ms", "parent_ms",
                "fresh_ms", "parent_shape", "device_ms", "library_device_ms",
                "split")
K9_RECORD_SHAPE = "64x64x48 32->32 3x3 s1 relu int8-out"
K10_RECORD_SHAPE = "M62720 156->468 bfloat16"


def kernel_entry(name, src, replaces, by_path, rec,
                 root=JAX_PKG + "ops/pallas/") -> dict:
    """One kernel of the kernels' JSON line: its source, what it
    replaces, its launches by path and its record's figures."""
    return {"name": name, "route": "cuda", "source": CSRC + src,
            "replaces": root + replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, **{k: rec[k] for k in RECORD_KEYS},
            **{k: rec[k] for k in RECORD_EXTRA if k in rec}}


def int8_launches_by_path(int8, k: str) -> dict:
    """Launches of kernel ``k`` in phase 27's served int8 batches (b = 32
    with flip and b = 1), by model."""
    if int8 is None:
        return {}
    return {f"serve_int8 {label}": rec["launches"][k] + rec["launches_b1"][k]
            for label, rec in int8["serving"].items() if rec["launches"][k]}


def int8_entries(int8, parent=None, paths=None) -> list:
    """The kernels' JSON entries of K9 and K10 from phase 27: the record
    shape's figures (with phase 20's parent and change ms when it ran),
    every shape's, the split at the record shape; ``paths``: more launches
    by path, by kernel ("k9", "k10"; phase 29's)."""
    out = []
    for kind, name, src, replaces, what, record_shape in (
            ("k9", "qconv_int8", "qgemm.cu", "ops/quant.py:95",
             "XLA int8 conv_general_dilated (qconv_affine, qconv :85); no "
             "TPU kernel", K9_RECORD_SHAPE),
            ("k10", "qdense_int8", "qdense.cu", "ops/quant.py:109",
             "XLA int8 dot_general (qdense); no TPU kernel",
             K10_RECORD_SHAPE)):
        rows = int8["kernels"][kind]
        rec = dict(next(r for r in rows if r["shape"] == record_shape))
        key = f"{kind} {record_shape}"
        if parent and key in parent["kernels"]:
            rec.update(parent_ms=parent["kernels"][key]["parent_ms"],
                       fresh_ms=parent["kernels"][key]["ms"],
                       parent_shape=key)
        by_path = dict(int8_launches_by_path(int8, kind),
                       **(paths or {}).get(kind, {}))
        e = dict(kernel_entry(name, src, replaces, by_path, rec,
                              root=JAX_PKG),
                 sources=[CSRC + src, CSRC + src.replace(".cu", ".cuh"),
                          CSRC + "qgemm_common.cuh"],
                 replaces_kind=what, library=rec["library"], per_shape=rows)
        if kind == "k10":
            e["library_bf16_ms"] = rec["library_bf16_ms"]
        for key, tag in ((f"{kind} sum", ""), (f"{kind}graph sum", "_graph")):
            if parent and key in parent["kernels"]:
                e[f"sum{tag}_parent_ms"] = parent["kernels"][key]["parent_ms"]
                e[f"sum{tag}_fresh_ms"] = parent["kernels"][key]["ms"]
        out.append(e)
    return out


def main(argv: list) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", metavar="DIR",
                        help="a checkout of the parent commit (git archive): "
                        "phase 20 times its K1, K1-hm, K2, K4, K5, K6, K7, "
                        "K8, bf16 steps and served batches against this "
                        "checkout's, in turns")
    parser.add_argument("--phases", metavar="N,N,...",
                        help="run only these phases (default: every "
                        "phase); 0 (device) and 1 (build) always run, and "
                        "so do the phases a chosen one needs: 5 and 8 need "
                        "4, 23 needs 22, 26 needs 6 and 9; 20 needs "
                        "--parent.  The kernels' JSON line then holds the "
                        "kernels of phase 27 only, if it ran")
    parser.add_argument("--bwd-times", action="store_true",
                        help=argparse.SUPPRESS)  # phase 20's subprocess
    parser.add_argument("--package-root", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.package_root:
        sys.path.insert(0, args.package_root)
    if args.bwd_times:
        smi = phase_device()
        phase_build()
        print(json.dumps(bwd_times(smi)), flush=True)
        return 0
    chosen = set(ALL_PHASES)
    if args.phases:
        chosen = {int(n) for n in args.phases.split(",") if n.strip()}
        if not chosen <= set(ALL_PHASES) | {0, 1}:
            parser.error(f"--phases: no phase {sorted(chosen - set(ALL_PHASES))}")
        for n, needs in PHASE_NEEDS.items():
            if n in chosen:
                chosen |= needs
    elif not args.parent:
        chosen.discard(20)
    if 20 in chosen and not args.parent:
        parser.error("phase 20 needs --parent DIR")
    every = chosen == set(ALL_PHASES) - ({20} if not args.parent else set())
    t_start = time.perf_counter()
    smi = timed("0 device", phase_device)
    timed("1 build", phase_build)
    def on(n: int) -> bool:
        return n in chosen

    k1 = timed("2 k1", phase_k1) if on(2) else None
    k2 = timed("3 k2", phase_k2) if on(3) else None
    with fused_blocks("0"):  # the default path: K1 and K2, no fused block
        inf, serve_launches = (timed("4 serving", phase_slice) if on(4)
                               else (None, None))
        thr = timed("5 throughput", phase_throughput, inf, smi) if on(5) else None
    k45 = timed("7 k4/k5", phase_fused_kernels) if on(7) else None
    fused_thr, fused_serve = (timed("8 fused serving", phase_fused_serving,
                                    inf, smi) if on(8) else (None, None))
    del inf

    def train_unfused():
        train_agreement_f32()
        train = train_bf16(smi, hrformer_cfg(), "train", dict(
            no_launches(), k1=K1_CALLS_PER_FORWARD, k2=K1_CALLS_PER_FORWARD))
        train.update(train_remat())
        return train

    def train_fused():
        train_agreement_f32("fused-train", FUSED_STEP_LOSS_RTOL,
                            FUSED_STEP_GRAD_RTOL, FUSED_STEP_STAT_TOL)
        n = K1_CALLS_PER_FORWARD
        result = train_bf16(smi, hrformer_cfg(), "fused-train", dict(
            no_launches(), k4=n, k4b=n, k5=n, k5b=n))
        result["window8"] = fused_train_ws8()
        return result

    with fused_blocks("0"):
        train = timed("6 training", train_unfused) if on(6) else None
    with fused_blocks("1"):
        fused_train = timed("9 fused training", train_fused) if on(9) else None
    k7 = timed("10 k7", phase_k7) if on(10) else None
    k6, k6_shapes = timed("11 k6", phase_k6) if on(11) else (None, None)
    hr_serve = (timed("12 hrnet serving", phase_hrnet_serving, smi) if on(12)
                else None)

    def hrnet_train():
        conv_train_agreement_f32(hrnet_cfg("heatmap", "float32"),
                                 "hrnet-train")
        hr_train = train_bf16(smi, hrnet_cfg("heatmap"), "hrnet-train",
                              no_launches())
        return hr_train, hrnet_fusion_step_k6()

    hr_train, hr_k6 = (timed("13 hrnet training", hrnet_train) if on(13)
                       else (None, None))
    k1hm = timed("14 k1-hm", phase_k1_hm) if on(14) else None
    k8 = timed("15 k8", phase_k8) if on(15) else None
    with fused_blocks("0"):
        analysis = timed("16 analysis", phase_analysis, smi) if on(16) else None
    k3 = timed("17 k3", phase_k3) if on(17) else None
    grid_serve = (timed("18 grid serving", phase_grid_serving, smi) if on(18)
                  else None)
    grid_train = (timed("19 grid training", phase_grid_training, smi)
                  if on(19) else None)
    fold = timed("21 fold", phase_fold, smi) if on(21) else None
    with fused_blocks("0"):
        server, inf16 = (timed("22 server", phase_server, smi) if on(22)
                         else (None, None))
        stream = timed("23 stream", phase_stream, inf16, smi) if on(23) else None
    del inf16
    graft = timed("24 graft entry", phase_graft) if on(24) else None
    post = timed("25 post-processing", phase_postprocess) if on(25) else None
    train_loop = (timed("26 training loop", phase_train_loop, smi,
                        train["images_per_s"], fused_train["images_per_s"])
                  if on(26) else None)
    with fused_blocks("0"):
        int8 = timed("27 int8", phase_int8, smi) if on(27) else None
    lite = timed("28 litehrnet", phase_lite, smi) if on(28) else None
    surf = timed("29 surfaces", phase_surfaces, smi) if on(29) else None
    parent = timed("20 parent", phase_parent, args.parent) if on(20) else None
    loaded = jax_modules()
    assert not loaded, loaded
    if not every:
        log(f"[time] phases {sorted(chosen)} of {len(ALL_PHASES)} in "
            f"{time.perf_counter() - t_start:.1f} s: "
            + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items()))
        if int8 is not None:
            log(json.dumps({"kernels": int8_entries(int8, parent)}))
        if surf is not None:
            log(json.dumps({"surfaces": surf}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    log(f"[fused] bf16 b=32 serving {fused_thr['crops_per_s']:.1f} crops/s "
        f"fused vs {thr['crops_per_s']:.1f} unfused; training "
        f"{fused_train['step_ms']:.1f} ms/step fused vs "
        f"{train['step_ms']:.1f} unfused, peak memory "
        f"{fused_train['peak_gib']:.2f} vs {train['peak_gib']:.2f} GiB")
    log(f"[time] whole run {time.perf_counter() - t_start:.1f} s; phases "
        + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items()))
    log(json.dumps({"slice": thr, "train": train, "fused_slice": fused_thr,
                    "fused_train": fused_train,
                    "hrnet_slice": {h: hr_serve[h]
                                    for h in ("heatmap", "fusion")},
                    "hrnet_train": hr_train, "hrnet_k7_served": hr_serve["k7"],
                    "hrnet_k6_step": hr_k6,
                    "hrnet_conv3x3_shapes": k6_shapes,
                    "k1_hm_relayout": k1hm["relayout"],
                    "k8_per_shape": k8["per_shape"], "analysis": analysis,
                    "fused_train_window8": fused_train["window8"],
                    "grid_slice": grid_serve, "grid_train": grid_train,
                    "fold": fold, "server": server, "stream": stream,
                    "graft_entry": graft, "post": post,
                    "train_loop": train_loop, "int8": int8["serving"],
                    "int8_clis": int8["clis"], "lite": lite,
                    "surfaces": surf}))
    # The redesigned kernels, from phase 20 of this call (null without
    # --parent): the parent commit's ms and this checkout's, both timed the
    # same way in fresh processes (``ms`` is phase 2's, 3's, 7's, 10's,
    # 11's, 14's or 15's, timed in this process), K1, K1-hm, K2, K4, K6, K7
    # and K8 at the record shape, K5 at its worst branch
    # (``parent_shape``); K3's forward (K1 on rank 0's head range) as
    # ``k1_parent_ms`` and ``k1_fresh_ms``; K9 and K10 in int8_entries.
    for rec, key in ((k1, "k1 base b0 b=64 bf16"),
                     (k1hm, "k1hm base b0 b=64 bf16"),
                     (k2, "k2 base b0 bf16"),
                     (k45["attn_fwd"], "k4fwd base b0 b=64 bf16"),
                     (k45["attn_bwd"], "k4bwd base b0 bf16"),
                     (k6, "k6 64x48 32->32 bf16"),
                     (k45["mlp_fwd"], "k5fwd base b3 b=32 bf16"),
                     (k45["mlp_bwd"], "k5bwd base b3 b=32 bf16"),
                     (k7, f"k7 w32 b0 b={HRNET_SERVE_BATCH} bf16"),
                     (k8["record"], "k8 default full@1")):
        for out, src in (("parent_ms", "parent_ms"), ("fresh_ms", "ms")):
            rec[out] = parent["kernels"][key][src] if parent else None
        rec["parent_shape"] = key
    t, ft = train["launches"], fused_train["launches"]
    tl, tlf = train_loop["unfused_total_launches"], train_loop["fused_launches"]
    sal = analysis["saliency_launches"]
    ex = {k: v["launches"] for k, v in surf["exports"].items()}
    an, probe = surf["analyze"]["launches"], surf["probe"]["launches"]
    entry = kernel_entry

    log(json.dumps({"kernels": [
        entry("window_msa_fwd", "window_msa.cu", "window_msa.py:222",
              {"serve": serve_launches, "serve_auto": fused_serve["k1"],
               "train": t["k1"], "analysis_saliency": sal["k1"],
               "serve_http": server["serve_http_k1"], "stream": stream["k1"],
               "train_loop": tl["k1"], **int8_launches_by_path(int8, "k1"),
               "export_a": ex["a"]["k1"], "export_d": ex["d"]["k1"],
               "analyze_cli": an["k1"],
               "video_overlay": surf["video"]["launches"]["k1"],
               "probe_http": probe["k1"]},
              k1),
        entry("window_msa_bwd", "window_msa_bwd.cu", "window_msa.py:422",
              {"train": t["k2"], "analysis_saliency": sal["k2"],
               "train_loop": tl["k2"], "analyze_cli": an["k2"]}, k2),
        entry("fused_attn_half_fwd", "fused_attn.cu", "fused_block.py:562",
              {"serve_fused": fused_serve["k4"], "train_fused": ft["k4"],
               "serve_http": server["serve_http_k4"],
               "train_loop_fused": tlf["k4"], "export_b": ex["b"]["k4"]},
              k45["attn_fwd"]),
        entry("fused_attn_half_bwd", "fused_attn.cu", "fused_block.py:608",
              {"train_fused": ft["k4b"], "train_loop_fused": tlf["k4b"]},
              k45["attn_bwd"]),
        entry("fused_mlp_half_fwd", "fused_mlp.cu", "fused_block.py:220",
              {"serve_fused": fused_serve["k5"], "train_fused": ft["k5"],
               "serve_http": server["serve_http_k5"],
               "train_loop_fused": tlf["k5"], "export_b": ex["b"]["k5"]},
              k45["mlp_fwd"]),
        entry("fused_mlp_half_bwd", "fused_mlp.cu", "fused_block.py:260",
              {"train_fused": ft["k5b"], "train_loop_fused": tlf["k5b"]},
              k45["mlp_bwd"]),
        entry("conv3x3_wgrad", "conv_wgrad.cu", "conv_wgrad.py:106",
              {"hrnet_train_fusion": hr_k6["launches"]}, k6),
        entry("fused_residual_chain", "residual_block.cu",
              "residual_block.py:87",
              {"hrnet_serve": hr_serve["k7"]["launches"]}, k7),
        entry("window_msa_hm_fwd", "window_msa.cu", "window_msa.py:81",
              {"window_major_relayout": k1hm["path_launches"]}, k1hm),
        entry("window_msa_ablate", "window_msa_ablate.cu",
              "tools/probe_wmsa_ablate.py:160", {"probe": k8["launches"]},
              k8["record"], root=JAX_PKG),
        dict(entry("window_msa_sharded", "window_msa.cu", "window_msa.py:483",
                   {"grid_serve_rank0": grid_serve["launches"],
                    "grid_train_rank0": grid_train["launches"],
                    "grid_tp_serve_rank0": grid_serve["tp"]["launches"],
                    "grid_tp_train_rank0": grid_train["tp"]["launches"],
                    "grid_int8_rank0": grid_serve["int8"][
                        "hrformer_base fusion"]["launches"]["k3"]}, k3),
             sources=[CSRC + "window_msa.cu", CSRC + "window_msa_bwd.cu"],
             allreduce_ms=k3["allreduce_ms"], k1_ms=k3["k1_ms"],
             k2_ms=k3["k2_ms"],
             k1_parent_ms=(parent["kernels"]["k3fwd base b0 bf16"]
                           ["parent_ms"] if parent else None),
             k1_fresh_ms=(parent["kernels"]["k3fwd base b0 bf16"]["ms"]
                          if parent else None)),
        *int8_entries(int8, parent, {
            "k9": {"export_c": ex["c"]["k9"],
                   "validate_int8": surf["validate"]["int8"]["launches"]["k9"],
                   "probe_http": probe["k9"],
                   "grid_int8_rank0": grid_serve["int8"][
                       "hrnet_w32 heatmap"]["launches"]["k9"]},
            "k10": {"export_d": ex["d"]["k10"],
                    "grid_int8_rank0": grid_serve["int8"][
                        "hrformer_base fusion"]["launches"]["k10"]}}),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
