// K9: the int8 conv of int8 PTQ serving, for Hopper (K10, the int8 Dense,
// is csrc/qdense.cu; both share csrc/qgemm_common.cuh).
//
// It replaces no TPU kernel.  The JAX package leaves the op to XLA
// (infantposeestimation_gaussianbias_tpu/ops/quant.py: `qconv` /
// `qconv_affine`, an int8 `conv_general_dilated` with int32 accumulation),
// and stock PyTorch has no CUDA route for it: `F.conv2d` refuses int8
// tensors on the card.
//
// The function (kernels/quant.py `qconv`): an implicit GEMM over NHWC int8
// activations x (B, H, W, C) and int8 weights w (Co, kh, kw, C),
//   M = B * Ho * Wo output pixels, N = Co, K = kh * kw * C,
// row k of the product's depth being (tap r, s; channel c) in that order,
// with symmetric padding kh / 2 and stride 1 or 2.  The epilogue is fused,
// in this order, each float step rounded on its own (`__fmul_rn` /
// `__fadd_rn`), so the result equals the plain version bit for bit:
//   y = acc * (x_scale * eff_scale[o]) + eff_bias[o]
//   y = y + res * res_scale   (an int8 residual)   or   y + res (float32)
//   y = max(y, 0)             (relu)
//   out = clamp(rint(y * (1 / out_scale)), -127, 127) as int8, or y as f32.
// int32 sums are exact in any order, split-K included.
//
// What bounds it: 2 M N K integer operations against one read of x, w and
// the residual and one write of the output.  At HRNet-W32's widths a 3x3
// conv does 0.5-1.9 K operations per byte: bytes bound the narrow branches
// and the 1x1 convs, the int8 tensor cores (1,979 TOPS) the 3x3 convs of
// 128 and 256 channels; at the 16x12 and 8x6 maps the tiles number fewer
// than the SMs, and every small launch pays the host's time to issue it.
// The design, against each:
//  * the tensor cores: `wgmma.mma_async.m64nNk32.s32.s8.s8` with the N tile
//    sized to Co (32, 64, 128 or 256: no zero columns at Co = 32, and the
//    gathered A tile read once for all output channels up to 256), one or
//    two warpgroups of 64 output pixels each; all four products of a slice
//    issued unconditionally (zeros past K), so that nothing but `wgmma`
//    touches the accumulators while they are in flight;
//  * the staging: slices 128 bytes deep (four products each) in a
//    four-slice ring of 128-byte-swizzled tiles (two slices where no split
//    has more: the 1x1 convs), filled by 16-byte `cp.async` (zero-fill for
//    the padding and the ragged edges) two slices ahead of the products,
//    one barrier a slice; each thread keeps the (tap, channel) of its
//    chunk and steps it by 128 without a division.  The gather is an
//    implicit im2col: a 128-pixel tile of (b, oh, ow) is no rectangle of
//    the input at the 8x6 and 16x12 maps or at stride 2, so it is not one
//    TMA box; 16-byte copies of a pixel's channels are.  The stem (C = 3,
//    K = 27) stages four bytes a thread at a time;
//  * the card's 132 SMs: where the tiles number fewer, the plan narrows
//    the N tile (to 64), then splits the depth over blocks (`splits`);
//    each writes its int32 partial tile, and the last block of a tile (a
//    counter) sums them and runs the epilogue;
//  * the epilogue: the accumulators pass through shared memory (the ring,
//    free by then), so the output moves as rows of 8 columns a thread
//    (8-byte int8 or 16-byte float32 stores); the residual tile is
//    prefetched into shared memory behind the products where it fits
//    without costing a block an SM; the per-channel scale and bias are
//    loaded once per block;
//  * the host: one packed argument struct a launch (kernels/quant.py).
// The kernel and its launch are in csrc/qgemm.cuh, with staging, the
// products and the epilogue as compile-time phases: this entry compiles all
// three; csrc/qgemm_ablate_*.cu compile each alone, so that a run can time
// where a launch's time goes (chip_smoke.py's [k9-split] lines).

#include "qgemm.cuh"

// K9 (kernels/quant.py `qconv`); the arguments: csrc/qgemm.cuh QconvArgs.
extern "C" int ipe_qconv(const QconvArgs* a) { return qconv_run<qg::kPhaseAll>(a); }
