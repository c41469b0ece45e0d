// K10: the int8 Dense of int8 PTQ serving, for Hopper (K9, the int8 conv,
// is csrc/qgemm.cu; both share csrc/qgemm_common.cuh).
//
// It replaces no TPU kernel.  The JAX package leaves the op to XLA
// (infantposeestimation_gaussianbias_tpu/ops/quant.py `qdense`, an int8
// `dot_general`); `torch._int_mm` wants K and N in multiples of 8, which
// HRFormer-Base's Dense layers (K = 156, N = 468) are not, and returns
// int32 without the epilogue.
//
// The function (kernels/quant.py `qdense`): rows x (M, K) of float32 or
// bf16, quantized with the static in_scale as
//   q = clamp(rint(x * (1 / in_scale)), -127, 127),
// times w (N, K) int8 into int32, then
//   y = acc * (in_scale * w_scale[o]) + bias[o]
// written as float32 or bf16, each float step rounded on its own and in
// the plain version's order (half to even: `__float2int_rn`, `__frcp_rn`,
// `__float2bfloat16_rn`), so the result equals it bit for bit.
//
// What bounds it: one read of the rows (4 or 2 bytes an element) and one
// write of the output (4 or 2 bytes) against 2 M N K int8 operations; at
// HRFormer-Base's widths (K = 156-2,496) that is 40-600 operations a byte,
// below the card's 590 for int8: bytes bound every shape but the deepest,
// and at the small M of the deep layers (3,072-12,288 rows) the latency of
// the row reads does.  The design, against each:
//  * rows read once: a block owns BM rows (64 or 128, one or two
//    warpgroups of products; the block always has 256 threads, a second
//    warpgroup helping with the reads where one computes), reads them with
//    16-byte loads (8-byte for bf16 rows whose K is not a multiple of 8),
//    eight loads a thread in flight, quantizes them once into shared
//    memory (zero-padded to a multiple of 128, 128-byte-swizzled slices),
//    and keeps them there while it walks its N tiles;
//  * the weights: a copy padded once (kernels/quant.py) to rows of a
//    multiple of 128 bytes and N rounded up to the 128-column tile,
//    streamed through a four-slice ring of 128-byte slices by 16-byte
//    `cp.async`, three slices ahead of the products
//    (`wgmma.mma_async.m64n128k32.s32.s8.s8`, four a slice);
//  * the card's 132 SMs: N is split over blocks only as far as the row
//    tiles fall short of them;
//  * the output: through a 512-byte buffer a warp, 32 bytes of columns of
//    its 16 rows at a time, stored as whole row segments (16, 8 or 4
//    bytes a lane, as the row starts are aligned).
// The kernel and its launch are in csrc/qdense.cuh, with staging, the
// products and the epilogue as compile-time phases: this entry compiles all
// three; csrc/qgemm_ablate_*.cu compile each alone ([k10-split] lines).

#include "qdense.cuh"

// K10 (kernels/quant.py `qdense`); the arguments: csrc/qdense.cuh QdenseArgs.
extern "C" int ipe_qdense(const QdenseArgs* a) { return qdense_run<qg::kPhaseAll>(a); }
