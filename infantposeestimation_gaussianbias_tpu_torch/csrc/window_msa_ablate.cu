// K8: in-kernel phase ablation of the W-MSA forward for Hopper.
//
// Replaces the TPU probe's kernels in
// infantposeestimation_gaussianbias_tpu/tools/probe_wmsa_ablate.py
// (`run_variant`'s pallas_call; bodies `_kernel_empty`, `_kernel_gemmonly`,
// `_kernel_softonly`, `_kernel_packslim`, and K1's `_attn_qkv_kernel` as
// `full`).  Each variant streams the same bf16 (nW, N, 3C) qkv through the
// same grid and differs only in the body, so that time differences name
// the phase that sets K1's time.  Variants 0-3 are K1's own kernel
// (csrc/window_msa_fwd.cuh `window_msa_fwd_kernel<bf16, kFlatQkv, P>`:
// grid (chunks of windows_per_block windows, heads), 128 threads, each
// window's q, k, v rows staged by 16-byte cp.async and converted into the
// core's operand tiles by csrc/wmsa_stage.cuh while the previous window
// computes) with phases compiled out:
//   0 empty     the staging and the conversion only, out = q;
//   1 gemmonly  the core's two products on the tensor cores, p = 0.01 s
//               (no bias, no softmax);
//   2 softonly  the core's softmax on the broadcast tile s[i, j] = q[i, 0] +
//               bias[0][i, j] (the probe adds head 0's bias to every head),
//               o = q * sum_j p, no products;
//   3 full      K1's instantiation itself: equal to K1 bit for bit;
//   4 packslim  G windows stacked into G*N rows: all (G*N)^2 scores against
//               the packed bias (-1e30 off the diagonal blocks), softmax,
//               (G*N, G*N) x (G*N, hd) PV (`packslim_kernel` below).
// What bounds each: the same qkv read and out written (0.0336 ms of bytes
// at the probe's default shape, bf16); the products are bf16 mma.sync with
// float32 accumulation (989 TFLOP/s is the card's dense bf16 rate).
//
// packslim: G*N (up to 196 at hd 32) is more than the core's 64 rows, so
// the block stages one group's G*N rows of q, k, v (the same staging) and
// takes them 64 query rows a pass (4 warps x 16) against the keys in
// blocks of 64 with an online softmax (FlashAttention-2's forward), on the
// core's fragment helpers (wcore::a_rows, b_rows, b_cols, a_from_acc): S
// of a key block and its packed bias in the accumulators, the running row
// max and sum rescaling O, P fed back as the A operand of P v.  The masked
// blocks are computed, not skipped: computing them is what the variant
// measures.  Windows past nW are zero rows (their outputs dropped), as the
// TPU pads nW to its block.

#include "window_msa_fwd.cuh"

namespace {

constexpr int kMaxPack = 8;  // packslim's most windows per group
constexpr int kKeyBlock = 64;

// packslim's shared memory: the zero row, q, k, v of one group (GN rows
// each, one bf16 term) and their staging words.
__host__ __device__ __forceinline__ size_t packslim_zeroed_bytes(int GN, int hd) {
  return sizeof(bf16) * (wcore::kZeroRow + 3 * (size_t)GN * wcore::operand_ld(hd));
}

__host__ __device__ __forceinline__ size_t packslim_smem_bytes(int GN, int hd) {
  return packslim_zeroed_bytes(GN, hd) + stage_bytes<bf16>(GN, hd);
}

// Block (c, h): windows [c wpb, (c + 1) wpb) of head h (wpb a multiple of
// G) as groups of G stacked windows, one at a time, the next group's rows
// in flight while this one computes.
__global__ void __launch_bounds__(kThreads)
packslim_kernel(const bf16* __restrict__ qkv, const float* __restrict__ pbias,
                bf16* __restrict__ out, int nW, int N, int C, int hd, float scale, int G,
                int wpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int GN = G * N;
  bf16* zrow = reinterpret_cast<bf16*>(smem);
  bf16* opnd = zrow + wcore::kZeroRow;
  const int ld = wcore::operand_ld(hd), term = GN * ld;
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem + packslim_zeroed_bytes(GN, hd));
  const int h = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int units = (int)(packslim_zeroed_bytes(GN, hd) / 16);
    for (int i = tid; i < units; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  const float* pb = pbias + (size_t)h * GN * GN;
  // The group at window w0: its q, k, v rows, consecutive rows of the qkv,
  // and how many of them hold windows < nW.
  auto tiles = [&](int w0, wstage::Tile<bf16> (&src)[3]) {
#pragma unroll
    for (int s = 0; s < 3; ++s)
      src[s] = {qkv + (size_t)w0 * N * 3 * C + s * C + h * hd, 3 * (size_t)C};
  };
  auto rows_of = [&](int w0) { return min(G, nW - w0) * N; };
  const int dsteps = wcore::pad16(hd) >> 4;
  const int w_begin = blockIdx.x * wpb, w_end = min(nW, w_begin + wpb);
  wstage::Tile<bf16> src[3];
  tiles(w_begin, src);
  wstage::issue(src, stage, rows_of(w_begin), hd);
  for (int w0 = w_begin; w0 < w_end; w0 += G) {
    const int rows = rows_of(w0);  // rows >= rows read as zeros
    wstage::cp_async_wait_all();
    __syncthreads();  // group w0 staged (the first time: the zeros too)
    tiles(w0, src);
    wstage::convert<bf16, 1>(src, stage, opnd, rows, hd, ld, term);
    __syncthreads();  // the stage is free, the operands written
    if (w0 + G < w_end) {
      tiles(w0 + G, src);
      wstage::issue(src, stage, rows_of(w0 + G), hd);
    }
    const bf16* q = opnd;
    const bf16* k = opnd + term;
    const bf16* v = opnd + 2 * term;
    for (int i0 = warp * 16; i0 < GN; i0 += kThreads / 2) {  // 64 query rows a pass
      float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, o[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
      for (int kb = 0; kb < GN; kb += kKeyBlock) {
        float s[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
        for (int kk = 0; kk < dsteps; ++kk) {
          uint32_t aq[1][4];
          wcore::a_rows(aq[0], q, ld, rows, zrow, i0, kk * 16);
#pragma unroll
          for (int np = 0; np < kKeyBlock / 16; ++np) {
            if (kb + np * 16 < GN) {
              uint32_t bk[1][4];
              wcore::b_rows(bk[0], k, ld, rows, zrow, kb + np * 16, kk * 16);
              wcore::mma_pair<1, 1, 1>(s[2 * np], s[2 * np + 1], aq, bk);
            }
          }
        }
        // Scores with the packed bias, the running max and sum.
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + g + 8 * (e >> 1), j = kb + nt * 8 + 2 * t + (e & 1);
            const float x = j < GN ? scale * s[nt][e] + (i < GN ? pb[(size_t)i * GN + j] : 0.f)
                                   : -CUDART_INF_F;
            s[nt][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float sum[2] = {0.f, 0.f}, corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          corr[r] = __expf(m[r] - mx[r]);  // 0 on the first block
          m[r] = mx[r];
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[nt][e] == -CUDART_INF_F ? 0.f : __expf(s[nt][e] - m[e >> 1]);
            s[nt][e] = x;
            sum[e >> 1] += x;
            o[nt][e] *= corr[e >> 1];
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
          l[r] = l[r] * corr[r] + sum[r];
        }
        // O += P v over this block's keys, P as two bf16 terms.
#pragma unroll
        for (int kk = 0; kk < kKeyBlock / 16; ++kk) {
          if (kb + kk * 16 < GN) {
            uint32_t a[2][4];
            wcore::a_from_acc(s, kk, a);
#pragma unroll
            for (int np = 0; np < kMaxHd / 16; ++np) {
              if (np < dsteps) {
                uint32_t bv[1][4];
                wcore::b_cols(bv[0], v, ld, rows, zrow, np * 16, kb + kk * 16);
                wcore::mma_pair<2, 1, 2>(o[2 * np], o[2 * np + 1], a, bv);
              }
            }
          }
        }
      }
      const float inv[2] = {1.f / l[0], 1.f / l[1]};
      bf16* ob = out + (size_t)w0 * N * C + h * hd;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = nt * 8 + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = i0 + g + 8 * r;
          if (nt < 2 * dsteps && i < rows && c < hd)
            wcore::store_pair(ob + (size_t)i * C + c, o[nt][2 * r] * inv[r],
                              o[nt][2 * r + 1] * inv[r], c + 1 < hd);
        }
      }
    }
    // The next iteration's first barrier keeps its conversion off these
    // operands until every warp has read them.
  }
}

// The most shared memory a block may opt in to on the current device
// (232,448 bytes on the H100).
int max_smem() {
  int dev = 0, most = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  return most;
}

cudaError_t launch_packslim(const bf16* qkv, const float* pbias, bf16* out, int nW, int N,
                            int H, int hd, float scale, int G, int wpb, cudaStream_t stream) {
  if (G < 1 || G > kMaxPack || wpb < G || wpb % G) return cudaErrorInvalidValue;
  const size_t smem = packslim_smem_bytes(G * N, hd);
  if (smem > (size_t)max_smem()) return cudaErrorInvalidValue;
  cudaError_t err = ipe::allow_smem(packslim_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nW + wpb - 1) / wpb, H);
  packslim_kernel<<<grid, kThreads, smem, stream>>>(qkv, pbias, out, nW, N, H * hd, hd, scale,
                                                    G, wpb);
  return cudaGetLastError();
}

// Variants 0-3: K1's kernel with phase P.
template <int P>
cudaError_t launch_phase(const bf16* qkv, const float* bias, bf16* out, int nW, int N, int H,
                         int hd, float scale, int wpb, cudaStream_t st) {
  return launch<bf16, Layout::kFlatQkv, P>(qkv, nullptr, nullptr, bias, out, nW, N, H * hd, H,
                                           hd, scale, wpb, st);
}

// Shared memory one block of the variant asks for: variants 0-3 stage one
// window at a time, packslim one group, whatever the windows per block.
size_t variant_smem_bytes(int variant, int N, int hd, int pack) {
  return variant == 4 ? packslim_smem_bytes(pack * N, hd) : smem_bytes<bf16>(N, hd);
}

}  // namespace

extern "C" {

// 1 if one block of the variant at wpb windows per block (packslim: pack
// windows per group) fits the current device's shared memory, else 0.
int ipe_window_msa_ablate_fits(int variant, int N, int hd, int wpb, int pack) {
  if (wpb < 1 || (variant == 4 && (pack < 1 || pack > kMaxPack || wpb % pack))) return 0;
  return variant_smem_bytes(variant, N, hd, pack) <= (size_t)max_smem();
}

// variant: 0 empty, 1 gemmonly, 2 softonly, 3 full, 4 packslim.  qkv
// (nW, N, 3C) and out (nW, N, C) bf16, contiguous; bias (H, N, N) float32,
// packslim's (H, G*N, G*N) masked.  wpb: windows per block (packslim a
// multiple of pack).  Returns the launch's cudaError_t.
int ipe_window_msa_ablate(int variant, const void* qkv, const void* bias, void* out, int nW,
                          int N, int H, int hd, float scale, int wpb, int pack, void* stream) {
  if (nW <= 0 || N <= 0 || N > kMaxN || hd <= 0 || hd > kMaxHd || H <= 0 || H > 65535 ||
      wpb <= 0 || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  const bf16* x = static_cast<const bf16*>(qkv);
  const float* b = static_cast<const float*>(bias);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return (int)launch_phase<kEmpty>(x, b, o, nW, N, H, hd, scale, wpb, st);
    case 1: return (int)launch_phase<kGemmOnly>(x, b, o, nW, N, H, hd, scale, wpb, st);
    case 2: return (int)launch_phase<kSoftOnly>(x, b, o, nW, N, H, hd, scale, wpb, st);
    case 3: return (int)launch_phase<kFull>(x, b, o, nW, N, H, hd, scale, wpb, st);
    case 4: return (int)launch_packslim(x, b, o, nW, N, H, hd, scale, pack, wpb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
