// The staged tensor-core tile product of K5 (csrc/fused_mlp.cu) and of the
// weight-gradient reduction that K4's and K5's backwards share (`atb`,
// csrc/fused_common.cuh).
//
// acc (BM x BN, float32, in registers) = A B over k < K, with
//   A: element (m, k) of an (M, K) operand, B: element (k, n) of a (K, N)
//   operand, each stored in device memory either "k-contiguous" (row i of
//   the operand's own rows is one k-run: p[i * ld + k]) or "i-contiguous"
//   (p[k * ld + i]), as bf16 in NT terms (a float32 weight as three bf16
//   terms whose sum is the weight exactly, term t at p + t * term).
// So one staged copy of a weight serves a product and its transpose: W1
// (Hd, C) is B of h = ln W1^T read k-contiguous, and B of dln = dh W1 read
// i-contiguous, through `ldmatrix` or `ldmatrix.trans`.
//
// What bounded the product it replaces (fused_common.cuh `mma_tile`): every
// warp fetched its B pairs as 32-bit loads from L1/L2 for every `mma` and
// its A pairs as scalar shared-memory loads (bank conflicts at odd row
// strides), float32 weights were split by every warp, and one block walked
// all the output tiles of its rows.  Here each block computes one BM x BN
// output tile (a `Cfg`); the k slices of both operands (BK deep) go to
// shared memory by 16-byte (or 4-byte, for operands whose rows are not
// 16-byte aligned) `cp.async` in a ring of STAGES slices, so that the next
// slices' loads overlap this slice's products; the fragments are read with
// `ldmatrix` (.trans where the operand is i-contiguous); the products are
// `mma.sync.m16n8k16` bf16 x bf16 -> float32, the warps as WM (rows) x WN
// (columns).  Every element outside [0, lim) x [0, klim) of an operand is
// zero-filled in shared memory (the cp.async source size 0), so padding
// never reads stale shared memory, and a float32 weight's three terms are
// multiplied with the same A fragments, which are loaded once per k step.
// Shared-memory row strides are the tile's width + 8 bf16: a multiple of
// 16 bytes and an odd number of 16-byte units, so the 8 rows of one
// `ldmatrix` matrix fall in different banks.
//
// Not here: `wgmma` and TMA (the route to the full tensor-core rate), a
// persistent grid, and split-K inside a launch (the callers split the
// row sums of `atb` into chunks added in a fixed order instead).
#pragma once

#include <cstdint>

#include "ipe_common.cuh"

namespace {
namespace mg {

using bf16 = __nv_bfloat16;

// A tile shape: BM x BN outputs per block, k slices of BK, WM x WN warps
// (warp w at row group w % WM, column group w / WM), STAGES slices in
// flight.  Each warp holds MT m16 tiles x NT8 n8 tiles of accumulators.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int threads = 32 * WM * WN;
  static constexpr int MT = BM / WM / 16, NT8 = BN / WN / 8;
  static_assert(BM % (16 * WM) == 0 && BN % (16 * WN) == 0 && BK % 16 == 0,
                "warp tiles of whole 16 x 16 steps");
};

// An operand in device memory (see the header): extent index i < lim,
// k < klim are read, the rest of a tile is zero.  KC: k-contiguous.  VEC:
// bf16 per cp.async (8: 16 bytes, needs ld, term and the pointer 16-byte
// aligned; 2: 4 bytes, needs them 4-byte aligned).  A run of VEC elements
// along the contiguous index is loaded whole when its first element is in
// range: along k that needs klim % VEC == 0 (checked by the callers); along
// i the elements past lim reach only outputs that are never stored.
template <bool KC, int NT, int VEC>
struct Operand {
  static constexpr bool kc = KC;
  static constexpr int nt = NT;
  static constexpr int vec = VEC;
  const bf16* p;
  int ld;
  long long term;
  int lim, klim;
};

// bf16 elements of one term's staged tile of an operand with E rows (of
// the output tile) over BK: k-contiguous [E][BK + 8], else [BK][E + 8].
template <bool KC, int E, int BK>
__host__ __device__ constexpr int tile_ld() {
  return KC ? BK + 8 : E + 8;
}

template <bool KC, int E, int BK>
__host__ __device__ constexpr int tile_elems() {
  return KC ? E * (BK + 8) : BK * (E + 8);
}

// Shared memory of the ring for an A (BM rows) and B (BN columns) operand.
template <class CF, class AO, class BO>
__host__ __device__ constexpr size_t ring_bytes() {
  return sizeof(bf16) * (size_t)CF::STAGES *
         (AO::nt * tile_elems<AO::kc, CF::BM, CF::BK>() +
          BO::nt * tile_elems<BO::kc, CF::BN, CF::BK>());
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A copy of VEC bf16 to shared memory, or VEC zeros when !ok (source size 0;
// the source address is then not read).
template <int VEC>
__device__ __forceinline__ void cp_async(bf16* dst, const bf16* src, bool ok) {
  const int n = ok ? 2 * VEC : 0;
  if constexpr (VEC == 8) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    static_assert(VEC == 2, "cp.async of 16 or 4 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage k slice [k0, k0 + BK) of the E rows [i0, i0 + E) of operand o
// (every term) into s, every element written (data or zero), by THREADS
// threads.
template <int E, int BK, int THREADS, class O>
__device__ __forceinline__ void stage(const O& o, bf16* s, int i0, int k0) {
  constexpr int V = O::vec;
  constexpr int TE = tile_elems<O::kc, E, BK>();
  constexpr int LD = tile_ld<O::kc, E, BK>();
  constexpr int RUNS = O::kc ? BK / V : E / V;  // vectors per staged row
  constexpr int ROWS = O::kc ? E : BK;
#pragma unroll
  for (int v = threadIdx.x; v < ROWS * RUNS; v += THREADS) {
    const int r = v / RUNS, c = (v - r * RUNS) * V;
    const int i = O::kc ? i0 + r : i0 + c;
    const int k = O::kc ? k0 + c : k0 + r;
    const bool ok = i < o.lim && k < o.klim;
    const long long at = O::kc ? (long long)i * o.ld + k : (long long)k * o.ld + i;
#pragma unroll
    for (int t = 0; t < O::nt; ++t)
      cp_async<V>(s + t * TE + r * LD + c, ok ? o.p + t * o.term + at : o.p, ok);
  }
}

// Fragments of k16 step kk of a staged tile (lane l of an x4 ldmatrix
// addresses row l & 7 of matrix l >> 3):
//   frag_a: the A fragment of the 16 rows e0.. (a0..a3: rows +0 / +8,
//           depth +0 / +8);
//   frag_b: the B fragments b0, b1 of the n8 tile e0 and b0, b1 of e0 + 8.
template <bool KC, int E, int BK>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s, int e0, int kk) {
  constexpr int LD = tile_ld<KC, E, BK>();
  const int l = threadIdx.x & 31;
  if (KC)
    ldsm(a, s + (e0 + (l & 7) + 8 * ((l >> 3) & 1)) * LD + kk * 16 + 8 * (l >> 4));
  else
    ldsm_t(a, s + (kk * 16 + (l & 7) + 8 * (l >> 4)) * LD + e0 + 8 * ((l >> 3) & 1));
}

template <bool KC, int E, int BK>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* s, int e0, int kk) {
  constexpr int LD = tile_ld<KC, E, BK>();
  const int l = threadIdx.x & 31;
  if (KC)
    ldsm(b, s + (e0 + (l & 7) + 8 * (l >> 4)) * LD + kk * 16 + 8 * ((l >> 3) & 1));
  else
    ldsm_t(b, s + (kk * 16 + (l & 7) + 8 * ((l >> 3) & 1)) * LD + e0 + 8 * (l >> 4));
}

// Accumulators of one warp: CF::MT m16 tiles x CF::NT8 n8 tiles of its
// (BM / WM) x (BN / WN) share of the output tile.
template <class CF>
struct Acc {
  static constexpr int MT = CF::MT, NT8 = CF::NT8;
  float v[MT][NT8][4];
};

// Where accumulator v[mi][ni][e] lies in the output tile (row, column).
template <class CF>
__device__ __forceinline__ int acc_row(int mi, int e) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return (warp % CF::WM) * (CF::BM / CF::WM) + mi * 16 + (lane >> 2) + 8 * (e >> 1);
}

template <class CF>
__device__ __forceinline__ int acc_col(int ni, int e) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return (warp / CF::WM) * (CF::BN / CF::WN) + ni * 8 + 2 * (lane & 3) + (e & 1);
}

// acc = A B over k < K for the output tile at (m0, n0): A's rows m0.., B's
// columns n0...  smem: ring_bytes<CF, AO, BO>() of dynamic shared memory,
// 16-byte aligned.  Ends past a barrier with the ring free; the float32
// weight terms are summed per k step in term order.
template <class CF, class AO, class BO>
__device__ void tile_product(Acc<CF>& acc, const AO& A, const BO& B, int K, int m0, int n0,
                             bf16* smem) {
  static_assert(AO::nt == 1, "the activation operand is one bf16 term");
  constexpr int BM = CF::BM, BN = CF::BN, BK = CF::BK, S = CF::STAGES, NTH = CF::threads;
  constexpr int MT = CF::MT, NT8 = CF::NT8;
  static_assert(NT8 % 2 == 0, "B fragments two n8 tiles at a time");
  constexpr int AE = tile_elems<AO::kc, BM, BK>(), BE = tile_elems<BO::kc, BN, BK>();
  constexpr int SE = AE + BO::nt * BE;  // bf16 per stage
  const int warp = threadIdx.x >> 5;
  const int wm = (warp % CF::WM) * (BM / CF::WM), wn = (warp / CF::WM) * (BN / CF::WN);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.v[mi][ni][e] = 0.f;
  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < KT) {
      stage<BM, BK, NTH>(A, smem + s * SE, m0, s * BK);
      stage<BN, BK, NTH>(B, smem + s * SE + AE, n0, s * BK);
    }
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<S - 2>();
    __syncthreads();  // slice kt landed for every thread; slice kt - 1's reads done
    const int next = kt + S - 1;
    if (next < KT) {
      bf16* s = smem + (next % S) * SE;
      stage<BM, BK, NTH>(A, s, m0, next * BK);
      stage<BN, BK, NTH>(B, s + AE, n0, next * BK);
    }
    cp_commit();
    const bf16* sa = smem + (kt % S) * SE;
    const bf16* sb = sa + AE;
    const int ksteps = min(BK, K - kt * BK + 15) / 16;  // k16 steps holding k < K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (kk < ksteps) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) frag_a<AO::kc, BM, BK>(a[mi], sa, wm + mi * 16, kk);
#pragma unroll
        for (int np = 0; np < NT8 / 2; ++np) {
          uint32_t b[BO::nt][4];
#pragma unroll
          for (int t = 0; t < BO::nt; ++t)
            frag_b<BO::kc, BN, BK>(b[t], sb + t * BE, wn + np * 16, kk);
#pragma unroll
          for (int t = 0; t < BO::nt; ++t)
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) {
              mma(acc.v[mi][2 * np], a[mi], b[t][0], b[t][1]);
              mma(acc.v[mi][2 * np + 1], a[mi], b[t][2], b[t][3]);
            }
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();
}

// A bf16 output tile through shared memory: f(row, col, v0, v1) maps the
// accumulator pair at (row, col), (row, col + 1) of the tile to the two
// values stored; they go to a staging tile (BM x (BN + 8) bf16 at stage,
// free shared memory) and then to dst (row stride ld) as 16-byte row
// vectors, rows < rows and columns < cols of the tile (cols a multiple of
// 8; dst, ld 16-byte aligned).  Starts and ends with a barrier.
template <class CF, class F>
__device__ __forceinline__ void store_tile(const Acc<CF>& acc, bf16* stage, bf16* dst, int ld,
                                           int rows, int cols, F f) {
  constexpr int SLD = CF::BN + 8;
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < CF::MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < CF::NT8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = acc_row<CF>(mi, 2 * h), c = acc_col<CF>(ni, 0);
        const float2 v = f(r, c, acc.v[mi][ni][2 * h], acc.v[mi][ni][2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(stage + r * SLD + c) = __floats2bfloat162_rn(v.x, v.y);
      }
  __syncthreads();
  constexpr int VPR = CF::BN / 8;  // 16-byte vectors per tile row
  for (int i = threadIdx.x; i < CF::BM * VPR; i += CF::threads) {
    const int r = i / VPR, c = (i - r * VPR) * 8;
    if (r < rows && c < cols)
      *reinterpret_cast<uint4*>(dst + (size_t)r * ld + c) =
          *reinterpret_cast<const uint4*>(stage + r * SLD + c);
  }
  __syncthreads();
}

// x0 and x1 to p[0] and p[1] (p even-aligned for the element type).
__device__ __forceinline__ void store2(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}

}  // namespace mg
}  // namespace
