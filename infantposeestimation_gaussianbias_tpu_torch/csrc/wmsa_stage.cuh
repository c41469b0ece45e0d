// Staging of the W-MSA kernels' operands: a window's (N, hd) tiles of one
// head, streamed from device memory into shared memory with cp.async and
// converted into the bf16 term tiles of the tensor-core core
// (csrc/wmsa_core.cuh `Operand`).  K1 and K1-hm (csrc/window_msa.cu: q, k,
// v) and K2 (csrc/window_msa_bwd.cu: q, k, v, dO) stage through it; each
// kernel says where a tile's rows lie (`Tile`).
//
// A head's rows start at h*hd elements of a flat row (K1, K2) or at
// w*N*hd of a head-major tensor (K1-hm): only 2-byte aligned in bf16 at an
// odd hd (39), so a row is staged as the aligned 16-byte units that hold
// it (16-byte cp.async, no TMA: rows of one tile are neither aligned nor
// evenly spaced in units).  The conversion shifts a row to its first
// element and splits a float32 element into NI bf16 terms (bf16 stays one
// term).  A caller issues the next window's tiles while the core runs on
// the current window's operands, then waits, converts and synchronises
// before the core reads them again: two stages deep.
#pragma once

#include <cstdint>

#include "wmsa_core.cuh"

namespace {
namespace wstage {

using wcore::bf16;

// 16-byte units of one staged row of hd elements that starts anywhere in
// its first unit (at an element boundary): the most a row can touch.
template <typename T>
__host__ __device__ __forceinline__ int row_units(int hd) {
  return 1 + ((hd - 1) * (int)sizeof(T) + 15) / 16;
}

// 4-byte words of one staged row.
template <typename T>
__host__ __device__ __forceinline__ int row_words(int hd) {
  return 4 * row_units<T>(hd);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Byte offset of a row's first element within its 16-byte unit.
template <typename T>
__device__ __forceinline__ int unit_offset(const T* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

// One (N, hd) tile in device memory: its row 0's first element and the
// row stride in elements.
template <typename T>
struct Tile {
  const T* p;
  size_t stride;
};

// n 4-byte words from src into shared dst, cp.async, spread over the block
// (not committed: they join the caller's next group).
__device__ __forceinline__ void issue_words(void* dst, const void* src, int n) {
  for (int i = threadIdx.x; i < n; i += wcore::kThreads)
    cp_async4(static_cast<uint32_t*>(dst) + i, static_cast<const uint32_t*>(src) + i);
}

// Stage tiles src[0 .. S) into stage (16-byte aligned), tile s's row r at
// words (s * N + r) * row_words: each row as the 16-byte units that hold
// its bytes, copied whole with 16-byte cp.async; a power of two of lanes
// per row, one unit each.  A unit that holds a byte of the row lies in the
// row's memory page, so the bytes around the row it brings along (other
// columns, or past the tensor's end) are readable; the conversion ignores
// them.  Commits one group.
template <typename T, int S>
__device__ __forceinline__ void issue(const Tile<T> (&src)[S], uint32_t* stage, int N, int hd) {
  const int units = row_units<T>(hd);
  const int lg = units > 1 ? 32 - __clz(units - 1) : 0;  // lanes per row: 2^lg >= units
  const int row_bytes = hd * (int)sizeof(T);
  const int lw = 4 * units;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    for (int i = threadIdx.x; i < N << lg; i += wcore::kThreads) {
      const int r = i >> lg, u = i & ((1 << lg) - 1);
      const uintptr_t a = reinterpret_cast<uintptr_t>(src[s].p + r * src[s].stride);
      if (16 * u < (int)(a & 15) + row_bytes)
        cp_async16(stage + (s * N + r) * lw + 4 * u,
                   reinterpret_cast<const void*>((a & ~static_cast<uintptr_t>(15)) + 16 * u));
    }
  }
  cp_async_commit();
}

// w[j + k] for the k (0 .. K-1) known only at run time, from constant
// indices (selects, not a local-memory array).
template <int K, int M>
__device__ __forceinline__ uint32_t pick(const uint32_t (&w)[M], int j, int k) {
  uint32_t x = w[j];
#pragma unroll
  for (int t = 1; t < K; ++t)
    if (k == t) x = w[j + t];
  return x;
}

// The staged rows of tiles src[0 .. S) as NI bf16 terms each: tile s's
// term i at opnd + (s * NI + i) * term, row r at r * ld (16-byte aligned
// rows).  Eight lanes per row, eight columns per lane: the staged units
// that hold them are read as 16-byte words, shifted to the row's first
// element, split into terms (float32) and stored as one 16-byte word per
// term.  Columns from hd to the end of the last group of eight are
// written as zeros; those after it keep what the caller put there.
template <typename T, int NI, int S>
__device__ __forceinline__ void convert(const Tile<T> (&src)[S], const uint32_t* stage,
                                        bf16* opnd, int N, int hd, int ld, int term) {
  constexpr int kPer = 16 / sizeof(T);        // elements per 16-byte unit
  constexpr int kUnits = 8 / kPer;            // units of eight elements
  constexpr int kWords = 4 * (kUnits + 1);    // eight elements at any shift
  const int units = row_units<T>(hd);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    for (int i = threadIdx.x; i < N * 8; i += wcore::kThreads) {
      const int r = i >> 3, c8 = i & 7;
      if (8 * c8 >= hd) continue;
      const int sh = unit_offset(src[s].p + r * src[s].stride) / (int)sizeof(T);
      const uint4* raw =
          reinterpret_cast<const uint4*>(stage + (s * N + r) * 4 * units) + kUnits * c8;
      uint32_t w[kWords];
#pragma unroll
      for (int u = 0; u <= kUnits; ++u) {
        const uint4 x = kUnits * c8 + u < units ? raw[u] : make_uint4(0, 0, 0, 0);
        w[4 * u] = x.x;
        w[4 * u + 1] = x.y;
        w[4 * u + 2] = x.z;
        w[4 * u + 3] = x.w;
      }
      uint32_t o[NI][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = 8 * c8 + 2 * j;  // this pair's first column
        if constexpr (sizeof(T) == 2) {
          static_assert(NI == 1, "a bf16 element is one bf16 term");
          // element e of the eight at halfword sh + e of w
          uint32_t x = __funnelshift_r(pick<4>(w, j, sh >> 1), pick<4>(w, j + 1, sh >> 1),
                                       16 * (sh & 1));
          if (d + 1 >= hd) x = d < hd ? x & 0xffffu : 0u;
          o[0][j] = x;
        } else {
          const float x0 = d < hd ? __uint_as_float(pick<4>(w, 2 * j, sh)) : 0.f;
          const float x1 = d + 1 < hd ? __uint_as_float(pick<4>(w, 2 * j + 1, sh)) : 0.f;
          uint32_t u[NI];
          wcore::split<NI>(x0, x1, u);
#pragma unroll
          for (int t = 0; t < NI; ++t) o[t][j] = u[t];
        }
      }
      bf16* dst = opnd + s * NI * term + r * ld + 8 * c8;
#pragma unroll
      for (int t = 0; t < NI; ++t)
        *reinterpret_cast<uint4*>(dst + t * term) = make_uint4(o[t][0], o[t][1], o[t][2], o[t][3]);
    }
  }
}

}  // namespace wstage
}  // namespace
