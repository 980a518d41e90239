// Bool planes <-> bit words, for the GC kernels (gc_mark.cu, gc_sweep.cu).
//
// A [R, K] bool plane (K-last, a byte a mark) packs into [words_for(R), K]
// uint32 words: bit b of words[w * K + k] is plane[32 w + b, k]. The pack
// and unpack grids touch the plane as whole rows: thread (word w, 4
// adjacent keys) moves a row's 4 bytes at once, so a warp covers 128 keys,
// 128 bytes a row, and writes the 4 keys' words as one 16-byte store. Where
// K is not a multiple of 4 (or the plane is not 4-byte aligned) a thread
// takes one key; at K = 1 its 32 rows are two 16-byte vectors. No atomics:
// each word is built by one thread and stored once, and each row of an
// unpacked plane is written once.
#pragma once

#ifdef NFA_CPU_EMU
#include "cpu_emu.h"
#include <cstdint>
#else
#include <cstdint>
#include <cuda_runtime.h>
#endif

__host__ __device__ inline int words_for(int R) { return (R + 31) / 32; }

// Whether a thread packs or unpacks 4 keys of `plane`.
inline bool quad_keys(const void* plane, int K) {
  return K % 4 == 0 && (reinterpret_cast<uintptr_t>(plane) & 3) == 0;
}

// Blocks of `threads` a pack or unpack grid takes: one item a thread, at
// most `max_blocks` (grid-stride past it).
inline int pack_blocks(int R, int K, bool quad, int threads, int max_blocks) {
  const long long items = (long long)words_for(R) * (quad ? K / 4 : K);
  const long long want = (items + threads - 1) / threads;
  return want < 1 ? 1 : (want < max_blocks ? (int)want : max_blocks);
}

// The 32 (or n < 32) bool rows r0.. of one key column as a bit word.
__device__ __forceinline__ unsigned load_word(const uint8_t* __restrict__ col, int K, int r0,
                                              int n) {
  if (K == 1 && n == 32 && (reinterpret_cast<uintptr_t>(col) & 15) == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(col + r0);
    const uint4 a = v[0], b = v[1];
    const unsigned q[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    unsigned word = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) word |= (((q[i] & 0x01010101u) * 0x01020408u) >> 24) << (4 * i);
    return word;
  }
  unsigned word = 0;
  for (int b = 0; b < n; ++b) word |= (col[(size_t)(r0 + b) * K] != 0 ? 1u : 0u) << b;
  return word;
}

// Writes the n <= 32 bool rows r0.. of one key column from a bit word.
__device__ __forceinline__ void store_word(uint8_t* __restrict__ col, int K, int r0, int n,
                                           unsigned word) {
  if (K == 1 && n == 32 && (reinterpret_cast<uintptr_t>(col) & 15) == 0) {
    unsigned q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = (((word >> (4 * i)) & 0xfu) * 0x00204081u) & 0x01010101u;
    uint4* v = reinterpret_cast<uint4*>(col + r0);
    v[0] = make_uint4(q[0], q[1], q[2], q[3]);
    v[1] = make_uint4(q[4], q[5], q[6], q[7]);
    return;
  }
  for (int b = 0; b < n; ++b) col[(size_t)(r0 + b) * K] = (uint8_t)((word >> b) & 1u);
}

// words[w * K + k] = rows 32w.. (< R) of plane[:, k] as bits.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
gc_pack_kernel(const uint8_t* __restrict__ plane, unsigned* __restrict__ words, int R, int K,
               int quad, int blocks) {
  const int groups = quad ? K / 4 : K;
  const size_t items = (size_t)words_for(R) * groups;
  const size_t stride = (size_t)blocks * THREADS;
  for (size_t t = (size_t)blockIdx.x * THREADS + threadIdx.x; t < items; t += stride) {
    const int w = (int)(t / groups), g = (int)(t % groups);
    const int r0 = w * 32, n = min(32, R - r0);
    if (!quad) {
      words[(size_t)w * K + g] = load_word(plane + g, K, r0, n);
      continue;
    }
    const uint8_t* col = plane + (size_t)r0 * K + 4 * g;
    unsigned v[32];
    if (n == 32) {
#pragma unroll
      for (int b = 0; b < 32; ++b) v[b] = *reinterpret_cast<const unsigned*>(col + (size_t)b * K);
    } else {
#pragma unroll
      for (int b = 0; b < 32; ++b)
        v[b] = b < n ? *reinterpret_cast<const unsigned*>(col + (size_t)b * K) : 0u;
    }
    unsigned q0 = 0, q1 = 0, q2 = 0, q3 = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      q0 |= (v[b] & 1u) << b;
      q1 |= ((v[b] >> 8) & 1u) << b;
      q2 |= ((v[b] >> 16) & 1u) << b;
      q3 |= ((v[b] >> 24) & 1u) << b;
    }
    *reinterpret_cast<uint4*>(words + (size_t)w * K + 4 * g) = make_uint4(q0, q1, q2, q3);
  }
}

// out rows [0, R) from the words (the pack in reverse); row R copied from
// `seed` (the mark's trash row).
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
gc_unpack_kernel(const unsigned* __restrict__ words, const uint8_t* __restrict__ seed,
                 uint8_t* __restrict__ out, int R, int K, int quad, int blocks) {
  const int groups = quad ? K / 4 : K;
  const size_t items = (size_t)words_for(R) * groups;
  const size_t stride = (size_t)blocks * THREADS;
  const size_t t0 = (size_t)blockIdx.x * THREADS + threadIdx.x;
  for (size_t t = t0; t < items; t += stride) {
    const int w = (int)(t / groups), g = (int)(t % groups);
    const int r0 = w * 32, n = min(32, R - r0);
    if (!quad) {
      store_word(out + g, K, r0, n, words[(size_t)w * K + g]);
      continue;
    }
    const uint4 q = *reinterpret_cast<const uint4*>(words + (size_t)w * K + 4 * g);
    uint8_t* col = out + (size_t)r0 * K + 4 * g;
    for (int b = 0; b < n; ++b) {
      const unsigned v = ((q.x >> b) & 1u) | (((q.y >> b) & 1u) << 8) |
                         (((q.z >> b) & 1u) << 16) | (((q.w >> b) & 1u) << 24);
      *reinterpret_cast<unsigned*>(col + (size_t)b * K) = v;
    }
  }
  for (size_t k = t0; k < (size_t)K; k += stride) out[(size_t)R * K + k] = seed[(size_t)R * K + k];
}
