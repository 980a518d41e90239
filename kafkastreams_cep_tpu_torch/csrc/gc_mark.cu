// The GC mark of the group flush, for sm_90a: every node reachable from a
// frontier along the predecessor pointers, per key, walked to its fixed
// point on the card.
//
// Replaces the mark walks of the JAX package's group-flush GC
// (kafkastreams_cep_tpu/ops/engine.py `build_gc`, the `walk` while_loop at
// lines 1118-1134), which XLA lowers to a device-side loop; PyTorch has no
// device-side loop, and the plain version (ops/gc_kernel.py `_walk`) has to
// ask the host every few hops whether any cursor is still live. Here the
// loop runs inside the kernel, so a flush issues no host read.
//
// What it computes, per key k (K-last layout, as the engine's planes):
//   marked [BW + 1, K] bool  the seed; row BW is the plain walk's trash row
//   frontier [F, K] int32    node ids to walk from, -1 (any negative) = hole
//   pred [BW, K] int32       each node's predecessor, -1 = chain start
// out = seed | { v : some frontier path f -> pred(f) -> ... -> v on which no
// node before v is in the seed }: a walker stops at a node that was marked
// already, by the seed or by another walker, which then owns the rest of
// that chain. The set does not depend on the order in which walkers run, so
// the result is bitwise the plain walk's. Row BW is copied from the seed.
// Ids >= BW are outside the contract and end a walk.
//
// Design: KEYS_PER_BLOCK keys per block, one warp per key for the walk,
// each key's BW + 1 marks as a bitmap in shared memory (2 KB a key at the
// flagship's BW = 16,384). The bool planes are read and written row by row
// across the block's keys (16 consecutive bytes a row). A walker's step is
// one shared atomicOr (stop if the bit was set) and one pred read, which is
// pointer chasing: no TMA or wgmma applies, and the pred reads (one 32-byte
// sector for 4 bytes) and the two bool planes bound it by bytes. A bitmap
// too large for shared memory lives in a global scratch the wrapper
// allocates (`gc_mark_scratch_words`).
#ifdef NFA_CPU_EMU
#include "cpu_emu.h"
#include <cstdint>
#else
#include <cstdint>
#include <cuda_runtime.h>
#endif

#define KEYS_PER_BLOCK 16
#define NTHREADS (32 * KEYS_PER_BLOCK)
// Shared memory a block may take for its bitmaps (of the 227 KB a block
// can have); past it the bitmaps go to the global scratch.
#define SMEM_MAX_BYTES (160 * 1024)

__host__ __device__ inline int words_for(int BW) { return (BW + 1 + 31) / 32; }

inline long long smem_bytes_for(int BW) {
  return (long long)KEYS_PER_BLOCK * words_for(BW) * 4;
}

__global__ void __launch_bounds__(NTHREADS)
gc_mark_kernel(const uint8_t* __restrict__ seed, const int* __restrict__ frontier,
               const int* __restrict__ pred, uint8_t* __restrict__ out, int F, int BW, int K,
               unsigned* gbits) {
#ifdef NFA_CPU_EMU
  unsigned* smem = static_cast<unsigned*>(emu::dynamic_smem());
#else
  extern __shared__ unsigned smem[];
#endif
  const int nwords = words_for(BW);
  unsigned* bits = gbits != nullptr ? gbits + (size_t)blockIdx.x * KEYS_PER_BLOCK * nwords : smem;
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * KEYS_PER_BLOCK;

  for (int i = tid; i < KEYS_PER_BLOCK * nwords; i += NTHREADS) bits[i] = 0u;
  __syncthreads();

  // Seed, row by row across the block's keys.
  const int j = tid % KEYS_PER_BLOCK;
  const int r0 = tid / KEYS_PER_BLOCK;
  const int rstep = NTHREADS / KEYS_PER_BLOCK;
  const int k = k0 + j;
  if (k < K) {
    unsigned* mine = bits + j * nwords;
    for (int r = r0; r < BW; r += rstep) {
      if (seed[(size_t)r * K + k]) atomicOr(&mine[r >> 5], 1u << (r & 31));
    }
  }
  __syncthreads();

  // Walk: warp w takes key k0 + w, its lanes the frontier entries strided.
  const int w = tid / 32;
  const int lane = tid % 32;
  const int kw = k0 + w;
  if (kw < K) {
    unsigned* mine = bits + w * nwords;
    for (int f = lane; f < F; f += 32) {
      int id = frontier[(size_t)f * K + kw];
      while (id >= 0 && id < BW) {
        const unsigned bit = 1u << (id & 31);
        if (atomicOr(&mine[id >> 5], bit) & bit) break;
        id = pred[(size_t)id * K + kw];
      }
    }
  }
  __syncthreads();

  // Write back, row by row; row BW is the seed's.
  if (k < K) {
    const unsigned* mine = bits + j * nwords;
    for (int r = r0; r < BW; r += rstep) {
      out[(size_t)r * K + k] = (uint8_t)((mine[r >> 5] >> (r & 31)) & 1u);
    }
    if (r0 == 0) out[(size_t)BW * K + k] = seed[(size_t)BW * K + k];
  }
}

// int32 words of global scratch a launch needs: 0 while the block's
// bitmaps fit in shared memory.
extern "C" long long gc_mark_scratch_words(int BW, int K) {
  if (smem_bytes_for(BW) <= SMEM_MAX_BYTES) return 0;
  const long long blocks = (K + KEYS_PER_BLOCK - 1) / KEYS_PER_BLOCK;
  return blocks * KEYS_PER_BLOCK * words_for(BW);
}

// Host entry, bound with ctypes. `scratch` holds gc_mark_scratch_words()
// words (or is null when that is 0). Returns the launch's cudaError_t.
extern "C" int gc_mark_launch(const void* seed, const void* frontier, const void* pred,
                              void* out, int F, int BW, int K, void* scratch, void* stream) {
  if (K <= 0) return 0;
  const int blocks = (K + KEYS_PER_BLOCK - 1) / KEYS_PER_BLOCK;
  const bool global = gc_mark_scratch_words(BW, K) > 0;
  if (global && scratch == nullptr) return 1;  // cudaErrorInvalidValue
  const size_t smem = global ? 0 : (size_t)smem_bytes_for(BW);
  unsigned* gbits = global ? static_cast<unsigned*>(scratch) : nullptr;
  const auto* s = static_cast<const uint8_t*>(seed);
  const auto* fr = static_cast<const int*>(frontier);
  const auto* pr = static_cast<const int*>(pred);
  auto* o = static_cast<uint8_t*>(out);
#ifdef NFA_CPU_EMU
  emu::launch(blocks, NTHREADS, [&]() { gc_mark_kernel(s, fr, pr, o, F, BW, K, gbits); }, smem);
  return 0;
#else
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gc_mark_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gc_mark_kernel<<<blocks, NTHREADS, smem, (cudaStream_t)stream>>>(s, fr, pr, o, F, BW, K, gbits);
  return (int)cudaGetLastError();
#endif
}
