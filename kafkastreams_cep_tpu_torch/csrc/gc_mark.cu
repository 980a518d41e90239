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
// Design: three grids on one stream, each row of a bool plane touched as
// whole lines, since a block of a few keys would read and write only a
// few bytes of each K-byte row (measured at the flagship: such a seed and
// write-back took 0.09 ms of a 0.11 ms launch; as pack and unpack grids
// the whole launch takes 0.05 ms).
//   1. pack (gc_pack.cuh): thread (word w, 4 keys) reads rows 32w..32w+31
//      of 4 adjacent keys as one 4-byte load a row and writes their 4 bit
//      words at once (a warp covers 128 keys: 128 bytes a row). No
//      atomics: each word is built by one thread and stored once. The
//      words, [BW / 32, K] uint32, are 1/8 of the plane.
//   2. walk: a block takes `kpb` keys (chosen at launch from BW and K, or
//      given), loads their words into shared memory (2 KB a key at the
//      flagship's BW = 16,384, 16 KB at the wide stack's 131,072), splits
//      its threads evenly over its keys, and strides a key's frontier
//      entries over them; a step is one shared atomicOr (stop if the bit
//      was set) and one pred read, which is pointer chasing: no TMA or
//      wgmma applies. Then it stores the words back.
//   3. unpack (gc_pack.cuh): the pack's mapping in reverse, each output
//      row written once as 4-byte stores (128 bytes a warp a row); row BW
//      copied.
// At K = 1 a thread packs or unpacks one word, its 32 rows two 16-byte
// vectors; where K is not a multiple of 4, one key a thread. Only a bitmap
// larger than a block's shared memory on its own (BW past 1,859,584 rows)
// is walked in place in the global words.
#include "gc_pack.cuh"

#define NTHREADS 512
// Keys a walk block may take, and the most the launch picks on its own.
#define MAX_KEYS_PER_BLOCK 32
#define AUTO_KEYS_PER_BLOCK 8
// Walk blocks a launch keeps, where K allows (about one wave of 132 SMs).
#define MIN_BLOCKS 128
// Threads a pack or unpack block, and the most such blocks (16 per SM; the
// CPU emulation, which runs blocks one after another, takes 4).
#define PACK_THREADS 256
#ifdef NFA_CPU_EMU
#define PACK_BLOCKS 4
#else
#define PACK_BLOCKS 2112
#endif
// Dynamic shared memory a block may take (the sm_90 limit, 227 KB).
#define SMEM_MAX_BYTES (227 * 1024)

inline bool fits_shared(int BW, int kpb) {
  return (long long)kpb * words_for(BW) * 4 <= SMEM_MAX_BYTES;
}

// Keys a walk block takes: at most 8; fewer while their bitmaps do not fit
// shared memory, while the launch has fewer than MIN_BLOCKS blocks, and
// while K would leave half the block idle (at K = 1 the whole block takes
// the key). Measured on flagship flushes (ops/gc_timing.py):
// 4-8 keys best at K = 2048 and 1024, within 10 % of each other at 512.
inline int auto_keys_per_block(int BW, int K) {
  int kpb = AUTO_KEYS_PER_BLOCK;
  while (kpb > 1 && (!fits_shared(BW, kpb) || (K + kpb - 1) / kpb < MIN_BLOCKS || kpb >= 2 * K))
    kpb /= 2;
  return kpb;
}

// The walk over the packed words of `kpb` keys a block: in shared
// memory, or (global != 0) in place in the words.
__global__ void __launch_bounds__(NTHREADS)
gc_mark_walk_kernel(unsigned* __restrict__ words, const int* __restrict__ frontier,
                    const int* __restrict__ pred, int F, int BW, int K, int kpb, int global) {
#ifdef NFA_CPU_EMU
  unsigned* smem = static_cast<unsigned*>(emu::dynamic_smem());
#else
  extern __shared__ unsigned smem[];
#endif
  const int nwords = words_for(BW);
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kpb;
  // Word w of the block's key j: smem[j * nwords + w], or words[w * K + k].
  const size_t key_step = global ? 1 : (size_t)nwords;
  const size_t word_step = global ? (size_t)K : 1;
  unsigned* bits = global ? words + k0 : smem;
  if (!global) {
    for (int i = tid; i < kpb * nwords; i += NTHREADS) {
      const int j = i % kpb, w = i / kpb;
      if (k0 + j < K) smem[(size_t)j * nwords + w] = words[(size_t)w * K + k0 + j];
    }
    __syncthreads();
  }

  const int per_key = NTHREADS / kpb;
  const int jw = tid / per_key;
  const int kw = k0 + jw;
  if (kw < K) {
    unsigned* mine = bits + jw * key_step;
    for (int f = tid % per_key; f < F; f += per_key) {
      int id = frontier[(size_t)f * K + kw];
      while (id >= 0 && id < BW) {
        const unsigned bit = 1u << (id & 31);
        if (atomicOr(&mine[(size_t)(id >> 5) * word_step], bit) & bit) break;
        id = pred[(size_t)id * K + kw];
      }
    }
  }

  if (!global) {
    __syncthreads();
    for (int i = tid; i < kpb * nwords; i += NTHREADS) {
      const int j = i % kpb, w = i / kpb;
      if (k0 + j < K) words[(size_t)w * K + k0 + j] = smem[(size_t)j * nwords + w];
    }
  }
}

// Keys a walk block takes for (BW, K), and its dynamic shared memory in
// bytes (0 when the walk runs in place in the global words).
extern "C" int gc_mark_keys_per_block(int BW, int K) { return auto_keys_per_block(BW, K); }

extern "C" long long gc_mark_smem_bytes(int BW, int K) {
  const int kpb = auto_keys_per_block(BW, K);
  return fits_shared(BW, kpb) ? (long long)kpb * words_for(BW) * 4 : 0;
}

// uint32 words of the packed marks a launch needs (the wrapper allocates
// them, 16-byte aligned).
extern "C" long long gc_mark_words(int BW, int K) { return (long long)words_for(BW) * K; }

// Host entry, bound with ctypes: pack, walk and unpack on `stream`. `kpb`
// 0 = auto_keys_per_block, else a power of two <= 32; `words` holds
// gc_mark_words() uint32; `global` != 0 walks in place in them even where
// shared memory would hold the bitmaps (the tests' way to run that branch
// at small shapes). Returns the launches' cudaError_t.
extern "C" int gc_mark_launch(const void* seed, const void* frontier, const void* pred,
                              void* out, int F, int BW, int K, int kpb, void* words,
                              int global, void* stream) {
  if (K <= 0) return 0;
  if (kpb == 0) kpb = auto_keys_per_block(BW, K);
  if (kpb < 1 || kpb > MAX_KEYS_PER_BLOCK || (kpb & (kpb - 1)) != 0 || words == nullptr) return 1;
  if (!fits_shared(BW, kpb)) global = 1;
  const int blocks = (K + kpb - 1) / kpb;
  const size_t smem = global ? 0 : (size_t)kpb * words_for(BW) * 4;
  const auto* s = static_cast<const uint8_t*>(seed);
  const auto* fr = static_cast<const int*>(frontier);
  const auto* pr = static_cast<const int*>(pred);
  auto* o = static_cast<uint8_t*>(out);
  auto* wd = static_cast<unsigned*>(words);
  const int quad = quad_keys(seed, K) && quad_keys(out, K) ? 1 : 0;
  const int pb = pack_blocks(BW, K, quad, PACK_THREADS, PACK_BLOCKS);
#ifdef NFA_CPU_EMU
  emu::launch(pb, PACK_THREADS, [&]() { gc_pack_kernel<PACK_THREADS>(s, wd, BW, K, quad, pb); });
  emu::launch(blocks, NTHREADS,
              [&]() { gc_mark_walk_kernel(wd, fr, pr, F, BW, K, kpb, global); }, smem);
  emu::launch(pb, PACK_THREADS,
              [&]() { gc_unpack_kernel<PACK_THREADS>(wd, s, o, BW, K, quad, pb); });
  return 0;
#else
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gc_mark_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const auto st = (cudaStream_t)stream;
  gc_pack_kernel<PACK_THREADS><<<pb, PACK_THREADS, 0, st>>>(s, wd, BW, K, quad, pb);
  gc_mark_walk_kernel<<<blocks, NTHREADS, smem, st>>>(wd, fr, pr, F, BW, K, kpb, global);
  gc_unpack_kernel<PACK_THREADS><<<pb, PACK_THREADS, 0, st>>>(wd, s, o, BW, K, quad, pb);
  return (int)cudaGetLastError();
#endif
}
