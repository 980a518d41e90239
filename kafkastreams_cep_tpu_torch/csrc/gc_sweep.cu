// The sweep of the group flush, for sm_90a: the stable compaction of the
// marked nodes into the B-slot region and every remap of node ids, per
// key, in one pass.
//
// Replaces the compaction and remaps of the JAX package's group-flush GC
// (kafkastreams_cep_tpu/ops/engine.py `build_gc`, lines 1178-1232: the
// exclusive cumsum of the marks, the stable argsort, the remap table and
// its gathers) and the ring remap of its batched wrapper
// (`remap_pend_blocks`, lines 1237-1282). The plain version is
// ops/gc_sweep.py `_sweep`, which this kernel equals bitwise.
//
// What it computes, per key k (K-last planes; BW = B + W):
//   marked, marked_pin [BW + 1, K] bool  the mark and its pinned part
//   node_event/name/pred [B, K] int32    the region
//   w_event/name/pred [T, K, cap] int32  the group's window as the step
//                                        writes it; window node id B + t *
//                                        cap + c is [t, k, c]
//   node, root [R, K]; pend [M, K]; pend_pos, pend_min, node_drops [K]
// rank(i) = the marked ids below i; i is kept when marked and rank(i) < B,
// and remap(i) = rank(i) if kept, else -1 (also for i < 0 or i >= BW).
// Out: node i kept goes to slot rank(i) with its event and name, its pred
// remapped and its pinned bit; slots from min(n_keep, B) on hold -1 (and
// not pinned); node_count = min(n_keep, B); node_drops += max(n_keep - B,
// 0); lane node/root remapped; ring rows below pend_pos remapped, the rest
// copied (they hold -1); pend_min stays NONE, else max(remap(clamp(pm, 0,
// BW)), 0).
//
// Design: three grids on one stream. A block of a few keys reads and
// writes only a few bytes of each K-wide row, so what touches whole planes
// is done by grids over whole rows:
//   1. pack (gc_pack.cuh): thread (word w, 4 adjacent keys) reads rows
//      32w..32w+31 of `marked` as one 4-byte load a row (a warp: 128 bytes
//      a row) and writes the 4 keys' bit words, [BW / 32, K] uint32 in
//      all. No atomics: each word is built by one thread and stored once.
//   2. fill: what does not depend on the marks -- every region slot -1 and
//      not pinned, the ring copied -- as 16-byte stores over whole rows.
//   3. block: a block takes `kpb` keys (chosen at launch from BW and K, or
//      given). It loads their words into shared memory, and a warp a key
//      scans the words' popcounts into per-word exclusive prefix counts,
//      also in shared memory. The rank of an id is then one popcount, and
//      the id of a rank a binary search and a select in one word, so no
//      [BW + 1, K] remap table goes through HBM. Region slot r <
//      min(n_keep, B) of key j takes the r-th marked node, read where it
//      lies (the pool planes or the step's window planes: no concatenated
//      copy, no permuted window; only kept rows are read), its pred
//      remapped; thread (key j, index s) strides the slots of key j by
//      NTHREADS / kpb, so a warp's writes land in one row of its keys.
//      Lanes, the ring rows below each cursor and pend_min are remapped
//      from the bitmap; node_count and node_drops written.
// 8 bytes of shared memory a word (4 KB a key at BW = 16,384, 32 KB at
// 131,072); past 929,760 rows a key's bitmap and prefixes go to a global
// scratch the wrapper allocates (`gc_sweep_scratch_words`).
#include "gc_pack.cuh"

#define NTHREADS 512
#define NWARPS (NTHREADS / 32)
// The pack and fill grids: blocks of NTHREADS, at most FILL_BLOCKS (8 per
// SM; the CPU emulation, which runs blocks one after another, takes 4).
#ifdef NFA_CPU_EMU
#define FILL_BLOCKS 4
#else
#define FILL_BLOCKS 1056
#endif
// Keys a block may take, and the most the launch picks on its own.
#define MAX_KEYS_PER_BLOCK 32
#define AUTO_KEYS_PER_BLOCK 8
// Blocks a launch keeps, where K allows (about two waves of 132 SMs).
#define MIN_BLOCKS 256
#define SMEM_MAX_BYTES (227 * 1024)
#define PEND_MIN_NONE 0x7fffffff

// Words between two keys' bitmaps (and prefixes): odd, so the threads of a
// warp, which take different keys, read different banks.
__host__ __device__ inline int key_stride(int BW) { return words_for(BW) | 1; }

// Words of bitmap, prefix and count a block of kpb keys needs.
__host__ __device__ inline long long block_words(int BW, int kpb) {
  return (long long)kpb * (2LL * key_stride(BW) + 1);
}

inline bool fits_shared(int BW, int kpb) { return block_words(BW, kpb) * 4 <= SMEM_MAX_BYTES; }

// Keys a block takes: at most 8; fewer while their bitmaps and prefixes do
// not fit shared memory, while the launch has fewer than MIN_BLOCKS
// blocks, and while K would leave half the block idle (at K = 1 the whole
// block takes the key). Measured on flagship flushes
// (ops/gc_timing.py): 8 keys best at K = 2048, 4 at 1024, 1-2
// at 512.
inline int auto_keys_per_block(int BW, int K) {
  int kpb = AUTO_KEYS_PER_BLOCK;
  while (kpb > 1 && (!fits_shared(BW, kpb) || (K + kpb - 1) / kpb < MIN_BLOCKS || kpb >= 2 * K))
    kpb /= 2;
  return kpb;
}

struct SweepArgs {
  const uint8_t* marked;
  unsigned* words;  // the packed marks, [words_for(BW), K]
  const uint8_t* marked_pin;
  const int* ev;
  const int* nm;
  const int* pr;
  const int* wev;
  const int* wnm;
  const int* wpr;
  const int* node;
  const int* root;
  const int* pend;
  const int* pend_pos;
  const int* pend_min;
  const int* node_drops;
  int* o_ev;
  int* o_nm;
  int* o_pr;
  uint8_t* o_pin;
  int* o_count;
  int* o_pend_min;
  int* o_node;
  int* o_root;
  int* o_drops;
  int* o_pend;
  int B, cap, BW, K, R, M, kpb;
  unsigned* scratch;
};

// The n-th (0-based) set bit of a word that has more than n.
__device__ __forceinline__ int nth_bit(unsigned w, int n) {
  int pos = 0;
  for (int width = 16; width > 0; width >>= 1) {
    const unsigned lo = w & ((1u << width) - 1u);
    const int c = __popc(lo);
    if (n >= c) {
      n -= c;
      w >>= width;
      pos += width;
    } else {
      w = lo;
    }
  }
  return pos;
}

// p[0, n) = v (int32), 16 bytes a store where p is 16-byte aligned.
__device__ __forceinline__ void fill_i32(int* p, size_t n, int v, size_t t, size_t stride) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    int4* q = reinterpret_cast<int4*>(p);
    const int4 v4 = make_int4(v, v, v, v);
    for (size_t i = t; i < n / 4; i += stride) q[i] = v4;
    for (size_t i = n / 4 * 4 + t; i < n; i += stride) p[i] = v;
  } else {
    for (size_t i = t; i < n; i += stride) p[i] = v;
  }
}

// dst[0, n) = src[0, n) (int32), 16 bytes a load and store where aligned.
__device__ __forceinline__ void copy_i32(int* dst, const int* src, size_t n, size_t t,
                                         size_t stride) {
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    int4* q = reinterpret_cast<int4*>(dst);
    const int4* r = reinterpret_cast<const int4*>(src);
    for (size_t i = t; i < n / 4; i += stride) q[i] = r[i];
    for (size_t i = n / 4 * 4 + t; i < n; i += stride) dst[i] = src[i];
  } else {
    for (size_t i = t; i < n; i += stride) dst[i] = src[i];
  }
}

// A key's marks: its bitmap and per-word exclusive prefix counts; the
// rank of an id is one popcount, the id of a rank a binary search over
// the prefixes and a select in one word.
struct KeyMarks {
  const unsigned* bits;
  const int* pre;
  int nwords, B, BW;

  // The id of the r-th marked node (r below the key's mark count).
  __device__ __forceinline__ int select(int r) const {
    int lo = 0, hi = nwords - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (pre[mid] <= r) lo = mid;
      else hi = mid - 1;
    }
    return lo * 32 + nth_bit(bits[lo], r - pre[lo]);
  }

  __device__ __forceinline__ int remap(int i) const {
    if (i < 0 || i >= BW) return -1;
    const unsigned word = bits[i >> 5];
    const unsigned bit = 1u << (i & 31);
    if (!(word & bit)) return -1;
    const int r = pre[i >> 5] + __popc(word & (bit - 1u));
    return r < B ? r : -1;
  }
};

// The writes that do not depend on the marks, over whole rows of all keys:
// region slots -1 and not pinned, the ring copied. The block kernel then
// overwrites the kept slots and the ring rows below each cursor.
__global__ void __launch_bounds__(NTHREADS) gc_sweep_fill_kernel(const SweepArgs a, int blocks) {
  const size_t t = (size_t)blockIdx.x * NTHREADS + threadIdx.x;
  const size_t stride = (size_t)blocks * NTHREADS;
  const size_t n = (size_t)a.B * a.K;
  fill_i32(a.o_ev, n, -1, t, stride);
  fill_i32(a.o_nm, n, -1, t, stride);
  fill_i32(a.o_pr, n, -1, t, stride);
  // The pinned plane is bytes: n / 4 words of 0 (its tail byte by byte).
  fill_i32(reinterpret_cast<int*>(a.o_pin), n / 4, 0, t, stride);
  for (size_t i = n / 4 * 4 + t; i < n; i += stride) a.o_pin[i] = 0;
  copy_i32(a.o_pend, a.pend, (size_t)a.M * a.K, t, stride);
}

__global__ void __launch_bounds__(NTHREADS) gc_sweep_kernel(const SweepArgs a) {
#ifdef NFA_CPU_EMU
  unsigned* smem = static_cast<unsigned*>(emu::dynamic_smem());
#else
  extern __shared__ unsigned smem[];
#endif
  const int kpb = a.kpb, K = a.K, B = a.B, BW = a.BW;
  const int nwords = words_for(BW), stride = key_stride(BW);
  unsigned* base = a.scratch != nullptr ? a.scratch + (size_t)blockIdx.x * block_words(BW, kpb)
                                        : smem;
  unsigned* bits = base;                                            // [kpb][stride]
  int* pre = reinterpret_cast<int*>(base + (size_t)kpb * stride);   // [kpb][stride]
  int* cnt = pre + (size_t)kpb * stride;                            // [kpb]
  const int tid = threadIdx.x;
  const int j = tid % kpb;
  const int S = NTHREADS / kpb;
  const int s0 = tid / kpb;
  const int k = blockIdx.x * kpb + j;
  const bool live = k < K;

  // Pass 1: the block's keys' packed words into its bitmaps.
  const int k0 = blockIdx.x * kpb;
  for (int i = tid; i < kpb * nwords; i += NTHREADS) {
    const int jj = i % kpb, w = i / kpb;
    bits[(size_t)jj * stride + w] = k0 + jj < K ? a.words[(size_t)w * K + k0 + jj] : 0u;
  }
  __syncthreads();

  // Pass 2: per-word exclusive prefix counts, a warp a key: each lane sums
  // a contiguous run of words, the warp scans the sums, each lane then
  // writes its run's prefixes.
  {
    const int warp = tid / 32, lane = tid % 32;
    const int run = (nwords + 31) / 32;
    for (int jj = warp; jj < kpb; jj += NWARPS) {
      const unsigned* kb = bits + (size_t)jj * stride;
      int* kp = pre + (size_t)jj * stride;
      const int lo = min(lane * run, nwords), hi = min(lo + run, nwords);
      int sum = 0;
      for (int w = lo; w < hi; ++w) sum += __popc(kb[w]);
      int incl = sum;
      for (int d = 1; d < 32; d *= 2) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      int acc = incl - sum;
      for (int w = lo; w < hi; ++w) {
        kp[w] = acc;
        acc += __popc(kb[w]);
      }
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      if (lane == 0) cnt[jj] = total;
    }
  }
  __syncthreads();
  if (!live) return;

  const KeyMarks km{bits + (size_t)j * stride, pre + (size_t)j * stride, nwords, B, BW};
  const int n_keep = cnt[j];
  const int kept = min(n_keep, B);

  // Pass 3: region slot r < kept takes the r-th marked node (region rows
  // from the pool planes, window rows from the step's [T, K, cap] planes);
  // the fill kernel wrote the slots past it. The threads of a warp write
  // one row of their keys.
  for (int r = s0; r < kept; r += S) {
    const size_t o = (size_t)r * K + k;
    const int i = km.select(r);
    int e, n, p;
    if (i < B) {
      const size_t idx = (size_t)i * K + k;
      e = a.ev[idx];
      n = a.nm[idx];
      p = a.pr[idx];
    } else {
      const int wi = i - B;
      const int t = wi / a.cap;
      const size_t idx = ((size_t)t * K + k) * a.cap + (wi - t * a.cap);
      e = a.wev[idx];
      n = a.wnm[idx];
      p = a.wpr[idx];
    }
    a.o_ev[o] = e;
    a.o_nm[o] = n;
    a.o_pr[o] = km.remap(p);
    a.o_pin[o] = a.marked_pin[(size_t)i * K + k] != 0 ? 1 : 0;
  }
  // Lane nodes and roots.
  for (int r = s0; r < a.R; r += S) {
    const size_t o = (size_t)r * K + k;
    a.o_node[o] = km.remap(a.node[o]);
    a.o_root[o] = km.remap(a.root[o]);
  }
  // The ring rows below the key's cursor, remapped (the fill kernel copied
  // the rest).
  const int pos = min(a.pend_pos[k], a.M);
  for (int r = s0; r < pos; r += S) {
    const size_t o = (size_t)r * K + k;
    a.o_pend[o] = km.remap(a.pend[o]);
  }
  if (s0 == 0) {
    a.o_count[k] = kept;
    a.o_drops[k] = a.node_drops[k] + max(n_keep - B, 0);
    const int pm = a.pend_min[k];
    if (pm == PEND_MIN_NONE) {
      a.o_pend_min[k] = pm;
    } else {
      const int c = pm < 0 ? 0 : (pm > BW ? BW : pm);
      a.o_pend_min[k] = max(km.remap(c), 0);
    }
  }
}

extern "C" int gc_sweep_keys_per_block(int BW, int K) { return auto_keys_per_block(BW, K); }

// uint32 words of the packed marks, and of a block's bitmaps, prefixes and
// counts (a launch's global scratch holds one such area a block).
extern "C" long long gc_sweep_words(int BW, int K) { return (long long)words_for(BW) * K; }

extern "C" long long gc_sweep_block_words(int BW, int kpb) { return block_words(BW, kpb); }

// Dynamic shared memory of a launch in bytes (0 when its bitmaps live in
// the global scratch).
extern "C" long long gc_sweep_smem_bytes(int BW, int K) {
  const int kpb = auto_keys_per_block(BW, K);
  return fits_shared(BW, kpb) ? block_words(BW, kpb) * 4 : 0;
}

// int32 words of global scratch a launch needs: 0 while a block's bitmaps
// and prefixes fit in shared memory, which is every BW up to 929,760 rows.
extern "C" long long gc_sweep_scratch_words(int BW, int K) {
  const int kpb = auto_keys_per_block(BW, K);
  if (fits_shared(BW, kpb)) return 0;
  return (long long)((K + kpb - 1) / kpb) * block_words(BW, kpb);
}

// Host entry, bound with ctypes: the pack grid, the fill grid and the
// block grid, on `stream`. `ptrs` holds the 24 tensor pointers in
// SweepArgs order (marked ... node_drops, then o_ev ... o_pend); `dims` is
// (B, cap, BW, K, R, M, kpb), kpb 0 = auto_keys_per_block, else a power of
// two <= 32. `words` holds gc_sweep_words() uint32 (16-byte aligned). A
// non-null `scratch` (blocks * gc_sweep_block_words() words) puts bitmaps
// and prefixes there; it must be given when gc_sweep_scratch_words() is
// not 0. Returns the launches' cudaError_t.
extern "C" int gc_sweep_launch(void* const* ptrs, const int* dims, void* words, void* scratch,
                               void* stream) {
  SweepArgs a;
  const void* const* p = ptrs;
  a.marked = static_cast<const uint8_t*>(p[0]);
  a.marked_pin = static_cast<const uint8_t*>(p[1]);
  a.ev = static_cast<const int*>(p[2]);
  a.nm = static_cast<const int*>(p[3]);
  a.pr = static_cast<const int*>(p[4]);
  a.wev = static_cast<const int*>(p[5]);
  a.wnm = static_cast<const int*>(p[6]);
  a.wpr = static_cast<const int*>(p[7]);
  a.node = static_cast<const int*>(p[8]);
  a.root = static_cast<const int*>(p[9]);
  a.pend = static_cast<const int*>(p[10]);
  a.pend_pos = static_cast<const int*>(p[11]);
  a.pend_min = static_cast<const int*>(p[12]);
  a.node_drops = static_cast<const int*>(p[13]);
  a.o_ev = static_cast<int*>(ptrs[14]);
  a.o_nm = static_cast<int*>(ptrs[15]);
  a.o_pr = static_cast<int*>(ptrs[16]);
  a.o_pin = static_cast<uint8_t*>(ptrs[17]);
  a.o_count = static_cast<int*>(ptrs[18]);
  a.o_pend_min = static_cast<int*>(ptrs[19]);
  a.o_node = static_cast<int*>(ptrs[20]);
  a.o_root = static_cast<int*>(ptrs[21]);
  a.o_drops = static_cast<int*>(ptrs[22]);
  a.o_pend = static_cast<int*>(ptrs[23]);
  a.B = dims[0];
  a.cap = dims[1];
  a.BW = dims[2];
  a.K = dims[3];
  a.R = dims[4];
  a.M = dims[5];
  a.kpb = dims[6] != 0 ? dims[6] : auto_keys_per_block(a.BW, a.K);
  a.words = static_cast<unsigned*>(words);
  a.scratch = static_cast<unsigned*>(scratch);
  if (a.K <= 0) return 0;
  if (a.words == nullptr) return 1;
  if (a.kpb < 1 || a.kpb > MAX_KEYS_PER_BLOCK || (a.kpb & (a.kpb - 1)) != 0) return 1;
  if (a.cap <= 0 || a.B <= 0) return 1;
  if (a.scratch == nullptr && !fits_shared(a.BW, a.kpb)) return 1;  // cudaErrorInvalidValue
  const int blocks = (a.K + a.kpb - 1) / a.kpb;
  const size_t smem = a.scratch != nullptr ? 0 : (size_t)block_words(a.BW, a.kpb) * 4;
  const size_t fill_vecs = ((size_t)(a.B > a.M ? a.B : a.M) * a.K + 3) / 4;
  const size_t fill_want = (fill_vecs + NTHREADS - 1) / NTHREADS;
  const int fill_blocks = fill_want < FILL_BLOCKS ? (int)fill_want : FILL_BLOCKS;
  const int quad = quad_keys(a.marked, a.K) ? 1 : 0;
  const int pb = pack_blocks(a.BW, a.K, quad, NTHREADS, FILL_BLOCKS);
#ifdef NFA_CPU_EMU
  emu::launch(pb, NTHREADS,
              [&]() { gc_pack_kernel<NTHREADS>(a.marked, a.words, a.BW, a.K, quad, pb); });
  emu::launch(fill_blocks, NTHREADS, [&]() { gc_sweep_fill_kernel(a, fill_blocks); });
  emu::launch(blocks, NTHREADS, [&]() { gc_sweep_kernel(a); }, smem);
  return 0;
#else
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gc_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const auto st = (cudaStream_t)stream;
  gc_pack_kernel<NTHREADS><<<pb, NTHREADS, 0, st>>>(a.marked, a.words, a.BW, a.K, quad, pb);
  gc_sweep_fill_kernel<<<fill_blocks, NTHREADS, 0, st>>>(a, fill_blocks);
  gc_sweep_kernel<<<blocks, NTHREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
#endif
}
