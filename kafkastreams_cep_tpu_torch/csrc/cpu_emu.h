// Runs a CUDA kernel source on the CPU, for testing without a card.
//
// nfa_step.cu, gc_mark.cu and gc_sweep.cu compile with g++ when
// NFA_CPU_EMU is defined: every CUDA thread of a block becomes an OS
// thread, __syncthreads() a block-wide std::barrier, atomicOr a
// std::atomic_ref fetch_or, a launch's dynamic shared memory a per-block
// buffer (emu::dynamic_smem()), and uint4 and int4 16-byte aligned
// structs. Each warp intrinsic the kernel uses (__shfl_sync,
// __shfl_up_sync, __ballot_sync, __any_sync, __syncwarp) meets at its
// warp's own barrier, so it needs all 32 lanes of the warp, as the
// kernel's full-mask calls do on the card; a call with a partial mask
// aborts rather than guess at the card's behaviour. Blocks run one after
// another, on one set of threads. The point is to execute the kernel's own
// arithmetic, ranks and scatters against the plain PyTorch version in the
// CPU test suite; speed is not a goal, and nothing about warp scheduling
// is modelled.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __launch_bounds__(...)

namespace emu {

struct Idx {
  int x = 0;
};

struct Block {
  Block(int nthreads, size_t smem_bytes)
      : bar(nthreads), end(nthreads), xchg(nthreads), smem((smem_bytes + 7) / 8) {
    for (int w = 0; w < nthreads / 32; ++w) warp_bar.emplace_back(new std::barrier<>(32));
  }
  std::barrier<> bar;                                    // __syncthreads
  std::barrier<> end;                                    // between two blocks
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;  // one per warp
  std::vector<int> xchg;                                 // one slot per thread
  std::vector<unsigned long long> smem;                  // dynamic shared memory
};

inline thread_local Block* blk = nullptr;

inline void launch(int grid, int nthreads, const std::function<void()>& body,
                   size_t smem_bytes = 0);

// The launch's dynamic shared memory (`extern __shared__` on the card).
inline void* dynamic_smem() { return blk->smem.data(); }

}  // namespace emu

inline thread_local emu::Idx threadIdx;
inline thread_local emu::Idx blockIdx;

inline void __syncthreads() { emu::blk->bar.arrive_and_wait(); }

namespace emu {

inline void full_mask(unsigned mask, const char* fn) {
  if (mask != 0xffffffffu) {
    std::fprintf(stderr, "cpu_emu: %s with partial mask %#x is not emulated\n", fn, mask);
    std::abort();
  }
}

// The 32 threads of the calling warp publish v and meet at their warp's
// barrier; pick(lane0_slot) reads any lane's value; a second meeting lets
// the slots be reused.
template <class Pick>
inline auto warp_exchange(unsigned mask, const char* fn, int v, Pick pick) {
  full_mask(mask, fn);
  Block& b = *blk;
  const int tid = threadIdx.x;
  std::barrier<>& wb = *b.warp_bar[tid / 32];
  b.xchg[tid] = v;
  wb.arrive_and_wait();
  const auto res = pick(&b.xchg[tid & ~31], tid & 31);
  wb.arrive_and_wait();
  return res;
}

}  // namespace emu

inline int __shfl_sync(unsigned mask, int v, int src) {
  return emu::warp_exchange(mask, "__shfl_sync", v,
                            [&](const int* w, int) { return w[src & 31]; });
}

inline int __shfl_up_sync(unsigned mask, int v, int delta) {
  return emu::warp_exchange(mask, "__shfl_up_sync", v, [&](const int* w, int lane) {
    return lane >= delta ? w[lane - delta] : w[lane];
  });
}

inline unsigned __ballot_sync(unsigned mask, int pred) {
  return emu::warp_exchange(mask, "__ballot_sync", pred != 0, [](const int* w, int) {
    unsigned bits = 0;
    for (int i = 0; i < 32; ++i) bits |= (w[i] ? 1u : 0u) << i;
    return bits;
  });
}

inline int __any_sync(unsigned mask, int pred) { return __ballot_sync(mask, pred) != 0; }

inline void __syncwarp(unsigned mask = 0xffffffffu) {
  emu::full_mask(mask, "__syncwarp");
  emu::blk->warp_bar[threadIdx.x / 32]->arrive_and_wait();
}

using std::max;
using std::min;

struct alignas(16) uint4 {
  unsigned x, y, z, w;
};

inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }

struct alignas(16) int4 {
  int x, y, z, w;
};

inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }

inline unsigned atomicOr(unsigned* address, unsigned val) {
  return std::atomic_ref<unsigned>(*address).fetch_or(val);
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }

inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, sizeof i);
  return i;
}

inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}

inline void emu::launch(int grid, int nthreads, const std::function<void()>& body,
                       size_t smem_bytes) {
  if (grid <= 0) return;
  // One set of threads runs the blocks in turn; between two blocks every
  // thread meets at a barrier of its own and the shared memory is cleared.
  Block block(nthreads, smem_bytes);
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) {
    threads.emplace_back([&, t]() {
      blk = &block;
      threadIdx.x = t;
      for (int g = 0; g < grid; ++g) {
        blockIdx.x = g;
        body();
        block.end.arrive_and_wait();
        if (t == 0) std::fill(block.smem.begin(), block.smem.end(), 0ull);
        block.end.arrive_and_wait();
      }
    });
  }
  for (auto& th : threads) th.join();
}
