// Runs a CUDA kernel source on the CPU, for testing without a card.
//
// nfa_step.cu compiles with g++ when NFA_CPU_EMU is defined: every CUDA
// thread of a block becomes an OS thread, __syncthreads() a block-wide
// std::barrier and shared memory a per-block buffer. __syncthreads_or()
// meets at the block barrier; a warp shuffle meets at its warp's own
// barrier, so it needs all 32 lanes of the warp, as the kernel's
// full-mask shuffles do on the card. Blocks run one after another. The
// point is to execute the kernel's own arithmetic, ranks and scatters
// against the plain PyTorch version in the CPU test suite; speed is not a
// goal, and nothing about warp scheduling is modelled.
#pragma once

#include <atomic>
#include <barrier>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __launch_bounds__(n)

namespace emu {

struct Idx {
  int x = 0;
};

struct Block {
  explicit Block(int nthreads, size_t smem_bytes)
      : bar(nthreads), xchg(nthreads), smem(smem_bytes / sizeof(int) + 1) {
    for (int w = 0; w < nthreads / 32; ++w) warp_bar.emplace_back(new std::barrier<>(32));
  }
  std::barrier<> bar;                                    // __syncthreads
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;  // one per warp
  std::vector<int> xchg;
  std::vector<int> smem;
  std::atomic<int> flag{0};
};

inline thread_local Block* blk = nullptr;

inline void* dyn_smem() { return blk->smem.data(); }

inline void launch(int grid, int nthreads, size_t smem_bytes, const std::function<void()>& body);

}  // namespace emu

inline thread_local emu::Idx threadIdx;
inline thread_local emu::Idx blockIdx;

inline void __syncthreads() { emu::blk->bar.arrive_and_wait(); }

inline int __syncthreads_or(int p) {
  emu::Block& b = *emu::blk;
  if (p) b.flag.store(1);
  b.bar.arrive_and_wait();
  const int res = b.flag.load();
  b.bar.arrive_and_wait();
  if (threadIdx.x == 0) b.flag.store(0);
  b.bar.arrive_and_wait();
  return res;
}

// A full-warp shuffle: the 32 threads of the calling warp meet at their
// warp's barrier (the kernel calls it with all 32 lanes, mask ~0u).
inline int __shfl_up_sync(unsigned /*mask*/, int v, int delta) {
  emu::Block& b = *emu::blk;
  const int tid = threadIdx.x;
  std::barrier<>& wb = *b.warp_bar[tid / 32];
  b.xchg[tid] = v;
  wb.arrive_and_wait();
  const int res = (tid & 31) >= delta ? b.xchg[tid - delta] : v;
  wb.arrive_and_wait();
  return res;
}

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

inline void emu::launch(int grid, int nthreads, size_t smem_bytes,
                        const std::function<void()>& body) {
  for (int g = 0; g < grid; ++g) {
    Block block(nthreads, smem_bytes);
    std::vector<std::thread> threads;
    threads.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) {
      threads.emplace_back([&, g, t]() {
        blk = &block;
        threadIdx.x = t;
        blockIdx.x = g;
        body();
      });
    }
    for (auto& th : threads) th.join();
  }
}
