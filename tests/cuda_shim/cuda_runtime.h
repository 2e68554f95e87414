// A CPU emulation of the CUDA features the port's kernels use, so that
// g++ can compile a source of src/repro_torch/csrc unchanged and run its
// kernels on the host (tests/test_torch_*_shim.py).
//
// Put this directory first on the include path: it stands in for
// <cuda_runtime.h> and <cuda_bf16.h>.  A source launches through
// cuda_shim::launch where nvcc would see <<<...>>> (the sources guard the
// two forms with __CUDACC__); __CUDA_ARCH__ stays undefined, so inline PTX
// takes its portable branch (cp.async becomes a plain 16-byte copy).
//
// Model: the CTAs of a grid run one after another, in a seeded random
// order (so a kernel that depends on which CTA runs last meets every
// order); the threads of a CTA are std::threads.  A warp is 32 threads
// with a std::barrier of its own: __syncwarp is that barrier, and each
// warp collective (__shfl*_sync, __ballot_sync, __reduce_max_sync) writes
// every lane's operand to a slot, waits, reads, and waits again.  Every
// collective must be reached by all lanes of the warp, as with the full
// mask on the card.  __syncthreads is a barrier of the whole CTA.
// Dynamic shared memory is one static array, filled with 0xFF bytes (a
// NaN in every float type) before each CTA, so a read of a slot the
// kernel never wrote shows.  Atomics and fences map onto the host's.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <numeric>
#include <random>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)

struct __attribute__((aligned(16))) uint4 {
  unsigned x, y, z, w;
};
struct __attribute__((aligned(8))) uint2 {
  unsigned x, y;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}
struct __attribute__((aligned(16))) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned x_, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};

typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };

template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return bytes <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

// The dynamic shared memory of the CTA that runs (one at a time).  A
// kernel's `extern __shared__ unsigned char smem[]` names it: both are
// members of the translation unit's unnamed namespace.
namespace {
alignas(16) unsigned char smem[256 * 1024];
}

namespace cuda_shim {

constexpr int WARP = 32;

struct Warp {
  explicit Warp(int n) : bar(n) {}
  std::barrier<> bar;
  uint64_t slot[WARP];
};

struct Cta {
  explicit Cta(int n) : bar(n) {
    for (int w = 0; w < (n + WARP - 1) / WARP; ++w)
      warps.emplace_back(new Warp(std::min(WARP, n - w * WARP)));
  }
  std::barrier<> bar;
  std::vector<std::unique_ptr<Warp>> warps;
};

inline thread_local Cta* cta = nullptr;
inline cudaError_t last_error = cudaSuccess;
inline uint64_t order_seed = 1;

inline Warp& warp() { return *cta->warps[threadIdx.x / WARP]; }
inline int lane() { return threadIdx.x % WARP; }
inline int lanes() {
  return std::min<int>(WARP, blockDim.x - threadIdx.x / WARP * WARP);
}

template <typename T>
inline uint64_t bits(T v) {
  static_assert(sizeof(T) <= 8, "a warp slot holds 8 bytes");
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  return u;
}

template <typename T>
inline T from_bits(uint64_t u) {
  T v;
  std::memcpy(&v, &u, sizeof(T));
  return v;
}

// Publish this lane's operand, wait for the warp, read `src`'s, and wait
// again before the slots are reused.
template <typename T>
inline T exchange(T v, int src) {
  Warp& w = warp();
  w.slot[lane()] = bits(v);
  w.bar.arrive_and_wait();
  const T r = from_bits<T>(w.slot[src]);
  w.bar.arrive_and_wait();
  return r;
}

// Runs `kernel(args...)` over `grid` CTAs of `block` threads each, with
// `smem_bytes` of dynamic shared memory.  Returns when every CTA is done.
template <typename K, typename... A>
inline void launch(K kernel, dim3 grid, dim3 block, size_t smem_bytes,
                   A... args) {
  const int n = static_cast<int>(block.x * block.y * block.z);
  if (block.y != 1 || block.z != 1 || n <= 0 || n > 1024 ||
      smem_bytes > sizeof(smem)) {
    last_error = cudaErrorInvalidValue;
    return;
  }
  std::vector<dim3> ctas;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) ctas.emplace_back(x, y, z);
  std::mt19937_64 rng(order_seed++);
  std::shuffle(ctas.begin(), ctas.end(), rng);
  Cta c(n);
  std::vector<std::thread> threads;
  for (int t = 0; t < n; ++t)
    threads.emplace_back([&, t] {
      cta = &c;
      threadIdx = dim3(t);
      blockDim = block;
      gridDim = grid;
      for (const dim3& b : ctas) {
        if (t == 0) std::memset(smem, 0xFF, sizeof(smem));
        c.bar.arrive_and_wait();
        blockIdx = b;
        kernel(args...);
        c.bar.arrive_and_wait();
      }
    });
  for (auto& th : threads) th.join();
  last_error = cudaSuccess;
}

}  // namespace cuda_shim

inline cudaError_t cudaGetLastError() {
  const cudaError_t e = cuda_shim::last_error;
  cuda_shim::last_error = cudaSuccess;
  return e;
}

inline void __syncthreads() { cuda_shim::cta->bar.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  cuda_shim::warp().bar.arrive_and_wait();
}
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}

template <typename T>
inline T __shfl_sync(unsigned, T v, int src) {
  return cuda_shim::exchange(v, src & (cuda_shim::WARP - 1));
}
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {
  return cuda_shim::exchange(v, cuda_shim::lane() ^ mask);
}
inline unsigned __ballot_sync(unsigned, bool pred) {
  cuda_shim::Warp& w = cuda_shim::warp();
  w.slot[cuda_shim::lane()] = pred ? 1 : 0;
  w.bar.arrive_and_wait();
  unsigned r = 0;
  for (int l = 0; l < cuda_shim::lanes(); ++l)
    if (w.slot[l]) r |= 1u << l;
  w.bar.arrive_and_wait();
  return r;
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  cuda_shim::Warp& w = cuda_shim::warp();
  w.slot[cuda_shim::lane()] = v;
  w.bar.arrive_and_wait();
  unsigned r = 0;
  for (int l = 0; l < cuda_shim::lanes(); ++l)
    r = std::max(r, static_cast<unsigned>(w.slot[l]));
  w.bar.arrive_and_wait();
  return r;
}

using std::max;
using std::min;

inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline unsigned long long __umul64hi(unsigned long long a,
                                     unsigned long long b) {
  return static_cast<unsigned long long>(
      (static_cast<unsigned __int128>(a) * b) >> 64);
}

inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> a(*p);
  int old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}
template <typename T>
inline T __ldcg(const T* p) {
  return *p;
}
