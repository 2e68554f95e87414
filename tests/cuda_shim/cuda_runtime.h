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
//
// Thread-block clusters (cudaLaunchKernelEx with
// cudaLaunchAttributeClusterDimension): the clusters of a grid run one
// after another in a seeded random order, and the CTAs of one cluster run
// at once, each with a shared-memory array of its own (cta_smem(), filled
// with 0xFF bytes before each cluster); cluster_sync() is a barrier of
// every thread of the cluster, map_shared_rank() points into another
// CTA's array at the same offset.  A plain launch is a grid of clusters of
// one CTA over the static array.
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
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributeNonPortableClusterSizeAllowed
};

template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute a, int v) {
  if (a == cudaFuncAttributeMaxDynamicSharedMemorySize)
    return v <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
  return cudaSuccess;
}

enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct {
    unsigned x, y, z;
  } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim;
  dim3 blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

// The dynamic shared memory of the CTA that runs (one at a time).  A
// kernel's `extern __shared__ unsigned char smem[]` names it: both are
// members of the translation unit's unnamed namespace.
namespace {
alignas(16) unsigned char smem[256 * 1024];
}

namespace cuda_shim {

constexpr int WARP = 32;
// the most CTAs a cluster holds (the card's, with the non-portable size)
constexpr unsigned CLUSTER_MAX = 16;

struct Warp {
  explicit Warp(int n) : bar(n) {}
  std::barrier<> bar;
  uint64_t slot[WARP];
};

struct Cta {
  Cta(int n, unsigned char* s) : bar(n), smem(s) {
    for (int w = 0; w < (n + WARP - 1) / WARP; ++w)
      warps.emplace_back(new Warp(std::min(WARP, n - w * WARP)));
  }
  std::barrier<> bar;
  std::vector<std::unique_ptr<Warp>> warps;
  unsigned char* smem;     // this CTA's dynamic shared memory
};

struct alignas(16) SmemArray {
  unsigned char b[sizeof(smem)];
};

// The CTAs of one cluster, run at once, and the barrier of all their
// threads.  A cluster of one CTA uses the static array.
struct Cluster {
  Cluster(unsigned ranks, int n) : bar(static_cast<int>(ranks) * n) {
    for (unsigned r = 0; r < ranks; ++r) {
      unsigned char* s = smem;
      if (ranks > 1) {
        own.emplace_back(new SmemArray);
        s = own.back()->b;
      }
      ctas.emplace_back(new Cta(n, s));
    }
  }
  std::barrier<> bar;
  std::vector<std::unique_ptr<SmemArray>> own;
  std::vector<std::unique_ptr<Cta>> ctas;
};

inline thread_local Cta* cta = nullptr;
inline thread_local Cluster* cluster = nullptr;
inline thread_local unsigned rank = 0;
inline cudaError_t last_error = cudaSuccess;
inline uint64_t order_seed = 1;

inline Warp& warp() { return *cta->warps[threadIdx.x / WARP]; }
inline int lane() { return threadIdx.x % WARP; }
inline int lanes() {
  return std::min<int>(WARP, blockDim.x - threadIdx.x / WARP * WARP);
}

// the calling thread's CTA: its dynamic shared memory, its rank in its
// cluster and the cluster's CTAs
inline unsigned char* cta_smem() { return cta->smem; }
inline unsigned cluster_rank() { return rank; }
inline unsigned cluster_ranks() {
  return static_cast<unsigned>(cluster->ctas.size());
}
inline void cluster_sync() { cluster->bar.arrive_and_wait(); }
// `p` (into this CTA's shared memory) in CTA `r` of the cluster
template <typename T>
inline T* map_shared_rank(T* p, unsigned r) {
  const auto off = reinterpret_cast<const unsigned char*>(p) - cta->smem;
  return reinterpret_cast<T*>(cluster->ctas[r]->smem + off);
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
// `smem_bytes` of dynamic shared memory, in clusters of `ranks` CTAs along
// x.  Returns when every CTA is done.
template <typename K, typename... A>
inline void launch_clusters(K kernel, dim3 grid, dim3 block,
                            size_t smem_bytes, unsigned ranks, A... args) {
  const int n = static_cast<int>(block.x * block.y * block.z);
  if (block.y != 1 || block.z != 1 || n <= 0 || n > 1024 ||
      smem_bytes > sizeof(smem) || ranks == 0 || ranks > CLUSTER_MAX ||
      grid.x % ranks != 0) {
    last_error = cudaErrorInvalidValue;
    return;
  }
  std::vector<dim3> firsts;          // each cluster's first CTA
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; x += ranks) firsts.emplace_back(x, y, z);
  std::mt19937_64 rng(order_seed++);
  std::shuffle(firsts.begin(), firsts.end(), rng);
  Cluster c(ranks, n);
  std::vector<std::thread> threads;
  for (unsigned r = 0; r < ranks; ++r)
    for (int t = 0; t < n; ++t)
      threads.emplace_back([&, r, t] {
        cta = c.ctas[r].get();
        cluster = &c;
        rank = r;
        threadIdx = dim3(t);
        blockDim = block;
        gridDim = grid;
        for (const dim3& b : firsts) {
          if (t == 0) std::memset(cta->smem, 0xFF, sizeof(smem));
          c.bar.arrive_and_wait();
          blockIdx = dim3(b.x + r, b.y, b.z);
          kernel(args...);
          c.bar.arrive_and_wait();
        }
      });
  for (auto& th : threads) th.join();
  last_error = cudaSuccess;
}

// A launch without clusters (`<<<grid, block, smem_bytes>>>`).
template <typename K, typename... A>
inline void launch(K kernel, dim3 grid, dim3 block, size_t smem_bytes,
                   A... args) {
  launch_clusters(kernel, grid, block, smem_bytes, 1, args...);
}

inline unsigned cluster_size(const cudaLaunchConfig_t* cfg) {
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      return cfg->attrs[i].val.clusterDim.y == 1 &&
                     cfg->attrs[i].val.clusterDim.z == 1
                 ? cfg->attrs[i].val.clusterDim.x
                 : 0;
  return 1;
}

}  // namespace cuda_shim

inline cudaError_t cudaGetLastError() {
  const cudaError_t e = cuda_shim::last_error;
  cuda_shim::last_error = cudaSuccess;
  return e;
}

template <typename K, typename... A>
inline cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                                      K kernel, A... args) {
  cuda_shim::launch_clusters(kernel, cfg->gridDim, cfg->blockDim,
                             cfg->dynamicSmemBytes,
                             cuda_shim::cluster_size(cfg), args...);
  return cuda_shim::last_error;
}

// One cluster of the configuration's size fits at a time when it holds at
// most CLUSTER_MAX CTAs of at most 1024 threads and 227 KB each.
template <typename F>
inline cudaError_t cudaOccupancyMaxActiveClusters(
    int* clusters, F, const cudaLaunchConfig_t* cfg) {
  const unsigned r = cuda_shim::cluster_size(cfg);
  *clusters = r >= 1 && r <= cuda_shim::CLUSTER_MAX &&
                      cfg->blockDim.x * cfg->blockDim.y * cfg->blockDim.z <=
                          1024 &&
                      cfg->dynamicSmemBytes <= 232448
                  ? 1
                  : 0;
  return cudaSuccess;
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
