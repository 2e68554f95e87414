// page_set, page_copy and page_gather for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernels src/repro/kernels/page_ops/page_ops.py
// (_set_kernel / page_set: PageS, the lazy zeroing of a freshly allocated
// KV page; _copy_kernel / page_copy: PageCP, the copy-on-write fork of a
// shared page; _gather_kernel / page_gather: PageR, pages of a table read
// out as one dense buffer).  What they compute is exactly the plain
// versions repro_torch/kernels/page_ops/ref.py::page_set_ref /
// page_copy_ref / page_gather_ref, on a pool of `layers` stacked pools of
// `np` pages each (a leading layer axis of the serving engine's KV pool),
// so one launch covers a command list on every layer:
//   page_set:    pool[l, ids[k]] = value               for every l, k, and
//                for every pool of a list of pools of one shape (the
//                serving engine's K and V pools in one launch)
//   page_copy:   pool[l, dst_k] = old pool[l, src_k]   for every l, k,
//                every source read as it was before the call, and on
//                duplicate destinations the last pair wins.
//   page_gather: out[l, k] = pool[l, table[k]]         for every l, k
// All three are dtype-agnostic: a page is `page_vecs` 16-byte vectors, and
// page_set stores a 16-byte pattern (the value repeated in the pool's
// dtype) that the wrapper builds.
//
// What bounds them here: bytes.  A page of the qwen3-8b pool is
// 64 x 8 x 128 bf16 = 128 KiB per layer, and the work is a pure stream of
// 16-byte loads and stores with neighbouring threads on neighbouring
// vectors.  page_set runs one CTA per (pool, id, layer) and page_gather
// one per (id, layer).  A one-CTA-per-pair copy would race (a pair's
// destination may be another pair's source, and two pairs may share a
// destination), so page_copy splits every page into chunks of `chunk`
// vectors instead and runs one CTA per (chunk, layer): the CTA loads its
// chunk of every pair's source into shared memory, waits for all of them,
// then writes its chunk of each destination that no later pair names.
// Chunks partition a page, so no two CTAs touch the same bytes, and every
// source is read before any write to the same bytes: one grid, each byte
// read once and written once, nothing staged in device memory.  The
// wrapper picks `chunk` so that K pairs' chunks fit in shared memory; for
// more pairs than a chunk of one vector each allows it stages instead:
// page_gather copies every source to a scratch buffer, page_copy_last
// marks each destination's last pair, and page_copy_scatter writes the
// marked pairs' pages from the buffer (three launches).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// most pools of one page_set launch
constexpr int MAX_POOLS = 8;

struct Pools {
  uint4* p[MAX_POOLS];
};

// CTA (x, layer): pool x / k, id x % k
__global__ void page_set_kernel(Pools pools, const int* __restrict__ ids,
                                int k, long long np, long long page_vecs,
                                uint4 pat) {
  const long long layer = blockIdx.y;
  const int x = blockIdx.x;
  uint4* dst = pools.p[x / k] + (layer * np + ids[x % k]) * page_vecs;
  for (long long i = threadIdx.x; i < page_vecs; i += blockDim.x)
    dst[i] = pat;
}

__global__ void page_copy_kernel(uint4* __restrict__ pool,
                                 const int* __restrict__ pairs, int k_total,
                                 long long np, long long page_vecs,
                                 int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* const buf = reinterpret_cast<uint4*>(smem);   // [k_total][chunk]
  const long long layer = blockIdx.y;
  const long long c0 = static_cast<long long>(blockIdx.x) * chunk;
  const int n = static_cast<int>(min(static_cast<long long>(chunk),
                                     page_vecs - c0));
  uint4* base = pool + layer * np * page_vecs + c0;
  for (int k = 0; k < k_total; ++k) {
    const uint4* src = base + pairs[2 * k] * page_vecs;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      buf[k * chunk + i] = src[i];
  }
  __syncthreads();   // every source chunk is read before any is written
  for (int k = 0; k < k_total; ++k) {
    const int dst_id = pairs[2 * k + 1];
    bool later = false;                      // a later pair wins
    for (int j = k + 1; j < k_total && !later; ++j)
      later = pairs[2 * j + 1] == dst_id;
    if (later) continue;
    uint4* dst = base + dst_id * page_vecs;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      dst[i] = buf[k * chunk + i];
  }
}

// last[dst] = the index + 1 of the last pair that names dst (last starts
// all 0): the pair that wins its destination.
__global__ void page_copy_last_kernel(const int* __restrict__ pairs,
                                      int k_total, int* __restrict__ last) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < k_total) atomicMax(last + pairs[2 * k + 1], k + 1);
}

// CTA (k, layer): pair k's page, staged in `scratch` ([layers][k_total]
// pages), to its destination, unless a later pair names the destination.
__global__ void page_copy_scatter_kernel(uint4* __restrict__ pool,
                                         const int* __restrict__ pairs,
                                         const int* __restrict__ last,
                                         const uint4* __restrict__ scratch,
                                         int k_total, long long np,
                                         long long page_vecs) {
  const int k = blockIdx.x;
  const int dst_id = pairs[2 * k + 1];
  if (last[dst_id] != k + 1) return;
  const long long layer = blockIdx.y;
  const uint4* src = scratch + (layer * k_total + k) * page_vecs;
  uint4* dst = pool + (layer * np + dst_id) * page_vecs;
  for (long long i = threadIdx.x; i < page_vecs; i += blockDim.x)
    dst[i] = src[i];
}

__global__ void page_gather_kernel(const uint4* __restrict__ pool,
                                   const int* __restrict__ table, int k_total,
                                   long long np, long long page_vecs,
                                   uint4* __restrict__ out) {
  const long long layer = blockIdx.y;
  const uint4* src = pool + (layer * np + table[blockIdx.x]) * page_vecs;
  uint4* dst = out + (layer * k_total + blockIdx.x) * page_vecs;
  for (long long i = threadIdx.x; i < page_vecs; i += blockDim.x)
    dst[i] = src[i];
}

}  // namespace

extern "C" {

// pools: `n_pools` (at most MAX_POOLS) pools of one geometry, each
// `layers` x `np` pages of `page_vecs` 16-byte vectors; ids: (k,) int32 in
// [0, np); pat_lo/pat_hi: the 16-byte fill pattern.  One grid of
// (n_pools * k, layers) CTAs.  Returns the CUDA error of the launch (0 =
// launched).
int page_set_launch(void* const* pools, int n_pools, const int* ids, int k,
                    int layers, long long np, long long page_vecs,
                    unsigned long long pat_lo, unsigned long long pat_hi,
                    void* stream) {
  if (n_pools < 1 || n_pools > MAX_POOLS || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Pools ps;
  for (int i = 0; i < MAX_POOLS; ++i)
    ps.p[i] = static_cast<uint4*>(pools[i < n_pools ? i : 0]);
  const uint4 pat = make_uint4(
      static_cast<unsigned>(pat_lo), static_cast<unsigned>(pat_lo >> 32),
      static_cast<unsigned>(pat_hi), static_cast<unsigned>(pat_hi >> 32));
  const dim3 grid(n_pools * k, layers);
#ifdef __CUDACC__
  page_set_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ps, ids, k, np, page_vecs, pat);
#else  // g++ under the CPU emulation of tests/cuda_shim
  cuda_shim::launch(page_set_kernel, grid, THREADS, 0, ps, ids, k, np,
                    page_vecs, pat);
#endif
  return static_cast<int>(cudaGetLastError());
}

// pairs: (k, 2) int32 [src, dst] in [0, np); chunk: 16-byte vectors of a
// page per CTA, k * chunk * 16 bytes of shared memory.  One grid of
// (ceil(page_vecs / chunk), layers) CTAs on `stream`.
int page_copy_launch(void* pool, const int* pairs, int k, int layers,
                     long long np, long long page_vecs, int chunk,
                     void* stream) {
  const size_t smem = static_cast<size_t>(k) * chunk * sizeof(uint4);
  cudaError_t err = cudaFuncSetAttribute(
      page_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned chunks =
      static_cast<unsigned>((page_vecs + chunk - 1) / chunk);
#ifdef __CUDACC__
  page_copy_kernel<<<dim3(chunks, layers), THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(pool), pairs, k, np, page_vecs, chunk);
#else
  cuda_shim::launch(page_copy_kernel, dim3(chunks, layers), THREADS, smem,
                    static_cast<uint4*>(pool), pairs, k, np, page_vecs,
                    chunk);
#endif
  return static_cast<int>(cudaGetLastError());
}

// The staged copy's last two launches, after page_gather has copied every
// pair's source into `scratch` (`layers` x k pages): last, (np,) int32
// all 0, gets each destination's winning pair, then the winners' pages go
// from `scratch` to the pool.
int page_copy_staged_launch(void* pool, const int* pairs, int k, int layers,
                            long long np, long long page_vecs,
                            const void* scratch, int* last, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((k + THREADS - 1) / THREADS);
#ifdef __CUDACC__
  page_copy_last_kernel<<<blocks, THREADS, 0, st>>>(pairs, k, last);
#else
  cuda_shim::launch(page_copy_last_kernel, blocks, THREADS, 0, pairs, k,
                    last);
#endif
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
#ifdef __CUDACC__
  page_copy_scatter_kernel<<<dim3(k, layers), THREADS, 0, st>>>(
      static_cast<uint4*>(pool), pairs, last,
      static_cast<const uint4*>(scratch), k, np, page_vecs);
#else
  (void)st;
  cuda_shim::launch(page_copy_scatter_kernel, dim3(k, layers), THREADS, 0,
                    static_cast<uint4*>(pool), pairs,
                    static_cast<const int*>(last),
                    static_cast<const uint4*>(scratch), k, np, page_vecs);
#endif
  return static_cast<int>(cudaGetLastError());
}

// table: (k,) int32 in [0, np); out: `layers` x k pages of `page_vecs`
// 16-byte vectors.
int page_gather_launch(const void* pool, const int* table, int k, int layers,
                       long long np, long long page_vecs, void* out,
                       void* stream) {
#ifdef __CUDACC__
  page_gather_kernel<<<dim3(k, layers), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(pool), table, k, np, page_vecs,
      static_cast<uint4*>(out));
#else
  cuda_shim::launch(page_gather_kernel, dim3(k, layers), THREADS, 0,
                    static_cast<const uint4*>(pool), table, k, np, page_vecs,
                    static_cast<uint4*>(out));
#endif
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
