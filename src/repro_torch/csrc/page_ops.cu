// page_set and page_copy for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels src/repro/kernels/page_ops/page_ops.py
// (_set_kernel / page_set: PageS, the lazy zeroing of a freshly allocated
// KV page; _copy_kernel / page_copy: PageCP, the copy-on-write fork of a
// shared page).  What they compute is exactly the plain versions
// repro_torch/kernels/page_ops/ref.py::page_set_ref / page_copy_ref, on a
// pool of `layers` stacked pools of `np` pages each (a leading layer axis
// of the serving engine's KV pool), so one launch covers a command list on
// every layer:
//   page_set:  pool[l, ids[k]] = value               for every l, k
//   page_copy: pool[l, dst_k] = old pool[l, src_k]   for every l, k,
//              every source read as it was before the call, and on
//              duplicate destinations the last pair wins.
// Both are dtype-agnostic: a page is `page_vecs` 16-byte vectors, and
// page_set stores a 16-byte pattern (the value repeated in the pool's
// dtype) that the wrapper builds.
//
// What bounds them here: bytes.  A page of the qwen3-8b pool is
// 64 x 8 x 128 bf16 = 128 KiB per layer, and the work is a pure stream of
// 16-byte loads and stores.  One CTA per (page, layer) streams a page with
// neighbouring threads on neighbouring vectors.  A one-CTA-per-pair copy
// would race (a pair's destination may be another pair's source, and two
// pairs may share a destination), so page_copy runs two grids on the
// stream: the first stages every source page into `stage`, the second
// writes each staged page to its destination unless a later pair names
// the same destination.  The staging costs a second pass over the bytes;
// copies are rare on the serving path (a COW break), so it stays simple.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void page_set_kernel(uint4* __restrict__ pool,
                                const int* __restrict__ ids, long long np,
                                long long page_vecs, uint4 pat) {
  const long long layer = blockIdx.y;
  uint4* dst = pool + (layer * np + ids[blockIdx.x]) * page_vecs;
  for (long long i = threadIdx.x; i < page_vecs; i += blockDim.x)
    dst[i] = pat;
}

__global__ void page_stage_kernel(const uint4* __restrict__ pool,
                                  const int* __restrict__ pairs, int k_total,
                                  long long np, long long page_vecs,
                                  uint4* __restrict__ stage) {
  const int k = blockIdx.x;
  const long long layer = blockIdx.y;
  const uint4* src = pool + (layer * np + pairs[2 * k]) * page_vecs;
  uint4* dst = stage + (layer * k_total + k) * page_vecs;
  for (long long i = threadIdx.x; i < page_vecs; i += blockDim.x)
    dst[i] = src[i];
}

__global__ void page_write_kernel(uint4* __restrict__ pool,
                                  const int* __restrict__ pairs, int k_total,
                                  long long np, long long page_vecs,
                                  const uint4* __restrict__ stage) {
  const int k = blockIdx.x;
  const int dst_id = pairs[2 * k + 1];
  for (int j = k + 1; j < k_total; ++j)     // a later pair wins: the
    if (pairs[2 * j + 1] == dst_id) return; // whole CTA leaves together
  const long long layer = blockIdx.y;
  const uint4* src = stage + (layer * k_total + k) * page_vecs;
  uint4* dst = pool + (layer * np + dst_id) * page_vecs;
  for (long long i = threadIdx.x; i < page_vecs; i += blockDim.x)
    dst[i] = src[i];
}

}  // namespace

extern "C" {

// pool: `layers` x `np` pages of `page_vecs` 16-byte vectors; ids: (k,)
// int32 in [0, np); pat_lo/pat_hi: the 16-byte fill pattern.  Returns
// the CUDA error of the launch (0 = launched).
int page_set_launch(void* pool, const int* ids, int k, int layers,
                    long long np, long long page_vecs,
                    unsigned long long pat_lo, unsigned long long pat_hi,
                    void* stream) {
  const uint4 pat = make_uint4(
      static_cast<unsigned>(pat_lo), static_cast<unsigned>(pat_lo >> 32),
      static_cast<unsigned>(pat_hi), static_cast<unsigned>(pat_hi >> 32));
  page_set_kernel<<<dim3(k, layers), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(pool), ids, np, page_vecs, pat);
  return static_cast<int>(cudaGetLastError());
}

// pairs: (k, 2) int32 [src, dst] in [0, np); stage: room for
// layers * k pages.  Two grids on `stream`: stage, then write.
int page_copy_launch(void* pool, const int* pairs, int k, int layers,
                     long long np, long long page_vecs, void* stage,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  page_stage_kernel<<<dim3(k, layers), THREADS, 0, s>>>(
      static_cast<const uint4*>(pool), pairs, k, np, page_vecs,
      static_cast<uint4*>(stage));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  page_write_kernel<<<dim3(k, layers), THREADS, 0, s>>>(
      static_cast<uint4*>(pool), pairs, k, np, page_vecs,
      static_cast<const uint4*>(stage));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
