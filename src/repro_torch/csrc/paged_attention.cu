// paged_attention for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel
// src/repro/kernels/paged_attention/paged_attention.py (_paged_kernel /
// paged_attention): one-token decode attention over a global KV page pool.
// What it computes is the plain version
// repro_torch/kernels/paged_attention/ref.py::paged_attention_ref:
//   q (B, H, D), kpool/vpool (NP, page, Hkv, D), block_table (B, P) int32,
//   seq_lens (B,) int32  ->  out (B, H, D) in q's dtype,
// with query head h*G + g (G = H / Hkv) reading KV head h, scores
// q.k / sqrt(D) in f32, positions >= seq_lens masked, and the softmax over
// the sequence's P * page slots.  A length of 0 masks every slot, and the
// reference's softmax over all-masked scores is uniform: the output is
// then the mean of V over all P * page slots, and so it is here.
//
// What bounds it here: bytes in principle (each K and V row up to the
// sequence's length is read once, at one multiply-add per element and
// query head), latency at the serving shape.  At qwen3-8b's decode
// (B = 4 slots, Hkv = 8, G = 4, D = 128, page = 64) a call moves a few
// MiB, so launch and the per-page round trips dominate.  The design is the
// simple one: one CTA per (sequence, KV head) walks the sequence's pages
// through the block table in order (the TPU grid's sequential page axis
// becomes a loop), stages the page's K and V rows of its head in shared
// memory with 16-byte loads, scores all G query heads against them, and
// carries an online softmax (running max, sum, f32 accumulator of G x D)
// across pages.  Pages at or past ceil(len / page) are never read, so
// table padding costs nothing; rows past the length inside the last page
// are neither read nor summed.  D, page, G and P are runtime values and
// the shared memory is sized from them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kpool,
    const T* __restrict__ vpool, const int* __restrict__ block_table,
    const int* __restrict__ seq_lens, T* __restrict__ out, int H, int Hkv,
    int D, int page, int P, float sqrt_d) {
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int G = H / Hkv;
  const int tid = threadIdx.x;

  // q_s [G][D] f32 | k_s, v_s [page][D] T | s_s [G][page] f32 |
  // acc [G][D] f32 | m_s, l_s, c_s [G] f32 — every part 16-byte aligned
  // because D * sizeof(T) is a multiple of 16
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  T* k_s = reinterpret_cast<T*>(q_s + G * D);
  T* v_s = k_s + page * D;
  float* s_s = reinterpret_cast<float*>(v_s + page * D);
  float* acc = s_s + G * page;
  float* m_s = acc + G * D;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const int len = seq_lens[b];
  const bool uniform = len <= 0;
  const int n_valid = uniform ? P * page : min(len, P * page);
  const int n_pages = (n_valid + page - 1) / page;

  const T* qb = q + (static_cast<long long>(b) * H + h * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    q_s[i] = to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = -1e30f;
    l_s[g] = 0.f;
  }

  const int row_vecs = D * static_cast<int>(sizeof(T)) / 16;
  const int warp = tid >> 5, lane = tid & 31, n_warps = blockDim.x >> 5;
  for (int p = 0; p < n_pages; ++p) {
    const long long id = block_table[b * P + p];
    const int valid = min(page, n_valid - p * page);
    __syncthreads();      // the previous page's k_s / v_s / s_s are done
    for (int i = tid; i < valid * row_vecs; i += blockDim.x) {
      const int j = i / row_vecs, c = i - j * row_vecs;
      const long long off = ((id * page + j) * Hkv + h) * D;
      reinterpret_cast<uint4*>(k_s + j * D)[c] =
          reinterpret_cast<const uint4*>(kpool + off)[c];
      reinterpret_cast<uint4*>(v_s + j * D)[c] =
          reinterpret_cast<const uint4*>(vpool + off)[c];
    }
    __syncthreads();
    // scores; each thread starts its dot product at another column so that
    // the threads of a warp (neighbouring rows) hit different banks
    for (int i = tid; i < G * page; i += blockDim.x) {
      const int g = i / page, j = i - g * page;
      float s = -1e30f;
      if (j < valid) {
        if (uniform) {
          s = 0.f;
        } else {
          const float* qg = q_s + g * D;
          const T* kj = k_s + j * D;
          float dot = 0.f;
          int d = (2 * j) % D;
          for (int dd = 0; dd < D; ++dd) {
            dot += qg[d] * to_f32(kj[d]);
            if (++d == D) d = 0;
          }
          s = dot / sqrt_d;
        }
      }
      s_s[i] = s;
    }
    __syncthreads();
    // online softmax, one warp per query head of the group
    for (int g = warp; g < G; g += n_warps) {
      float* sg = s_s + g * page;
      float mx = -1e30f;
      for (int j = lane; j < valid; j += 32) mx = fmaxf(mx, sg[j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < valid; j += 32) {
        const float e = expf(sg[j] - m_new);
        sg[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i - g * D;
      const float* pg = s_s + g * page;
      float a = acc[i] * c_s[g];
      for (int j = 0; j < valid; ++j) a += pg[j] * to_f32(v_s[j * D + d]);
      acc[i] = a;
    }
  }
  __syncthreads();
  T* ob = out + (static_cast<long long>(b) * H + h * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x)
    store(ob + i, acc[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* kpool, const void* vpool,
           const int* block_table, const int* seq_lens, void* out, int B,
           int H, int Hkv, int D, int page, int P, void* stream) {
  const int G = H / Hkv;
  const size_t smem = sizeof(float) * (2 * G * D + G * page + 3 * G) +
                      sizeof(T) * 2 * page * D;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  paged_attention_kernel<T><<<B * Hkv, THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), block_table, seq_lens,
      static_cast<T*>(out), H, Hkv, D, page, P, sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and out alike).  Returns
// the CUDA error of the launch (0 = launched).
int paged_attention_launch(const void* q, const void* kpool,
                           const void* vpool, const int* block_table,
                           const int* seq_lens, void* out, int B, int H,
                           int Hkv, int D, int page, int P, int dtype,
                           void* stream) {
  if (dtype == 0)
    return launch<float>(q, kpool, vpool, block_table, seq_lens, out, B, H,
                         Hkv, D, page, P, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kpool, vpool, block_table, seq_lens,
                                 out, B, H, Hkv, D, page, P, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
