// flash_attention for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py (_flash_kernel /
// flash_attention) together with the GQA fold of
// src/repro/kernels/flash_attention/ops.py (flash_mha).  What it computes
// is the plain version repro_torch/kernels/flash_attention/ref.py
// (flash_mha_ref, attention_ref):
//   q (B, S, H, D), k/v (B, S, Hkv, D)  ->  o (B, S, H, D) in q's dtype,
// query head h reading KV head h / (H / Hkv) (the reference repeats K and
// V; here the index does it), scores (q * 1/sqrt(D)) . k in f32 with q
// scaled first as the TPU kernel and the model's _online_attn do, an
// optional causal mask by index, the softmax over the keys and p @ v in
// f32.  A (BH, S, D) tensor is the case H = Hkv = 1.  It holds at every S:
// rows and keys past S are neither read nor summed (the TPU kernel pads
// its last tile and reads NaN there when S % 128 != 0).
//
// What bounds it here: operations.  A causal call does 2 * 2 * BH * S^2 *
// D / 2 multiply-adds' worth of FLOPs on S * D inputs per head, far above
// the card's ~295 FLOP per byte.  This first version is the simple design:
// scalar f32 FMAs (no tensor cores, no wgmma, no TMA — later work), so
// its ceiling is the 67 TFLOP/s f32 rate, not the 989 TFLOP/s bf16 one.
// One CTA of 256 threads per (sequence * head, 64-row query tile) loops
// over 64-key tiles with an online softmax (running max m, sum l and an
// f32 accumulator in registers) and normalises once at the end.  The
// query tile (pre-scaled) and each K tile sit transposed in shared memory
// in f32, so a thread's 4 x 4 block of scores reads two 16-byte vectors
// per step of the dot product; the V tile sits row-major; the tile of
// probabilities reuses the K tile's space.  Under the causal mask the key
// tiles wholly above the diagonal are skipped, and the heaviest query
// tiles are scheduled first.  Masked scores are -1e30, as the reference
// writes them; the running max starts there too, so no inf - inf arises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows of a CTA
constexpr int BK = 64;        // keys of a tile
constexpr int THREADS = 256;  // thread (ty, tx) = (tid / 16, tid % 16)
constexpr int PAD = 4;        // keeps transposed rows 16-byte aligned
constexpr int QS = BQ + PAD;  // row stride of the transposed q and p tiles
constexpr int KS = BK + PAD;  // row stride of the transposed K tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// the 16 threads of one ty (one half of a warp) share four query rows
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr int smem_floats() {
  return D * QS + (D * KS > BK * QS ? D * KS : BK * QS) + BK * D;
}

// output column c (of D / 16) of thread tx: four neighbouring columns per
// 16-byte vector where D allows it, else every 16th column
template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  if constexpr (D % 64 == 0) return (c / 4) * 64 + tx * 4 + c % 4;
  return tx + 16 * c;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int S, int H, int Hkv, float scale, int causal) {
  constexpr int C = D / 16;   // output columns per thread
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  extern __shared__ __align__(16) float smem[];
  float* qT = smem;                 // [D][QS]  q * scale, transposed
  float* kT = qT + D * QS;          // [D][KS]  K tile, transposed
  float* pT = kT;                   // [BK][QS] probabilities, transposed
  float* vs = kT + (D * KS > BK * QS ? D * KS : BK * QS);   // [BK][D]

  const long long q_row = static_cast<long long>(H) * D;
  const long long kv_row = static_cast<long long>(Hkv) * D;
  const T* qb = q + static_cast<long long>(b) * S * q_row + h * D;
  const T* kb = k + static_cast<long long>(b) * S * kv_row + hk * D;
  const T* vb = v + static_cast<long long>(b) * S * kv_row + hk * D;
  T* ob = o + static_cast<long long>(b) * S * q_row + h * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int s = q0 + r;
    qT[d * QS + r] = s < S ? to_f32(qb[s * q_row + d]) * scale : 0.f;
  }

  float acc[4][C];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    const int kn = min(BK, S - k0);   // keys of this tile inside S
    __syncthreads();   // the previous tile's p and V are read; q is written
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D, d = i - j * D;
      float kk = 0.f, vv = 0.f;
      if (j < kn) {
        const long long off = (k0 + j) * kv_row + d;
        kk = to_f32(kb[off]);
        vv = to_f32(vb[off]);
      }
      kT[d * KS + j] = kk;
      vs[j * D + d] = vv;
    }
    __syncthreads();

    // scores of rows ty*4 + i, keys tx*4 + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * QS + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kT + d * KS + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // online softmax; a key past S gets probability 0 outright
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        if (col >= S || (causal && col > row)) s[i][j] = NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = k0 + tx * 4 + j < S ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= corr;
    }
    __syncthreads();   // every thread is done reading kT: p takes its place
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pT + (tx * 4 + j) * QS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    for (int j = 0; j < kn; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(pT + j * QS + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[C];
      if constexpr (D % 64 == 0) {
#pragma unroll
        for (int c = 0; c < C; c += 4) {
          const float4 x = *reinterpret_cast<const float4*>(
              vs + j * D + out_col<D>(tx, c));
          vv[c] = x.x;
          vv[c + 1] = x.y;
          vv[c + 2] = x.z;
          vv[c + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) vv[c] = vs[j * D + out_col<D>(tx, c)];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c)
      store(ob + row * q_row + out_col<D>(tx, c), acc[i][c] / den);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int Hkv, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv,
      1.0f / sqrtf(static_cast<float>(D)), causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, int D, int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, o, B, S, H, Hkv, causal, stream);
    case 32: return launch_d<T, 32>(q, k, v, o, B, S, H, Hkv, causal, stream);
    case 64: return launch_d<T, 64>(q, k, v, o, B, S, H, Hkv, causal, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, o, B, S, H, Hkv, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike); D one of 16,
// 32, 64, 128.  Returns the CUDA error of the launch (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int H, int Hkv, int D,
                           int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, S, H, Hkv, D, causal, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, D, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
