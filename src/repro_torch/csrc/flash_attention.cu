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
// V; here the index does it), scores q . k scaled 1/sqrt(D) in f32, an
// optional causal mask by index, the softmax over the keys and p @ v in
// f32.  A (BH, S, D) tensor is the case H = Hkv = 1.  It holds at every S:
// rows and keys past S are neither summed nor stored (the TPU kernel pads
// its last tile and reads NaN there when S % 128 != 0).
//
// What bounds it here: operations.  A causal call does 2 * 2 * BH * S^2 *
// D / 2 FLOPs on S * D inputs per head, far above the card's ~295 FLOP per
// byte, so the tensor cores are what it must use.  Two designs live in
// this file, chosen by dtype and D in flash_attention_launch (never by
// trying one):
//
// * tc:: — bfloat16 with D = 64 or 128, every case the training path
//   runs.  Hopper tensor cores: one CTA of two consumer warpgroups (64
//   query rows each) and one producer warpgroup per (sequence * head,
//   128-row query tile); setmaxnreg moves the producer's registers to the
//   consumers, and one producer thread does all its work.  It loads the Q
//   tile once and 128-key K and V tiles through a two-stage ring in shared
//   memory by TMA (128-byte swizzle, completion on mbarriers).  A consumer
//   computes S = Q K^T by wgmma (bf16 in, f32 accumulate, both operands in
//   shared memory), scales S by 1/sqrt(D) in f32 (log2 e folded in, for
//   exp2f), runs the online softmax in registers (running max from -1e30,
//   so no inf - inf; the row sum l from the f32 probabilities), and adds
//   P V by wgmma with P from registers and V from shared memory (V is
//   N-major: the transpose bit).  P is issued three times, as P_hi =
//   bf16(P), P_mid = bf16(P - P_hi) and P_lo = bf16(P - P_hi - P_mid),
//   into the same f32 accumulator.  The card check holds the kernel to one
//   bf16 rounding step of its f32 plain version with an absolute floor of
//   1e-6: one bf16 rounding of P (a textbook FA kernel) misses it by
//   thousands of elements, two parts (2^-18 of P) still miss it where an
//   output cancels to near 0, three (2^-27) meet it with a margin
//   (tests/test_torch_flash_attention.py pins all three).  That is 2x the
//   tensor-core work of a plain FA kernel.  The TMA view is 4-D (D, heads,
//   S, B), so a tile's S axis ends at S and TMA fills rows past it with
//   zeros; keys past S are masked by index.  Under the causal mask the key
//   tiles wholly above the diagonal are skipped, only the diagonal tile is
//   masked, and the heaviest query tiles are scheduled first.
//
// * sc:: — float32 (any D) and bfloat16 with D = 16 or 32: no path runs
//   these, and TF32 tensor cores would break the f32 tolerance.  The
//   first design: scalar f32 FMAs.  One CTA of 256 threads per (sequence
//   * head, 64-row query tile) loops over 64-key tiles with an online
//   softmax (running max m, sum l and an f32 accumulator in registers)
//   and normalises once at the end.  The query tile (pre-scaled) and each
//   K tile sit transposed in shared memory in f32, so a thread's 4 x 4
//   block of scores reads two 16-byte vectors per step of the dot
//   product; the V tile sits row-major; the tile of probabilities reuses
//   the K tile's space.  Causal tiles are skipped and scheduled as in
//   tc::.  Masked scores are -1e30, as the reference writes them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;

namespace sc {

constexpr int BQ = 64;        // query rows of a CTA
constexpr int BK = 64;        // keys of a tile
constexpr int THREADS = 256;  // thread (ty, tx) = (tid / 16, tid % 16)
constexpr int PAD = 4;        // keeps transposed rows 16-byte aligned
constexpr int QS = BQ + PAD;  // row stride of the transposed q and p tiles
constexpr int KS = BK + PAD;  // row stride of the transposed K tile

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

}  // namespace sc

namespace tc {

constexpr int BQ = 128;           // query rows of a CTA (two warpgroups)
constexpr int BK = 128;           // keys of a K/V tile
constexpr int STAGES = 2;         // K/V tiles in flight
constexpr int CONSUMERS = 256;    // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and one producer warpgroup
// registers a thread after setmaxnreg: 2 x 128 x 240 + 128 x 24 is the
// 384 x 168 the CTA is launched with (65536 / 384, rounded down to 8)
constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;
constexpr int PARTS = 3;          // bf16 parts P is split into
constexpr int ATOM = 64;          // bf16 columns of a 128-byte swizzle atom
constexpr int ROW_BYTES = 128;    // one atom row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// one 4-D box of the tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a wgmma shared-memory descriptor of a 128-byte-swizzled tile:
// lbo / sbo in bytes
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence, commit and wait above
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// d (64 x 128 f32, the accumulator fragment) += A (desc da) . B (desc db),
// or = when acc is 0; A and B K-major bf16 in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      " %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      " %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64 f32) += A (the four bf16x2 registers a) . B (desc db), B
// N-major (the transpose bit) bf16 in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      " %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += A (the four bf16x2 registers a) . B (desc db), B
// N-major (the transpose bit) bf16 in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      " %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      " %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 64) wgmma_rs_n64(o, a, db);
  else wgmma_rs_n128(o, a, db);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// shared memory of a CTA: Q, then STAGES x (K, V), each tile D / 64
// swizzle atoms of (rows x 128 bytes), then the barriers
template <int D>
struct Smem {
  static constexpr int Q = BQ * D * 2;
  static constexpr int KV = BK * D * 2;
  static constexpr int BARS = Q + 2 * STAGES * KV;
  static constexpr int BYTES = BARS + 8 * (1 + 3 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;   // room to align to 1024
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ o, int S, int H,
                           int Hkv, float scale_log2, int causal) {
  using L = Smem<D>;
  constexpr int ATOMS = D / ATOM;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int kv_tiles_all = (S + BK - 1) / BK;
  const int n_tiles = causal ? min(kv_tiles_all, q0 / BK + 1) : kv_tiles_all;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroups 0 and 1 consume, warpgroup 2 produces; registers move from
  // the producer to the consumers (setmaxnreg acts on whole warpgroups)
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    // one thread of the producer warpgroup issues every TMA load
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, L::Q);
      for (int c = 0; c < ATOMS; ++c)
        tma_load(q_s + c * BQ * ROW_BYTES, &tq, q_full, c * ATOM, h, q0, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % STAGES;
        if (n >= STAGES) mbar_wait(empty + st, ((n / STAGES) & 1) ^ 1);
        uint8_t* k_s = smem + L::Q + st * 2 * L::KV;
        uint8_t* v_s = k_s + L::KV;
        mbar_expect_tx(k_full + st, L::KV);
        for (int c = 0; c < ATOMS; ++c)
          tma_load(k_s + c * BK * ROW_BYTES, &tk, k_full + st, c * ATOM, hk,
                   n * BK, b);
        mbar_expect_tx(v_full + st, L::KV);
        for (int c = 0; c < ATOMS; ++c)
          tma_load(v_s + c * BK * ROW_BYTES, &tv, v_full + st, c * ATOM, hk,
                   n * BK, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
    // a consumer warpgroup: query rows q0 + 64 wg + 16 warp + {g, g + 8}
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int row0 = q0 + wg * 64 + warp * 16 + g, row1 = row0 + 8;

    float acc[D / 2];      // O, the accumulator fragment of 64 x D
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;   // l: this thread's part

    mbar_wait(q_full, 0);
    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % STAGES;
      const int par = (n / STAGES) & 1;
      const uint8_t* k_s = smem + L::Q + st * 2 * L::KV;
      const uint8_t* v_s = k_s + L::KV;
      const int k0 = n * BK;

      // S = Q K^T over D in steps of 16 (32 bytes inside a 128-byte atom)
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      mbar_wait(k_full + st, par);
      fence_regs<BK / 2>(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int atom = kk / 4, off = (kk % 4) * 32;
        const uint64_t da = smem_desc(
            q_s + atom * BQ * ROW_BYTES + wg * 64 * ROW_BYTES + off, 16, 1024);
        const uint64_t db = smem_desc(k_s + atom * BK * ROW_BYTES + off, 16,
                                      1024);
        wgmma_ss_n128(s, da, db, kk);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs<BK / 2>(s);

      // online softmax on rows row0 (s[4i], s[4i+1]) and row1 (s[4i+2],
      // s[4i+3]), keys k0 + 8i + 2t + {0, 1}
      const bool edge = k0 + BK > S || (causal && n == n_tiles - 1);
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * i + e] * scale_log2;
          if (edge) {
            const int col = k0 + 8 * i + 2 * t + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (col >= S || (causal && col > row)) x = NEG;
          }
          s[4 * i + e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        s[4 * i] = exp2f(s[4 * i] - mn0);
        s[4 * i + 1] = exp2f(s[4 * i + 1] - mn0);
        s[4 * i + 2] = exp2f(s[4 * i + 2] - mn1);
        s[4 * i + 3] = exp2f(s[4 * i + 3] - mn1);
        sum0 += s[4 * i] + s[4 * i + 1];
        sum1 += s[4 * i + 2] + s[4 * i + 3];
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;

      // P as the A fragments of the 16-key steps of P V: for keys
      // 16j..16j+15, register r of the fragment is s[8j + 2r], s[8j + 2r + 1]
      // (hi, mid, lo): each part the bf16 rounding of what the parts
      // before it left over (the differences are exact in f32)
      uint32_t p[PARTS][BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float a = s[8 * j + 2 * r], c = s[8 * j + 2 * r + 1];
#pragma unroll
          for (int part = 0; part < PARTS; ++part) {
            const __nv_bfloat162 x = __floats2bfloat162_rn(a, c);
            p[part][j][r] = *reinterpret_cast<const uint32_t*>(&x);
            a -= __low2float(x);
            c -= __high2float(x);
          }
        }
      }
      fence_regs<D / 2>(acc);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[4 * i] *= c0;
        acc[4 * i + 1] *= c0;
        acc[4 * i + 2] *= c1;
        acc[4 * i + 3] *= c1;
      }

      // O += (P_hi + P_mid + P_lo) V over the keys in steps of 16 (16
      // rows of V)
      mbar_wait(v_full + st, par);
      fence_regs<D / 2>(acc);
      fence_regs<PARTS * BK / 4>(&p[0][0][0]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const uint64_t db = smem_desc(v_s + j * 16 * ROW_BYTES,
                                      BK * ROW_BYTES, 1024);
#pragma unroll
        for (int part = 0; part < PARTS; ++part)
          wgmma_pv<D>(acc, p[part][j], db);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs<D / 2>(acc);
      fence_regs<PARTS * BK / 4>(&p[0][0][0]);
      mbar_arrive(empty + st);      // this thread is done with the stage
    }

    // normalise once and store the rows inside S, two columns at a time
    const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
    const long long q_row = static_cast<long long>(H) * D;
    __nv_bfloat16* ob = o + static_cast<long long>(b) * S * q_row + h * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = 8 * i + 2 * t;
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(ob + row0 * q_row + col) =
            pack_bf16(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
      if (row1 < S)
        *reinterpret_cast<uint32_t*>(ob + row1 * q_row + col) =
            pack_bf16(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
    }
  }
}

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the 4-D view (D, heads, S, B) of a contiguous (B, S, heads, D) bf16
// tensor, cut in boxes of (64 columns, 1 head, `rows` positions, 1)
bool make_map(CUtensorMap* map, const void* base, int B, int S, int heads,
              int D, int rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
      static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(D) * 2,
      static_cast<cuuint64_t>(heads) * D * 2,
      static_cast<cuuint64_t>(S) * heads * D * 2};
  const cuuint32_t box[4] = {ATOM, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int Hkv, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, S, H, D, BQ) || !make_map(&tk, k, B, S, Hkv, D, BK)
      || !make_map(&tv, v, B, S, Hkv, D, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Smem<D>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_attention_kernel<D><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, H, Hkv,
      1.4426950408889634f / sqrtf(static_cast<float>(D)), causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike); D one of 16,
// 32, 64, 128.  Sets *design to the design launched (1 = tc, the tensor
// cores; 0 = sc, scalar) and returns the CUDA error of the launch
// (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int H, int Hkv, int D,
                           int causal, int dtype, void* stream,
                           int* design) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *design = dtype == 1 && (D == 64 || D == 128);
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    switch (D) {
      case 16: return sc::launch_d<bf16, 16>(q, k, v, o, B, S, H, Hkv, causal,
                                             st);
      case 32: return sc::launch_d<bf16, 32>(q, k, v, o, B, S, H, Hkv, causal,
                                             st);
      case 64: return tc::launch_d<64>(q, k, v, o, B, S, H, Hkv, causal, st);
      case 128: return tc::launch_d<128>(q, k, v, o, B, S, H, Hkv, causal, st);
    }
  } else if (dtype == 0) {
    switch (D) {
      case 16: return sc::launch_d<float, 16>(q, k, v, o, B, S, H, Hkv, causal,
                                              st);
      case 32: return sc::launch_d<float, 32>(q, k, v, o, B, S, H, Hkv, causal,
                                              st);
      case 64: return sc::launch_d<float, 64>(q, k, v, o, B, S, H, Hkv, causal,
                                              st);
      case 128: return sc::launch_d<float, 128>(q, k, v, o, B, S, H, Hkv,
                                                causal, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
