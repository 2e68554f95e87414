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
// then the mean of V over all P * page slots, and so it is here.  Table
// entries at or past ceil(len / page) are never read.
//
// What bounds it: bytes.  Each K and V row up to the sequence's length is
// read once, and a row of D elements costs G * D multiply-adds for the
// scores and as many for P.V: about one FMA a byte, some 300 times below
// the card's ratio of operations to bytes.  Hence no tensor cores either:
// a KV head serves G = 4 query rows at qwen3-8b, and wgmma's M = 64 would
// be 94 % padding for work the memory bounds anyway.
//
// Design (flash-decoding).  The grid is (B * Hkv * groups) x splits: each
// CTA takes one KV head of one sequence, a group of at most GC of its G
// query heads (groups = ceil(G / gc), one for every model of the registry),
// and a contiguous range of pages_per_split pages; the wrapper picks the
// split count from P, the CTA count and the SM count, never from seq_lens.
// A CTA whose range lies wholly past the length returns at once.  It
// stages its range's page ids in shared memory; then each of its warps (4,
// or 8 for a range of at most 16 chunks, whose latency is the warp's chain
// of batches) owns every 4th (8th) chunk of `rows` rows and runs alone:
// a ring of STAGES chunks per warp is filled with 16-byte cp.async.cg
// copies STAGES - 1 chunks ahead of the math, and only __syncwarp orders
// it.  A lane holds its 4-element slices of the head group's query rows in
// registers (pre-scaled by log2(e) / sqrt(D)).  Rows are scored 32 / GC at
// a time: a lane's 32 partial dot products (rows x heads) go through five
// __shfl_xor_sync rounds that halve what each lane keeps and sum the rest,
// so that lane i ends with score i complete; the online softmax (running
// max and sum per head) works on that one score per lane, and the P.V
// accumulator (GC x 4 * C4 f32 per lane) stays in registers.  At the end
// the warps merge through shared memory once.  A sequence whose rows all
// lie in the first range is written to `out` by that CTA.  Otherwise each
// live CTA writes its partial (m, l, acc[D] per query head) to the
// workspace and takes a ticket from its (sequence, KV head, group) counter
// with an acquire-release atomic; the CTA with the last ticket weighs the
// live partials once per head, sums them (each thread's loads in flight
// together), writes `out`, and sets the counter back to 0 for the next
// call.  One launch a call, no memset.
//
// The windowed instantiation (WINDOW = true, entry
// paged_attention_window_launch) serves a sliding window over a ring: the
// table's P * page slots hold the last tokens of the sequence, the newest
// one in slot (len - 1) mod (P * page), and slot t is attended iff
// (len - 1 - t) mod (P * page) < window — the reference's decode rule,
// which does not ask whether a slot was ever written (ref.py).  Every range
// is live, every row is read, and a row out of the window scores -inf; the
// masked span is the P * page - window slots after the newest one, which
// wrap and need not be page-aligned, so a batch, a warp or a whole range
// may hold no attended row: its running max stays -inf and adds nothing.
// WINDOW = false is the source as it was; all it sees of the window is
// one more field at the end of Params, which it never reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int MAX_WARPS = 8;
constexpr int STAGES = 3;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const void* kpool;
  const void* vpool;
  const int* block_table;
  const int* seq_lens;
  void* out;
  float* part;           // (slots, splits, gc, D + 2): acc[D], m, l
  int* counters;         // (slots,)
  int H, Hkv, D, page, P;
  int gc;                // query heads a CTA takes (the last group: fewer)
  int groups;            // ceil(G / gc)
  int splits;
  int pages_per_split;
  int rows;              // rows of a ring chunk
  int warps;             // warps of a CTA, 4 or MAX_WARPS
  float qscale;          // log2(e) / sqrt(D)
  int window;            // the windowed instantiation's window (> 0)
};

__device__ __forceinline__ float bits_f32(unsigned u) {
  return __uint_as_float(u);
}

// Four consecutive elements at p (8 or 16 bytes, aligned) as f32.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  x[0] = bits_f32(u.x);
  x[1] = bits_f32(u.y);
  x[2] = bits_f32(u.z);
  x[3] = bits_f32(u.w);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  x[0] = bits_f32(u.x << 16);
  x[1] = bits_f32(u.x & 0xffff0000u);
  x[2] = bits_f32(u.y << 16);
  x[3] = bits_f32(u.y & 0xffff0000u);
}

__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// One xor round of the scores' reduction: lanes that differ in bit HALF
// swap halves of their first 2 * HALF values, and each keeps the sum of
// the half its bit selects (compile-time indices: the values stay in
// registers).
template <int HALF>
__device__ __forceinline__ void halve(float (&sc)[32], int lane) {
  const bool hi = (lane & HALF) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = hi ? sc[i] : sc[i + HALF];
    const float keep = hi ? sc[i + HALF] : sc[i];
    sc[i] = keep + __shfl_xor_sync(FULL, send, HALF);
  }
}

// atomicAdd with release and acquire semantics at device scope.
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
#ifdef __CUDA_ARCH__
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
#else
  return atomicAdd(p, v);
#endif
}

// A 16-byte copy from global to shared memory: cp.async.cg on the card
// (through L2 only, no registers), a plain copy elsewhere.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
#else
  *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// C4: 4-element slices per lane (lane l owns dims 4 * (l + 32 c) .. + 3,
// c < C4), so D <= 128 * C4.  GC: query heads held in registers.  WINDOW:
// the ring under a sliding window (see the top of the file).
template <typename T, int C4, int GC, bool WINDOW>
__global__ void __launch_bounds__(32 * MAX_WARPS)
    paged_attention_kernel(const Params p) {
  // a batch is BATCH rows x GC heads = 32 scores: after the five xor
  // rounds lane i holds score i = r * GC + g in full
  constexpr int BATCH = 32 / GC;
  static_assert(GC >= 1 && GC <= 16 && 32 % GC == 0, "GC divides 32");
  const int slot = blockIdx.x, split = blockIdx.y;
  const int grp = slot % p.groups;
  const int bh = slot / p.groups;
  const int b = bh / p.Hkv, h = bh % p.Hkv;
  const int G = p.H / p.Hkv;
  const int g0 = grp * p.gc;
  const int gn = min(p.gc, G - g0);           // heads of this CTA
  const int D = p.D, page = p.page;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = p.warps, nthreads = 32 * nw;

  // smem: rings [nw][STAGES][K, V][rows][D] T (the combine's weights
  // after the loop) | wml [nw + 1][GC][2] | wacc [nw][GC][D] f32 | the
  // last-ticket flag | the page ids of this CTA's range
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ring = reinterpret_cast<T*>(smem);
  const int chunk_elems = 2 * p.rows * D;
  const int ring_bytes =
      nw * STAGES * chunk_elems * static_cast<int>(sizeof(T));
  const int combine_bytes = (2 * p.splits + 1) * GC * 4;
  float* const wml = reinterpret_cast<float*>(
      smem + (ring_bytes > combine_bytes ? ring_bytes : combine_bytes));
  float* const wacc = wml + (nw + 1) * GC * 2;
  int* const flag = reinterpret_cast<int*>(wacc + nw * GC * D);
  int* const ids = flag + 4;

  // the lane's slices of the group's query rows, pre-scaled; loaded while
  // the length is on its way
  float q[GC][C4][4];
  const T* const qb = static_cast<const T*>(p.q) +
                      (static_cast<long long>(b) * p.H + h * G + g0) * D;
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int c = 0; c < C4; ++c) {
      const int d = 4 * (lane + 32 * c);
      if (g < gn && d < D) {
        load4(qb + g * D + d, q[g][c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) q[g][c][e] *= p.qscale;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) q[g][c][e] = 0.f;
      }
    }

  const int len = p.seq_lens[b];
  const bool uniform = !WINDOW && len <= 0;
  const int n_valid = WINDOW || uniform ? p.P * page : min(len, p.P * page);
  // the ring slot of the newest token (WINDOW only)
  int newest = 0;
  if constexpr (WINDOW) {
    newest = (len - 1) % n_valid;
    if (newest < 0) newest += n_valid;
  }
  // ranges 0 .. live - 1 hold rows; a CTA of a range wholly past the length
  // has nothing to do, and a sequence with one live range needs no combine
  const int span = p.pages_per_split * page;
  const int live = (n_valid + span - 1) / span;
  if (split >= live) return;                      // CTA-uniform
  const bool direct = live == 1;
  const int first_page = split * p.pages_per_split;
  const int r_begin = first_page * page;
  const int r_end = min(r_begin + span, n_valid);
  {
    // the table entries of the range up to the length's last page, once
    const int* const table = p.block_table + static_cast<long long>(b) * p.P;
    const int n_ids = (r_end - 1) / page - first_page + 1;
    for (int i = tid; i < n_ids; i += nthreads)
      ids[i] = table[first_page + i];
    __syncthreads();
  }

  // this lane's score of a batch: row r_me, head g_me; the running max and
  // sum of head g_me; the P.V accumulator of every head
  const int r_me = lane / GC, g_me = lane % GC;
  float m_me = -INFINITY, l_me = 0.f, acc[GC][C4][4];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int c = 0; c < C4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][c][e] = 0.f;

  {
    const T* const kpool = static_cast<const T*>(p.kpool);
    const T* const vpool = static_cast<const T*>(p.vpool);

    T* const my_ring = ring + static_cast<long long>(warp) * STAGES *
                                  chunk_elems;
    const int n_chunks = (r_end - r_begin + p.rows - 1) / p.rows;
    const int n_local =
        n_chunks > warp ? (n_chunks - warp + nw - 1) / nw : 0;
    const int row_vecs = D * static_cast<int>(sizeof(T)) / 16;
    const long long row_stride = static_cast<long long>(p.Hkv) * D;
    const long long page_stride = row_stride * page;
    constexpr int VEC = 16 / static_cast<int>(sizeof(T));    // a vector
    // the k-th chunk of this warp into ring stage `st`: each lane copies
    // its 16-byte vectors (K's, then V's, of a row) of every row
    auto load_chunk = [&](int k, int st) {
      const int t0 = r_begin + (warp + k * nw) * p.rows;
      const int n = min(p.rows, r_end - t0);
      T* const ks = my_ring + st * chunk_elems;
      const int pi0 = t0 / page, jp0 = t0 - pi0 * page;   // page, slot
      for (int v = lane; v < 2 * row_vecs; v += 32) {
        const bool is_v = v >= row_vecs;
        const int c = (is_v ? v - row_vecs : v) * VEC;
        const T* const src = (is_v ? vpool : kpool) + h * D + c;
        T* dst = ks + (is_v ? p.rows * D : 0) + c;
        int pi = pi0 - first_page, jp = jp0;
        long long base = ids[pi] * page_stride + jp * row_stride;
        for (int j = 0; j < n; ++j, dst += D) {
          if (jp == page) {                    // the next page of the range
            jp = 0;
            base = ids[++pi] * page_stride;
          }
          cp_async16(dst, src + base);
          base += row_stride;
          ++jp;
        }
      }
    };
    for (int k = 0; k < STAGES - 1; ++k) {
      if (k < n_local) load_chunk(k, k);
      cp_async_commit();
    }
    for (int k = 0; k < n_local; ++k) {
      const int nk = k + STAGES - 1;
      if (nk < n_local) load_chunk(nk, nk % STAGES);
      cp_async_commit();
      cp_async_wait<STAGES - 1>();
      __syncwarp();                    // every lane's copies of chunk k
      const T* const ks = my_ring + (k % STAGES) * chunk_elems;
      const T* const vs = ks + p.rows * D;
      const int t0 = r_begin + (warp + k * nw) * p.rows;
      const int n = min(p.rows, r_end - t0);
      for (int r0 = 0; r0 < n; r0 += BATCH) {
        // the lane's partial dot products, then five xor rounds that halve
        // the values a lane keeps (16 -> 8 -> 4 -> 2 -> 1) and sum the last
        float sc[32];
        if (!uniform) {
#pragma unroll
          for (int r = 0; r < BATCH; ++r) {
            float kv[C4][4];
#pragma unroll
            for (int c = 0; c < C4; ++c) {
              const int d = 4 * (lane + 32 * c);
              if (r0 + r < n && d < D) {           // r: warp-uniform
                load4(ks + (r0 + r) * D + d, kv[c]);
              } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) kv[c][e] = 0.f;
              }
            }
#pragma unroll
            for (int g = 0; g < GC; ++g) {
              float part = 0.f;
#pragma unroll
              for (int c = 0; c < C4; ++c)
#pragma unroll
                for (int e = 0; e < 4; ++e) part += q[g][c][e] * kv[c][e];
              sc[r * GC + g] = part;
            }
          }
          halve<16>(sc, lane);
          halve<8>(sc, lane);
          halve<4>(sc, lane);
          halve<2>(sc, lane);
          halve<1>(sc, lane);
        }
        // the online softmax of the lane's score (rows past n: -inf); the
        // batch's max and sum over its rows are xor rounds over the row
        // bits of the lane (without a window row r0 is valid, so the new
        // max is finite and exp2(-inf) is an exact 0)
        float s_me = r0 + r_me >= n ? -INFINITY : uniform ? 0.f : sc[0];
        if constexpr (WINDOW) {
          // ring distance of the lane's row from the newest token
          int dist = newest - (t0 + r0 + r_me);
          if (dist < 0) dist += n_valid;
          if (dist >= p.window) s_me = -INFINITY;
        }
        float mx = s_me;
#pragma unroll
        for (int o = GC; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
        const float m_new = fmaxf(m_me, mx);
        float corr = exp2f(m_me - m_new);
        float p_me = exp2f(s_me - m_new);
        if constexpr (WINDOW) {
          // no attended row yet (the head's max is -inf, the same on every
          // lane: the mask is a row's): nothing to rescale or add
          if (m_new == -INFINITY) {
            corr = 1.f;
            p_me = 0.f;
          }
        }
        float sum = p_me;
#pragma unroll
        for (int o = GC; o < 32; o <<= 1)
          sum += __shfl_xor_sync(FULL, sum, o);
        l_me = l_me * corr + sum;
        m_me = m_new;
        // every head's rescale, skipped while no max grew (warp-uniform)
        float cg[GC];
        bool grew = false;
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          cg[g] = __shfl_sync(FULL, corr, g);
          grew = grew || cg[g] != 1.f;
        }
        if (grew) {
#pragma unroll
          for (int g = 0; g < GC; ++g)
#pragma unroll
            for (int c = 0; c < C4; ++c)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[g][c][e] *= cg[g];
        }
#pragma unroll
        for (int r = 0; r < BATCH; ++r) {
          if (r0 + r >= n) break;                // warp-uniform
          float pr[GC];
#pragma unroll
          for (int g = 0; g < GC; ++g)
            pr[g] = __shfl_sync(FULL, p_me, r * GC + g);
#pragma unroll
          for (int c = 0; c < C4; ++c) {
            const int d = 4 * (lane + 32 * c);
            if (d >= D) continue;
            float vv[4];
            load4(vs + (r0 + r) * D + d, vv);
#pragma unroll
            for (int g = 0; g < GC; ++g)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[g][c][e] += pr[g] * vv[e];
          }
        }
      }
      __syncwarp();                    // chunk k read before its refill
    }
    cp_async_wait<0>();
  }

  // the warps' partials, merged through shared memory
  if (lane < gn) {                             // row 0's lane of head g
    wml[(warp * GC + g_me) * 2] = m_me;
    wml[(warp * GC + g_me) * 2 + 1] = l_me;
  }
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g >= gn) break;
#pragma unroll
    for (int c = 0; c < C4; ++c) {
      const int d = 4 * (lane + 32 * c);
      if (d < D)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wacc[(warp * GC + g) * D + d + e] = acc[g][c][e];
    }
  }
  __syncthreads();

  // each warp's weight exp2(m_w - max) per head (0 for a warp without
  // rows) and the sum of l, once; then every output element
  if (tid < gn) {
    float mx = -INFINITY;
    for (int w = 0; w < nw; ++w) mx = fmaxf(mx, wml[(w * GC + tid) * 2]);
    float lsum = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float mw = wml[(w * GC + tid) * 2];
      const float f = mw == -INFINITY ? 0.f : exp2f(mw - mx);
      lsum += f * wml[(w * GC + tid) * 2 + 1];
      wml[(w * GC + tid) * 2 + 1] = f;
    }
    wml[(nw * GC + tid) * 2] = mx;
    wml[(nw * GC + tid) * 2 + 1] = lsum;
  }
  __syncthreads();
  T* const ob = static_cast<T*>(p.out) +
                (static_cast<long long>(b) * p.H + h * G + g0) * D;
  const long long first = static_cast<long long>(slot) * p.splits * p.gc;
  for (int i = tid; i < gn * D; i += nthreads) {
    const int g = i / D, d = i - g * D;
    float a = 0.f;
    for (int w = 0; w < nw; ++w)
      a += wml[(w * GC + g) * 2 + 1] * wacc[(w * GC + g) * D + d];
    const float mx = wml[(nw * GC + g) * 2];
    const float lsum = wml[(nw * GC + g) * 2 + 1];
    if (direct) {
      store(ob + g * D + d, a / lsum);
    } else {
      float* const pr = p.part + (first + split * p.gc + g) * (D + 2);
      pr[d] = a;
      if (d == 0) {
        pr[D] = mx;
        pr[D + 1] = lsum;
      }
    }
  }
  if (direct) return;

  // the ticket: the CTA that takes the last of the live ranges' tickets of
  // this (sequence, KV head, group) combines.  The barrier orders every
  // thread's partial before thread 0's release, its acquire orders every
  // other range's partial before the barrier after it.
  __syncthreads();
  if (tid == 0) *flag = atomic_add_acq_rel(p.counters + slot, 1) == live - 1;
  __syncthreads();
  if (!*flag) return;
  // every live partial's m and l into shared memory (the rings are free
  // now), all loads in flight at once; each head's max, the partials'
  // weights exp2(m - max) and the sum of l, once; then every output
  // element, its loads over the ranges in flight together
  float* const cw = reinterpret_cast<float*>(smem);      // [live][GC]
  float* const cl = cw + live * GC;                      // [live][GC]
  float* const cL = cl + live * GC;                      // [GC]
  for (int i = tid; i < live * gn; i += nthreads) {
    const int sp = i / gn, g = i - sp * gn;
    const float* const pr = p.part + (first + sp * p.gc + g) * (D + 2);
    cw[sp * GC + g] = __ldcg(pr + D);
    cl[sp * GC + g] = __ldcg(pr + D + 1);
  }
  __syncthreads();
  if (tid < gn) {
    float mx = -INFINITY;
    for (int sp = 0; sp < live; ++sp) mx = fmaxf(mx, cw[sp * GC + tid]);
    float lsum = 0.f;
    for (int sp = 0; sp < live; ++sp) {
      const float w = exp2f(cw[sp * GC + tid] - mx);
      cw[sp * GC + tid] = w;
      lsum += w * cl[sp * GC + tid];
    }
    cL[tid] = lsum;
  }
  __syncthreads();
  const long long stride = static_cast<long long>(p.gc) * (D + 2);
  // gn * D <= GC * 128 * C4 elements: at most GC * C4 a thread of 128
  constexpr int EPT = GC * C4;
  float a[EPT];
  int gi[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    a[k] = 0.f;
    gi[k] = (tid + k * nthreads) / D;
  }
  const float* const pr0 = p.part + first * (D + 2);
  for (int sp = 0; sp < live; ++sp) {
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const int i = tid + k * nthreads;
      if (i < gn * D) {
        const int g = gi[k], d = i - g * D;
        a[k] += cw[sp * GC + g] * __ldcg(pr0 + sp * stride + g * (D + 2) + d);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int i = tid + k * nthreads;
    if (i < gn * D) store(ob + i, a[k] / cL[gi[k]]);
  }
  if (tid == 0) p.counters[slot] = 0;           // ready for the next call
}

// Shared memory of one CTA: the rings (which the combine reuses for the
// partials' weights), the warps' partials, the flag and the range's page
// ids.
size_t smem_bytes(const Params& p, int gc_max, size_t esize) {
  const size_t ring =
      static_cast<size_t>(p.warps) * STAGES * 2 * p.rows * p.D * esize;
  const size_t combine =
      (2 * static_cast<size_t>(p.splits) + 1) * gc_max * sizeof(float);
  return (ring > combine ? ring : combine) +
         static_cast<size_t>(gc_max) *
             ((p.warps + 1) * 2 + static_cast<size_t>(p.warps) * p.D) *
             sizeof(float) +
         16 + static_cast<size_t>(p.pages_per_split) * sizeof(int);
}

template <typename T, int C4, int GC, bool WINDOW>
int launch(const Params& p, int B, void* stream) {
  auto kernel = paged_attention_kernel<T, C4, GC, WINDOW>;
  const size_t smem = smem_bytes(p, GC, sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * p.Hkv * p.groups, p.splits);
#ifdef __CUDACC__
  kernel<<<grid, 32 * p.warps, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
#else  // g++ under the CPU emulation of tests/cuda_shim
  cuda_shim::launch(kernel, grid, 32 * p.warps, smem, p);
#endif
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C4, bool WINDOW>
int dispatch_gc(const Params& p, int B, void* stream) {
  if (p.gc <= 1) return launch<T, C4, 1, WINDOW>(p, B, stream);
  if (p.gc <= 2) return launch<T, C4, 2, WINDOW>(p, B, stream);
  if (p.gc <= 4) return launch<T, C4, 4, WINDOW>(p, B, stream);
  if constexpr (C4 <= 2)
    if (p.gc <= 8) return launch<T, C4, 8, WINDOW>(p, B, stream);
  if constexpr (C4 == 1)
    if (p.gc <= 16) return launch<T, C4, 16, WINDOW>(p, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool WINDOW>
int dispatch(const Params& p, int B, void* stream) {
  if (p.D <= 128) return dispatch_gc<T, 1, WINDOW>(p, B, stream);
  if (p.D <= 256) return dispatch_gc<T, 2, WINDOW>(p, B, stream);
  if (p.D <= 512) return dispatch_gc<T, 4, WINDOW>(p, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Both entries: the checks, the Params, the dtype's instantiation.
template <bool WINDOW>
int launch_entry(const void* q, const void* kpool, const void* vpool,
                 const int* block_table, const int* seq_lens, void* out,
                 void* part, void* counters, int B, int H, int Hkv, int D,
                 int page, int P, int dtype, int gc, int splits,
                 int pages_per_split, int rows, int warps, int window,
                 void* stream) {
  const int G = Hkv > 0 ? H / Hkv : 0;
  if (B < 1 || G < 1 || gc < 1 || splits < 1 || rows < 1 ||
      (warps != 4 && warps != MAX_WARPS) ||
      pages_per_split < 1 || (splits - 1) * pages_per_split >= P ||
      splits * pages_per_split < P || (WINDOW && window < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.kpool = kpool;
  p.vpool = vpool;
  p.block_table = block_table;
  p.seq_lens = seq_lens;
  p.out = out;
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.H = H;
  p.Hkv = Hkv;
  p.D = D;
  p.page = page;
  p.P = P;
  p.gc = gc;
  p.groups = (G + gc - 1) / gc;
  p.splits = splits;
  p.pages_per_split = pages_per_split;
  p.rows = rows;
  p.warps = warps;
  p.qscale = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  p.window = window;
  if (dtype == 0) return dispatch<float, WINDOW>(p, B, stream);
  if (dtype == 1) return dispatch<__nv_bfloat16, WINDOW>(p, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and out alike).  gc,
// splits, pages_per_split, rows and warps are the wrapper's plan
// (paged_attention.py::plan); part and counters its workspace (unused
// with one split).  Returns the CUDA error of the launch (0 = launched).
int paged_attention_launch(const void* q, const void* kpool,
                           const void* vpool, const int* block_table,
                           const int* seq_lens, void* out, void* part,
                           void* counters, int B, int H, int Hkv, int D,
                           int page, int P, int dtype, int gc, int splits,
                           int pages_per_split, int rows, int warps,
                           void* stream) {
  return launch_entry<false>(q, kpool, vpool, block_table, seq_lens, out,
                             part, counters, B, H, Hkv, D, page, P, dtype,
                             gc, splits, pages_per_split, rows, warps, 0,
                             stream);
}

// The same under a sliding window of `window` >= 1 tokens: seq_lens counts
// each row's tokens, the new one included, and the table is its ring.
int paged_attention_window_launch(const void* q, const void* kpool,
                                  const void* vpool, const int* block_table,
                                  const int* seq_lens, void* out, void* part,
                                  void* counters, int B, int H, int Hkv,
                                  int D, int page, int P, int dtype, int gc,
                                  int splits, int pages_per_split, int rows,
                                  int warps, int window, void* stream) {
  return launch_entry<true>(q, kpool, vpool, block_table, seq_lens, out,
                            part, counters, B, H, Hkv, D, page, P, dtype, gc,
                            splits, pages_per_split, rows, warps, window,
                            stream);
}

}  // extern "C"
