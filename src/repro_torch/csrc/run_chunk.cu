// The FASE target's chunk loop as one persistent kernel for NVIDIA Hopper
// (sm_90a), plain C interface.
//
// Replaces, on a CUDA target, two pieces of the reference at once:
//   * the XLA loop of src/repro/core/target/cpu.py:1089-1169
//     (_run_chunk_fast: lax.while_loop over issue_width substeps of
//     _exec_substep), which PyTorch has no device-side form of, and
//   * the TPU kernel walk_fetch_block
//     (src/repro/kernels/page_walk/page_walk.py:126), which becomes the
//     device functions of page_walk.cuh called from inside this loop.
// What it computes is, bit for bit, the eager loop
// repro_torch/core/target/cpu.py::_run_chunk_eager (its plain version):
// every CpuState field, the four model counters and the substep count.
//
// Design.  One CTA runs the whole chunk; thread l is core l.  A board of at
// most 32 cores is one warp (chunk_body<TRACE, false>): every cross-lane
// step of a substep -- the same-tick conflict test, the prefix of safe
// lanes, any/argmax, the u64 minimum of the stall gaps and the loop
// predicate -- is a ballot or a shuffle, with no block barrier and no host
// round trip.  A board of 33 to LANES_MAX = 1024 cores (one CTA's threads)
// is ceil(n / 32) warps (chunk_body<TRACE, true>): each of those steps
// becomes CTA-wide -- a warp's ballot goes to a shared word of its own,
// __syncthreads stands where __syncwarp stood, the lowest lane is taken
// across the words, the store words that the conflict test compares are
// read from shared memory, and the minimum and maximum go through shared
// memory -- with the same rule: the lowest conflicting lane still bounds
// the prefix, so the commit order stays the eager loop's.  The shared
// memory a board needs (its register files, TLB and fetch slots) must fit
// one CTA's 227 KB.  Architectural state lives in registers
// (the register file in shared memory, indexed by rs1/rs2/rd) and is
// loaded once and written back once per launch.  The fetch-block cache and
// the data TLB are rebuilt empty in shared memory at every launch: the
// chunk-local invalidation of the eager loop (interface.py sfence), with no
// protocol.  The memory image stays in device memory and is read and
// written in place.  Each substep has the eager loop's two phases: every
// lane executes from pre-substep state (reads only), then, after a
// __syncwarp, the conflict-free prefix commits its stores; the next
// substep's reads come after a further __syncwarp, which orders the stores
// before them.  Loads of the image go through the coherent path (see
// page_walk.cuh).
//
// A board past one CTA (more than cta_lanes cores, the launch's argument:
// by default the most whole warps whose shared memory fits 227 KB, 384 at
// 8 TLB ways and 16-word blocks) runs on a thread-block cluster of
// ceil(n / cta_lanes) CTAs of cta_lanes threads (chunk_body<TRACE, true,
// true>): core l is thread l % cta_lanes of cluster rank l / cta_lanes, and
// each CTA keeps its own cores' register files, TLB and fetch slots in its
// own shared memory.  Each CTA-wide step gains a second level: the CTA's
// summary of a site (any, lowest lane, u64 minimum, maximum) is written by
// thread r into a slot of rank r through distributed shared memory, and
// after one cluster barrier every thread reads the ranks' slots locally.
// The conflict test and the kills read the committing lanes' ballot words
// and store words from the rank that owns them.  Every barrier of the
// board is then barrier.cluster.arrive.release / wait.acquire: the CTAs
// sit on different SMs with their own L1s, and a lane's commit to the
// image reaches another CTA's next read only through that pair.  The
// lowest conflicting lane across the cluster still bounds the prefix, so
// the commit order stays the eager loop's.  A cluster holds at most
// CLUSTER_MAX = 16 CTAs (8 on every card, 16 where the card schedules a
// non-portable cluster of that size: run_chunk_max_cluster asks it).
//
// The fleet.  run_chunk_fleet_launch runs one global chunk of D boards
// (src/repro/core/target/cpu.py:1180-1255, run_chunk_fleet; its plain
// version is repro_torch/core/target/cpu.py::_run_chunk_fleet_eager): a
// grid of D CTAs, CTA d running board d through the same device body
// (chunk_body) with its pointers offset to the board's slice of the stacked
// state and its limit read from budgets[d].  Boards are shared-nothing in
// the reference's flat loop (every cross-lane relation there is masked to
// one board), and a board whose loop predicate is false stays unchanged
// while the others run -- no candidate lane, no skip, no clock or counter
// movement -- so a CTA that stops at its own predicate, tested every
// issue_width substeps as the flat loop tests it, leaves its board as the
// flat loop does.  A CTA whose budget is 0 returns before it reads or writes
// any state: the board is untouched, bit for bit.  A board of more than 32
// cores runs on the CTA-wide instantiation, as in run_chunk, and a board
// past cta_lanes on a cluster: the grid is then D clusters, cluster d board
// d, and every rank of a board of budget 0 returns before its first
// cluster barrier.
//
// The commit-trace ring (src/repro/core/target/cpu.py:1021-1060, the
// `if trace_on:` block of _exec_substep).  chunk_body is a template on
// TRACE and run_chunk_kernel is instantiated twice: the untraced one is the
// kernel above, the traced one also keeps each lane's trace_n and arm bit
// in registers and, at the retire point, has every retiring lane whose
// capture gate is open store one (tick, pc, inst, priv) record -- the clock
// the substep started from, the retiring pc and word -- to row
// trace_n % slots of its own ring.  Lanes write disjoint rows, so no
// cross-lane step is needed, and the store is off the dependent chain.  The
// gate's kind is a launch-uniform value tested only under TRACE (the
// reference makes it a static argument).  The fleet entry is untraced: the
// reference's ring is single-device.
//
// What bounds it: neither bytes nor operations but the chain of dependent
// global-memory round trips in a substep -- an instruction fetch that
// misses the block cache (up to three PTE loads, then the slots), a data
// access that misses the TLB (up to three PTE loads), then the data word
// itself, then the commit.  A substep that hits both caches costs one
// dependent load (the data word of a load/store/AMO) plus a few hundred
// instructions of decode, conflict test and bookkeeping.  The kernel counts
// the longest such chain of each substep (out[1]); chip_smoke.py sets the
// sum against a one-thread pointer chase over the image.

#include <cuda_runtime.h>

#include "page_walk.cuh"

namespace {

constexpr int LANES_MAX = 1024;      // one CTA's threads
constexpr int WARP_LANES = 32;       // above this, the CTA-wide steps
constexpr int CLUSTER_PORTABLE = 8;  // CTAs a cluster on every sm_90 card
constexpr int CLUSTER_MAX = 16;      // with the non-portable size allowed
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory of one CTA
constexpr unsigned NO_LANE = 0xffffffffu;  // a cluster site: no lane holds
constexpr unsigned FULL = 0xffffffffu;
constexpr u64 RES_INVALID = ~0ull;
constexpr u64 M32 = 0xFFFFFFFFull;

// major opcodes and the few encodings the interpreter names
constexpr u64 OP_LOAD = 0x03, OP_MISC_MEM = 0x0F, OP_IMM = 0x13,
              OP_AUIPC = 0x17, OP_IMM_32 = 0x1B, OP_STORE = 0x23,
              OP_AMO = 0x2F, OP_OP = 0x33, OP_LUI = 0x37, OP_OP_32 = 0x3B,
              OP_BRANCH = 0x63, OP_JALR = 0x67, OP_JAL = 0x6F,
              OP_SYSTEM = 0x73;
constexpr u64 INST_ECALL = 0x00000073ull, INST_EBREAK = 0x00100073ull;
constexpr u64 AMO_ADD = 0x00, AMO_SWAP = 0x01, AMO_LR = 0x02, AMO_SC = 0x03,
              AMO_XOR = 0x04, AMO_OR = 0x08, AMO_AND = 0x0C, AMO_MIN = 0x10,
              AMO_MAX = 0x14, AMO_MINU = 0x18;

struct Params {
  u64* mem;               // (W,) the image, read and written in place
  u64* regs;              // (nc, 32)
  u64* pc;
  int* priv;              // 0 user, 3 parked (read only here)
  unsigned char* pending;
  const u64* stall_until;
  const u64* satp;
  u64* mcause;
  u64* mepc;
  u64* mtval;
  u64* res;
  u64* ticks;             // () the global clock
  u64* uticks;
  u64* instret;
  u64* stall_ticks;
  u64* fetch_hits;
  u64* fetch_walks;
  u64* tlb_walks;
  long long* out;         // (2,) out: substeps issued, dependent round
                          // trips to global memory on the critical path
  u64* tracebuf;          // (nc, slots, 4) the commit-trace ring (TRACE)
  u64* trace_n;           // (nc,) records ever captured
  unsigned char* trace_armed;  // (nc,) sticky arm bit of pc/inst triggers
  long long slots;        // ring rows a core
  int trig_kind;          // TRIG_* below
  int trig_disarm;        // pc/inst: the window has a disarm value
  u64 trig_a;             // tick t0 / instret n / arm value
  u64 trig_b;             // tick t1 / disarm value
  u64 mask;               // mem_bytes - 1
  long long limit;        // max_cycles
  int nc;
  int issue_width;
  int block_words;        // power of two
  int block_cache;
  int ways;               // data-TLB ways per lane (power of two or 0)
};

// the capture-window kinds of repro_torch.telemetry.triggers
constexpr int TRIG_NONE = 0, TRIG_TICK = 1, TRIG_INSTRET = 2, TRIG_PC = 3,
              TRIG_INST = 4;

// one commit record: the retiring lane writes it with two 16-byte stores
struct alignas(32) TraceRec {
  u64 tick, pc, inst, priv;
};

__device__ __forceinline__ u64 sx(u64 v, int bits) {
  const u64 m = 1ull << (bits - 1);
  return (v ^ m) - m;
}

__device__ __forceinline__ u64 sra(u64 v, int sh) {
  return (u64)((long long)v >> sh);
}

__device__ __forceinline__ bool slt(u64 a, u64 b) {
  return (long long)a < (long long)b;
}

__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }

// RISC-V signed division: x / 0 = (-1, x), int_min / -1 = (int_min, 0).
// The W forms pass operands already sign-extended from 32 bits.
__device__ __forceinline__ void sdiv(u64 a, u64 b, u64 int_min, u64& q,
                                     u64& r) {
  if (b == 0) {
    q = ~0ull;
    r = a;
  } else if (a == int_min && b == ~0ull) {
    q = a;
    r = 0;
  } else {
    q = (u64)((long long)a / (long long)b);
    r = (u64)((long long)a % (long long)b);
  }
}

// _alu64 of the eager interpreter (cpu.py:134-152)
__device__ __forceinline__ u64 alu64(u64 f3, bool is_sub, bool is_sra,
                                     bool is_m, u64 a, u64 b) {
  if (is_m) {
    const u64 hu = __umul64hi(a, b);
    const u64 hsu = hu - (slt(a, 0) ? b : 0);
    u64 q, r;
    switch (f3) {
      case 0: return a * b;
      case 1: return hsu - (slt(b, 0) ? a : 0);        // mulh
      case 2: return hsu;
      case 3: return hu;
      case 4: sdiv(a, b, 1ull << 63, q, r); return q;
      case 5: return b == 0 ? ~0ull : a / b;
      case 6: sdiv(a, b, 1ull << 63, q, r); return r;
      default: return b == 0 ? a : a % b;
    }
  }
  const int sh = (int)(b & 63);
  switch (f3) {
    case 0: return is_sub ? a - b : a + b;
    case 1: return a << sh;
    case 2: return slt(a, b) ? 1 : 0;
    case 3: return a < b ? 1 : 0;
    case 4: return a ^ b;
    case 5: return is_sra ? sra(a, sh) : a >> sh;
    case 6: return a | b;
    default: return a & b;
  }
}

// _alu32 of the eager interpreter (cpu.py:155-173), sign-extended result
__device__ __forceinline__ u64 alu32(u64 f3, bool is_sub, bool is_sra,
                                     bool is_m, u64 a, u64 b) {
  const u64 a32 = a & M32, b32 = b & M32;
  const u64 sa = sx(a32, 32), sb = sx(b32, 32);
  u64 v;
  if (is_m) {
    const u64 ur = b32 == 0 ? a32 : a32 % b32;
    u64 q, r;
    switch (f3) {
      case 0: v = a32 * b32; break;
      case 4: sdiv(sa, sb, sx(1ull << 31, 32), q, r); v = q; break;
      case 5: v = b32 == 0 ? ~0ull : a32 / b32; break;
      case 6: sdiv(sa, sb, sx(1ull << 31, 32), q, r); v = r; break;
      // f3 1..3 are not W-form M ops; the reference's select leaves the
      // unsigned remainder there
      default: v = ur; break;
    }
  } else {
    const int sh = (int)(b & 31);
    if (f3 == 0)
      v = is_sub ? a - b : a + b;
    else if (f3 == 1)
      v = a32 << sh;
    else
      v = is_sra ? sra(sa, sh) : a32 >> sh;
  }
  return sx(v & M32, 32);
}

// ---- the cluster of a board past one CTA -----------------------------------
#if defined(__CUDA_ARCH__)
__device__ __forceinline__ int cl_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cl_ranks() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return (int)r;
}
// every thread of the cluster; release / acquire order each CTA's global
// and shared stores before any other CTA's accesses after the barrier
__device__ __forceinline__ void cl_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n\t"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}
// `p`, an address in this CTA's shared memory, in rank `r`'s
template <typename T>
__device__ __forceinline__ T* cl_map(T* p, int r) {
  unsigned long long a;
  asm volatile("mapa.u64 %0, %1, %2;" : "=l"(a) : "l"(p), "r"(r));
  return (T*)a;
}
#elif !defined(__CUDACC__)  // g++ under the CPU emulation of tests/cuda_shim
inline int cl_rank() { return (int)cuda_shim::cluster_rank(); }
inline int cl_ranks() { return (int)cuda_shim::cluster_ranks(); }
inline void cl_sync() { cuda_shim::cluster_sync(); }
template <typename T>
inline T* cl_map(T* p, int r) {
  return cuda_shim::map_shared_rank(p, (unsigned)r);
}
#else  // nvcc's host pass: declarations only
__device__ int cl_rank();
__device__ int cl_ranks();
__device__ void cl_sync();
template <typename T>
__device__ T* cl_map(T* p, int r);
#endif

// rank `r`'s copy of the shared array `p`: through distributed shared
// memory on a cluster, `p` itself on one CTA (a cluster of one rank)
template <bool CLUSTER, typename T>
__device__ __forceinline__ T* at_rank(T* p, int r) {
  if constexpr (CLUSTER)
    return cl_map(p, r);
  else
    return p;
}

__device__ __forceinline__ u64 warp_umin(u64 v) {
  for (int o = 16; o > 0; o >>= 1) v = umin(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// ---- the CTA-wide steps of a board of more than 32 cores -------------------
// The shared scratch after the fetch slots: one word a warp for each ballot
// site, one u64 a warp for each of the two reductions, and each thread's
// store word (what the conflict test and the kills compare).  A site is used
// once a substep; the substep's closing __syncthreads separates its reads
// from the next substep's writes.  On a cluster the scratch also holds each
// rank's summary of the two reductions and of each site (one slot a rank,
// written by that rank), and the barriers between a site's uses are the
// cluster's.
enum Site { S_GO, S_GATE, S_ACTIVE, S_COMMITS0, S_CONFS, S_COMMITS, S_DEFS,
            S_CAND, S_RUNNABLE, SITES };

struct Cross {
  unsigned* words;   // [SITES][32]
  u64* red;          // [2][32]: the minimum's, then the maximum's
  u64* stw;          // [threads]
  int warps;
  u64* cred;         // cluster: [2][CLUSTER_MAX], each rank's reductions
  unsigned* cw;      // cluster: [SITES][CLUSTER_MAX], each rank's summaries
  int rank;          // cluster: this CTA's rank, the ranks, its first lane
  int ranks;
  int base;
};

__host__ __device__ constexpr size_t align8(size_t b) {
  return (b + 7) & ~size_t(7);
}

__host__ __device__ constexpr size_t cross_bytes(int threads) {
  return (size_t)SITES * 32 * 4 + 2 * 32 * 8 + (size_t)threads * 8;
}

__host__ __device__ constexpr size_t cluster_slot_bytes() {
  return (size_t)2 * CLUSTER_MAX * 8 + (size_t)SITES * CLUSTER_MAX * 4;
}

// Cluster: this CTA's summary `v` of site `s` goes to slot [s][rank] of
// every rank (thread r writes rank r's); after the cluster barrier the
// ranks' slots of the site, read locally.  The barriers of the substep
// separate a slot's reads from its next write.
__device__ __forceinline__ const unsigned* cl_gather(const Cross& x, int s,
                                                     unsigned v) {
  if ((int)threadIdx.x < x.ranks)
    cl_map(x.cw, (int)threadIdx.x)[s * CLUSTER_MAX + x.rank] = v;
  cl_sync();
  return x.cw + s * CLUSTER_MAX;
}

__device__ __forceinline__ const u64* cl_gather64(const Cross& x, int s,
                                                  u64 v) {
  if ((int)threadIdx.x < x.ranks)
    cl_map(x.cred, (int)threadIdx.x)[s * CLUSTER_MAX + x.rank] = v;
  cl_sync();
  return x.cred + s * CLUSTER_MAX;
}

// this warp's ballot of `pred` into site `s`, after the CTA has written its
// words; returns the site's words
__device__ __forceinline__ const unsigned* cta_ballot(const Cross& x, int s,
                                                      bool pred) {
  const unsigned m = __ballot_sync(FULL, pred);
  unsigned* w = x.words + s * 32;
  if ((threadIdx.x & 31) == 0) w[threadIdx.x >> 5] = m;
  __syncthreads();
  return w;
}

template <bool CLUSTER>
__device__ __forceinline__ bool cta_any(const Cross& x, int s, bool pred) {
  const unsigned* w = cta_ballot(x, s, pred);
  unsigned a = 0;
  for (int i = 0; i < x.warps; ++i) a |= w[i];
  if constexpr (CLUSTER) {
    const unsigned* c = cl_gather(x, s, a);
    for (int r = 0; r < x.ranks; ++r) a |= c[r];
  }
  return a != 0;
}

// the lowest lane whose `pred` holds, or `none`
template <bool CLUSTER>
__device__ __forceinline__ int cta_lowest(const Cross& x, int s, bool pred,
                                          int none) {
  const unsigned* w = cta_ballot(x, s, pred);
  if constexpr (CLUSTER) {
    unsigned low = NO_LANE;
    for (int i = 0; i < x.warps; ++i)
      if (w[i]) {
        low = (unsigned)(x.base + i * 32 + __ffs(w[i]) - 1);
        break;
      }
    const unsigned* c = cl_gather(x, s, low);
    for (int r = 0; r < x.ranks; ++r) low = c[r] < low ? c[r] : low;
    return low == NO_LANE ? none : (int)low;
  } else {
    for (int i = 0; i < x.warps; ++i)
      if (w[i]) return i * 32 + __ffs(w[i]) - 1;
    return none;
  }
}

template <bool CLUSTER>
__device__ __forceinline__ u64 cta_umin(const Cross& x, u64 v) {
  v = warp_umin(v);
  if ((threadIdx.x & 31) == 0) x.red[threadIdx.x >> 5] = v;
  __syncthreads();
  u64 r = ~0ull;
  for (int i = 0; i < x.warps; ++i) r = umin(r, x.red[i]);
  if constexpr (CLUSTER) {
    const u64* c = cl_gather64(x, 0, r);
    for (int k = 0; k < x.ranks; ++k) r = umin(r, c[k]);
  }
  return r;
}

template <bool CLUSTER>
__device__ __forceinline__ unsigned cta_max(const Cross& x, unsigned v) {
  v = __reduce_max_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) x.red[32 + (threadIdx.x >> 5)] = v;
  __syncthreads();
  unsigned r = 0;
  for (int i = 0; i < x.warps; ++i) r = max(r, (unsigned)x.red[32 + i]);
  if constexpr (CLUSTER) {
    const u64* c = cl_gather64(x, 1, r);
    for (int k = 0; k < x.ranks; ++k) r = max(r, (unsigned)c[k]);
  }
  return r;
}

// any lane's `pred`: a ballot of the warp, or across the CTA (or cluster)
// at site `s`
template <bool MULTI, bool CLUSTER>
__device__ __forceinline__ bool team_any(const Cross& x, int s, bool pred) {
  if constexpr (MULTI) return cta_any<CLUSTER>(x, s, pred);
  else return __ballot_sync(FULL, pred) != 0;
}

// orders every lane's memory accesses before the next step's
template <bool MULTI, bool CLUSTER>
__device__ __forceinline__ void team_sync() {
  if constexpr (CLUSTER) cl_sync();
  else if constexpr (MULTI) __syncthreads();
  else __syncwarp();
}

// The chunk loop of one target (one board of a fleet), run by the calling
// CTA: one warp, or with MULTI ceil(nc / 32) warps, or with CLUSTER (and
// MULTI) the CTAs of the calling cluster; with TRACE it records the
// commit-trace ring.
template <bool TRACE, bool MULTI, bool CLUSTER>
__device__ __forceinline__ void chunk_body(const Params& p) {
#ifdef __CUDACC__
  extern __shared__ __align__(16) unsigned char smem[];
#else  // each emulated CTA of a cluster has its own (tests/cuda_shim)
  unsigned char* const smem = cuda_shim::cta_smem();
#endif
  static_assert(MULTI || !CLUSTER, "a cluster runs the CTA-wide steps");
  // `tid` indexes the CTA's shared memory, `lane` the board's cores: on a
  // cluster, rank r holds lanes r * blockDim.x to (r + 1) * blockDim.x - 1
  const int tid = threadIdx.x;
  Cross x{};
  if constexpr (CLUSTER) {
    x.rank = cl_rank();
    x.ranks = cl_ranks();
    x.base = x.rank * (int)blockDim.x;
  }
  const int lane = CLUSTER ? x.base + tid : tid;
  const int wl = MULTI ? (tid & 31) : tid;       // lane within its warp
  const int wbase = MULTI ? tid - wl : 0;        // its warp's first thread
  const int nc = p.nc;
  const int nl = CLUSTER ? (int)blockDim.x : nc; // cores in shared memory
  const bool on = lane < nc;
  const u64 mask = p.mask;
  const int bw = p.block_words;
  const int ways = p.ways;
  u64* const mem = p.mem;

  // shared memory: the register file, the data TLB (tag, ppn, perms and
  // backing PTE word per way), then the fetch blocks' slots
  u64* const regs_sh = (u64*)smem;
  u64* const tlb_vpn = regs_sh + nl * 32;
  u64* const tlb_ppn = tlb_vpn + nl * ways;
  u64* const tlb_perm = tlb_ppn + nl * ways;
  u64* const tlb_ptw = tlb_perm + nl * ways;
  unsigned* const slots_sh = (unsigned*)(tlb_ptw + nl * ways);
  u64* const R = regs_sh + tid * 32;
  u64* const TV = tlb_vpn + tid * ways;
  u64* const TP = tlb_ppn + tid * ways;
  u64* const TM = tlb_perm + tid * ways;
  u64* const TW = tlb_ptw + tid * ways;
  if constexpr (MULTI) {
    unsigned char* const c = smem + align8((unsigned char*)(slots_sh +
                                                   nl * bw) - smem);
    x.words = (unsigned*)c;
    x.red = (u64*)(c + SITES * 32 * 4);
    x.stw = x.red + 2 * 32;
    x.warps = (int)(blockDim.x >> 5);
    if constexpr (CLUSTER) {
      x.cred = x.stw + blockDim.x;
      x.cw = (unsigned*)(x.cred + 2 * CLUSTER_MAX);
    }
  }

  // ---- state in: once per launch ------------------------------------------
  u64 pc = 0, stall = 0, satp = 0, mcause = 0, mepc = 0, mtval = 0;
  u64 res = RES_INVALID, uticks = 0, instret = 0;
  u64 c_stall = 0, c_hits = 0, c_walks = 0, c_tlb = 0;
  int priv = 3;
  bool pending = false;
  u64 fb_vbase = 0, fb_pbase = 0, fb_nbytes = 0;   // this lane's block
  u64 t_n = 0;                                     // TRACE: trace_n
  bool t_armed = false;                            // TRACE: trace_armed
  if (on) {
    for (int k = 0; k < 32; ++k) R[k] = p.regs[lane * 32 + k];
    for (int w = 0; w < ways; ++w) {
      TV[w] = pw::NO_WORD;
      TP[w] = TM[w] = TW[w] = 0;
    }
    pc = p.pc[lane];
    priv = p.priv[lane];
    pending = p.pending[lane] != 0;
    stall = p.stall_until[lane];
    satp = p.satp[lane];
    mcause = p.mcause[lane];
    mepc = p.mepc[lane];
    mtval = p.mtval[lane];
    res = p.res[lane];
    uticks = p.uticks[lane];
    instret = p.instret[lane];
    c_stall = p.stall_ticks[lane];
    c_hits = p.fetch_hits[lane];
    c_walks = p.fetch_walks[lane];
    c_tlb = p.tlb_walks[lane];
    if (TRACE) {
      t_n = p.trace_n[lane];
      t_armed = p.trace_armed[lane] != 0;
    }
  }
  u64 ticks = *p.ticks;
  const bool active = on && priv != 3;       // priv is not written here
  const bool any_active = team_any<MULTI, CLUSTER>(x, S_ACTIVE, active);
  team_sync<MULTI, CLUSTER>();

  long long cycles = 0;
  int exec_from = 0;
  long long substeps = 0;
  long long trips = 0;
  while (true) {
    // the loop predicate of cpu.py:631-632, tested every issue_width
    const bool go = (cycles < p.limit &&
                     !team_any<MULTI, CLUSTER>(x, S_GO, pending) &&
                     any_active) || exec_from > 0;
    if (!go) break;
    for (int it = 0; it < p.issue_width; ++it) {
      const bool gate = !team_any<MULTI, CLUSTER>(x, S_GATE, pending) &&
                        cycles < p.limit;
      const u64 budget_left = (u64)(p.limit - cycles);
      const bool cont = exec_from > 0;
      const bool runnable = active && !pending && ticks >= stall;
      const bool cand = (cont || gate) && runnable && lane >= exec_from;

      // ---- phase 1: execute from pre-substep state, reads only ----------
      // fetch: block-cache hit, or walk + fill on a miss
      u64 off = 0;
      bool hit = false;
      if (p.block_cache) {
        off = pc - fb_vbase;
        hit = cand && off < fb_nbytes && (off & 3) == 0;
      }
      const bool miss = cand && !hit;
      pw::Walk fw = pw::no_walk();
      u64 wnb = 0;
      unsigned inst = 0;
      if (miss) {
        fw = pw::sv39_walk(mem, satp, pc, pw::PTE_U | pw::PTE_X, mask);
        wnb = pw::fetch_nbytes(pc, fw.fault, bw);
        // slot 0 is gathered on a fault too, from pa 0 (the plain version)
        inst = pw::fetch_slot(mem, fw.pa, 0, mask);
      } else if (hit) {
        inst = slots_sh[tid * bw + ((off >> 2) & (u64)(bw - 1))];
      }
      const bool ifault = fw.fault;
      const u64 ipa = hit ? fb_pbase + off : fw.pa;
      if (p.block_cache) {
        // every missing lane that translated fills, deferred ones too; the
        // whole warp gathers each of its filling lanes' slots
        const bool fill = miss && !ifault;
        for (unsigned m = __ballot_sync(FULL, fill); m; m &= m - 1) {
          const int f = __ffs(m) - 1;
          const u64 fpa = __shfl_sync(FULL, fw.pa, f);
          for (int k = wl; k < bw; k += 32)
            slots_sh[(wbase + f) * bw + k] = pw::fetch_slot(mem, fpa, k, mask);
        }
        if (fill) {
          fb_vbase = pc;
          fb_pbase = fw.pa;
          fb_nbytes = wnb;
        }
      }

      // decode (inst is a u32, so >> is logical)
      const u64 in = inst;
      const u64 op = in & 0x7F;
      const u64 rd = (in >> 7) & 0x1F;
      const u64 f3 = (in >> 12) & 7;
      const u64 rs1 = (in >> 15) & 0x1F;
      const u64 rs2 = (in >> 20) & 0x1F;
      const u64 f7 = in >> 25;
      const u64 imm_i = sx(in >> 20, 12);
      const u64 imm_s = sx((f7 << 5) | rd, 12);
      const u64 imm_b = sx((((in >> 8) & 0xF) << 1) |
                           (((in >> 25) & 0x3F) << 5) |
                           (((in >> 7) & 1) << 11) | ((in >> 31) << 12), 13);
      const u64 imm_u = sx(in & 0xFFFFF000ull, 32);
      const u64 imm_j = sx((((in >> 21) & 0x3FF) << 1) |
                           (((in >> 20) & 1) << 11) |
                           (((in >> 12) & 0xFF) << 12) | ((in >> 31) << 20),
                           21);
      const u64 a = on ? R[rs1] : 0;
      const u64 b = on ? R[rs2] : 0;

      const bool is_load = op == OP_LOAD, is_fence = op == OP_MISC_MEM,
                 is_opimm = op == OP_IMM, is_auipc = op == OP_AUIPC,
                 is_opimm32 = op == OP_IMM_32, is_store = op == OP_STORE,
                 is_amo = op == OP_AMO, is_op = op == OP_OP,
                 is_lui = op == OP_LUI, is_op32 = op == OP_OP_32,
                 is_branch = op == OP_BRANCH, is_jalr = op == OP_JALR,
                 is_jal = op == OP_JAL, is_system = op == OP_SYSTEM;
      const bool is_ecall = is_system && in == INST_ECALL;
      const bool is_ebreak = is_system && in == INST_EBREAK;
      // SYSTEM is illegal unless ECALL/EBREAK
      const bool illegal =
          !(is_load || is_fence || is_opimm || is_auipc || is_opimm32 ||
            is_store || is_amo || is_op || is_lui || is_op32 || is_branch ||
            is_jalr || is_jal || is_ecall || is_ebreak);

      // ALU
      const bool reg_form = is_op || is_op32;
      const u64 bop = reg_form ? b : imm_i;
      const bool is_m = reg_form && f7 == 1;
      const bool f7_20 = f7 == 0x20;
      const bool is_sub = reg_form && f7_20 && f3 == 0;
      const bool is_sra =
          (reg_form ? f7_20 : ((in >> 30) & 1) != 0) && f3 == 5;

      // data access: translate through the TLB, or walk
      const u64 funct5 = f7 >> 2;
      const bool is_lr = is_amo && funct5 == AMO_LR;
      const bool is_sc = is_amo && funct5 == AMO_SC;
      const u64 dva = is_amo ? a : a + (is_store ? imm_s : imm_i);
      const bool is_memop = is_load || is_store || is_amo;
      const bool want_w = is_store || (is_amo && !is_lr);
      const u64 dneed = pw::PTE_U | (want_w ? pw::PTE_W : pw::PTE_R);
      pw::Walk dw = pw::no_walk();
      bool dwalk = false, dhit = false;
      u64 dpa = 0, vpn = 0;
      int way = 0;
      if (ways) {
        const bool bare = (satp >> 60) != 8;
        vpn = dva >> 12;
        way = (int)(vpn & (u64)(ways - 1));
        const bool xlate = cand && is_memop && !bare;
        dhit = xlate && TV[way] == vpn && (TM[way] & dneed) == dneed;
        dwalk = xlate && !dhit;
        if (dwalk) dw = pw::sv39_walk(mem, satp, dva, dneed, mask);
        dpa = dhit ? ((TP[way] << 12) | (dva & 0xFFF)) & mask
                   : bare ? dva & mask : dw.pa;
      } else {
        dwalk = cand && is_memop;
        if (dwalk) dw = pw::sv39_walk(mem, satp, dva, dneed, mask);
        dpa = dw.pa;
      }
      const bool dfault = dwalk && dw.fault;
      const u64 szb = is_amo ? (f3 == 2 ? 4 : 8) : 1ull << (f3 & 3);
      const bool misal = is_memop && (dva & (szb - 1)) != 0;
      const u64 stw = dpa >> 3;                 // dpa is masked
      const u64 dword = cand && is_memop ? mem[stw] : 0;
      const int dshift = (int)((dpa & 7) << 3);
      const u64 sizemask = szb == 8 ? ~0ull : (1ull << (szb << 3)) - 1;
      const u64 rawv = (dword >> dshift) & sizemask;
      const u64 sbit = 1ull << ((szb << 3) - 1);
      const u64 loaded = (f3 & 4) ? rawv : (rawv ^ sbit) - sbit;

      // AMO
      const bool amo_w = f3 == 2;
      const u64 amo_old = rawv;
      const u64 amo_b = b & sizemask;
      const u64 s_old = amo_w ? sx(amo_old, 32) : amo_old;
      const u64 s_b = amo_w ? sx(amo_b, 32) : amo_b;
      u64 amo_new;
      switch (funct5) {
        case AMO_SWAP: amo_new = amo_b; break;
        case AMO_ADD: amo_new = amo_old + amo_b; break;
        case AMO_XOR: amo_new = amo_old ^ amo_b; break;
        case AMO_AND: amo_new = amo_old & amo_b; break;
        case AMO_OR: amo_new = amo_old | amo_b; break;
        case AMO_MIN: amo_new = slt(s_old, s_b) ? amo_old : amo_b; break;
        case AMO_MAX: amo_new = slt(s_b, s_old) ? amo_old : amo_b; break;
        case AMO_MINU: amo_new = amo_old < amo_b ? amo_old : amo_b; break;
        // AMOMAXU, and any unlisted funct5: the reference select's default
        default: amo_new = amo_old > amo_b ? amo_old : amo_b; break;
      }
      const bool sc_ok = is_sc && res == dpa;
      const u64 amo_rdval = is_sc ? (sc_ok ? 0 : 1) : s_old;

      // traps, in the reference's priority order
      const bool dtrap = is_memop && (misal || dfault);
      const bool traps = ifault || illegal || is_ecall || is_ebreak || dtrap;
      const u64 cause = ifault ? 12
                        : illegal ? 2
                        : is_ecall ? 8
                        : is_ebreak ? 3
                        : misal ? ((is_load || is_lr) ? 4 : 6)
                        : (want_w ? 15 : 13);
      const u64 tval = ifault ? pc
                       : illegal ? in
                       : (is_ecall || is_ebreak) ? 0 : dva;
      const bool commit0 = cand && !traps &&
                           (is_store || (is_amo && !is_lr && (!is_sc || sc_ok)));

      // ---- same-tick conflicts: the applied prefix ------------------------
      // Lane j's read set: its instruction word, its data word, the fetch
      // walk's PTE words (miss only), the data walk's (walk only); an
      // earlier lane's commit into it, onto the word j also writes, or onto
      // j's reservation line defers j and every later lane.
      const u64 r_inst = cand ? sra(ipa, 3) : pw::NO_WORD;
      const u64 r_data = cand && is_memop ? stw : pw::NO_WORD;
      const u64 res_word =
          cand && res != RES_INVALID ? sra(res, 3) : pw::NO_WORD;
      bool conf = false;
      int first_conf;
      unsigned commits = 0;              // one warp: the committing lanes
      const unsigned* kwords = nullptr;  // MULTI: their words a warp
      // (the one-warp branches spell out their own expressions: sharing
      // lambdas with the CTA-wide ones cost the one-warp kernel 6
      // registers and 4 % of its time a substep on an H100)
      if constexpr (MULTI) {
        x.stw[tid] = stw;      // published by the ballot's barrier
        const unsigned* cw = cta_ballot(x, S_COMMITS0, commit0);
        if constexpr (CLUSTER)
          cl_sync();     // every rank's words and store words, cluster-wide
        const int me = CLUSTER ? x.rank : 0;
        if (cand)
          for (int r = 0; r <= me; ++r) {
            const unsigned* rw = at_rank<CLUSTER>(cw, r);
            const u64* rs = at_rank<CLUSTER>(x.stw, r);
            const int last = r < me ? x.warps - 1 : tid >> 5;
            for (int w = 0; w <= last; ++w)
              for (unsigned m = rw[w]; m; m &= m - 1) {
                const int il = w * 32 + __ffs(m) - 1;
                if (r == me && il >= tid) break;
                const u64 si = rs[il];
                conf = conf || si == r_inst || si == r_data ||
                       si == fw.words[0] || si == fw.words[1] ||
                       si == fw.words[2] || si == dw.words[0] ||
                       si == dw.words[1] || si == dw.words[2] ||
                       (commit0 && si == stw) || si == res_word;
              }
          }
        first_conf = cta_lowest<CLUSTER>(x, S_CONFS, conf,
                                         CLUSTER ? 1 << 30 : LANES_MAX);
      } else {
        const unsigned commits0 = __ballot_sync(FULL, commit0);
        for (unsigned m = commits0; m; m &= m - 1) {
          const int i = __ffs(m) - 1;
          const u64 si = __shfl_sync(FULL, stw, i);
          if (i < lane && cand)
            conf = conf || si == r_inst || si == r_data ||
                   si == fw.words[0] || si == fw.words[1] ||
                   si == fw.words[2] || si == dw.words[0] ||
                   si == dw.words[1] || si == dw.words[2] ||
                   (commit0 && si == stw) || si == res_word;
        }
        const unsigned confs = __ballot_sync(FULL, conf);
        first_conf = confs ? __ffs(confs) - 1 : WARP_LANES;
      }
      const bool safe = cand && lane < first_conf;
      const bool deferred = cand && !safe;
      const bool tr = safe && traps;
      const bool ret = safe && !traps;
      const bool commit = commit0 && safe;
      if constexpr (MULTI)
        kwords = cta_ballot(x, S_COMMITS, commit);
      else
        commits = __ballot_sync(FULL, commit);

      // ---- phase 2: the prefix commits -------------------------------------
      // (on a cluster this barrier also publishes the S_COMMITS words)
      team_sync<MULTI, CLUSTER>();
      if (commit) {
        const u64 sval = (is_store || is_sc) ? b : amo_new;
        const u64 wmask = sizemask << dshift;
        mem[stw] = (dword & ~wmask) | ((sval << dshift) & wmask);
      }

      // data-TLB fill: an applied walk lane that reached a 4 KiB leaf;
      // deferred lanes re-walk next substep and fill then
      if (ways && on && dwalk && safe && !dfault && dw.leaf0) {
        TV[way] = vpn;
        TP[way] = dw.pa >> 12;
        TM[way] = dw.perms;
        TW[way] = dw.leaf_widx;
      }

      // Then, for every applied commit: the reservation of any other lane
      // on that line is lost; a cached fetch block it lands in (one filled
      // this substep included) is killed; a TLB entry whose backing leaf
      // PTE it overwrites (one filled this substep included) is killed.
      const u64 own = (ret && is_lr) ? dpa : (ret && is_sc) ? RES_INVALID
                                                            : res;
      bool inv = false;
      bool kill = false;
      if constexpr (MULTI) {
        for (int r = 0; r < (CLUSTER ? x.ranks : 1); ++r) {
          const unsigned* rw = at_rank<CLUSTER>(kwords, r);
          const u64* rs = at_rank<CLUSTER>(x.stw, r);
          for (int w = 0; w < x.warps; ++w)
            for (unsigned m = rw[w]; m; m &= m - 1) {
              const int il = w * 32 + __ffs(m) - 1;
              const int i = CLUSTER ? r * (int)blockDim.x + il : il;
              const u64 si = rs[il];
              inv = inv || (i != lane && si == sra(own, 3));
              const long long sb = (long long)(si << 3);
              kill = kill || (sb + 8 > (long long)fb_pbase &&
                              sb < (long long)(fb_pbase + fb_nbytes));
              if (on)
                for (int w2 = 0; w2 < ways; ++w2)
                  if (TW[w2] == si) TV[w2] = pw::NO_WORD;
            }
        }
      } else {
        for (unsigned m = commits; m; m &= m - 1) {
          const int i = __ffs(m) - 1;
          const u64 si = __shfl_sync(FULL, stw, i);
          inv = inv || (i != lane && si == sra(own, 3));
          const long long sb = (long long)(si << 3);
          kill = kill || (sb + 8 > (long long)fb_pbase &&
                          sb < (long long)(fb_pbase + fb_nbytes));
          if (on)
            for (int w = 0; w < ways; ++w)
              if (TW[w] == si) TV[w] = pw::NO_WORD;
        }
      }
      res = inv ? RES_INVALID : own;
      if (kill) fb_nbytes = 0;

      // next pc, register write-back; f3 2/3 are not branches and take
      // BGEU's compare, the reference select's default
      const bool ge_u = a >= b;
      bool taken;
      switch (f3) {
        case 0: taken = a == b; break;
        case 1: taken = a != b; break;
        case 4: taken = slt(a, b); break;
        case 5: taken = !slt(a, b); break;
        case 6: taken = !ge_u; break;
        default: taken = ge_u; break;
      }
      taken = taken && is_branch;
      const u64 pc4 = pc + 4;
      u64 next_pc = taken ? pc + imm_b : pc4;
      if (is_jal) next_pc = pc + imm_j;
      if (is_jalr) next_pc = (a + imm_i) & ~1ull;
      u64 wval = 0;
      if (is_opimm || is_op) wval = alu64(f3, is_sub, is_sra, is_m, a, bop);
      if (is_opimm32 || is_op32)
        wval = alu32(f3, is_sub, is_sra, is_m, a, bop);
      if (is_load) wval = loaded;
      if (is_lui) wval = imm_u;
      if (is_auipc) wval = pc + imm_u;
      if (is_jal || is_jalr) wval = pc4;
      if (is_amo) wval = amo_rdval;
      const bool writes_rd = is_load || is_opimm || is_auipc || is_opimm32 ||
                             is_amo || is_op || is_lui || is_op32 ||
                             is_jalr || is_jal;
      if (ret && writes_rd && rd != 0) R[rd] = wval;

      // ---- tick bookkeeping --------------------------------------------------
      unsigned defs;      // nonzero iff some lane deferred
      int first_def = 0;  // MULTI: the lowest deferred lane
      if constexpr (MULTI) {
        first_def = cta_lowest<CLUSTER>(x, S_DEFS, deferred, -1);
        defs = first_def >= 0;
      } else {
        defs = __ballot_sync(FULL, deferred);
      }
      const bool started = team_any<MULTI, CLUSTER>(x, S_CAND, cand) || cont;
      const bool tick_done = started && !defs;
      const bool skip = gate && !cont &&
                        !team_any<MULTI, CLUSTER>(x, S_RUNNABLE, runnable) &&
                        any_active;
      const u64 wait = stall - ticks;
      u64 dticks = tick_done ? 1 : 0;
      if (skip) {         // uniform: every lane of the CTA takes this branch
        const u64 gap = active ? wait : ~0ull;
        if constexpr (MULTI)
          dticks = umin(cta_umin<CLUSTER>(x, gap), budget_left);
        else
          dticks = umin(warp_umin(gap), budget_left);
      }
      if constexpr (MULTI)
        exec_from = first_def < 0 ? 0 : first_def;
      else
        exec_from = defs ? __ffs(defs) - 1 : 0;
      const bool stalled = active && stall > ticks;
      if (stalled) c_stall += umin(wait, dticks);
      if (TRACE) {
        // the retire point, before pc, the clock and instret move: the
        // gate of cpu.py::_trace_record, then one record a captured lane
        bool cap = ret;
        if (p.trig_kind == TRIG_TICK) {
          cap = ret && ticks >= p.trig_a && ticks < p.trig_b;
        } else if (p.trig_kind == TRIG_INSTRET) {
          cap = ret && instret >= p.trig_a;
        } else if (p.trig_kind != TRIG_NONE) {
          const u64 val = p.trig_kind == TRIG_PC ? pc : in;
          bool armed = t_armed || (ret && val == p.trig_a);
          cap = ret && armed;
          if (p.trig_disarm) armed = armed && !(ret && val == p.trig_b);
          t_armed = armed;
        }
        if (cap) {
          const u64 row = (u64)lane * (u64)p.slots + t_n % (u64)p.slots;
          *reinterpret_cast<TraceRec*>(p.tracebuf + row * 4) =
              TraceRec{ticks, pc, in, (u64)priv};
          t_n += 1;
        }
      }
      if (ret) pc = next_pc;
      if (tr) {
        pending = true;
        mcause = cause;
        mepc = pc;
        mtval = tval;
      }
      ticks += dticks;
      cycles += (long long)dticks;
      uticks += ret;
      instret += ret;
      c_hits += hit && safe;
      c_walks += miss && safe;
      if (ways) c_tlb += dwalk && safe;
      // the substep's chain of dependent global loads: the fetch walk's
      // PTEs and the slot behind them, the data walk's PTEs, the data word;
      // lanes run side by side, so the longest chain counts
      int chain = (cand && is_memop) ? 1 : 0;
      for (int k = 0; k < 3; ++k)
        chain += (fw.words[k] != pw::NO_WORD) + (dw.words[k] != pw::NO_WORD);
      chain += miss;
      if constexpr (MULTI)
        trips += cta_max<CLUSTER>(x, (unsigned)chain);
      else
        trips += __reduce_max_sync(FULL, (unsigned)chain);
      team_sync<MULTI, CLUSTER>();  // the commits land before the next reads
    }
    substeps += p.issue_width;
  }

  // ---- state out: once per launch -----------------------------------------
  if (on) {
    for (int k = 0; k < 32; ++k) p.regs[lane * 32 + k] = R[k];
    p.pc[lane] = pc;
    p.pending[lane] = pending ? 1 : 0;
    p.mcause[lane] = mcause;
    p.mepc[lane] = mepc;
    p.mtval[lane] = mtval;
    p.res[lane] = res;
    p.uticks[lane] = uticks;
    p.instret[lane] = instret;
    p.stall_ticks[lane] = c_stall;
    p.fetch_hits[lane] = c_hits;
    p.fetch_walks[lane] = c_walks;
    p.tlb_walks[lane] = c_tlb;
    if (TRACE) {
      p.trace_n[lane] = t_n;
      p.trace_armed[lane] = t_armed ? 1 : 0;
    }
  }
  if (lane == 0) {
    *p.ticks = ticks;
    p.out[0] = substeps;
    p.out[1] = trips;
  }
  // no rank leaves while another may still reach into its shared memory
  if constexpr (CLUSTER) cl_sync();
}

template <bool TRACE, bool MULTI, bool CLUSTER = false>
__global__ void __launch_bounds__(MULTI ? LANES_MAX : WARP_LANES, 1)
    run_chunk_kernel(Params p) {
  chunk_body<TRACE, MULTI, CLUSTER>(p);
}

// CTA d (with CLUSTER, cluster d) runs board d: `p` points at board 0's
// slice of every stacked field and at the image of board 0 (`words` u64
// words a board), `budgets` holds the boards' limits, `p.out` is (D, 2).
template <bool MULTI, bool CLUSTER = false>
__global__ void __launch_bounds__(MULTI ? LANES_MAX : WARP_LANES, 1)
    run_chunk_fleet_kernel(Params p, const long long* budgets,
                           long long words) {
  int d = blockIdx.x;
  if constexpr (CLUSTER) d /= cl_ranks();
  const long long limit = budgets[d];
  p.out += 2 * d;
  if (limit == 0) {               // the board stays untouched, bit for bit
    if (threadIdx.x == 0) p.out[0] = p.out[1] = 0;
    return;
  }
  const long long c = (long long)d * p.nc;
  p.limit = limit;
  p.mem += d * words;
  p.regs += c * 32;
  p.pc += c;
  p.priv += c;
  p.pending += c;
  p.stall_until += c;
  p.satp += c;
  p.mcause += c;
  p.mepc += c;
  p.mtval += c;
  p.res += c;
  p.ticks += d;
  p.uticks += c;
  p.instret += c;
  p.stall_ticks += c;
  p.fetch_hits += c;
  p.fetch_walks += c;
  p.tlb_walks += c;
  chunk_body<false, MULTI, CLUSTER>(p);
}

// One thread follows `steps` links of `next` from `start` (the measure of
// one dependent load's latency on the path the chunk kernel's loads take).
__global__ void chase_kernel(const long long* next, long long start,
                             long long steps, long long* out) {
  long long i = start;
  for (long long k = 0; k < steps; ++k) i = next[i];
  *out = i;
}

Params make_params(void* mem, void* regs, void* pc, void* priv,
                   void* pending, void* stall_until, void* satp,
                   void* mcause, void* mepc, void* mtval, void* res,
                   void* ticks, void* uticks, void* instret,
                   void* stall_ticks, void* fetch_hits, void* fetch_walks,
                   void* tlb_walks, void* out, u64 mask, long long limit,
                   int lanes, int issue_width, int block_words,
                   int block_cache, int ways) {
  Params p;
  p.mem = (u64*)mem;
  p.regs = (u64*)regs;
  p.pc = (u64*)pc;
  p.priv = (int*)priv;
  p.pending = (unsigned char*)pending;
  p.stall_until = (const u64*)stall_until;
  p.satp = (const u64*)satp;
  p.mcause = (u64*)mcause;
  p.mepc = (u64*)mepc;
  p.mtval = (u64*)mtval;
  p.res = (u64*)res;
  p.ticks = (u64*)ticks;
  p.uticks = (u64*)uticks;
  p.instret = (u64*)instret;
  p.stall_ticks = (u64*)stall_ticks;
  p.fetch_hits = (u64*)fetch_hits;
  p.fetch_walks = (u64*)fetch_walks;
  p.tlb_walks = (u64*)tlb_walks;
  p.out = (long long*)out;
  p.mask = mask;
  p.limit = limit;
  p.nc = lanes;
  p.issue_width = issue_width;
  p.block_words = block_words;
  p.block_cache = block_cache;
  p.ways = ways;
  p.tracebuf = nullptr;
  p.trace_n = nullptr;
  p.trace_armed = nullptr;
  p.slots = 0;
  p.trig_kind = TRIG_NONE;
  p.trig_disarm = 0;
  p.trig_a = p.trig_b = 0;
  return p;
}

// threads of a CTA for a board of `lanes` cores: whole warps
int cta_threads(int lanes) { return (lanes + 31) / 32 * 32; }

// shared memory of `lanes` cores' register files, TLB and fetch slots
size_t board_bytes(int lanes, int block_words, int ways) {
  return (size_t)lanes * (32 + 4 * (size_t)ways) * 8 +
         (size_t)lanes * block_words * 4;
}

// shared memory of `lanes` cores in one CTA: past 32, the CTA-wide scratch
size_t cta_smem(int lanes, int block_words, int ways) {
  const size_t b = board_bytes(lanes, block_words, ways);
  if (lanes <= WARP_LANES) return b;
  return align8(b) + cross_bytes(cta_threads(lanes));
}

// shared memory of one rank of a cluster of `cta_lanes` threads a CTA
size_t cluster_smem(int cta_lanes, int block_words, int ways) {
  return align8(board_bytes(cta_lanes, block_words, ways)) +
         cross_bytes(cta_lanes) + cluster_slot_bytes();
}

// the dynamic shared memory a kernel may take, and past 8 CTAs a cluster
// the non-portable size
template <typename K>
cudaError_t prepare(K kernel, size_t smem, int ranks) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (ranks > CLUSTER_PORTABLE)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return cudaSuccess;
}

// a grid of `clusters` clusters of `ranks` CTAs of `threads` threads
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int clusters, int ranks, int threads, size_t smem,
                void* stream) : attr{}, cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)(clusters * ranks));
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <bool TRACE, bool MULTI>
int launch_chunk(const Params& p, size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        run_chunk_kernel<TRACE, MULTI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = cta_threads(p.nc);
#ifdef __CUDACC__
  run_chunk_kernel<TRACE, MULTI><<<1, threads, smem, (cudaStream_t)stream>>>(
      p);
#else  // g++ under the CPU emulation of tests/cuda_shim
  (void)stream;
  cuda_shim::launch(run_chunk_kernel<TRACE, MULTI>, 1, threads, smem, p);
#endif
  return (int)cudaGetLastError();
}

// a board past one CTA: one cluster of ceil(nc / cta_lanes) ranks
template <bool TRACE>
int launch_cluster(const Params& p, int cta_lanes, int block_words,
                   int ways, void* stream) {
  const int ranks = (p.nc + cta_lanes - 1) / cta_lanes;
  const size_t smem = cluster_smem(cta_lanes, block_words, ways);
  cudaError_t e = prepare(run_chunk_kernel<TRACE, true, true>, smem, ranks);
  if (e != cudaSuccess) return (int)e;
  ClusterLaunch l(1, ranks, cta_lanes, smem, stream);
  e = cudaLaunchKernelEx(&l.cfg, run_chunk_kernel<TRACE, true, true>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool TRACE>
int launch_chunk(const Params& p, int cta_lanes, int block_words, int ways,
                 void* stream) {
  if (p.nc > WARP_LANES && p.nc > cta_lanes)
    return launch_cluster<TRACE>(p, cta_lanes, block_words, ways, stream);
  const size_t smem = cta_smem(p.nc, block_words, ways);
  return p.nc > WARP_LANES ? launch_chunk<TRACE, true>(p, smem, stream)
                           : launch_chunk<TRACE, false>(p, smem, stream);
}

template <bool MULTI>
int launch_fleet(const Params& p, int boards, const long long* budgets,
                 long long words, size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        run_chunk_fleet_kernel<MULTI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = cta_threads(p.nc);
#ifdef __CUDACC__
  run_chunk_fleet_kernel<MULTI><<<boards, threads, smem,
                                  (cudaStream_t)stream>>>(p, budgets, words);
#else  // g++ under the CPU emulation of tests/cuda_shim
  (void)stream;
  cuda_shim::launch(run_chunk_fleet_kernel<MULTI>, boards, threads, smem, p,
                    budgets, words);
#endif
  return (int)cudaGetLastError();
}

// boards past one CTA: one cluster a board
int launch_fleet_cluster(const Params& p, int boards,
                         const long long* budgets, long long words,
                         int cta_lanes, int block_words, int ways,
                         void* stream) {
  const int ranks = (p.nc + cta_lanes - 1) / cta_lanes;
  const size_t smem = cluster_smem(cta_lanes, block_words, ways);
  cudaError_t e = prepare(run_chunk_fleet_kernel<true, true>, smem, ranks);
  if (e != cudaSuccess) return (int)e;
  ClusterLaunch l(boards, ranks, cta_lanes, smem, stream);
  e = cudaLaunchKernelEx(&l.cfg, run_chunk_fleet_kernel<true, true>, p,
                         budgets, words);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the launch's cores a CTA: a multiple of 32, at most LANES_MAX, whose
// cluster rank fits SMEM_MAX
bool cta_lanes_ok(int cta_lanes, int block_words, int ways) {
  return cta_lanes >= WARP_LANES && cta_lanes <= LANES_MAX &&
         cta_lanes % WARP_LANES == 0 &&
         cluster_smem(cta_lanes, block_words, ways) <= SMEM_MAX;
}

}  // namespace

extern "C" {

// Shared memory a launch needs for `lanes` cores in one CTA: the register
// files, the data TLB, the fetch slots and, past 32 cores, the CTA-wide
// scratch.
size_t run_chunk_smem_bytes(int lanes, int block_words, int ways) {
  return cta_smem(lanes, block_words, ways);
}

// Shared memory of each CTA of a cluster of `cta_lanes` threads a CTA:
// its cores' register files, TLB and fetch slots, the CTA-wide scratch and
// the ranks' summary slots.
size_t run_chunk_cluster_smem_bytes(int cta_lanes, int block_words,
                                    int ways) {
  return cluster_smem(cta_lanes, block_words, ways);
}

// The default cores a CTA of a cluster: the most whole warps, at most
// LANES_MAX, whose cluster rank fits SMEM_MAX (0 if not one warp does).
int run_chunk_cta_lanes(int block_words, int ways) {
  for (int n = LANES_MAX; n >= WARP_LANES; n -= WARP_LANES)
    if (cta_lanes_ok(n, block_words, ways)) return n;
  return 0;
}

// The most CTAs of `cta_lanes` threads a cluster that the current device
// schedules: the largest of CLUSTER_MAX, 8, 4 and 2 it finds room for,
// else 1; a negative CUDA error code on failure.
int run_chunk_max_cluster(int cta_lanes, int block_words, int ways) {
  if (!cta_lanes_ok(cta_lanes, block_words, ways))
    return -(int)cudaErrorInvalidValue;
  const size_t smem = cluster_smem(cta_lanes, block_words, ways);
  for (int ranks = CLUSTER_MAX; ranks >= 2; ranks /= 2) {
    cudaError_t e = prepare(run_chunk_kernel<false, true, true>, smem, ranks);
    if (e != cudaSuccess) return -(int)e;
    ClusterLaunch l(1, ranks, cta_lanes, smem, nullptr);
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(
        &clusters, run_chunk_kernel<false, true, true>, &l.cfg);
    if (e != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    if (clusters >= 1) return ranks;
  }
  return 1;
}

// Runs one chunk on `stream` and returns cudaGetLastError() (0 on
// success), or the error of a launch the device refused; does not
// synchronise and allocates nothing.  A board of at most 32 cores is one
// warp, of at most `cta_lanes` one CTA, and past that a cluster of
// ceil(lanes / cta_lanes) CTAs of cta_lanes threads (at most CLUSTER_MAX).
// Pointers are the CpuState fields in STATE_FIELDS order, then the
// commit-trace ring, trace_n and trace_armed.  trace_on picks the traced
// instantiation, which records the ring (`slots` rows a core) under the
// gate trig_kind (TRIG_*) with its values trig_a / trig_b; the untraced
// one never touches the ring.
int run_chunk_launch(void* mem, void* regs, void* pc, void* priv,
                     void* pending, void* stall_until, void* satp,
                     void* mcause, void* mepc, void* mtval, void* res,
                     void* ticks, void* uticks, void* instret,
                     void* stall_ticks, void* fetch_hits, void* fetch_walks,
                     void* tlb_walks, void* out, u64 mask,
                     long long limit, int lanes, int issue_width,
                     int block_words, int block_cache, int ways,
                     int cta_lanes, void* tracebuf, void* trace_n,
                     void* trace_armed, long long slots, int trace_on,
                     int trig_kind, int trig_disarm, u64 trig_a, u64 trig_b,
                     void* stream) {
  if (lanes <= 0 || (lanes > WARP_LANES &&
                     (!cta_lanes_ok(cta_lanes, block_words, ways) ||
                      lanes > CLUSTER_MAX * cta_lanes)))
    return (int)cudaErrorInvalidValue;
  if (trace_on && (slots <= 0 || trig_kind < TRIG_NONE ||
                   trig_kind > TRIG_INST))
    return (int)cudaErrorInvalidValue;
  Params p = make_params(
      mem, regs, pc, priv, pending, stall_until, satp, mcause, mepc, mtval,
      res, ticks, uticks, instret, stall_ticks, fetch_hits, fetch_walks,
      tlb_walks, out, mask, limit, lanes, issue_width, block_words,
      block_cache, ways);
  if (!trace_on)
    return launch_chunk<false>(p, cta_lanes, block_words, ways, stream);
  p.tracebuf = (u64*)tracebuf;
  p.trace_n = (u64*)trace_n;
  p.trace_armed = (unsigned char*)trace_armed;
  p.slots = slots;
  p.trig_kind = trig_kind;
  p.trig_disarm = trig_disarm;
  p.trig_a = trig_a;
  p.trig_b = trig_b;
  return launch_chunk<true>(p, cta_lanes, block_words, ways, stream);
}

// Runs one global chunk of `boards` boards on `stream` (one CTA a board,
// or past `cta_lanes` cores one cluster a board) and returns
// cudaGetLastError(); does not synchronise and allocates nothing.
// Pointers are the stacked CpuState fields in STATE_FIELDS order ((D,
// lanes, ...) contiguous, ticks (D,)), the image (D * words,), budgets (D,)
// and out (D, 2): substeps issued and dependent round trips, per board.
int run_chunk_fleet_launch(void* mem, void* regs, void* pc, void* priv,
                           void* pending, void* stall_until, void* satp,
                           void* mcause, void* mepc, void* mtval, void* res,
                           void* ticks, void* uticks, void* instret,
                           void* stall_ticks, void* fetch_hits,
                           void* fetch_walks, void* tlb_walks,
                           const void* budgets, void* out, u64 mask,
                           long long words, int lanes, int boards,
                           int issue_width, int block_words, int block_cache,
                           int ways, int cta_lanes, void* stream) {
  if (lanes <= 0 || boards <= 0 ||
      (lanes > WARP_LANES && (!cta_lanes_ok(cta_lanes, block_words, ways) ||
                              lanes > CLUSTER_MAX * cta_lanes)))
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(
      mem, regs, pc, priv, pending, stall_until, satp, mcause, mepc, mtval,
      res, ticks, uticks, instret, stall_ticks, fetch_hits, fetch_walks,
      tlb_walks, out, mask, 0, lanes, issue_width, block_words, block_cache,
      ways);
  const long long* lim = (const long long*)budgets;
  if (lanes > WARP_LANES && lanes > cta_lanes)
    return launch_fleet_cluster(p, boards, lim, words, cta_lanes,
                                block_words, ways, stream);
  const size_t smem = cta_smem(lanes, block_words, ways);
  return lanes > WARP_LANES
             ? launch_fleet<true>(p, boards, lim, words, smem, stream)
             : launch_fleet<false>(p, boards, lim, words, smem, stream);
}

// Launches the pointer chase on `stream` (one thread); returns
// cudaGetLastError().
int run_chunk_chase_launch(const void* next, long long start,
                           long long steps, void* out, void* stream) {
#ifdef __CUDACC__
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const long long*)next, start, steps, (long long*)out);
#else
  cuda_shim::launch(chase_kernel, 1, 1, 0, (const long long*)next, start,
                    steps, (long long*)out);
#endif
  return (int)cudaGetLastError();
}

}  // extern "C"
