// walk_fetch_block for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/page_walk/page_walk.py
// (_walk_fetch_kernel / walk_fetch_block).  What it computes is exactly the
// plain version repro_torch/kernels/page_walk/ref.py::walk_fetch_block_ref,
// for every slot: per lane an Sv39 execute-translate of `va` under `satp`
// (up to three dependent PTE loads; Bare when satp's mode is not 8; a leaf
// may sit at any level and needs U|X), the word index each level read, and
// `block_words` 32-bit instruction slots behind the translated pc, slot k
// being the low or high half of word ((pa + 4k) & mask) >> 3.  The TPU
// kernel's single contiguous block DMA (clamped at the image end) is not
// carried over: it exists for that machine's DMA engine and differs from
// the plain version beyond `nbytes` and at the end of the image.
//
// What bounds it here: latency, not bytes or operations.  A lane moves a
// few hundred bytes (three 8-byte PTEs, a 64-byte block, ~100 bytes of
// results), but the walk is a chain of up to three dependent global-memory
// round trips followed by a fourth for the block, and at the interpreter's
// shape (4 lanes) the launch itself costs more than all of them.  The
// design does not fight that: one warp per lane, thread 0 chases the
// pointers and broadcasts pa/fault with a shuffle, then threads
// 0..block_words-1 each load one slot (neighbouring threads, neighbouring
// addresses: one or two 32-byte sectors per lane) and store it.
//
// `base` (nullable) is a per-lane word offset into a larger buffer holding
// several images back to back; only the loads are offset, every returned
// index stays image-local.  `active` (nullable) masks lanes out: an
// inactive lane touches no memory and returns pa 0, fault 0, NO_WORD walk
// words, zero slots and nbytes 0.

#include <cuda_runtime.h>

typedef unsigned long long u64;

namespace {

constexpr u64 PTE_V = 1ull << 0;
constexpr u64 PTE_R = 1ull << 1;
constexpr u64 PTE_X = 1ull << 3;
constexpr u64 PTE_U = 1ull << 4;
constexpr u64 NO_WORD = ~0ull;
constexpr int WARPS_PER_BLOCK = 4;

__global__ void walk_fetch_block_kernel(
    const u64* __restrict__ mem, const u64* __restrict__ satp_v,
    const u64* __restrict__ va_v, const u64* __restrict__ base,
    const unsigned char* __restrict__ active, u64 mask, int lanes,
    int block_words, u64* __restrict__ pa_out,
    unsigned char* __restrict__ fault_out, u64* __restrict__ words_out,
    unsigned int* __restrict__ insts_out, u64* __restrict__ nbytes_out) {
  const int lane = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (lane >= lanes) return;                 // whole warps leave together
  const bool act = active == nullptr || active[lane] != 0;
  const u64* m = mem + (base == nullptr ? 0ull : base[lane]);

  u64 pa = 0;
  if (t == 0) {
    u64 w[3] = {NO_WORD, NO_WORD, NO_WORD};
    bool fault = false;
    u64 nbytes = 0;
    if (act) {
      const u64 satp = satp_v[lane];
      const u64 va = va_v[lane];
      if ((satp >> 60) != 8ull) {
        pa = va & mask;                      // Bare: identity under the mask
      } else {
        const u64 need = PTE_U | PTE_X;
        u64 a = (satp & ((1ull << 44) - 1)) << 12;
        bool done = false;
        for (int slot = 0; slot < 3 && !done; ++slot) {
          const int level = 2 - slot;
          const u64 idx = (va >> (12 + 9 * level)) & 0x1FFull;
          const u64 widx = ((a + idx * 8ull) & mask) >> 3;
          w[slot] = widx;
          const u64 pte = m[widx];
          const bool valid = (pte & PTE_V) != 0;
          const bool leaf = valid && (pte & (PTE_R | PTE_X)) != 0;
          if (!valid) {
            fault = true;
            done = true;
          } else if (leaf) {
            if ((pte & need) == need) {
              const u64 off_mask = (1ull << (12 + 9 * level)) - 1;
              pa = (((pte >> 10) << 12) | (va & off_mask)) & mask;
            } else {
              fault = true;
            }
            done = true;
          } else {
            a = (pte >> 10) << 12;
          }
        }
        fault = fault || !done;              // three pointers, no leaf
      }
      if (!fault) {
        const u64 remain = 0x1000ull - (va & 0xFFFull);
        const u64 want = 4ull * (u64)block_words;
        nbytes = remain < want ? remain : want;
      }
    }
    pa_out[lane] = pa;
    fault_out[lane] = fault ? 1 : 0;
    words_out[3 * lane + 0] = w[0];
    words_out[3 * lane + 1] = w[1];
    words_out[3 * lane + 2] = w[2];
    nbytes_out[lane] = nbytes;
  }
  pa = __shfl_sync(0xffffffffu, pa, 0);

  // the slots are gathered on a fault too (from pa = 0), as the plain
  // version does; consumers ignore them through nbytes = 0
  for (int k = t; k < block_words; k += 32) {
    unsigned int inst = 0;
    if (act) {
      const u64 addr = pa + 4ull * (u64)k;
      const u64 word = m[(addr & mask) >> 3];
      inst = (unsigned int)(word >> (((addr >> 2) & 1ull) * 32ull));
    }
    insts_out[(size_t)lane * block_words + k] = inst;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success); does
// not synchronise and allocates nothing.
extern "C" int walk_fetch_block_launch(
    const void* mem, const void* satp, const void* va, const void* base,
    const void* active, u64 mask, int lanes, int block_words, void* pa,
    void* fault, void* walk_words, void* insts, void* nbytes, void* stream) {
  if (lanes <= 0) return 0;
  const int blocks = (lanes + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  walk_fetch_block_kernel<<<blocks, 32 * WARPS_PER_BLOCK, 0,
                            (cudaStream_t)stream>>>(
      (const u64*)mem, (const u64*)satp, (const u64*)va, (const u64*)base,
      (const unsigned char*)active, mask, lanes, block_words, (u64*)pa,
      (unsigned char*)fault, (u64*)walk_words, (unsigned int*)insts,
      (u64*)nbytes);
  return (int)cudaGetLastError();
}
