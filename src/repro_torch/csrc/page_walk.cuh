// Sv39 walk and fetch-slot gather as device functions, shared by the
// standalone walk_fetch_block kernel (page_walk.cu) and the persistent chunk
// kernel (run_chunk.cu).
//
// Semantics are the plain version's, repro_torch/kernels/page_walk/ref.py:
// a satp whose mode is not 8 is Bare (identity under the image mask, no
// fault, no walk words); mode 8 walks three levels, a leaf may sit at any
// level and must carry every bit of `need`; an invalid PTE, a leaf without
// the permission or three pointers without a leaf fault with pa 0.
//
// The image pointer is a plain `const u64*`, never `const __restrict__`:
// inside the chunk kernel lanes read words that other lanes stored earlier
// in the same launch, and the read-only (non-coherent) load path that
// __restrict__ licenses would return stale words.

#pragma once

typedef unsigned long long u64;

namespace pw {

constexpr u64 PTE_V = 1ull << 0;
constexpr u64 PTE_R = 1ull << 1;
constexpr u64 PTE_W = 1ull << 2;
constexpr u64 PTE_X = 1ull << 3;
constexpr u64 PTE_U = 1ull << 4;
constexpr u64 NO_WORD = ~0ull;

// One walk's result, with the leaf metadata a translation cache needs
// (ref.py::sv39_walk_leaf).
struct Walk {
  u64 pa;          // translated address under the mask; 0 on a fault
  bool fault;
  u64 words[3];    // word index each level's PTE load read; NO_WORD for
                   // levels not reached and for Bare
  u64 perms;       // the taken leaf's low PTE byte (0 without one)
  bool leaf0;      // a 4 KiB (level-0) leaf was taken
  u64 leaf_widx;   // that leaf PTE's word index, NO_WORD otherwise
};

// A walk that touched nothing: what a lane that does not walk reports.
__device__ __forceinline__ Walk no_walk() {
  Walk r;
  r.pa = 0;
  r.fault = false;
  r.words[0] = r.words[1] = r.words[2] = NO_WORD;
  r.perms = 0;
  r.leaf0 = false;
  r.leaf_widx = NO_WORD;
  return r;
}

// Translate `va` under `satp` for an access that needs the PTE bits `need`
// (PTE_U plus R, W or X), reading PTEs from the word image `m`.
__device__ __forceinline__ Walk sv39_walk(const u64* m, u64 satp, u64 va,
                                          u64 need, u64 mask) {
  Walk r = no_walk();
  if ((satp >> 60) != 8ull) {
    r.pa = va & mask;
    return r;
  }
  u64 a = (satp & ((1ull << 44) - 1)) << 12;
  bool done = false;
  for (int slot = 0; slot < 3 && !done; ++slot) {
    const int level = 2 - slot;
    const u64 idx = (va >> (12 + 9 * level)) & 0x1FFull;
    const u64 widx = ((a + idx * 8ull) & mask) >> 3;
    r.words[slot] = widx;
    const u64 pte = m[widx];
    const bool valid = (pte & PTE_V) != 0;
    const bool leaf = valid && (pte & (PTE_R | PTE_X)) != 0;
    if (!valid) {
      r.fault = true;
      done = true;
    } else if (leaf) {
      if ((pte & need) == need) {
        const u64 off_mask = (1ull << (12 + 9 * level)) - 1;
        r.pa = (((pte >> 10) << 12) | (va & off_mask)) & mask;
        r.perms = pte & 0xFFull;
        if (level == 0) {
          r.leaf0 = true;
          r.leaf_widx = widx;
        }
      } else {
        r.fault = true;
      }
      done = true;
    } else {
      a = (pte >> 10) << 12;
    }
  }
  r.fault = r.fault || !done;              // three pointers, no leaf
  return r;
}

// The valid bytes of a fetch block at `va`: clamped to the enclosing 4 KiB
// page (the walk proves contiguity within one page only), 0 on a fault.
__device__ __forceinline__ u64 fetch_nbytes(u64 va, bool fault,
                                            int block_words) {
  if (fault) return 0;
  const u64 remain = 0x1000ull - (va & 0xFFFull);
  const u64 want = 4ull * (u64)block_words;
  return remain < want ? remain : want;
}

// Instruction slot k of the block at physical `pa`: the low or high half
// of word ((pa + 4k) & mask) >> 3.
__device__ __forceinline__ unsigned int fetch_slot(const u64* m, u64 pa,
                                                   int k, u64 mask) {
  const u64 addr = pa + 4ull * (u64)k;
  const u64 word = m[(addr & mask) >> 3];
  return (unsigned int)(word >> (((addr >> 2) & 1ull) * 32ull));
}

}  // namespace pw
