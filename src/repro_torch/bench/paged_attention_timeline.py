"""Where one CTA of the ``paged_attention`` kernel spends its cycles, on
one NVIDIA GPU: builds a copy of ``src/repro_torch/csrc/paged_attention.cu``
in which thread 0 of CTA (0, 0) stores ``clock64()`` at the ends of its
phases into a device array, launches it through the port's wrapper at
the serving shape of :mod:`repro_torch.bench.decode_kernels` (qwen3-8b's
heads, 4 slots, pages of 64, a table of 8 pages) with a few lengths and
split counts, and prints the cycles from the start of the kernel to each
mark::

    PYTHONPATH=src python -m repro_torch.bench.paged_attention_timeline

Marks: ``start`` before the length is read, ``len`` the length read;
``ids`` the range's page ids staged; ``chunkK`` chunk K of warp 0
arrived, ``doneK`` its batches done; ``loop`` the ring drained;
``merged`` the warps' partials in shared memory; ``written`` the output
(one live range) or the partial written; ``ticket`` the ticket taken;
``weights`` the partials' weights computed; ``combined`` the output
written by the last CTA.  A mark the CTA does not reach is left out.
The copy differs from the source only by the stores.  Exits non-zero
without a GPU.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

from . import decode_kernels as TD
from . import timing

#: (name, lengths, split count): one full page a slot on one range, the
#: serve run's busiest lengths on the planned 8 ranges, one token a slot
CASES = (("64 rows, 1 range", (64, 64, 64, 64), 1),
         ("serve lengths, 8 ranges", (68, 156, 156, 44), 8),
         ("1 row, 8 ranges", (1, 1, 1, 1), 8))
NAMES = ["start", "len", "ids", "chunk0", "done0", "chunk1", "done1", "loop",
         "merged", "written", "ticket", "weights", "combined"]


def mark(i):
    return ("if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) "
            f"g_marks[{i}] = clock64();\n")


STRIDE = "  const long long stride = static_cast<long long>(p.gc) * (D + 2);\n"


def instrumented(src):
    """The source with a mark after each phase (see the module's doc)."""
    k = NAMES.index
    edits = [
        ("namespace {\n", "namespace {\n__device__ long long g_marks[16];\n"),
        ("  const int len = p.seq_lens[b];",
         mark(k("start")) + "  const int len = p.seq_lens[b];"),
        ("  if (split >= live) return;",
         mark(k("len")) + "  if (split >= live) return;"),
        ("    __syncthreads();\n  }\n",
         "    __syncthreads();\n  }\n" + mark(k("ids"))),
        ("      __syncwarp();                    // every lane's copies of "
         "chunk k\n",
         "      __syncwarp();                    // every lane's copies of "
         "chunk k\n      if (blockIdx.x == 0 && blockIdx.y == 0 && "
         "threadIdx.x == 0 && k < 2) g_marks[3 + 2 * k] = clock64();\n"),
        ("      __syncwarp();                    // chunk k read before its "
         "refill\n",
         "      __syncwarp();                    // chunk k read before its "
         "refill\n      if (blockIdx.x == 0 && blockIdx.y == 0 && "
         "threadIdx.x == 0 && k < 2) g_marks[4 + 2 * k] = clock64();\n"),
        ("    cp_async_wait<0>();\n",
         "    cp_async_wait<0>();\n" + mark(k("loop"))),
        ("  T* const ob = static_cast<T*>(p.out) +",
         mark(k("merged")) + "  T* const ob = static_cast<T*>(p.out) +"),
        ("  if (direct) return;\n", mark(k("written")) +
         "  if (direct) return;\n"),
        ("  if (!*flag) return;\n", mark(k("ticket")) +
         "  if (!*flag) return;\n"),
        (STRIDE, STRIDE + mark(k("weights"))),
        ("  if (tid == 0) p.counters[slot] = 0;",
         mark(k("combined")) + "  if (tid == 0) p.counters[slot] = 0;"),
        ('extern "C" {\n',
         'extern "C" {\nint marks_read(long long* h) {\n'
         "  return (int)cudaMemcpyFromSymbol(h, g_marks, sizeof(g_marks));\n"
         "}\nint marks_clear() {\n  long long z[16] = {0};\n"
         "  return (int)cudaMemcpyToSymbol(g_marks, z, sizeof(z));\n}\n"),
    ]
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"the source has changed: no {old!r}")
        src = src.replace(old, new, 1)
    return src


def main():
    import torch
    if not torch.cuda.is_available():
        print("paged_attention_timeline: no CUDA device",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import paged_attention as PA
    smi = timing.nvidia_smi_line()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "paged_attention_marks.cu")
        lib_path = os.path.join(tmp, "libpaged_attention_marks.so")
        with open(_build.CSRC / "paged_attention.cu") as f:
            text = instrumented(f.read())
        with open(src, "w") as f:
            f.write(text)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                        f"-I{_build.CSRC}", "-o", lib_path, src], check=True)
        lib = ctypes.CDLL(lib_path)
    fn = lib.paged_attention_launch
    fn.argtypes, fn.restype = PA._ARGS, ctypes.c_int
    _build._entries[("paged_attention", "paged_attention_launch")] = fn
    dev = torch.device("cuda")
    plan = PA.plan
    buf = (ctypes.c_longlong * 16)()
    out = {"nvidia_smi": smi}
    for name, lens, splits in CASES:
        args = TD.attention_inputs(torch, dev, *TD.SERVE_SHAPE, lens,
                                   TD.SERVE_POOL_PAGES, 3)

        def forced(*a, splits=splits):
            pl = plan(*a)
            P = a[5]
            pps = -(-P // splits)
            return pl._replace(splits=-(-P // pps), pages_per_split=pps)
        PA.plan = forced
        PA._checked.clear()
        for _ in range(20):
            PA.paged_attention(*args)
        torch.cuda.synchronize()
        lib.marks_clear()
        PA.paged_attention(*args)
        torch.cuda.synchronize()
        lib.marks_read(buf)
        out[name] = {NAMES[i]: buf[i] - buf[0] for i in range(len(NAMES))
                     if buf[i]}
    PA.plan = plan
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
