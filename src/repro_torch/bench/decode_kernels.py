"""Device and host times of the port's decode-step kernels on one NVIDIA
GPU: ``paged_attention`` at the serving shape of ``chip_smoke.py``
(qwen3-8b's heads, 4 slots, pages of 64, a table of 8 pages, the busiest
step's lengths of its serve run) and at 32 768 tokens a slot, and
``page_set`` on the serving shape's K and V pools (36 layers, 65 pages,
8 ids).  With ``--src DIR`` it times the ``repro_torch`` package under
``DIR`` (for instance an unpacked earlier commit, whose kernels it builds
into ``DIR/build``), so that two trees compare inside one call::

    PYTHONPATH=src python -m repro_torch.bench.decode_kernels [--src DIR]
        [--label NAME]

It prints the card's name and power limit and one JSON line.  Times:
``wrapper_ms`` by CUDA events over back-to-back calls; ``device_ms`` a
launch's device time, as a CUDA graph of back-to-back calls replayed;
``profiler_device_us`` the kernel's own duration as the profiler records
it; ``graph_floor_ms`` a graph node of a 4-byte add, the floor under
``device_ms``; host µs (``split_us``, ``step_host_us``) the least of five
loops of 500 calls with nothing synchronised inside a loop; the
host split times each part of a call alone in a loop: an earlier
wrapper's five tensor checks, the key the current wrapper checks
instead, the output allocation, the current stream as a
``torch.cuda.Stream`` and as a raw handle, and the ctypes call of the
entry point with its arguments built (the CUDA launch included).  On a
tree whose wrapper plans a split (``paged_attention.plan``) it also
times the kernel at each of several split counts and chunk sizes
(``split_sweep``, ``rows_sweep``, device ms).  Exits non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import timing as S

#: B, H, Hkv, D, page, P
SERVE_SHAPE = (4, 32, 8, 128, 64, 8)
#: the busiest step's lengths of chip_smoke.py's serve run
SERVE_LENS = (68, 156, 156, 44)
SERVE_POOL_PAGES = 65
LONG_SHAPE, LONG_LENS = S.LONG_SHAPE, S.LONG_TIMED_LENS
#: the serve K/V pool: (layers, 1, pages, page, Hkv, D) and page_set's ids
POOL_SHAPE = (36, 1, 65, 64, 8, 128)
SET_IDS = 8


def host_us(torch, fn, iters=500, repeats=5):
    """The host's µs per call: the least of ``repeats`` loops of ``iters``
    calls (few enough that the device's queue never fills and blocks the
    host), each synchronised after its clock stops."""
    best = float("inf")
    for _ in range(repeats):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / iters * 1e6


def attention_inputs(torch, dev, B, H, Hkv, D, page, P, lens, pages, seed):
    """chip_smoke.py's seeded bf16 inputs with these lengths."""
    return S.attention_inputs(torch, dev, B, H, Hkv, D, page, P,
                              torch.bfloat16, seed, lens, pages)


def host_split(torch, PA, _build, args):
    """Each part of a wrapper call alone, and the whole call, in µs per
    call (``host_us``)."""
    q, kp, vp, bt, lens = args
    dev = q.device
    B, H, D = q.shape
    NP, page, Hkv, _ = kp.shape

    def five_checks():
        _build.check_tensor("p", "q", q, q.dtype, (B, H, D), dev)
        _build.check_tensor("p", "k", kp, q.dtype, (None, None, None, D),
                            dev)
        _build.check_tensor("p", "v", vp, q.dtype, (NP, page, Hkv, D), dev)
        _build.check_tensor("p", "t", bt, torch.int32, (B, None), dev)
        _build.check_tensor("p", "l", lens, torch.int32, (B,), dev)

    table = {}

    def fused_key():
        key = (q.device, q.dtype, q.shape, kp.shape, vp.shape, kp.dtype,
               vp.dtype, kp.device, vp.device, bt.shape, bt.dtype, bt.device,
               lens.shape, lens.dtype, lens.device, q.is_contiguous(),
               kp.is_contiguous(), vp.is_contiguous(), bt.is_contiguous(),
               lens.is_contiguous())
        return table.get(key)

    out = torch.empty_like(q)
    fn = _build.entry("paged_attention", "paged_attention_launch", PA._ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if len(PA._ARGS) == 14:                  # an earlier wrapper: no workspace
        call = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
                lens.data_ptr(), out.data_ptr(), B, H, Hkv, D, page,
                bt.shape[1], 1, stream)
    else:
        _, _, part, counters, tail = next(iter(PA._checked.values()))
        call = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
                lens.data_ptr(), out.data_ptr(), part, counters, *tail,
                stream)
    parts = {
        "five_check_tensor": lambda: five_checks(),
        "fused_key": fused_key,
        "empty_like": lambda: torch.empty_like(q),
        "stream_object": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "ctypes_launch": lambda: fn(*call),
        "wrapper": lambda: PA.paged_attention(*args),
    }
    return {name: host_us(torch, f) for name, f in parts.items()}


def profiler_us(torch, fn, name, iters):
    """Mean device µs of the kernels whose name holds ``name`` over
    ``iters`` calls, as ``torch.profiler`` (CUPTI) records them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        S.lead_in(torch)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in S.device_events(prof.key_averages()) if name in e.key]
    n = sum(e.count for e in ev)
    return sum(e.self_device_time_total for e in ev) / n if n else None


def plan_sweep(torch, PA, fn, field, values, iters):
    """Device ms of ``fn`` (a paged_attention call) with its plan's
    ``field`` ("splits" or "rows") forced to each of ``values``, on a tree
    that plans; {} on one that does not."""
    if not hasattr(PA, "plan"):
        return {}
    plan = PA.plan
    out = {}
    try:
        for n in values:
            def forced(B, H, Hkv, D, page, P, esize, sm_count, n=n):
                pl = plan(B, H, Hkv, D, page, P, esize, sm_count)
                if field == "rows":
                    return pl._replace(rows=n)
                pps = -(-P // min(n, P))
                return pl._replace(splits=-(-P // pps), pages_per_split=pps)
            PA.plan = forced
            PA._checked.clear()
            out[n] = S.graph_ms(torch, fn, iters)
    finally:
        PA.plan = plan
        PA._checked.clear()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=S.OWN_SRC,
                    help="directory holding the repro_torch package")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("decode_kernels: no CUDA device", file=sys.stderr)
        return 1
    S.use_tree(args.src)
    from repro_torch.kernels import _build
    from repro_torch.kernels.page_ops import page_ops
    from repro_torch.kernels.paged_attention import paged_attention as PA
    smi = S.nvidia_smi_line()
    print(smi, flush=True)
    dev = torch.device("cuda")
    t0 = time.time()
    _build.load_all(["paged_attention", "page_ops"])
    res = {"label": args.label, "src": args.src, "nvidia_smi": smi,
           "build_s": time.time() - t0}
    # what a graph node costs with next to no work: one 4-byte add
    tiny = torch.zeros((1,), device=dev)
    res["graph_floor_ms"] = S.graph_ms(torch, lambda: tiny.add_(1), 500)

    B, H, Hkv, D, page, P = SERVE_SHAPE
    a = attention_inputs(torch, dev, B, H, Hkv, D, page, P, SERVE_LENS,
                         SERVE_POOL_PAGES, 3)

    def attn():
        return PA.paged_attention(*a)
    res["attn_serve"] = dict(
        wrapper_ms=S.time_ms(torch, attn, 2000),
        device_ms=S.graph_ms(torch, attn, 500),
        split_us=host_split(torch, PA, _build, a),
        profiler_device_us=profiler_us(torch, attn, "paged_attention", 200),
        split_sweep=plan_sweep(torch, PA, attn, "splits", (1, 2, 4, 8), 500),
        rows_sweep=plan_sweep(torch, PA, attn, "rows", (2, 4, 8, 16), 500))
    del a

    B, H, Hkv, D, page, P = LONG_SHAPE
    a = attention_inputs(torch, dev, B, H, Hkv, D, page, P, LONG_LENS,
                         B * P, 7)
    res["attn_long"] = dict(
        wrapper_ms=S.time_ms(torch, attn, 30, 3),
        device_ms=S.graph_ms(torch, attn, 10),
        split_sweep=plan_sweep(torch, PA, attn, "splits",
                               (8, 16, 32, 64, 128), 10),
        rows_sweep=plan_sweep(torch, PA, attn, "rows", (2, 4, 8, 16), 10))
    # the same bytes with every length 0 (the kernel scores nothing: the
    # uniform mean), and laid out with one KV head (each sequence's rows
    # contiguous in the pool) over 8x the sequences
    a = (*a[:4], torch.zeros_like(a[4]))
    res["attn_long"]["uniform_device_ms"] = S.graph_ms(torch, attn, 10)
    del a
    a = attention_inputs(torch, dev, B * Hkv, H // Hkv, 1, D, page, P,
                         LONG_LENS * Hkv, B * Hkv * P, 7)
    res["attn_long"]["one_kv_head_device_ms"] = S.graph_ms(torch, attn, 10)
    del a
    torch.cuda.empty_cache()

    g = torch.Generator(device=dev)
    g.manual_seed(11)
    kpool = torch.randn(POOL_SHAPE, generator=g, device=dev).bfloat16()
    vpool = torch.randn(POOL_SHAPE, generator=g, device=dev).bfloat16()
    ids = torch.arange(SET_IDS, dtype=torch.int32, device=dev) * 3 % \
        POOL_SHAPE[2]
    fused = hasattr(page_ops, "SET_MAX_POOLS")

    def one_pool():
        page_ops.page_set(kpool, ids, 0.0)

    def both_pools():
        if fused:
            page_ops.page_set((kpool, vpool), ids, 0.0)
        else:
            page_ops.page_set(kpool, ids, 0.0)
            page_ops.page_set(vpool, ids, 0.0)
    res["page_set"] = dict(
        fused=fused,
        one_pool_wrapper_ms=S.time_ms(torch, one_pool, 200),
        one_pool_device_ms=S.graph_ms(torch, one_pool, 50),
        step_wrapper_ms=S.time_ms(torch, both_pools, 200),
        step_device_ms=S.graph_ms(torch, both_pools, 50),
        step_host_us=host_us(torch, both_pools))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
