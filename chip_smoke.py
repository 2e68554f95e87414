#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU and the
CUDA toolkit::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all started together), holds each kernel against its
plain PyTorch version on the card (``flash_attention`` with and without
a sliding window, in both designs), and drives the port's paths:

* the FASE path: the two reference pins (hello@UART, bc@PCIe) on
  ``TorchTarget(device="cuda")`` on both routes of the interpreter — the
  chunk kernel (one launch per chunk) and the eager loop
  (``chunk_kernel="ref"``, the standalone ``walk_fetch_block`` once a
  substep) — with every state field compared after every chunk (bc's
  eager run is the ``telemetry`` phase's armed one, held against both
  kernel routes, when both phases run); then the
  full-width run on the chunk kernel — the registry's ``FASE_ROCKET_PCIE``
  deployment (4 cores, 64 MiB target image resident on the card, PCIe
  async queue pair) running GAPBS ``bc`` with 4 threads — against
  constants pinned from the pure-Python reference simulator; then
  CoreMark (``coremark 1``, 1 core, UART) against its pins; boards of 40
  and 64 cores (the chunk kernels' CTA-wide instantiation, untraced,
  traced and fleet) against the eager loop after every chunk, and boards
  of 500 and 1 025 cores (the cluster instantiation: a thread-block
  cluster of 2 and 3 CTAs of 384 cores; 500 also traced, and a fleet of
  2 x 500; 512 cores and a fleet of 2 x 288 through the wrappers'
  ``cta_lanes=32``, clusters of 16 and 9 one-warp CTAs) against the eager
  route on the card after every chunk;
* the paper's FASE panels (phase ``panels``): the eight twins of
  ``repro_torch.bench`` at ``--quick`` on the card, each file's modelled
  numbers equal to the same panel's run on the port's PySim (run one
  after another in the background from launch), with the wall of each;
* the speed panels (phase ``speed_panels``): ``target_speed`` and
  ``speedup`` at ``--quick`` on the card — bc 4T on rmat(5,8) on the chunk
  kernel with and without the fetch-block cache, on the eager loop and on
  four boards of the stacked fleet kernel; CoreMark against PySim — each
  row's modelled numbers equal to the same twin's PySim run, its launches
  one a chunk (a substep, a global chunk) and the twin's quick gate held;
  before them the chunk kernel with ``block_cache=False`` against the
  eager route with the same knob after every chunk on hello@UART;
* telemetry (phase ``telemetry``): hello@UART and bc@PCIe with both
  out-of-band bridges armed on both interpreter routes, the ring included
  in the fields compared after every chunk; bc@PCIe on the chunk kernel's
  traced instantiation under each capture-window trigger kind against the
  port's PySim record for record (and an 8-slot ring's drops); the
  full-width run armed (pins unchanged, the hub's report equal to PySim's
  but for the backend model counters) and a lossless full-width capture
  replayed against PySim with 0 divergences; traced against untraced
  kernel time a substep and armed against unarmed wall;
* the fleet (phase ``fleet``): run_synchronous of three jobs on a stacked
  ``FleetTarget`` on the fleet chunk kernel (one launch, one CTA a board,
  per global chunk) in lockstep with its eager flat form, every board's
  state equal after every global chunk and every board of budget 0
  untouched; the 2-board gang pin over the switch fabric on both fleet
  forms, hello@UART and bc@PCIe through ``target="fleet-vmap"``; then the
  full width — ``FASE_FLEET_NET``'s 4-board gang (4 cores, 64 MiB a
  board) and ``FASE_FLEET_VMAP``'s run_synchronous of four bc jobs, one
  launch a global chunk — against constants pinned from the pure-Python
  simulator;
* the fleet panels (phase ``fleet_panels``): the twins of the
  reference's fleet_scale, net_scale, stall_attribution and migration at
  full size, every board a ``TorchTarget`` on the card, each file's
  modelled numbers equal to the checked-in ``results/<name>.json`` and to
  the same panel's PySim run (the makespans of
  ``results/fleet_scale.json`` and its PCIe migration row pinned), with
  the wall of each beside PySim's;
* the serving path: ``ServeEngine`` over qwen3-8b at full width (36
  layers, d_model 4096, seeded random bf16 weights on the card), 4 decode
  slots, ``max_seq`` 512, eight requests (``SERVE_MIX``), once timed on the
  kernels and then in lockstep against the plain versions; then the same
  mix over jamba-v0.1-52b at full width cut to one hybrid period of 8
  layers (1 windowed attention through ``paged_attention``'s windowed
  instantiation, 7 Mamba, 4 MoE, 4 MLP sublayers; 13.7 G parameters),
  timed and then in lockstep against the plain route, and over xlstm-350m
  whole (24 layers; no hand-written kernel on its path), timed and then
  its first decode steps against the same steps on the CPU;
* the training path: ``repro_torch.training.train_loop.train`` over
  qwen3-8b at full width cut to ``TRAIN_LAYERS`` layers (the card's 80 GB
  cannot hold AdamW's state for all 36), one sequence of 4096 tokens a
  step, attention through the ``flash_attention`` kernel; one step on the
  kernel route against the plain route; a failure-restart run at smoke
  width against an uninterrupted one;
* the families (phase ``families``): jamba-v0.1-52b's gradients at one
  period on the kernel route against the plain route (which replays the
  kernel route's MoE routing) and a planted attention fault, its prefill
  at 16 384 tokens on ``flash_attention``'s windowed instantiation, and
  xlstm-350m through ``train``; the windowed kernel timed at jamba's
  prefill shape;
* the dry run (phase ``dryrun``): ``python -m repro_torch.launch.dryrun``
  on five production cells (``meta`` tensors on the host's CPU, started
  with the build and run beside the card's phases), each cell's
  argument and peak bytes a device beside its parent's, a decode cell's
  KV pools a device the whole pools over the devices that split them, a
  decode row
  the data axes do not shard (jamba-v0.1-52b ``long_500k``) gathering
  under 1 MiB a device, qwen3-8b
  ``train_4k``'s peak a device beside its reading under DTensor's own
  layouts, and the card's measured bf16 GEMM and HBM copy rates;
* the LM-side twins (phase ``lm_panels``): serving_traffic's poll sweep
  at the reference's size on the card against the same twin's host run,
  its co-residency panel at full size against
  ``results/serving_coresidency.json``, the sweep at full width
  (qwen3-8b whole) on the kernel route against the plain route, the
  roofline over the dry run's cells, hillclimb's quick pair (run on the
  host in the background), and the three LM examples at a short argv.

Every phase prints one JSON line; any mismatch, build failure or launch
error ends the run with a non-zero exit code, and nothing runs on the CPU
when no GPU is found.  The last line is ``{"ok": true, "device": {...}}``.

Options (none are needed for the full check): ``--scale N`` picks the
R-MAT scale of the full-width graph (one of ``FULL_WIDTH``), ``--only``
limits the run to some phases, ``--profile`` adds ``torch.profiler``
windows over the interpreter's chunks, over serving decode steps and over
a train step, and writes their tables to ``--out`` (default
``smoke_out/``).
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import gc
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the timing helpers and seeded inputs the port's benchmark scripts share
from repro_torch.bench.timing import (  # noqa: E402
    CHUNK_CYCLES, LEAD_IN_LAUNCHES, LONG_SHAPE, LONG_TIMED_LENS,
    attention_inputs, device_events, flash_inputs, graph_ms, lead_in,
    loop_target, nvidia_smi_line, time_ms)

#: hello, 1 core, 4 MiB image, 921600-baud UART, async queue pair
HELLO_UART = dict(ticks=6_554_780,
                  stdout=b"hello from FASE target\nanswer 42\n")
#: bc on rmat(4,4), 2 threads, 2 cores, 4 MiB image, PCIe async queue pair
BC_PCIE = dict(ticks=775_078, instret=11_876, traffic=24_681)
#: the full-width run: FASE_ROCKET_PCIE, ``bc g.bin 4 1`` on
#: ``graphgen.rmat(scale, 4, weights=True)``; constants from the reference
#: package's pure-Python simulator (tests/test_torch_golden.py re-derives
#: them), keyed by scale
FULL_WIDTH = {
    5: dict(ticks=1_346_268, instret=34_530, traffic=46_676),
    8: dict(ticks=1_684_458, instret=71_269, traffic=69_810),
    10: dict(ticks=1_606_494, instret=181_583, traffic=125_900),
}
#: the chunk kernel runs a substep in microseconds, so the full-width run
#: takes the largest pinned graph
DEFAULT_SCALE = 10
#: CoreMark, one iteration, 1 core, 4 MiB image, 921600-baud UART; ticks
#: and instret from the reference package's pure-Python simulator
#: (tests/test_torch_golden.py re-derives them)
COREMARK = dict(ticks=9_402_851, instret=120_853, crc=16356)
#: links of the one-thread pointer chase that measures a dependent load
CHASE_STEPS = 1 << 16

#: the 2-board gang of tests/test_golden_ticks.py: bc on
#: partition(rmat(4, 4), 2), one core and 4 MiB a board, PCIe queue pairs,
#: the registry fabric, 40 000-tick supersteps, 4-page halos
GANG_PIN = dict(makespan=526_792, supersteps=6, exchanges=10, instret=4_319,
                fabric_bytes=164_460)
#: the full-width gang: FASE_FLEET_NET's 4 boards of 4 cores and 64 MiB,
#: bc with 4 threads a board on partition(rmat(10, 4), 4), the gang pin's
#: supersteps and halos; constants from the reference package's
#: pure-Python simulator (tests/test_torch_golden.py re-derives them)
GANG_FULL = dict(makespan=3_141_255, supersteps=25, exchanges=69,
                 instret=216_063, fabric_bytes=1_137_051)
#: the full-width run_synchronous: FASE_FLEET_VMAP's 4 boards, one job a
#: board, bc with 4 threads on rmat(10, 4, seed) for these seeds; each
#: job's (ticks, instret, traffic) from the pure-Python simulator
#: (tests/test_torch_golden.py re-derives them)
SYNC_SEEDS = (42, 43, 44, 45)
SYNC_FULL = ((1_606_494, 181_583, 125_900), (2_109_976, 180_905, 130_556),
             (1_608_932, 183_062, 127_280), (1_589_450, 182_760, 126_992))
#: results/fleet_scale.json's scale panel: 8 replicas of bc 1T on
#: rmat(5, 8), one core and 8 MiB a board, round-robin placement; the
#: makespan by (link, boards) (tests/test_torch_golden.py holds them to
#: the file)
FLEET_SCALE = {("uart", 1): 187_747_392, ("uart", 2): 93_873_696,
               ("uart", 4): 46_936_848, ("pcie", 1): 5_784_384,
               ("pcie", 2): 2_892_192, ("pcie", 4): 1_446_096}
#: results/migration.json's PCIe row: bc 1T, 48 trials on rmat(5, 8), one
#: core and 8 MiB a board, a full migration at 70 % of the baseline's
#: instructions
MIGRATION_PCIE = dict(baseline=4_171_071, migrated=4_294_529, pages=25,
                      src_bytes=103_121, dst_bytes=103_114)

#: published peaks of one H100 SXM: HBM bytes per second, dense bf16
#: tensor-core FLOP per second
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
#: the TPU kernel each port kernel replaces (file:line of its pallas_call)
REPLACES = {
    "walk_fetch_block": "src/repro/kernels/page_walk/page_walk.py:126",
    # no pallas_call: the reference's XLA while_loop of the chunk
    "run_chunk": "src/repro/core/target/cpu.py:1089",
    # no pallas_call: the reference's flat-fleet while_loop
    "run_chunk_fleet": "src/repro/core/target/cpu.py:1180",
    # no pallas_call: the commit-trace ring of the reference's substep
    "run_chunk_trace": "src/repro/core/target/cpu.py:1021",
    # the same loops on a board past one CTA (a thread-block cluster)
    "run_chunk_cluster": "src/repro/core/target/cpu.py:1089",
    "run_chunk_trace_cluster": "src/repro/core/target/cpu.py:1021",
    "run_chunk_fleet_cluster": "src/repro/core/target/cpu.py:1180",
    "paged_attention":
    "src/repro/kernels/paged_attention/paged_attention.py:89",
    # the same pallas_call; the ring of the reference's windowed decode
    # (src/repro/models/core.py:632-683) is what the instantiation adds
    "paged_attention_window":
    "src/repro/kernels/paged_attention/paged_attention.py:89",
    "page_set": "src/repro/kernels/page_ops/page_ops.py:68",
    "page_copy": "src/repro/kernels/page_ops/page_ops.py:38",
    "page_gather": "src/repro/kernels/page_ops/page_ops.py:94",
    "flash_attention":
    "src/repro/kernels/flash_attention/flash_attention.py:70",
    "flash_attention_window":
    "src/repro/kernels/flash_attention/flash_attention.py:70",
}
SOURCES = {
    "walk_fetch_block": "src/repro_torch/csrc/page_walk.cu",
    "run_chunk": "src/repro_torch/csrc/run_chunk.cu",
    "run_chunk_fleet": "src/repro_torch/csrc/run_chunk.cu",
    "run_chunk_trace": "src/repro_torch/csrc/run_chunk.cu",
    "run_chunk_cluster": "src/repro_torch/csrc/run_chunk.cu",
    "run_chunk_trace_cluster": "src/repro_torch/csrc/run_chunk.cu",
    "run_chunk_fleet_cluster": "src/repro_torch/csrc/run_chunk.cu",
    "paged_attention": "src/repro_torch/csrc/paged_attention.cu",
    "paged_attention_window": "src/repro_torch/csrc/paged_attention.cu",
    "page_set": "src/repro_torch/csrc/page_ops.cu",
    "page_copy": "src/repro_torch/csrc/page_ops.cu",
    "page_gather": "src/repro_torch/csrc/page_ops.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "flash_attention_window": "src/repro_torch/csrc/flash_attention.cu",
}
#: every csrc/<name>.cu the paths launch
CUDA_LIBS = ("page_walk", "run_chunk", "page_ops", "paged_attention",
             "flash_attention")

#: the serve run: qwen3-8b, 4 slots, max_seq 512, and the request mix as
#: (kind, prompt length, max_new).  Both "S" prompts start with one
#: 128-token prefix (two prefix hits).  "A" registers a 64-token prefix and
#: finishes first; "X" starts with the same 64 tokens and is admitted after
#: A's pages were freed and reused by a running sequence — the reference's
#: stale prefix hit (serving/pages.py:67), which is the one way a PageCP
#: (copy-on-write break) reaches the pool in an engine run, because
#: start_seq sets the host length to the prompt's (pages.py:84).  The
#: schedule depends on the mix alone unless a request emits its eos early.
SERVE_ARCH = "qwen3-8b"
SERVE_SLOTS, SERVE_MAX_SEQ = 4, 512
SERVE_MIX = (("A", 70, 16), ("S", 150, 16), ("S", 140, 16), ("B", 96, 16),
             ("C", 130, 16), ("X", 100, 16), ("D", 65, 16), ("E", 80, 16))
#: kernel vs plain route of the serve run (see ``lockstep``): the largest
#: difference of any logit, and of the plain route's logit at the kernel
#: route's token below its best where the two argmaxes differ.  Absolute:
#: the logits are bf16 of magnitude up to ~8, where a bf16 ulp is 1/32,
#: and the two attention implementations round their bf16 outputs apart
#: in a few elements, which 36 layers carry into the logits
SERVE_LOGIT_TOL = 0.25
#: paged_attention at ``LONG_SHAPE`` (32 768 tokens a slot) is checked
#: with one full, one single-token, one mid-page and one empty sequence
LONG_CHECK_LENS = (32768, 1, 20000, 0)
#: page_copy pairs past the one-grid limit (COPY_MAX_PAIRS + 1): the staged
#: route, checked on a small pool
STAGED_PAIRS = 12_801
#: page_gather's table on the serve pool's 65 pages: 8 entries, page 5
#: twice
GATHER_TABLE = (5, 64, 0, 17, 5, 33, 2, 9)
#: decode steps run on a throwaway engine before the timed serve window,
#: so that first-call costs (cuBLAS heuristics, allocator growth, pinned
#: host blocks) fall outside it
SERVE_WARM_STEPS = 8
#: the profiled decode steps of the jamba and xlstm serve runs (after
#: SERVE_WARM_STEPS unprofiled ones): launches, device time, busy share
FAMILY_PROFILE_STEPS = 16

#: the hybrid serve run: jamba-v0.1-52b at full width (d 4096, 32/8 heads,
#: 16 experts of d_ff 14336, top-2, window 8192), depth cut from 32 layers
#: to one hybrid period of 8 (13.7 G parameters, 27.5 GB of bf16; the
#: whole model's 53.3 G, 107 GB, do not fit the card's 80 GB); SERVE_MIX
#: at 4 slots and max_seq 512, so its ring is 8 pages, all of them inside
#: the window
JAMBA_ARCH, JAMBA_LAYERS = "jamba-v0.1-52b", 8
#: the lockstep of the jamba run compares one decode step at a time (the
#: plain route starts each step from the kernel route's whole decode
#: state): a 1-ulp difference of the attention output moves the hidden
#: state by bf16 rounding noise, which the 16-expert routers see, and
#: where a token's top-k is a near tie it goes to another expert — after
#: which its hidden state, and through the capacity of one token an
#: expert the others', differ wholly for the rest of the step (the later
#: MoE calls route apart at any margin), and a Mamba state would carry
#: that forever.  A step whose first MoE call that routes some token apart
#: does so with each such token's router probabilities on the two routes
#: within ROUTER_TIE of each other is excused from the logit checks; any
#: other fails.  Excused steps may be at most ROUTER_FLIP_SHARE of the
#: run's.  Both limits are read off the honest runs at JAMBA_SEEDS and the
#: runs with ROUTER_FAULTS planted, each of which the rule must fail
#: (PERF.md §6).  Honest, the routers' probabilities differed by up to
#: 0.019 where the routes routed alike, first flips came at gaps up to
#: 0.0076, and 7-8 % of steps flipped; with the attention output 2^-8
#: high, 39 % of steps flipped (first-flip gaps up to 0.022) and 25 steps'
#: logits were beyond 0.25; 2^-5 high gave a first flip at 0.057
ROUTER_TIE, ROUTER_FLIP_SHARE = 0.025, 0.15
JAMBA_SEEDS = (0, 1)
#: faults planted in the kernel route's windowed attention (see
#: ``PlantedFault``): (name, relative error of every output element,
#: window dropped).  2^-8 is the least that moves a bf16 output: 2^-9 is
#: under half an ulp and rounds back to the kernel's own output
ROUTER_FAULTS = (("out 2^-8 high", 2.0 ** -8, False),
                 ("out 2^-6 high", 2.0 ** -6, False),
                 ("out 2^-5 high", 2.0 ** -5, False),
                 ("window dropped", 0.0, True))
#: the recurrent serve run: xlstm-350m whole (24 layers, d 1024); its
#: first XLSTM_CPU_STEPS decode steps on the card against the same steps
#: on the CPU (the parameters copied over), under the lockstep rule:
#: on an f32 copy of the parameters step after step (card and CPU then
#: both compute in IEEE f32, TF32 off), and on the served bf16 parameters
#: one step at a time (the CPU starts each step from the card's state:
#: every bf16 product rounds apart between cuBLAS and the CPU's BLAS, and
#: the recurrent states would carry that into every later step)
XLSTM_ARCH, XLSTM_CPU_STEPS = "xlstm-350m", 8
#: the windowed paged_attention at jamba's heads: its serve shape (a ring
#: of 8 pages inside the window: every slot attended, written or not), and
#: a wrapped ring — max_seq 16 384 gives the reference's ring of
#: min(16 384, 8192 + 64) = 8 256 slots, P = 129 — with lengths past the
#: wrap (a masked span of 64 slots that is not page-aligned), mid-page and
#: below the window.  Timed at the wrapped shape with every row past the
#: wrap
WINDOW = 8192
WINDOW_SERVE_SHAPE = (4, 32, 8, 128, 64, 8)
WINDOW_SERVE_LENS = (1, 37, 300, 512)
WINDOW_RING_SHAPE = (4, 32, 8, 128, 64, 129)
WINDOW_RING_LENS = (9000, 8257 + 64 * 3 + 17, 16384, 5000)
WINDOW_RING_TIMED_LENS = (9000, 12000, 14000, 16384)

#: the train run: qwen3-8b at full width, depth cut from 36 to 12 layers
#: (12 bytes a parameter — bf16 weights and gradients, f32 AdamW moments —
#: are 42.7 GB at 12 layers and 98.3 GB at 36), batch 1 of the repository's
#: train_4k sequence length (src/repro/launch/steps.py SHAPES), the first
#: step warm
TRAIN_ARCH = "qwen3-8b"
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 12, 1, 4096, 4
#: the kernel route's gradients (the CUDA forward, attention_bwd) against
#: autograd through the plain version, as the relative L2 error of each of
#: dq, dk, dv: both are f32 arithmetic in another order (1e-4), and in
#: bf16 the plain route rounds the per-head gradients of K and V to bf16
#: before it sums a GQA group while attention_bwd sums in f32 (2e-2)
FLASH_BWD_REL_L2 = {"float32": 1e-4, "bfloat16": 2e-2}
#: one full-width train step on the kernel route against the plain route,
#: same parameters and batch: the loss (about 12.7) within
#: TRAIN_LOSS_ATOL, the grad norm within TRAIN_GN_RTOL, and the gradient
#: of each attention leaf (wq, wk, wv, wo, stacked over the layers) within
#: TRAIN_LEAF_REL_L2 as a relative L2 error.  The two attention routes
#: round their bf16 outputs apart in a few elements and their bf16 dK and
#: dV apart by ~3e-3 relative L2 (the plain route rounds each head's
#: gradient before it sums a GQA group); bf16 gradients and an unordered
#: index_add on the embedding make bit-equality no property here.  The
#: bf16 backward carries such differences through every layer: a one-ulp
#: change in 0.1 % of the attention outputs alone moves each attention
#: leaf's gradient by ~2e-2 relative L2, a wrong dK/dV of one GQA group by
#: 0.4 or more (tests/test_torch_training.py).  The bounds stand a few
#: times above the gaps measured on the card (PERF.md, training findings)
TRAIN_LOSS_ATOL, TRAIN_GN_RTOL, TRAIN_LEAF_REL_L2 = 5e-4, 2e-3, 5e-2
ATTN_LEAVES = ("wq", "wk", "wv", "wo")
#: the restart check at smoke width (the reference's fault test): the
#: losses after the restore against the uninterrupted run's
RESTART_ATOL = 1e-6

#: both out-of-band bridges armed: the reference's tier-1 golden-run
#: telemetry (tests/test_telemetry.py ARMED)
TELEM_ARMED = dict(counters=True, commit_trace=True, interval_ticks=50_000,
                   trace_slots=256)
#: the depth of bc@PCIe's armed eager run (``telemetry_goldens``): it ends
#: with the chunk that takes it to this many of bc's 11 472 substeps (23 of
#: 68 chunks: the graph load, both threads' start, the first parallel
#: chunks; ~35 % of the ~90-160 s the whole run costs on the card's host)
BC_EAGER_SUBSTEPS = 4096
#: the ring of the traced chunk kernel's timed chunk: the registry's
#: telem_trace_slots (configs/registry.py FASE_ROCKET)
TRACE_SLOTS = 4096
#: a lossless capture's ring (telemetry/replay.py's default)
CAPTURE_SLOTS = 1 << 15

PHASES = ("kernel", "chunk", "full", "coremark", "panels", "speed_panels",
          "telemetry", "fleet", "fleet_panels", "serve", "train", "families",
          "dryrun", "lm_panels")
#: seconds a phase waits for the host's share of its panels (they run
#: one after another in the background from launch)
PANELS_TIMEOUT = 600


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# kernel vs plain version, on the card
# ---------------------------------------------------------------------------
def build_walk_image(torch, mem_bytes, seed, dev):
    """A seeded word image with a 3-level Sv39 table (root/l1/l0 at pages
    2/3/4): 4 KiB leaves for vpn 16..64 (vpn 50 read-only, vpn 51 without
    X), a non-U leaf at vpn 65, nothing above, a 2 MiB superpage at
    vpn1 = 1, random words everywhere else."""
    import numpy as np
    V, R, W, X, U, A, D = 1, 2, 4, 8, 16, 64, 128
    flags = V | R | W | X | U | A | D
    n = mem_bytes // 8
    rng = np.random.RandomState(seed)
    mem = rng.randint(0, 1 << 62, n).astype(np.uint64) << np.uint64(2)
    mem[:16 * 512] = 0
    root, l1, l0 = 2, 3, 4
    mem[root * 512] = (l1 << 10) | V
    mem[l1 * 512] = (l0 << 10) | V
    mem[l1 * 512 + 1] = (0x80 << 10) | flags
    for vpn0 in range(16, 65):
        mem[l0 * 512 + vpn0] = (vpn0 << 10) | flags
    mem[l0 * 512 + 50] = (50 << 10) | (flags & ~W)
    mem[l0 * 512 + 51] = (51 << 10) | (flags & ~X)
    mem[l0 * 512 + 65] = (65 << 10) | (flags & ~U)
    return torch.from_numpy(mem.view(np.int64)).to(dev), (8 << 60) | root


def i64(torch, vals, dev):
    from repro_torch.core.target.u64 import to_signed
    return torch.tensor([to_signed(int(v)) for v in vals],
                        dtype=torch.int64, device=dev)


def compare_outputs(torch, got, want, what):
    """Array-equal on all five outputs and all slots; returns the largest
    absolute difference seen (0 when equal) and fails when it is not 0."""
    names = ("pa", "fault", "walk_words", "insts", "nbytes")
    worst = 0
    for name, g, w in zip(names, got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{what}: {name} shape/dtype {g.shape}/{g.dtype} != "
              f"{w.shape}/{w.dtype}")
        if not torch.equal(g, w):
            diff = (g.to(torch.float64) - w.to(torch.float64)).abs().max()
            worst = max(worst, float(diff))
            bad = (g != w).nonzero()[:4].tolist()
            fail(f"{what}: kernel != plain version in {name} at {bad} "
                 f"(max abs diff {worst})")
    return worst


def walk_fetch_bound_ms(torch, out, lanes, block_words, active=None,
                        base=False):
    """Least time for one call on these inputs: every input read once and
    every output written once at the HBM rate.  The PTE words are counted
    as the walk really read them (levels reached), the block as the
    distinct 8-byte words its slots cover."""
    pa, fault, walk_words, insts, nbytes = out
    pte_reads = int((walk_words != -1).sum())
    lane_on = active if active is not None else torch.ones_like(fault)
    block_words_read = int(((block_words // 2) + ((pa >> 2) & 1))[lane_on]
                           .sum())
    in_bytes = 16 * lanes + (lanes if active is not None else 0) + \
        (8 * lanes if base else 0) + 8 * (pte_reads + block_words_read)
    out_bytes = lanes * (8 + 1 + 24 + 4 * block_words + 8)
    return (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.time()
    _build.load_all(CUDA_LIBS)
    emit({"phase": "build", "kernels": list(CUDA_LIBS),
          "seconds": round(time.time() - t0, 3)})


def phase_kernel(torch, dev):
    from repro_torch.kernels.page_walk import ops, page_walk

    mem_bytes = 1 << 20
    mask = mem_bytes - 1
    mem, satp_v = build_walk_image(torch, mem_bytes, 1, dev)
    n = mem_bytes // 8
    both = torch.cat([mem, mem ^ 0x5A5A_0000_0000_A5A5])
    # the reference test's cases: 4 KiB leaf mid-page, block clamped at the
    # page end, 2 MiB superpage, no-U fault, invalid leaf, out of table
    vas = [16 * 4096 + 8, 40 * 4096 + 4092, 0x200000 + 0x1234 * 4,
           65 * 4096, 66 * 4096, 0x7000_0000]
    cases = 0
    worst = 0.0
    for bw in (8, 16):
        for with_base in (False, True):
            m = both if with_base else mem
            for bare in (False, True):
                va_l = [0x10000, 0x10002 * 4 + 2] if bare else vas
                reps = 2 if with_base else 1
                va = i64(torch, va_l * reps, dev)
                satp = i64(torch, [0 if bare else satp_v] * len(va), dev)
                base = None
                if with_base:
                    base = i64(torch, [0] * len(va_l) + [n] * len(va_l), dev)
                got = ops.walk_fetch_block(m, satp, va, mask, bw, base)
                want = ops.walk_fetch_block(m, satp, va, mask, bw, base,
                                            impl="ref")
                torch.cuda.synchronize()
                worst = max(worst, compare_outputs(
                    torch, got, want,
                    f"directed bw={bw} base={with_base} bare={bare}"))
                if not bare:
                    check(got[1].tolist()[:6] ==
                          [False, False, False, True, True, True],
                          "directed faults are not F,F,F,T,T,T")
                cases += 1
    # a few thousand random lanes over the seeded table, with a mask
    import numpy as np
    rng = np.random.RandomState(5)
    lanes = 4096
    va_np = rng.randint(0, 80 * 4096, lanes).astype(np.uint64)
    va_np[::7] = (0x200000 + rng.randint(0, 1 << 21, len(va_np[::7]))) \
        .astype(np.uint64)
    va_np[::11] |= np.uint64(1) << np.uint64(rng.randint(39, 64))
    satp_np = np.where(rng.rand(lanes) < 0.85, np.uint64(satp_v),
                       np.uint64(0)).astype(np.uint64)
    va = torch.from_numpy(va_np.view(np.int64)).to(dev)
    satp = torch.from_numpy(satp_np.view(np.int64)).to(dev)
    active = torch.from_numpy(rng.rand(lanes) < 0.7).to(dev)
    base = torch.from_numpy(
        (rng.randint(0, 2, lanes) * n).astype(np.int64)).to(dev)
    for bw in (8, 16):
        for b, a in ((None, None), (base, None), (None, active),
                     (base, active)):
            m = both if b is not None else mem
            got = ops.walk_fetch_block(m, satp, va, mask, bw, b, a)
            want = ops.walk_fetch_block(m, satp, va, mask, bw, b, a,
                                        impl="ref")
            torch.cuda.synchronize()
            worst = max(worst, compare_outputs(
                torch, got, want, f"random bw={bw} base={b is not None} "
                f"active={a is not None}"))
            cases += 1
    nf = int(got[1].sum())
    check(0 < nf < lanes, "random lanes: faults are all or none")
    # the wrapper refuses what the kernel does not take
    for bad in (lambda: page_walk.walk_fetch_block(mem.cpu(), satp, va,
                                                   mask, 16),
                lambda: page_walk.walk_fetch_block(mem, satp, va, mask, 12),
                lambda: page_walk.walk_fetch_block(mem, satp.to(torch.int32),
                                                   va, mask, 16)):
        try:
            bad()
        except ValueError:
            continue
        fail("the kernel wrapper accepted an input it must refuse")
    emit({"phase": "kernel_vs_plain", "kernel": "walk_fetch_block",
          "cases": cases, "random_lanes": lanes, "tolerance": 0,
          "max_abs_err": worst, "equal": True})
    check_run_chunk_wrapper(torch, dev)
    return {"walk_fetch_block": worst, **check_attention(torch, dev),
            **check_page_ops(torch, dev), **check_flash_attention(torch, dev),
            "flash_attention_window": check_flash_window(torch, dev)}


def past_largest_cluster():
    """``(cores, message)``: one core past the largest cluster the card
    schedules at the registry's knobs, and what the refusal must name."""
    from repro_torch.kernels.run_chunk import run_chunk as RC
    lanes = RC.default_cta_lanes(16, 8)
    most = RC.max_cluster(lanes, 16, 8)
    n = most * lanes + 1
    return n, (f"{n} cores need a cluster of {most + 1} CTAs of cta_lanes "
               f"{lanes} cores, and the device schedules at most {most} a "
               f"cluster: at most {most * lanes} cores")


def check_run_chunk_wrapper(torch, dev):
    """The chunk kernel's wrapper refuses what the kernel does not take:
    a CPU state, a field of another dtype, more cores than the largest
    cluster the card schedules (the limit named), block words beyond
    shared memory."""
    from repro_torch.core.target import cpu
    from repro_torch.kernels.run_chunk import run_chunk as RC
    st = cpu.make_state(2, 1 << 20, device=dev)
    bad_dtype = cpu.make_state(2, 1 << 20, device=dev)
    bad_dtype.priv = bad_dtype.priv.long()
    n_past, limit = past_largest_cluster()
    wide = cpu.make_state(n_past, 1 << 20, device=dev)
    for call, says in (
            (lambda: RC.run_chunk(cpu.make_state(2, 1 << 20, device="cpu"),
                                  2, 1 << 20, 64), "CUDA state"),
            (lambda: RC.run_chunk(bad_dtype, 2, 1 << 20, 64), "priv"),
            (lambda: RC.run_chunk(wide, n_past, 1 << 20, 64), limit),
            (lambda: RC.run_chunk(st, 2, 1 << 20, 64, block_words=1 << 16),
             "shared memory")):
        try:
            call()
        except ValueError as e:
            check(says in str(e), f"run_chunk refused with {e!r}, not "
                  f"naming {says!r}")
            continue
        fail("the run_chunk wrapper accepted an input it must refuse")
    emit({"phase": "wrapper_checks", "kernel": "run_chunk", "refused": 4,
          "past_largest_cluster": limit})


def attention_err(torch, q, kp, vp, bt, lens, window=0):
    """Largest |kernel - plain version| of paged_attention on one input
    set (with ``window``, the windowed instantiation); fails beyond the
    dtype's ``ATTN_TOL`` or on a non-finite output."""
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.flash_attention.ref import ATTN_TOL
    got = ops.paged_decode(q, kp, vp, bt, lens, window=window)
    want = ops.paged_decode(q, kp, vp, bt, lens, impl="ref", window=window)
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape,
          "paged_attention: kernel output dtype/shape differs")
    check(bool(torch.isfinite(got).all()), "paged_attention: non-finite")
    diff = (got.float() - want.float()).abs()
    atol, rtol = ATTN_TOL[str(q.dtype).split(".")[1]]
    over = float((diff - rtol * want.float().abs()).max())
    check(over <= atol, f"paged_attention {tuple(q.shape)} {q.dtype} "
          f"kp {tuple(kp.shape)} lens {lens.tolist()} window {window}: "
          "kernel differs from "
          f"the plain version by {over} beyond rtol {rtol} > atol {atol} "
          f"(max abs diff {float(diff.max())})")
    return float(diff.max())


def check_attention(torch, dev):
    """paged_attention == its plain version on the card: the f32 sweep of
    tests/test_kernels.py:50-65 (every combination), D 128 / page 64 in
    f32, a GQA group of 16 (chatglm3-6b), zero lengths, bf16 at the
    serving shape with lens of 1, mid-page, a page boundary and P * page,
    and bf16 at ``LONG_SHAPE`` (32 768 tokens a slot) with
    ``LONG_CHECK_LENS``."""
    import itertools
    from repro_torch.kernels.flash_attention.ref import ATTN_TOL
    worst, cases, s = 0.0, 0, 0
    for B, H, Hkv, D, page, P in itertools.product(
            (1, 2), (2, 4), (1, 2), (16, 32), (8, 16), (1, 2, 3, 4)):
        if H % Hkv:
            H = Hkv
        s += 1
        worst = max(worst, attention_err(torch, *attention_inputs(
            torch, dev, B, H, Hkv, D, page, P, torch.float32, s)))
        cases += 1
    for B, H, Hkv, D, page, P, dtype, lens in (
            (3, 8, 2, 128, 64, 4, torch.float32, [1, 130, 256]),
            (2, 32, 2, 128, 64, 3, torch.float32, [0, 100]),
            (4, 32, 8, 128, 64, 8, torch.bfloat16, [1, 37, 64, 512]),
            (4, 32, 8, 128, 64, 8, torch.bfloat16, [65, 300, 511, 0]),
            (4, 4, 2, 16, 64, 2, torch.bfloat16, [1, 64, 65, 128])):
        s += 1
        worst = max(worst, attention_err(torch, *attention_inputs(
            torch, dev, B, H, Hkv, D, page, P, dtype, s, lens,
            pages=2 * B * P + 1)))
        cases += 1
    worst = max(worst, attention_err(torch, *attention_inputs(
        torch, dev, *LONG_SHAPE, torch.bfloat16, s + 1, LONG_CHECK_LENS)))
    cases += 1
    # the wrapper refuses what the kernel does not take
    from repro_torch.kernels.paged_attention import paged_attention as PA
    q, kp, vp, bt, lens = attention_inputs(torch, dev, 1, 2, 1, 16, 8, 1,
                                           torch.float32, 0)
    for bad in (lambda: PA.paged_attention(q.cpu(), kp, vp, bt, lens),
                lambda: PA.paged_attention(q.half(), kp, vp, bt, lens),
                lambda: PA.paged_attention(q, kp, vp, bt.long(), lens),
                lambda: PA.paged_attention(q[..., :10].contiguous(),
                                           kp[..., :10].contiguous(),
                                           vp[..., :10].contiguous(), bt,
                                           lens)):
        try:
            bad()
        except ValueError:
            continue
        fail("the paged_attention wrapper accepted an input it must refuse")
    emit({"phase": "kernel_vs_plain", "kernel": "paged_attention",
          "cases": cases, "tolerance": ATTN_TOL, "max_abs_err": worst})
    return {"paged_attention": worst, **check_window_attention(torch, dev)}


def check_window_attention(torch, dev):
    """The windowed instantiation == its plain version on the card, at
    jamba's heads: the serve shape (a ring inside the window), the wrapped
    ring of ``WINDOW_RING_SHAPE`` (checked and timed lengths), and small
    rings whose plan gives one page a range and whose window masks whole
    ranges (no attended row in them), in f32 and bf16; and the window is
    not a no-op (it differs from full attention over the same wrapped
    ring)."""
    from repro_torch.kernels.flash_attention.ref import ATTN_TOL
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention import paged_attention as PA
    worst, cases = 0.0, 0
    before = PA.paged_attention.window_launches
    for seed, (shape, lens, window, dtype) in enumerate((
            (WINDOW_SERVE_SHAPE, WINDOW_SERVE_LENS, WINDOW, torch.bfloat16),
            (WINDOW_RING_SHAPE, WINDOW_RING_LENS, WINDOW, torch.bfloat16),
            (WINDOW_RING_SHAPE, WINDOW_RING_TIMED_LENS, WINDOW,
             torch.bfloat16),
            ((3, 8, 2, 32, 8, 4), (40, 45, 70), 10, torch.float32),
            ((3, 8, 2, 32, 8, 4), (33, 64, 97), 20, torch.bfloat16),
            ((2, 4, 1, 128, 16, 6), (5, 200), 50, torch.float32))):
        args = attention_inputs(torch, dev, *shape, dtype, 40 + seed, lens)
        worst = max(worst, attention_err(torch, *args, window=window))
        cases += 1
    q, kp, vp, bt, lens = attention_inputs(
        torch, dev, *WINDOW_RING_SHAPE, torch.float32, 50, WINDOW_RING_LENS)
    gap = float((ops.paged_decode(q, kp, vp, bt, lens, window=WINDOW) -
                 ops.paged_decode(q, kp, vp, bt, lens.clamp(
                     max=bt.shape[1] * kp.shape[1]))).abs().max())
    check(gap > 1e-3, f"the window masked nothing on the wrapped ring ({gap})")
    check(PA.paged_attention.window_launches >= before + cases + 1,
          "the windowed checks did not launch the windowed instantiation")
    emit({"phase": "kernel_vs_plain", "kernel": "paged_attention_window",
          "cases": cases, "window": WINDOW, "tolerance": ATTN_TOL,
          "max_abs_err": worst, "window_vs_full_gap": gap})
    return {"paged_attention_window": worst}


def check_page_ops(torch, dev):
    """page_set / page_copy / page_gather == their plain versions on the
    card, array equal: the reference test's pool and pairs, a chained pair
    (``[[0,3],[3,5]]``: page 5 gets the old page 3), a duplicate
    destination (``[[0,3],[1,3]]``: the last pair wins), random pairs with
    repeats, on an f32 pool and on a layered bf16 pool of the serving
    shape; ``STAGED_PAIRS`` random pairs on the f32 pool (the staged
    route); page_set on two pools in one launch; page_gather with a table
    of 8 pages holding a repeated id on the f32 pool and on the serve K
    pool's shape (36, 1, 65, 64, 8, 128) in bf16."""
    from repro_torch.kernels.page_ops import ops, page_ops
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    pools = [torch.randn((8, 16, 2, 32), generator=g, device=dev),
             torch.randn((3, 1, 65, 64, 8, 128), generator=g,
                         device=dev).to(torch.bfloat16)]
    pair_sets = [[[0, 3], [5, 7]], [[0, 3], [3, 5]], [[0, 3], [1, 3]],
                 torch.randint(0, 8, (16, 2), generator=g, device=dev).tolist()]
    id_sets = [[1, 4], [4, 4, 2], [7]]
    cases = {"page_set": 0, "page_copy": 0, "page_gather": 0}
    for pool in pools:
        for op, args_list in (("page_copy", pair_sets),
                              ("page_set", id_sets)):
            for args in args_list:
                a = torch.tensor(args, dtype=torch.int32, device=dev)
                got, want = pool.clone(), pool.clone()
                if op == "page_copy":
                    ops.page_copy(got, a)
                    ops.page_copy(want, a, impl="ref")
                else:
                    ops.page_set(got, a, 0.0)
                    ops.page_set(want, a, 0.0, impl="ref")
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"{op} {args} on {tuple(pool.shape)}: the kernel "
                      f"differs from the plain version")
                cases[op] += 1
        # the documented semantics, directly
        got = pool.clone()
        ops.page_copy(got, torch.tensor([[0, 3], [3, 5]], dtype=torch.int32,
                                        device=dev))
        check(torch.equal(got[..., 5, :, :, :], pool[..., 3, :, :, :]) and
              torch.equal(got[..., 3, :, :, :], pool[..., 0, :, :, :]),
              "page_copy: a chained pair did not read the old source")
    serve_pool = torch.randn((36, 1, 65, 64, 8, 128), generator=g,
                             device=dev).to(torch.bfloat16)
    for pool, ids in ((pools[0], (5, 7, 0, 3, 5, 1, 2, 6)),
                      (serve_pool, GATHER_TABLE)):
        table = torch.tensor(ids, dtype=torch.int32, device=dev)
        got = ops.page_gather(pool, table)
        want = ops.page_gather(pool, table, impl="ref")
        torch.cuda.synchronize()
        check(got.shape == want.shape and torch.equal(got, want),
              f"page_gather on {tuple(pool.shape)}: the kernel differs "
              f"from the plain version")
        cases["page_gather"] += 1
    # past the one-grid limit: the staged route, with repeated sources and
    # destinations (the last pair of each destination wins)
    check(page_ops.copy_route(STAGED_PAIRS) == "staged",
          f"{STAGED_PAIRS} pairs do not take the staged route")
    pairs = torch.randint(0, 8, (STAGED_PAIRS, 2), generator=g, device=dev,
                          dtype=torch.int32)
    got, want = pools[0].clone(), pools[0].clone()
    ops.page_copy(got, pairs)
    ops.page_copy(want, pairs, impl="ref")
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"page_copy of {STAGED_PAIRS} pairs: the "
          "kernel differs from the plain version")
    cases["page_copy"] += 1
    # both pools of a step in one launch
    for pool in pools:
        a = torch.tensor([4, 1, 4], dtype=torch.int32, device=dev)
        got = (pool.clone(), pool.clone() + 1)
        want = tuple(t.clone() for t in got)
        ops.page_set(got, a, 0.0)
        ops.page_set(want, a, 0.0, impl="ref")
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"page_set on two pools {tuple(pool.shape)}: the kernel "
              "differs from the plain version")
        cases["page_set"] += 1
    one = torch.tensor([1], dtype=torch.int32)
    for bad in (lambda: page_ops.page_set(pools[0].cpu(), one, 0.0),
                lambda: page_ops.page_set(pools[0], torch.tensor(
                    [1], device=dev), 0.0),
                lambda: page_ops.page_set((pools[0], pools[1]), torch.tensor(
                    [1], dtype=torch.int32, device=dev), 0.0),
                lambda: page_ops.page_copy(pools[0], torch.tensor(
                    [1, 2], dtype=torch.int32, device=dev)),
                lambda: page_ops.page_gather(pools[0].cpu(), one),
                lambda: page_ops.page_gather(pools[0], table.long()),
                lambda: page_ops.page_gather(pools[0].transpose(1, 2),
                                             table)):
        try:
            bad()
        except ValueError:
            continue
        fail("a page-op wrapper accepted an input it must refuse")
    for op, n in cases.items():
        emit({"phase": "kernel_vs_plain", "kernel": op, "cases": n,
              "tolerance": 0, "max_abs_err": 0.0, "equal": True})
    return dict.fromkeys(cases, 0.0)


def time_walk_fetch(torch, tgt, worst):
    """The kernel and its plain version at the main path's shape, on the
    image, ``satp`` and program counters the full-width run left behind."""
    from repro_torch.kernels.page_walk import ops

    st = tgt.st
    mask = tgt.mem_bytes - 1
    bw = tgt.block_words
    lanes = tgt.nc
    active = torch.ones((lanes,), dtype=torch.bool, device=st.device)
    args = (st.mem, st.satp, st.pc, mask, bw, None, active)
    got = ops.walk_fetch_block(*args)
    want = ops.walk_fetch_block(*args, impl="ref")
    torch.cuda.synchronize()
    worst = max(worst, compare_outputs(torch, got, want, "main-path shape"))
    check(not bool(got[1].any()), "main-path shape: a final pc faults")
    ms = time_ms(torch, lambda: ops.walk_fetch_block(*args), 2000)
    plain_ms = time_ms(torch, lambda: ops.walk_fetch_block(*args,
                                                           impl="ref"), 100)
    return dict(shape=dict(W=int(st.mem.shape[0]), L=lanes, block_words=bw),
                ms=ms, plain_ms=plain_ms,
                bound_ms=walk_fetch_bound_ms(torch, got, lanes, bw, active),
                max_abs_err=worst)


# ---------------------------------------------------------------------------
# end-to-end phases: the FASE path
# ---------------------------------------------------------------------------
class target_class:
    """Within the block, ``run_workload`` builds its target from ``cls``
    (a ``TorchTarget`` subclass that watches its chunks)."""

    def __init__(self, cls):
        self.cls = cls

    def __enter__(self):
        import repro_torch.run as run_mod
        self.old, run_mod.TorchTarget = run_mod.TorchTarget, self.cls

    def __exit__(self, *exc):
        import repro_torch.run as run_mod
        run_mod.TorchTarget = self.old


def chase_ns(torch, words, span, dev):
    """Mean latency of one dependent load, in ns: one thread follows a
    seeded random cycle through ``span`` words of a ``words``-word image
    (``CHASE_STEPS`` links, timed by CUDA events, after a warm pass)."""
    import ctypes
    import numpy as np
    from repro_torch.kernels import _build
    fn = _build.entry("run_chunk", "run_chunk_chase_launch",
                      [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p])
    order = np.random.RandomState(7).permutation(span)
    nxt = np.zeros(words, dtype=np.int64)
    nxt[order] = np.roll(order, -1)
    nxt = torch.from_numpy(nxt).to(dev)
    out = torch.zeros((1,), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (nxt.data_ptr(), int(order[0]), CHASE_STEPS, out.data_ptr(),
            stream)
    _build.launch("chase", fn, args, dev)              # warm
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    _build.launch("chase", fn, args, dev)
    t1.record()
    torch.cuda.synchronize()
    check(int(out) == int(order[CHASE_STEPS % span]),
          "pointer chase ended on the wrong word")
    return t0.elapsed_time(t1) * 1e6 / CHASE_STEPS


def phase_latency(torch, dev, words):
    """The dependent-load latency the chunk kernel's bound uses: a chase
    inside one 4 KiB page (resident near the SM, as the hot words of a
    guest loop are) and across the whole image (device memory)."""
    out = {"page_ns": chase_ns(torch, words, 512, dev),
           "image_ns": chase_ns(torch, words, words, dev)}
    emit({"phase": "load_latency", "steps": CHASE_STEPS, "words": words,
          **out})
    return out


def state_fields(st):
    from repro_torch.core.target.cpu import STATE_FIELDS
    return {name: getattr(st, name) for name in STATE_FIELDS}


def compare_states(torch, got, want, what):
    for name, w in want.items():
        g = got[name]
        if not torch.equal(g, w):
            bad = (g != w).nonzero()[:4].tolist()
            fail(f"{what}: {name} differs at {bad}")


#: the commit-trace ring's state fields: the only ones an armed run may
#: hold apart from an unarmed run of the same guest
RING_FIELDS = ("tracebuf", "trace_n", "trace_armed")


class _EagerCut(Exception):
    """Raised by the eager route's target once it has run the substeps it
    was given (``routes_in_lockstep``'s ``eager_substeps``)."""

    def __init__(self, target):
        super().__init__("eager route cut")
        self.target = target


def routes_in_lockstep(torch, name, argv, pins, on_report=None,
                       target_opts=None, eager=True, keep=None, also=None,
                       eager_substeps=None, **kw):
    """``name`` on both routes of the interpreter: the chunk kernel first,
    each chunk's state kept on the card; then the eager loop with the
    standalone walk kernel, each chunk's state and substep count held
    against the kernel route's.  Each route must hit ``pins``, and
    ``on_report(route, report)`` is called with each route's report.
    ``target_opts`` go to both routes' targets (``block_cache=False``).
    With ``telemetry=`` in ``kw`` the ring is armed, the kernel route
    launches the traced instantiation and every state field compared
    includes ``tracebuf``/``trace_n``/``trace_armed``.  ``eager=False``
    runs the kernel route alone, its chunks appended to the list ``keep``;
    ``also`` (such a list, of an unarmed kernel route) holds the eager
    route against a second kernel route after every chunk too, on every
    field but :data:`RING_FIELDS`.  ``eager_substeps`` cuts the eager
    route's depth: it stops at the end of the chunk that takes it to that
    many substeps, every chunk up to there held as above (its pins and
    report are then the kernel route's alone).  Returns the launches each
    route made and the number of chunks."""
    from repro_torch.core.interface import TorchTarget
    from repro_torch.kernels.page_walk import page_walk
    from repro_torch.kernels.run_chunk.run_chunk import run_chunk
    from repro_torch.run import run_workload
    chunks = [] if keep is None else keep

    class Recording(TorchTarget):
        def run(self, max_cycles=1 << 62):
            before = self.substeps
            super().run(max_cycles)
            chunks.append((self.substeps - before,
                           {k: v.clone() for k, v in
                            state_fields(self.st).items()}))

    class Checking(TorchTarget):
        def run(self, max_cycles=1 << 62):
            before = self.substeps
            super().run(max_cycles)
            i = self.chunks = getattr(self, "chunks", 0) + 1
            check(i <= len(chunks), f"{name}: the eager route ran more "
                  f"chunks than the kernel route's {len(chunks)}")
            sub, want = chunks[i - 1]
            check(self.substeps - before == sub,
                  f"{name} chunk {i}: substeps {self.substeps - before} "
                  f"!= the kernel route's {sub}")
            compare_states(torch, state_fields(self.st), want,
                           f"{name} chunk {i}")
            if also is not None:
                check(i <= len(also), f"{name}: the eager route ran more "
                      f"chunks than the unarmed kernel route's {len(also)}")
                sub, want = also[i - 1]
                check(self.substeps - before == sub,
                      f"{name} chunk {i}: substeps {self.substeps - before}"
                      f" != the unarmed kernel route's {sub}")
                compare_states(torch, state_fields(self.st),
                               {k: v for k, v in want.items()
                                if k not in RING_FIELDS},
                               f"{name} chunk {i} (unarmed kernel route)")
            if eager_substeps is not None and \
                    self.substeps >= eager_substeps and i < len(chunks):
                raise _EagerCut(self)

    out = {}
    routes = (("kernel", Recording, {}),
              ("ref", Checking, dict(chunk_kernel="ref",
                                     fetch_kernel="kernel")))
    for route, cls, opts in routes if eager else routes[:1]:
        opts = {**(target_opts or {}), **opts}
        with target_class(cls):
            run_chunk.launches = 0                  # just before the path
            run_chunk.trace_launches = 0
            page_walk.walk_fetch_block.launches = 0
            t0 = time.time()
            try:
                rt, rep, wall = run_workload(name, argv, device="cuda",
                                             target_opts=opts, **kw)
                tgt = rt.target
            except _EagerCut as cut:
                torch.cuda.synchronize()
                rep, wall, tgt = None, time.time() - t0, cut.target
            launches = dict(run_chunk=run_chunk.launches,
                            run_chunk_trace=run_chunk.trace_launches,
                            walk_fetch_block=page_walk.walk_fetch_block
                            .launches)               # just after it
        got = {} if rep is None else dict(
            ticks=rep.ticks, instret=sum(rep.instret),
            traffic=rep.traffic_total, stdout=rep.stdout.decode())
        emit({"phase": f"{name}_{kw.get('link') or 'uart'}", "route": route,
              **({"target_opts": target_opts} if target_opts else {}),
              **{k: got[k] for k in pins if k in got},
              **({} if rep else {"cut_after_chunks": tgt.chunks}),
              "substeps": tgt.substeps, "launches": launches,
              "wall_s": round(wall, 3),
              "s_per_substep": wall / tgt.substeps})
        if rep is not None:
            for k, v in pins.items():
                check(got[k] == v, f"{name} on the {route} route: {k} "
                      f"{got[k]!r} != {v!r}")
            if on_report is not None:
                on_report(route, rep)
        traced = "telemetry" in kw
        used, unused = (("run_chunk_trace", "run_chunk") if traced else
                        ("run_chunk", "run_chunk_trace"))
        if route == "kernel":
            check(launches["walk_fetch_block"] == 0,
                  "the kernel route launched the standalone walk kernel")
            check(launches[used] == len(chunks) > 0 and
                  launches[unused] == 0,
                  f"{launches} chunk launches for {len(chunks)} chunks")
        else:
            ran = getattr(tgt, "chunks", 0)
            check((ran == len(chunks) if rep else 0 < ran < len(chunks))
                  and (also is None or len(also) == len(chunks)),
                  f"{name}: the eager route ran {ran} chunks, the kernel "
                  f"route {len(chunks)}")
            check(launches["run_chunk"] == launches["run_chunk_trace"] == 0,
                  "the eager route launched the chunk kernel")
            check(launches["walk_fetch_block"] == tgt.substeps,
                  "the eager route did not walk once a substep")
        out[route] = launches
    return out, len(chunks)


HELLO_PINS = dict(ticks=HELLO_UART["ticks"],
                  stdout=HELLO_UART["stdout"].decode())


def bc_pcie_run():
    """bc@PCIe 2T's argv and ``run_workload`` keywords (the pin's run)."""
    from repro_torch.core.workloads import graphgen
    g = graphgen.rmat(4, 4, weights=True)
    return ["g.bin", "2", "1"], dict(link="pcie", n_cores=2, mem=1 << 22,
                                     files={"g.bin": g})


def phase_chunk(torch, bc_chunks=None):
    """hello@UART and bc@PCIe 2T on both routes, state equal after every
    chunk; returns the standalone walk kernel's launches on the eager
    route.  Given a list ``bc_chunks``, bc runs on the kernel route alone
    and its chunks go there: the ``telemetry`` phase's armed eager run is
    then held against them after every chunk it runs (one eager bc run,
    cut to ``BC_EAGER_SUBSTEPS``, instead of two whole ones of some 90-160
    s each on the card's host)."""
    t0 = time.time()
    hello, n_hello = routes_in_lockstep(
        torch, "hello", [], HELLO_PINS, mode="fase", n_cores=1, mem=1 << 22)
    argv, kw = bc_pcie_run()
    bc, n_bc = routes_in_lockstep(
        torch, "bc", argv, BC_PCIE, mode="fase", eager=bc_chunks is None,
        keep=bc_chunks, **kw)
    walks = hello["ref"]["walk_fetch_block"] + \
        bc.get("ref", {}).get("walk_fetch_block", 0)
    emit({"phase": "chunk_vs_plain", "workloads": ["hello@uart", "bc@pcie"],
          "chunks": n_hello + n_bc, "fields_equal_after_every_chunk": True,
          "tolerance": 0, "walk_fetch_block_launches_eager": walks,
          **({"bc_eager_route": "telemetry_goldens: its armed eager run, "
                                "held against this kernel route's chunks "
                                f"to {BC_EAGER_SUBSTEPS} substeps"}
             if bc_chunks is not None else {}),
          "seconds": round(time.time() - t0, 1)})
    from repro_torch.kernels.run_chunk import run_chunk as RC
    RC.run_chunk.cluster_launches = RC.run_chunk.cluster_trace_launches = 0
    wide_boards(torch)
    return walks, (RC.run_chunk.cluster_launches,
                   RC.run_chunk.cluster_trace_launches)


#: boards past one warp (the chunk kernels' CTA-wide instantiation): the
#: atomics/MMU program of tests/test_torch_gpu.py on every core, in 97-tick
#: chunks, against the eager loop (on the host) after every chunk
WIDE_CORES = (40, 64)
WIDE_MEM = 1 << 21
WIDE_CHUNK = 97
WIDE_PROGRAM = """
_start:
    la s0, counter
    li t1, 12
loop:
    amoadd.d t2, t1, (s0)
    amoadd.w t3, t1, (s0)
    lr.d t4, (s0)
    addi t4, t4, 1
    sc.d t5, t4, (s0)
    amomax.d t6, a0, (s0)
    amominu.w s1, t1, (s0)
    la s2, bytes_area
    add s3, s2, a0
    sb t1, 0(s3)
    lb s4, 0(s3)
    sh t1, 8(s2)
    lhu s5, 8(s2)
    mul s6, t1, t3
    divu s7, s6, t1
    rem s8, s6, t1
    mulh s9, s6, t3
    addi t1, t1, -1
    bnez t1, loop
    li a7, 93
    ecall
.data
counter: .dword 0
bytes_area: .zero 64
"""


#: the eager loop's states after every chunk, by core count (both phases)
_WIDE_EAGER = {}


def load_wide(t, img, nc):
    """``img`` on ``nc`` cores of ``t`` behind a 3-level Sv39 table (root,
    l1, l0 at pages 2, 3, 4; vpn 16..95 and 256..271 identity, RWXU), core
    ``c`` with a0 = c."""
    from repro_torch.core.target import isa
    for seg in img.segments:
        data = bytes(seg.data).ljust((len(seg.data) + 7) // 8 * 8, b"\0")
        for i in range(0, len(data), 8):
            t.mem_write_word(seg.vaddr + i,
                             int.from_bytes(data[i:i + 8], "little"))
    flags = (isa.PTE_V | isa.PTE_R | isa.PTE_W | isa.PTE_X | isa.PTE_U |
             isa.PTE_A | isa.PTE_D)
    t.mem_write_word(2 * 4096, (3 << 10) | isa.PTE_V)
    t.mem_write_word(3 * 4096, (4 << 10) | isa.PTE_V)
    for vpn0 in list(range(16, 96)) + list(range(256, 272)):
        t.mem_write_word(4 * 4096 + vpn0 * 8, (vpn0 << 10) | flags)
    for c in range(nc):
        t.set_satp(c, (8 << 60) | 2)
        t.reg_write(c, 10, c)
        t.redirect(c, img.entry)


def wide_run(torch, targets, nc, step_all, on_chunk):
    """Chunks of every target until every core has parked: ``step_all``
    runs one chunk of each, ``on_chunk(i)`` compares; each exit is
    cleared and parked as the runtime would."""
    for i in range(400):
        step_all()
        on_chunk(i)
        for t in targets:
            for c in t.pending_cores():
                t.clear_pending(c)
                t.park(c)
        if all(t.get_priv(c) == 3 for t in targets for c in range(nc)):
            return i + 1
    fail(f"wide board of {nc} cores: the program did not finish")


def wide_boards(torch, fleet=False):
    """Boards of ``WIDE_CORES`` cores on the chunk kernel's CTA-wide
    instantiation (untraced and traced), or with ``fleet`` on the fleet
    kernel (two boards in one launch a global chunk), each held field for
    field against the eager loop after every chunk: the eager loop runs
    on the host with the ring armed (4096 slots, no wrap), its states are
    kept, and every kernel run is compared with them (the untraced one on
    every field but the ring's)."""
    from repro_torch.core.fleet.vmap import FleetTarget
    from repro_torch.core.interface import TorchTarget
    from repro_torch.core.target import asm
    from repro_torch.kernels.run_chunk import run_chunk as RC
    img = asm.assemble(WIDE_PROGRAM)
    out = {}
    for nc in WIDE_CORES:
        t0 = time.time()
        if nc not in _WIDE_EAGER:
            eager = TorchTarget(nc, WIDE_MEM, device="cpu")
            eager.trace_arm(4096)
            load_wide(eager, img, nc)
            states = []
            wide_run(torch, [eager], nc,
                     lambda: eager.run(max_cycles=WIDE_CHUNK),
                     lambda i: states.append({k: v.clone() for k, v in
                                              state_fields(eager.st).items()}))
            _WIDE_EAGER[nc] = (states, eager.substeps, time.time() - t0)
        want, subs, eager_s = _WIDE_EAGER[nc]
        runs = {}
        if fleet:
            ft = FleetTarget(2, nc, WIDE_MEM, device="cuda")
            views = [ft.view(d) for d in range(2)]
            for v in views:
                load_wide(v, img, nc)
            before = RC.run_chunk_fleet.launches

            def cmp_fleet(i):
                for v in views:
                    got = {k: x.cpu() for k, x in state_fields(v.st).items()
                           if not k.startswith("trace")}
                    compare_states(torch, got, {k: w for k, w in
                                                want[i].items()
                                                if k in got},
                                   f"fleet kernel, {nc} cores, board "
                                   f"{v.d}, chunk {i}")
            n = wide_run(torch, views, nc,
                         lambda: ft.run_global([WIDE_CHUNK] * 2), cmp_fleet)
            check(n == len(want) and
                  RC.run_chunk_fleet.launches - before == n,
                  f"fleet kernel at {nc} cores: {n} global chunks")
            runs["fleet"] = n
        else:
            for traced in (False, True):
                t = TorchTarget(nc, WIDE_MEM, device="cuda")
                if traced:
                    t.trace_arm(4096)
                load_wide(t, img, nc)
                counter = "trace_launches" if traced else "launches"
                before = getattr(RC.run_chunk, counter)

                def cmp_chunk(i, t=t, traced=traced):
                    got = {k: x.cpu() for k, x in state_fields(t.st).items()
                           if traced or not k.startswith("trace")}
                    compare_states(torch, got, {k: want[i][k] for k in got},
                                   f"run_chunk {'traced' if traced else ''}"
                                   f", {nc} cores, chunk {i}")
                n = wide_run(torch, [t], nc,
                             lambda t=t: t.run(max_cycles=WIDE_CHUNK),
                             cmp_chunk)
                check(n == len(want) and t.substeps == subs and
                      getattr(RC.run_chunk, counter) - before == n,
                      f"run_chunk at {nc} cores (traced={traced}): {n} "
                      f"chunks, {t.substeps} substeps, eager {subs}")
                runs["traced" if traced else "untraced"] = n
        out[nc] = {"chunks": runs, "eager_substeps": subs,
                   "instret": sum(int(x) for x in want[-1]["instret"]),
                   "eager_host_s": round(eager_s, 1),
                   "seconds": round(time.time() - t0, 1)}
    emit({"phase": "wide_boards", "kernel": "run_chunk_fleet" if fleet
          else "run_chunk", "cores": list(WIDE_CORES),
          "fields_equal_after_every_chunk": True, "tolerance": 0,
          "boards": out})
    cluster_boards(torch, fleet)


#: boards past one CTA (the chunk kernels' cluster instantiation: 384
#: cores a CTA at the registry's knobs, so 2 and 3 CTAs), against the
#: eager route on the card after every chunk; 500 cores also traced, and
#: as a fleet of two boards
CLUSTER_CORES = (500, 1025)
#: the atomics program of WIDE_PROGRAM cut for wide boards: core c works
#: on cell c % 64 (AMOs, LR/SC) and on byte (c // 64) % 8 of word c % 64
#: of a byte area, so cores 64 apart -- across the CTAs of the cluster
#: too -- race on one word in every tick while a substep still commits 64
#: cores (the eager route pays ~9 ms a substep on the card); two trips
CLUSTER_PROGRAM = """
_start:
    la s0, counter
    andi t0, a0, 63
    slli t0, t0, 3
    add s0, s0, t0
    la s2, bytes_area
    add s2, s2, t0
    srli t2, a0, 6
    andi t2, t2, 7
    add s3, s2, t2
    li t1, 2
loop:
    amoadd.d t2, t1, (s0)
    amoadd.w t3, t1, (s0)
    lr.d t4, (s0)
    addi t4, t4, 1
    sc.d t5, t4, (s0)
    amomax.d t6, a0, (s0)
    amominu.w s1, t1, (s0)
    sb t1, 0(s3)
    lb s4, 0(s3)
    lhu s5, 0(s2)
    mul s6, t1, t3
    divu s7, s6, t1
    rem s8, s6, t1
    mulh s9, s6, t3
    addi t1, t1, -1
    bnez t1, loop
    li a7, 93
    ecall
.data
counter: .zero 512
bytes_area: .zero 512
"""
#: ticks a chunk of the cluster boards (about twenty chunks a run)
CLUSTER_CHUNK = 13
#: boards on clusters of one-warp CTAs, through the wrappers' own
#: ``cta_lanes`` argument at 32: 512 cores on 16 CTAs (the most the
#: source launches, a non-portable cluster) on ``run_chunk``, and 288
#: cores on 9 CTAs (one past the portable 8) a board of a 2-board fleet
WARP_CTA_CORES = 512
WARP_CTA_FLEET_CORES = 288
#: the eager route's states after every chunk, by core count
_CLUSTER_EAGER = {}


def cluster_eager(torch, img, nc):
    """``(states, substeps, seconds)`` of ``img`` on ``nc`` cores on the
    eager route on the card (ring armed): the state after every chunk of
    ``CLUSTER_CHUNK`` ticks; run once a core count."""
    from repro_torch.core.interface import TorchTarget
    if nc not in _CLUSTER_EAGER:
        t0 = time.time()
        eager = TorchTarget(nc, WIDE_MEM, device="cuda", chunk_kernel="ref")
        eager.trace_arm(TRACE_SLOTS)
        load_wide(eager, img, nc)
        states = []
        wide_run(torch, [eager], nc,
                 lambda: eager.run(max_cycles=CLUSTER_CHUNK),
                 lambda i: states.append({
                     k: v.to("cpu", copy=True)
                     for k, v in state_fields(eager.st).items()}))
        _CLUSTER_EAGER[nc] = (states, eager.substeps, time.time() - t0)
    return _CLUSTER_EAGER[nc]


def warp_cta_board(torch, img, fleet):
    """``WARP_CTA_CORES`` cores on ``run_chunk``, or with ``fleet`` two
    boards of ``WARP_CTA_FLEET_CORES`` on ``run_chunk_fleet``, called
    with ``cta_lanes=32`` (clusters of 16 and 9 one-warp CTAs, past the
    portable size), every field equal to the eager route on the card
    after every chunk, one cluster launch a chunk."""
    from repro_torch.core.fleet.vmap import FleetTarget
    from repro_torch.core.interface import TorchTarget
    from repro_torch.kernels.run_chunk import run_chunk as RC
    nc = WARP_CTA_FLEET_CORES if fleet else WARP_CTA_CORES
    t0 = time.time()
    want, subs, eager_s = cluster_eager(torch, img, nc)
    if fleet:
        ft = FleetTarget(2, nc, WIDE_MEM, device="cuda")
        targets = [ft.view(d) for d in range(2)]
        wrapper = RC.run_chunk_fleet

        def step():
            RC.run_chunk_fleet(ft.sts, nc, WIDE_MEM, [CLUSTER_CHUNK] * 2,
                               ft.issue_width, ft.block_words,
                               ft.block_cache, ft.dtlb_ways,
                               cta_lanes=RC.WARP_LANES)
    else:
        t = TorchTarget(nc, WIDE_MEM, device="cuda")
        targets = [t]
        wrapper = RC.run_chunk

        def step():
            RC.run_chunk(t.st, nc, WIDE_MEM, CLUSTER_CHUNK, t.issue_width,
                         t.block_words, t.block_cache, t.dtlb_ways,
                         cta_lanes=RC.WARP_LANES)
    for v in targets:
        load_wide(v, img, nc)
    before = wrapper.cluster_launches

    def cmp_chunk(i):
        for d, v in enumerate(targets):
            got = {k: x.cpu() for k, x in state_fields(v.st).items()
                   if not k.startswith("trace")}
            compare_states(torch, got, {k: want[i][k] for k in got},
                           f"{wrapper.__name__} at cta_lanes 32, {nc} "
                           f"cores, board {d}, chunk {i}")
    n = wide_run(torch, targets, nc, step, cmp_chunk)
    check(n == len(want) and wrapper.cluster_launches - before == n,
          f"{wrapper.__name__} at cta_lanes 32, {nc} cores: {n} chunks, "
          f"eager {len(want)}")
    return {"chunks": {"fleet" if fleet else "untraced": n},
            "eager_substeps": subs,
            "instret": sum(int(x) for x in want[-1]["instret"]),
            "cta_lanes": RC.WARP_LANES, "ctas": -(-nc // RC.WARP_LANES),
            "eager_card_s": round(eager_s, 1),
            "seconds": round(time.time() - t0, 1)}


def cluster_boards(torch, fleet=False):
    """Boards of ``CLUSTER_CORES`` cores on the chunk kernels' cluster
    instantiation -- one launch a chunk, counted in
    ``cluster_launches`` -- or with ``fleet`` two boards of 500 cores on
    the fleet kernel (one cluster a board, one launch a global chunk),
    each held field for field against the eager route on the card
    (``chunk_kernel="ref"``, ring armed) after every chunk; then
    :func:`warp_cta_board`."""
    from repro_torch.core.fleet.vmap import FleetTarget
    from repro_torch.core.interface import TorchTarget
    from repro_torch.core.target import asm
    from repro_torch.kernels.run_chunk import run_chunk as RC
    img = asm.assemble(CLUSTER_PROGRAM)
    out = {}
    for nc in CLUSTER_CORES[:1] if fleet else CLUSTER_CORES:
        t0 = time.time()
        want, subs, eager_s = cluster_eager(torch, img, nc)
        runs = {}
        if fleet:
            ft = FleetTarget(2, nc, WIDE_MEM, device="cuda")
            views = [ft.view(d) for d in range(2)]
            for v in views:
                load_wide(v, img, nc)
            before = RC.run_chunk_fleet.cluster_launches

            def cmp_fleet(i):
                for v in views:
                    got = {k: x.cpu() for k, x in state_fields(v.st).items()
                           if not k.startswith("trace")}
                    compare_states(torch, got, {k: want[i][k] for k in got},
                                   f"fleet cluster, {nc} cores, board "
                                   f"{v.d}, chunk {i}")
            n = wide_run(torch, views, nc,
                         lambda: ft.run_global([CLUSTER_CHUNK] * 2), cmp_fleet)
            check(n == len(want) and
                  RC.run_chunk_fleet.cluster_launches - before == n,
                  f"fleet cluster at {nc} cores: {n} global chunks")
            runs["fleet"] = n
        else:
            for traced in (False, True)[:2 if nc == CLUSTER_CORES[0] else 1]:
                t = TorchTarget(nc, WIDE_MEM, device="cuda")
                if traced:
                    t.trace_arm(TRACE_SLOTS)
                load_wide(t, img, nc)
                counter = "cluster_trace_launches" if traced else \
                    "cluster_launches"
                before = getattr(RC.run_chunk, counter)

                def cmp_chunk(i, t=t, traced=traced):
                    got = {k: x.cpu() for k, x in state_fields(t.st).items()
                           if traced or not k.startswith("trace")}
                    compare_states(torch, got, {k: want[i][k] for k in got},
                                   f"run_chunk cluster "
                                   f"{'traced ' if traced else ''}, {nc} "
                                   f"cores, chunk {i}")
                n = wide_run(torch, [t], nc,
                             lambda t=t: t.run(max_cycles=CLUSTER_CHUNK),
                             cmp_chunk)
                check(n == len(want) and t.substeps == subs and
                      getattr(RC.run_chunk, counter) - before == n,
                      f"run_chunk cluster at {nc} cores (traced={traced}): "
                      f"{n} chunks, {t.substeps} substeps, eager {subs}")
                runs["traced" if traced else "untraced"] = n
        out[nc] = {"chunks": runs, "eager_substeps": subs,
                   "instret": sum(int(x) for x in want[-1]["instret"]),
                   "ctas": -(-nc // RC.default_cta_lanes(16, 8)),
                   "eager_card_s": round(eager_s, 1),
                   "seconds": round(time.time() - t0, 1)}
    out[f"{WARP_CTA_FLEET_CORES if fleet else WARP_CTA_CORES}"
        f"@cta_lanes=32"] = warp_cta_board(torch, img, fleet)
    emit({"phase": "cluster_boards", "kernel": "run_chunk_fleet" if fleet
          else "run_chunk", "fields_equal_after_every_chunk": True,
          "tolerance": 0, "boards": out})


def time_cluster(torch):
    """The three cluster instantiations at 1 025 cores (three CTAs of 384)
    on the guest loop of ``loop_target``, each against its plain version
    from the same state: ``run_chunk`` and its traced instantiation on
    one board, ``run_chunk_fleet`` on two.  ms by CUDA events over
    back-to-back chunks of ``CHUNK_CYCLES`` ticks; plain ms one chunk of
    the eager route on the card (host clock ending in a synchronise);
    bound the state's bytes read and written once at the HBM rate."""
    from repro_torch.core.fleet.vmap import FleetTarget
    from repro_torch.core.target import cpu
    nc = CLUSTER_CORES[-1]
    t = loop_target(torch, nc, WIDE_MEM)
    t.run(max_cycles=CHUNK_CYCLES)                   # past the start-up
    ft = FleetTarget(2, nc, WIDE_MEM, device="cuda")
    for d in range(2):
        for name, v in state_fields(t.st).items():
            getattr(ft.view(d).st, name).copy_(v)
    out = {}
    for name in ("run_chunk_cluster", "run_chunk_trace_cluster",
                 "run_chunk_fleet_cluster"):
        fleet, traced = "fleet" in name, "trace" in name
        if traced:
            t.trace_arm(TRACE_SLOTS)

        def fields():
            st = ft.sts if fleet else t.st
            return {k: v.clone() for k, v in state_fields(st).items()}

        def chunk(route):
            if fleet:
                return cpu.run_chunk_fleet(
                    ft.sts, nc, WIDE_MEM, [CHUNK_CYCLES] * 2, ft.issue_width,
                    ft.block_words, ft.block_cache, ft.fetch_kernel,
                    ft.dtlb_ways, route)
            return cpu.run_chunk_fast(
                t.st, nc, WIDE_MEM, CHUNK_CYCLES, t.issue_width,
                t.block_words, t.block_cache, t.fetch_kernel, traced, None,
                dtlb_ways=t.dtlb_ways, chunk_kernel=route)
        snap = fields()
        sub_k = chunk("kernel")
        got = fields()
        st = ft.sts if fleet else t.st
        for k, v in snap.items():
            getattr(st, k).copy_(v)
        torch.cuda.synchronize()
        t0 = time.time()
        sub_r = chunk("ref")
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        check(sub_k == sub_r, f"{name}: substeps {sub_k} != {sub_r}")
        compare_states(torch, got, state_fields(st), f"{name} timed chunk")
        ms = time_ms(torch, lambda: chunk("kernel"), 10, warmup=2)
        nbytes = 2 * sum(v.numel() * v.element_size() for k, v in
                         state_fields(st).items() if k != "mem")
        subs = sub_k[0] if fleet else sub_k
        out[name] = dict(shape=dict(L=nc, D=2 if fleet else 1,
                                    chunk_cycles=CHUNK_CYCLES,
                                    substeps=subs),
                         ms=ms, us_per_substep=ms * 1e3 / subs,
                         plain_ms=plain_ms,
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                         max_abs_err=0.0)
    emit({"phase": "cluster_timing", **out})
    return out


def state_bytes(st):
    return sum(v.numel() * v.element_size()
               for k, v in state_fields(st).items() if k != "mem")


def time_run_chunk(torch, tgt, latency):
    """The chunk kernel and its plain version (the eager loop) on one
    chunk of ``CHUNK_CYCLES`` ticks at the full-width shape, from the same
    state; then the kernel back to back on equal chunks."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.fase_rocket import target_kwargs
    from repro_torch.configs.registry import FASE_ROCKET_PCIE as cfg
    from repro_torch.core.target import cpu
    from repro_torch.kernels.run_chunk.run_chunk import run_chunk
    t = loop_target(torch, tgt.nc, tgt.mem_bytes, **target_kwargs(cfg))
    t.run(max_cycles=CHUNK_CYCLES)                   # past the start-up
    snap = {k: v.clone() for k, v in state_fields(t.st).items()}

    def chunk(route):
        return cpu.run_chunk_fast(
            t.st, t.nc, t.mem_bytes, CHUNK_CYCLES, t.issue_width,
            t.block_words, t.block_cache, t.fetch_kernel,
            dtlb_ways=t.dtlb_ways, chunk_kernel=route)

    trips0 = run_chunk.trips
    sub_k = chunk("kernel")
    trips = run_chunk.trips - trips0
    got = {k: v.clone() for k, v in state_fields(t.st).items()}
    for k, v in snap.items():
        v_now = getattr(t.st, k)
        v_now.copy_(v)
    torch.cuda.synchronize()
    t0 = time.time()
    sub_r = chunk("ref")
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    check(sub_k == sub_r, f"timed chunk: substeps {sub_k} != {sub_r}")
    compare_states(torch, got, state_fields(t.st), "timed chunk")
    ms = time_ms(torch, lambda: chunk("kernel"), 50, warmup=5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lead_in(torch)
        for _ in range(20):
            chunk("kernel")
        torch.cuda.synchronize()
    kern = [e for e in device_events(prof.key_averages())
            if "run_chunk" in e.key]
    check(len(kern) == 1 and kern[0].count == 20,
          f"profile: the run_chunk kernel was not traced 20 times: "
          f"{[(e.key, e.count) for e in kern]}")
    dev_ms = kern[0].self_device_time_total / kern[0].count / 1e3
    # bytes: the state fields read once and written once (the image words
    # a chunk touches depend on the data and only raise the bound)
    nbytes = 2 * state_bytes(t.st)
    return dict(shape=dict(W=int(t.st.mem.shape[0]), L=t.nc,
                           chunk_cycles=CHUNK_CYCLES, substeps=sub_k),
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                round_trips=trips,
                latency_bound_ms=trips * latency["page_ns"] * 1e-6,
                max_abs_err=0.0)


def profile_window(torch, tgt, s_per_substep, out_dir, chunks=16):
    """A ``torch.profiler`` window over ``chunks`` chunks of the guest
    loop at the full-width shape (``CHUNK_CYCLES`` * 4 ticks each).
    Writes the by-operator tables under ``out_dir`` and reports launches
    and device time per chunk and per substep, and the device-busy share
    under the profiler and against ``s_per_substep``, the full-width
    run's unprofiled pace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.fase_rocket import target_kwargs
    from repro_torch.configs.registry import FASE_ROCKET_PCIE as cfg
    t = loop_target(torch, tgt.nc, tgt.mem_bytes, **target_kwargs(cfg))
    t.run(max_cycles=CHUNK_CYCLES)                   # warm-up
    before = t.substeps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lead_in(torch)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(chunks):
            t.run(max_cycles=4 * CHUNK_CYCLES)
        torch.cuda.synchronize()
        wall = time.time() - t0
    ka = prof.key_averages()
    on_dev = device_events(ka)
    dev_us = sum(e.self_device_time_total for e in on_dev)
    kern = [e for e in on_dev if "run_chunk" in e.key]
    check(len(kern) == 1, "profile: the run_chunk kernel was not traced")
    launches = sum(e.count for e in ka
                   if e.key == "cudaLaunchKernel") - LEAD_IN_LAUNCHES
    ran = t.substeps - before
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "substep_profile.txt"), "w") as f:
        f.write(ka.table(sort_by="self_cpu_time_total", row_limit=40))
        f.write("\n")
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    # the standalone walk kernel, every lane walking, at the main path's
    # shape: its device time without the wrapper's host cost
    from repro_torch.kernels.page_walk import ops
    st = tgt.st
    args = (st.mem, st.satp, st.pc, tgt.mem_bytes - 1, tgt.block_words,
            None, torch.ones_like(st.pending))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as kprof:
        lead_in(torch)
        for _ in range(200):
            ops.walk_fetch_block(*args)
        torch.cuda.synchronize()
    alone = [e for e in kprof.key_averages()
             if e.device_type == DeviceType.CUDA and
             "walk_fetch_block" in e.key]
    n_alone = sum(e.count for e in alone)
    check(n_alone == 200, f"profile: {n_alone} of 200 "
          f"walk_fetch_block launches traced")
    out = {"phase": "profile", "chunks": chunks, "substeps": ran,
           "wall_s_under_profiler": round(wall, 4),
           "kernel_launches_per_chunk": launches / chunks,
           "run_chunk_launches": kern[0].count,
           "device_us_per_chunk": dev_us / chunks,
           "device_us_per_substep": dev_us / ran,
           "device_busy_share_under_profiler": dev_us / (wall * 1e6),
           "device_busy_share": dev_us / ran / (s_per_substep * 1e6),
           "walk_fetch_block_device_us_all_lanes":
           sum(e.self_device_time_total for e in alone) / n_alone}
    emit(out)
    return out


def full_width_drive(scale):
    """The full-width run's driver: ``drive(telemetry, target)`` runs bc
    4T on rmat(scale, 4) on FASE_ROCKET_PCIE."""
    from repro_torch.configs.fase_rocket import (runtime_kwargs,
                                                 target_kwargs)
    from repro_torch.configs.registry import FASE_ROCKET_PCIE as cfg
    from repro_torch.core.workloads import graphgen
    from repro_torch.run import run_workload
    g = graphgen.rmat(scale, 4, weights=True)

    def drive(telemetry=None, target="torch"):
        return run_workload(
            "bc", ["g.bin", "4", "1"], mode="fase", n_cores=cfg["n_cores"],
            mem=cfg["mem_bytes"], device="cuda", files={"g.bin": g},
            target=target, telemetry=telemetry,
            target_opts=target_kwargs(cfg) if target == "torch" else None,
            **runtime_kwargs(cfg))
    return drive, g


def phase_full(torch, scale, worst, latency, profile_dir):
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.interface import TorchTarget
    from repro_torch.kernels.page_walk import page_walk
    from repro_torch.kernels.run_chunk.run_chunk import run_chunk

    class Counting(TorchTarget):
        def run(self, max_cycles=1 << 62):
            self.runs = getattr(self, "runs", 0) + 1
            super().run(max_cycles)

    pins = FULL_WIDTH[scale]
    drive, _ = full_width_drive(scale)

    torch.cuda.reset_peak_memory_stats()
    with target_class(Counting):
        run_chunk.launches = run_chunk.trips = 0     # just before the path
        page_walk.walk_fetch_block.launches = 0
        rt, rep, wall = drive()
        launches = run_chunk.launches                # just after it
        trips = run_chunk.trips
        walk_launches = page_walk.walk_fetch_block.launches
    tgt = rt.target
    got = dict(ticks=rep.ticks, instret=sum(rep.instret),
               traffic=rep.traffic_total)
    sub = tgt.substeps
    walks = int(tgt.st.fetch_walks.sum())
    check(got == pins, f"full-width run {got} != pinned {pins}")
    check(b"bc_delta0" in rep.stdout, "full-width run: bc printed no result")
    check(tgt.st.mem.is_cuda and tgt.st.mem.shape[0] == 1 << 23,
          "full-width image is not 8 Mi words on the card")
    check(launches > 0, "the main path never launched the run_chunk kernel")
    check(launches == tgt.runs,
          f"chunk launches {launches} != target.run calls {tgt.runs}")
    check(walk_launches == 0,
          "the kernel route launched the standalone walk kernel")
    check(walks > 0, "the full-width run walked no fetch block")
    # the same run again under the profiler: the chunk kernel's device time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lead_in(torch)
        rt2, rep2, _ = drive()
        torch.cuda.synchronize()
    check(rep2.ticks == rep.ticks and rt2.target.substeps == sub,
          "the profiled full-width run differs")
    on_dev = device_events(prof.key_averages())
    kern_us = sum(e.self_device_time_total for e in on_dev
                  if "run_chunk" in e.key)
    dev_us = sum(e.self_device_time_total for e in on_dev)
    emit({"phase": "full_width", "config": "FASE_ROCKET_PCIE",
          "workload": f"bc 4T rmat({scale},4)", "route": "kernel",
          "n_cores": tgt.nc, "mem_bytes": tgt.mem_bytes,
          "image_on": str(tgt.st.mem.device), **got, "substeps": sub,
          "chunks": launches, "wall_s": round(wall, 3),
          "instr_per_s": got["instret"] / wall,
          "s_per_substep": wall / sub,
          "run_chunk_device_us_per_substep": kern_us / sub,
          "run_chunk_device_us_per_chunk": kern_us / launches,
          "device_us_all_kernels": dev_us,
          "host_ms_per_chunk_outside_kernel":
          (wall * 1e6 - kern_us) / launches / 1e3,
          "device_busy_share": dev_us / (wall * 1e6),
          "round_trips": trips, "round_trips_per_substep": trips / sub,
          "latency_bound_s": trips * latency["page_ns"] * 1e-9,
          "walk_fetch_block_launches": walk_launches,
          "fetch_lanes_walked": walks,
          "fetch_hits": int(tgt.st.fetch_hits.sum()),
          "tlb_walks": int(tgt.st.tlb_walks.sum()),
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    timing = time_walk_fetch(torch, tgt, worst)
    chunk_timing = time_run_chunk(torch, tgt, latency)
    emit({"phase": "run_chunk_timing", **chunk_timing})
    if profile_dir:
        profile_window(torch, tgt, wall / sub, profile_dir)
    return launches, timing, chunk_timing


def phase_coremark(torch):
    from repro_torch.kernels.run_chunk.run_chunk import run_chunk
    from repro_torch.run import run_workload
    run_chunk.launches = 0                           # just before the path
    rt, rep, wall = run_workload("coremark", ["1"], mode="fase", n_cores=1,
                                 mem=1 << 22, device="cuda")
    launches = run_chunk.launches                    # just after it
    out = dict(line.split() for line in rep.stdout.decode().splitlines())
    got = dict(ticks=rep.ticks, instret=sum(rep.instret),
               crc=int(out.get("coremark_crc", -1)))
    emit({"phase": "coremark", "route": "kernel", **got,
          "coremark_ns": int(out.get("coremark_ns", -1)),
          "substeps": rt.target.substeps, "chunks": launches,
          "wall_s": round(wall, 3), "instr_per_s": got["instret"] / wall})
    check(got == COREMARK, f"CoreMark {got} != pinned {COREMARK}")
    check(launches > 0, "CoreMark never launched the run_chunk kernel")


# ---------------------------------------------------------------------------
# telemetry: the commit-trace ring, the bridges, triggers and replay
# ---------------------------------------------------------------------------
def pysim_report(name, argv, **kw):
    """``name`` on the port's PySim (the oracle) through run_workload."""
    from repro_torch.run import run_workload
    return run_workload(name, argv, mode="fase", target="pysim", **kw)


def telemetry_goldens(torch, bc_chunks=None):
    """hello@UART and bc@PCIe 2T with both bridges armed on both routes,
    every field (the ring included) equal after every chunk, the pins
    held, every hello record drained, and each report equal to PySim's
    but for the backend model counters.  bc's eager route runs to
    ``BC_EAGER_SUBSTEPS`` (its report and pins are the kernel route's).
    ``bc_chunks`` (the ``chunk`` phase's unarmed kernel route of bc) holds
    the armed eager bc run against that route too, after every chunk, on
    every field but the ring's."""
    from repro_torch.telemetry import without_backend_counters
    bc_argv, bc_kw = bc_pcie_run()
    runs = (("hello", [], HELLO_PINS, dict(n_cores=1, mem=1 << 22)),
            ("bc", bc_argv, BC_PCIE, bc_kw))
    out = {}
    for name, argv, pins, kw in runs:
        reps = {}
        launches, chunks = routes_in_lockstep(
            torch, name, argv, pins,
            on_report=lambda route, rep: reps.__setitem__(route, rep),
            also=bc_chunks if name == "bc" else None,
            eager_substeps=BC_EAGER_SUBSTEPS if name == "bc" else None,
            mode="fase", telemetry=dict(TELEM_ARMED), **kw)
        _, want, _ = pysim_report(name, argv, telemetry=dict(TELEM_ARMED),
                                  **kw)
        for route, rep in reps.items():
            tel = rep.telemetry
            ct = tel["commit_trace"]
            check(tel["stream"]["dropped_frames"] == 0 and
                  sum(ct["records"]) > 0,
                  f"{name} armed on the {route} route: {tel['stream']}")
            if name == "hello":
                check(sum(ct["records"]) == sum(rep.instret) and
                      sum(ct["ring_dropped"]) == 0,
                      f"hello armed on the {route} route: records "
                      f"{ct['records']} != instret {rep.instret}")
            check(without_backend_counters(tel) ==
                  without_backend_counters(want.telemetry),
                  f"{name} armed on the {route} route: the telemetry "
                  f"report differs from PySim's")
        out[name] = dict(chunks=chunks, launches=launches,
                         **({"also_equal_to_unarmed_kernel_route": True}
                            if name == "bc" and bc_chunks is not None
                            else {}),
                         records=reps["kernel"].telemetry[
                             "commit_trace"]["records"],
                         ring_dropped=reps["kernel"].telemetry[
                             "commit_trace"]["ring_dropped"],
                         frames=reps["kernel"].telemetry["stream"]["frames"])
    return out


def telemetry_triggers(torch):
    """bc@PCIe 2T on the traced chunk kernel under each trigger kind: a
    lossless capture equal to the port's PySim's record for record, and
    an 8-slot ring whose records and drops equal PySim's."""
    from repro_torch.core.workloads import graphgen
    from repro_torch.kernels.run_chunk.run_chunk import run_chunk
    from repro_torch.run import run_workload
    from repro_torch.telemetry import capture_commit_trace
    g = graphgen.rmat(4, 4, weights=True)
    argv = ["g.bin", "2", "1"]
    kw = dict(n_cores=2, mem=1 << 22, files={"g.bin": g}, link="pcie")
    full, _ = capture_commit_trace("bc", argv, target="pysim", **kw)
    r0 = full[0]
    n = len(r0)
    specs = {"pc": ("pc", r0[n // 4][1], r0[n // 2][1]),
             "inst": ("inst", r0[n // 3][2], r0[2 * n // 3][2]),
             "tick": ("tick", r0[n // 4][0], r0[n // 2][0]),
             "instret": ("instret", n // 2)}
    out = {}
    for kind, spec in specs.items():
        want, _ = capture_commit_trace("bc", argv, target="pysim",
                                       trigger=spec, **kw)
        traced = run_chunk.trace_launches
        got, rep = capture_commit_trace(
            "bc", argv, target="torch", target_opts=dict(device="cuda"),
            trigger=spec, **kw)
        check(run_chunk.trace_launches > traced,
              f"trigger {kind}: the traced kernel was not launched")
        n_got = sum(len(r) for r in got)
        check(got == want, f"trigger {kind}: the capture differs from "
              f"PySim's ({n_got} records against "
              f"{sum(len(r) for r in want)})")
        check(0 < n_got < sum(rep.instret),
              f"trigger {kind}: {n_got} records is not a window")
        small = dict(counters=False, commit_trace=True, trace_slots=8,
                     trigger=spec)
        rt_t, rep_t, _ = run_workload("bc", argv, mode="fase",
                                      device="cuda", telemetry=dict(small),
                                      **kw)
        rt_p, _, _ = pysim_report("bc", argv, telemetry=dict(small), **kw)
        ct, cp = rt_t.telemetry.commit, rt_p.telemetry.commit
        check(ct.ring_dropped == cp.ring_dropped and
              ct.records == cp.records and rep_t.ticks == BC_PCIE["ticks"],
              f"trigger {kind} on an 8-slot ring: dropped "
              f"{ct.ring_dropped} != PySim's {cp.ring_dropped}")
        out[kind] = dict(spec=list(spec), records=n_got,
                         ring8_records=sum(len(r) for r in ct.records),
                         ring8_dropped=ct.ring_dropped)
    check(sum(sum(v["ring8_dropped"]) for v in out.values()) > 0,
          "no 8-slot ring dropped a record")
    return out


def telemetry_full_width(torch, scale):
    """The full-width run with both bridges armed (the registry's lane,
    ``telemetry_kwargs``, plus the commit-trace bridge) as the phase's
    main path: the pins unchanged, one traced launch a chunk, the hub's
    report equal to PySim's but for the backend model counters.  Then
    walls unarmed/armed in turns, and a lossless capture replayed
    against PySim."""
    from repro_torch.configs.fase_rocket import (target_kwargs,
                                                 telemetry_kwargs)
    from repro_torch.configs.registry import FASE_ROCKET_PCIE as cfg
    from repro_torch.core.interface import TorchTarget
    from repro_torch.kernels.page_walk import page_walk
    from repro_torch.kernels.run_chunk.run_chunk import run_chunk
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.telemetry import (capture_commit_trace, replay_trace,
                                       without_backend_counters)

    class Draining(TorchTarget):
        """Counts its chunks and times its drains (the ring's copy to the
        host and the records built from it)."""
        def run(self, max_cycles=1 << 62):
            self.runs = getattr(self, "runs", 0) + 1
            super().run(max_cycles)

        def trace_drain(self, c=None, limit=None):
            t0 = time.perf_counter()
            try:
                return super().trace_drain(c, limit)
            finally:
                self.drain_s = getattr(self, "drain_s", 0.0) + \
                    time.perf_counter() - t0

    pins = FULL_WIDTH[scale]
    drive, g = full_width_drive(scale)
    armed = dict(telemetry_kwargs(cfg), commit_trace=True)
    with target_class(Draining):
        run_chunk.launches = run_chunk.trace_launches = 0   # just before
        page_walk.walk_fetch_block.launches = 0
        rt, rep, wall = drive(dict(armed))
        launches = dict(run_chunk=run_chunk.launches,       # just after
                        run_chunk_trace=run_chunk.trace_launches,
                        walk_fetch_block=page_walk.walk_fetch_block
                        .launches)
    tgt = rt.target
    got = dict(ticks=rep.ticks, instret=sum(rep.instret),
               traffic=rep.traffic_total)
    check(got == pins, f"full width armed: {got} != pinned {pins}")
    check(launches["run_chunk_trace"] == tgt.runs > 0 and
          launches["run_chunk"] == launches["walk_fetch_block"] == 0,
          f"full width armed: launches {launches} for {tgt.runs} chunks")
    tel = rep.telemetry
    t0 = time.time()
    _, want, _ = drive(dict(armed), target="pysim")
    pysim_s = time.time() - t0
    check(without_backend_counters(tel) ==
          without_backend_counters(want.telemetry),
          "full width armed: the hub's report differs from PySim's")
    ct = tel["commit_trace"]
    # walls in turns: unarmed, armed, armed, unarmed
    walls = {"unarmed": [], "armed": []}
    for label in ("unarmed", "armed", "armed", "unarmed"):
        with target_class(Draining):
            r2, rep2, w = drive(dict(armed) if label == "armed" else None)
        check(rep2.ticks == pins["ticks"], f"full width {label}: ticks")
        walls[label].append(dict(wall_s=w, chunks=r2.target.runs,
                                 drain_s=getattr(r2.target, "drain_s", 0.0)))
    # the chunk kernel's device time a run, unarmed and armed, from one
    # profiled run each: the host's share of a chunk is the wall less it
    kern_us = {}
    for label in ("unarmed", "armed"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lead_in(torch)
            _, rep3, _ = drive(dict(armed) if label == "armed" else None)
            torch.cuda.synchronize()
        check(rep3.ticks == pins["ticks"], f"profiled {label}: ticks")
        kern_us[label] = sum(e.self_device_time_total
                             for e in device_events(prof.key_averages())
                             if "run_chunk" in e.key)
    # a lossless capture at full width, replayed against PySim
    t0 = time.time()
    recs, rep_c = capture_commit_trace(
        "bc", ["g.bin", "4", "1"], target="torch",
        target_opts=dict(target_kwargs(cfg), device="cuda"),
        n_cores=cfg["n_cores"], mem=cfg["mem_bytes"], files={"g.bin": g},
        link="pcie", slots=CAPTURE_SLOTS)
    capture_s = time.time() - t0
    n_recs = sum(len(r) for r in recs)
    check(n_recs == sum(rep_c.instret),
          f"full-width capture: {n_recs} records for {sum(rep_c.instret)} "
          f"retirements")
    t0 = time.time()
    div = replay_trace(recs, "bc", ["g.bin", "4", "1"],
                       n_cores=cfg["n_cores"], mem=cfg["mem_bytes"],
                       files={"g.bin": g}, link="pcie", slots=CAPTURE_SLOTS)
    replay_s = time.time() - t0
    check(div == [], f"full-width replay: {len(div)} divergence(s): "
          f"{[str(d) for d in div[:2]]}")

    def mean(label, key):
        return sum(w[key] for w in walls[label]) / len(walls[label])

    def host_ms(label):
        return (mean(label, "wall_s") * 1e6 - kern_us[label]) / \
            mean(label, "chunks") / 1e3
    return dict(
        config="FASE_ROCKET_PCIE", workload=f"bc 4T rmat({scale},4)",
        telemetry=armed, **got, chunks=tgt.runs, launches=launches,
        wall_s=wall, records=sum(ct["records"]),
        ring_dropped=sum(ct["ring_dropped"]),
        frames=tel["stream"]["frames"],
        per_bridge=tel["stream"]["per_bridge"],
        samples=len(tel["counters"]["samples"]),
        drain_s=getattr(tgt, "drain_s", 0.0), pysim_s=pysim_s,
        walls=walls, wall_unarmed_s=mean("unarmed", "wall_s"),
        wall_armed_s=mean("armed", "wall_s"),
        wall_ms_per_chunk_unarmed=1e3 * mean("unarmed", "wall_s") /
        mean("unarmed", "chunks"),
        wall_ms_per_chunk_armed=1e3 * mean("armed", "wall_s") /
        mean("armed", "chunks"),
        run_chunk_device_us_unarmed=kern_us["unarmed"],
        run_chunk_device_us_armed=kern_us["armed"],
        host_ms_per_chunk_outside_kernel_unarmed=host_ms("unarmed"),
        host_ms_per_chunk_outside_kernel_armed=host_ms("armed"),
        capture_records=n_recs, capture_s=capture_s, replay_s=replay_s,
        divergences=len(div))


def time_run_chunk_trace(torch, latency):
    """The traced instantiation against its plain version (the eager loop
    with the ring) on one ``CHUNK_CYCLES``-tick chunk of the guest loop
    at the full-width shape, from the same state, ring armed with
    ``TRACE_SLOTS`` rows; then untraced and traced back to back in turns
    (untraced, traced, traced, untraced), by CUDA events and by the
    profiler's device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.fase_rocket import target_kwargs
    from repro_torch.configs.registry import FASE_ROCKET_PCIE as cfg
    from repro_torch.core.target import cpu
    from repro_torch.kernels.run_chunk.run_chunk import run_chunk
    t = loop_target(torch, cfg["n_cores"], cfg["mem_bytes"],
                    **target_kwargs(cfg))
    t.run(max_cycles=CHUNK_CYCLES)                   # past the start-up
    t.trace_arm(TRACE_SLOTS)
    snap = {k: v.clone() for k, v in state_fields(t.st).items()}

    def chunk(route, trace):
        return cpu.run_chunk_fast(
            t.st, t.nc, t.mem_bytes, CHUNK_CYCLES, t.issue_width,
            t.block_words, t.block_cache, t.fetch_kernel, trace, None,
            dtlb_ways=t.dtlb_ways, chunk_kernel=route)

    trips0 = run_chunk.trips
    sub_k = chunk("kernel", True)
    trips = run_chunk.trips - trips0
    got = {k: v.clone() for k, v in state_fields(t.st).items()}
    captured = int((got["trace_n"] - snap["trace_n"]).sum())
    for k, v in snap.items():
        getattr(t.st, k).copy_(v)
    torch.cuda.synchronize()
    t0 = time.time()
    sub_r = chunk("ref", True)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    check(sub_k == sub_r, f"traced chunk: substeps {sub_k} != {sub_r}")
    compare_states(torch, got, state_fields(t.st), "traced chunk")
    check(captured == int(got["instret"].sum() - snap["instret"].sum()) > 0,
          f"traced chunk: {captured} records for the chunk's retirements")
    ms = {}
    for label in ("untraced", "traced", "traced2", "untraced2"):
        ms[label] = time_ms(torch, lambda: chunk("kernel",
                                                 "untraced" not in label),
                            50, warmup=5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lead_in(torch)
        for _ in range(20):
            chunk("kernel", False)
            chunk("kernel", True)
        torch.cuda.synchronize()
    dev = {}
    for e in device_events(prof.key_averages()):
        if "run_chunk_kernel" in e.key:
            # run_chunk_kernel<TRACE, MULTI>: the traced one is <true, ...>
            key = "traced" if "<true" in e.key else "untraced"
            dev[key] = e.self_device_time_total / e.count / 1e3
    check(set(dev) == {"traced", "untraced"},
          f"profile: the two instantiations were not both traced: {dev}")
    ring_bytes = t.st.tracebuf.numel() * 8
    nbytes = 2 * (state_bytes(t.st) - ring_bytes) + 32 * captured
    return dict(
        shape=dict(W=int(t.st.mem.shape[0]), L=t.nc,
                   chunk_cycles=CHUNK_CYCLES, substeps=sub_k,
                   slots=TRACE_SLOTS, records=captured),
        ms=(ms["traced"] + ms["traced2"]) / 2,
        untraced_ms=(ms["untraced"] + ms["untraced2"]) / 2, turns_ms=ms,
        device_ms=dev["traced"], untraced_device_ms=dev["untraced"],
        us_per_substep=dev["traced"] * 1e3 / sub_k,
        untraced_us_per_substep=dev["untraced"] * 1e3 / sub_k,
        traced_over_untraced=dev["traced"] / dev["untraced"],
        plain_ms=plain_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        round_trips=trips,
        latency_bound_ms=trips * latency["page_ns"] * 1e-6,
        max_abs_err=0.0)


def telemetry_clis(torch):
    """``python -m repro_torch.telemetry`` and ``python -m
    repro_torch.analysis`` at their defaults, which put the targets on
    the card: the hello timeline (every event equal to the eager loop's
    on the CPU: the routes keep every counter equal) and the quick
    analysis gate with 0 findings."""
    import contextlib
    import io
    from repro_torch.analysis.cli import main as analysis_main
    from repro_torch.kernels.run_chunk.run_chunk import run_chunk
    from repro_torch.telemetry.__main__ import _timeline_solo
    from repro_torch.telemetry.__main__ import main as telemetry_main
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "timeline_hello.json")
        traced = run_chunk.trace_launches
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_t = telemetry_main(["timeline", "hello", "--out", out])
            rc_v = telemetry_main(["validate", out])
        check(rc_t == rc_v == 0 and run_chunk.trace_launches > traced,
              f"telemetry timeline hello on the card: rc {rc_t}/{rc_v}: "
              f"{buf.getvalue()[-400:]}")
    card = _timeline_solo("hello", "pcie", True, "cuda")["traceEvents"]
    host = _timeline_solo("hello", "pcie", True, "cpu")["traceEvents"]
    check(card == host, "the hello timeline on the card differs from the "
          "eager loop's on the CPU")
    t0 = time.time()
    launched = run_chunk.launches + run_chunk.trace_launches
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = analysis_main(["gate", "--quick"])
    text = buf.getvalue()
    check(rc == 0 and "race: 0 finding(s)" in text and
          "lint: 0 finding(s)" in text and
          run_chunk.launches + run_chunk.trace_launches > launched,
          f"analysis gate --quick on the card: rc {rc}: {text[-600:]}")
    return dict(timeline_events=len(card), gate_rc=rc,
                gate_s=round(time.time() - t0, 1),
                gate=[ln for ln in text.splitlines() if ": " in ln])


def phase_telemetry(torch, scale, latency, bc_chunks=None):
    t0 = time.time()
    goldens = telemetry_goldens(torch, bc_chunks)
    emit({"phase": "telemetry_goldens", "telemetry": TELEM_ARMED,
          "fields_equal_after_every_chunk": True, "tolerance": 0,
          **goldens, "seconds": round(time.time() - t0, 1)})
    t1 = time.time()
    triggers = telemetry_triggers(torch)
    emit({"phase": "telemetry_triggers", "workload": "bc@pcie 2T",
          "route": "kernel", "equal_to_pysim": True, **triggers,
          "seconds": round(time.time() - t1, 1)})
    t1 = time.time()
    full = telemetry_full_width(torch, scale)
    emit({"phase": "telemetry_full_width", "route": "kernel", **full,
          "seconds": round(time.time() - t1, 1)})
    timing = time_run_chunk_trace(torch, latency)
    emit({"phase": "run_chunk_trace_timing", **timing})
    t1 = time.time()
    clis = telemetry_clis(torch)
    emit({"phase": "telemetry_clis", "device": "cuda", **clis,
          "seconds": round(time.time() - t1, 1)})
    emit({"phase": "telemetry", "seconds": round(time.time() - t0, 1)})
    return full["launches"]["run_chunk_trace"], timing, \
        goldens["bc"]["launches"]["ref"]["walk_fetch_block"]


# ---------------------------------------------------------------------------
# the fleet: boards behind the switch fabric, the stacked fleet target
# ---------------------------------------------------------------------------
def fleet_of(n, stacked, n_cores, mem_bytes, fabric=False, net_cfg=None,
             target_kw=None, **runtime_kw):
    """A FleetRuntime of ``n`` boards on the card: the stacked FleetTarget
    (one launch of the fleet chunk kernel a global chunk) or a TorchTarget
    a board (one launch of the chunk kernel a chunk)."""
    from repro_torch.configs.fase_rocket import net_kwargs
    from repro_torch.core.fleet import FleetRuntime
    from repro_torch.core.interface import TorchTarget
    from repro_torch.core.net import Switch
    tk = dict(target_kw or {})
    if fabric:
        runtime_kw["fabric"] = Switch(**(net_kwargs(net_cfg) if net_cfg
                                         else net_kwargs()))
    if stacked:
        return FleetRuntime(n_devices=n, fleet_vmap=True,
                            target_cfg=dict(n_cores=n_cores,
                                            mem_bytes=mem_bytes, **tk),
                            **runtime_kw)
    return FleetRuntime(
        n_devices=n, make_target=lambda: TorchTarget(n_cores, mem_bytes,
                                                     device="cuda", **tk),
        **runtime_kw)


def gang_summary(rep):
    return dict(makespan=rep.makespan_ticks, supersteps=rep.supersteps,
                exchanges=rep.exchanges,
                instret=sum(sum(r.instret) for r in rep.reports),
                fabric_bytes=rep.fabric["total_bytes"])


def run_gang(torch, fleet, graph, threads):
    """bc as a gang of one member a board on ``graph`` split in parts,
    40 000-tick supersteps, 4-page halos; returns the report and the wall
    seconds (ended after the card has finished)."""
    from repro_torch.core.fleet import Job
    from repro_torch.core.net import GangJob
    from repro_torch.core.workloads import graphgen
    parts = graphgen.partition(graph, len(fleet.devices))
    rg = fleet.start_gang(GangJob(
        [Job("bc", ["part.bin", str(threads), "1"], files={"part.bin": p})
         for p in parts], superstep_ticks=40_000, halo_pages=4))
    torch.cuda.synchronize()
    t0 = time.time()
    rep = fleet.run_gang(rg)
    torch.cuda.synchronize()
    return rep, time.time() - t0


def fleet_state(ft):
    return {name: getattr(ft.sts, name).clone()
            for name in state_fields(ft.sts)}


def sync_in_lockstep(torch):
    """run_synchronous of three different jobs (hello over UART, hello
    and bc 1T on rmat(3, 4) over PCIe), one a board of a stacked fleet of
    one-core 4 MiB boards, first on the fleet chunk kernel — each global
    chunk's budgets and stack kept, and every board of budget 0 held to
    its bytes from before the launch — then on the eager flat form, every
    field of every board and each board's substeps held against the
    kernel route's after every global chunk."""
    from repro_torch.core.fleet import Job
    from repro_torch.core.workloads import graphgen
    from repro_torch.kernels.run_chunk import run_chunk as RC
    g = graphgen.rmat(3, 4, weights=True)
    links = ["uart", "pcie", "pcie"]
    chunks, out = [], {}
    frozen_boards = 0
    for route in ("kernel", "ref"):
        fr = fleet_of(3, True, 1, 1 << 22, links=links,
                      target_kw=dict(chunk_kernel=route))
        ft = fr.fleet_target
        step = ft.run_global

        def run_global(budgets, route=route, ft=ft, step=step):
            nonlocal frozen_boards
            i = ft.dispatch_count
            before = fleet_state(ft) if route == "kernel" else None
            step(budgets)
            subs = [v.substeps for v in ft._views]
            if route == "kernel":
                after = fleet_state(ft)
                for d, b in enumerate(budgets):
                    if b == 0:
                        frozen_boards += 1
                        compare_states(
                            torch, {k: v[d] for k, v in after.items()},
                            {k: v[d] for k, v in before.items()},
                            f"global chunk {i}: board {d} of budget 0")
                chunks.append((list(budgets), subs, after))
                return
            check(i < len(chunks), "the eager flat form ran more global "
                  f"chunks than the kernel's {len(chunks)}")
            want_b, want_s, want = chunks[i]
            check(list(budgets) == want_b, f"global chunk {i}: budgets "
                  f"{list(budgets)} != the kernel route's {want_b}")
            check(subs == want_s, f"global chunk {i}: substeps {subs} != "
                  f"the kernel route's {want_s}")
            compare_states(torch, fleet_state(ft), want,
                           f"global chunk {i}")
        ft.run_global = run_global
        jobs = [Job("hello"), Job("hello"),
                Job("bc", ["g.bin", "1", "1"], files={"g.bin": g})]
        RC.run_chunk_fleet.launches = 0
        t0 = time.time()
        res = fr.run_synchronous(jobs)
        torch.cuda.synchronize()
        out[route] = dict(
            wall_s=time.time() - t0, global_chunks=ft.dispatch_count,
            launches=RC.run_chunk_fleet.launches,
            jobs=[(r.report.ticks, sum(r.report.instret),
                   r.report.traffic_total, r.report.stdout) for r in res])
    k, r = out["kernel"], out["ref"]
    check(k["jobs"] == r["jobs"], "the routes' job reports differ")
    check(k["jobs"][0][0] == HELLO_UART["ticks"] and
          k["jobs"][0][3] == HELLO_UART["stdout"],
          f"hello@UART on the stacked fleet: {k['jobs'][0][:2]}")
    check(k["launches"] == k["global_chunks"] == len(chunks) ==
          r["global_chunks"] > 0 and r["launches"] == 0,
          f"launches {k['launches']}/{r['launches']} for "
          f"{k['global_chunks']}/{r['global_chunks']} global chunks")
    check(frozen_boards > 0, "no global chunk left a board at budget 0")
    emit({"phase": "fleet_vs_plain", "boards": 3, "links": links,
          "jobs": ["hello", "hello", "bc 1T rmat(3,4)"],
          "global_chunks": len(chunks), "fields_equal_after_every_chunk":
          True, "tolerance": 0, "budget0_boards_checked": frozen_boards,
          "kernel_wall_s": round(k["wall_s"], 3),
          "eager_wall_s": round(r["wall_s"], 3),
          "job_ticks": [j[0] for j in k["jobs"]]})


def fleet_pins(torch):
    """The pins of the fleet layer on the card: the gang pin on both
    fleet forms, hello@UART and bc@PCIe through ``target="fleet-vmap"``.
    results/fleet_scale.json's makespans and results/migration.json's
    PCIe row on TorchTarget boards are the ``fleet_panels`` phase's, from
    the panels' own runs."""
    from repro_torch.core.workloads import graphgen
    from repro_torch.kernels.run_chunk import run_chunk as RC
    from repro_torch.run import run_workload
    out = {}
    g = graphgen.rmat(4, 4, weights=False)
    for form in ("stacked", "torch_target"):
        RC.run_chunk.launches = RC.run_chunk_fleet.launches = 0
        fleet = fleet_of(2, form == "stacked", 1, 1 << 22, fabric=True,
                         link="pcie")
        rep, wall = run_gang(torch, fleet, g, 1)
        got = gang_summary(rep)
        check(got == GANG_PIN, f"gang pin on {form}: {got} != {GANG_PIN}")
        launches = dict(run_chunk=RC.run_chunk.launches,
                        run_chunk_fleet=RC.run_chunk_fleet.launches)
        want = "run_chunk_fleet" if form == "stacked" else "run_chunk"
        check(launches[want] > 0 and sum(launches.values()) ==
              launches[want], f"gang on {form}: launches {launches}")
        out[f"gang_{form}"] = dict(**got, wall_s=round(wall, 3),
                                   launches=launches)
    for name, argv, kw, pins in (
            ("hello", [], dict(n_cores=1, mem=1 << 22),
             dict(ticks=HELLO_UART["ticks"])),
            ("bc", ["g.bin", "2", "1"],
             dict(link="pcie", n_cores=2, mem=1 << 22,
                  files={"g.bin": graphgen.rmat(4, 4, weights=True)}),
             BC_PCIE)):
        RC.run_chunk.launches = RC.run_chunk_fleet.launches = 0
        rt, rep, wall = run_workload(name, argv, mode="fase",
                                     target="fleet-vmap", device="cuda",
                                     **kw)
        got = dict(ticks=rep.ticks, instret=sum(rep.instret),
                   traffic=rep.traffic_total)
        check(all(got[k] == v for k, v in pins.items()),
              f"{name} on fleet-vmap: {got} != {pins}")
        check(RC.run_chunk_fleet.launches == rt.target.ft.dispatch_count > 0
              and RC.run_chunk.launches == 0,
              f"{name} on fleet-vmap: {RC.run_chunk_fleet.launches} fleet "
              f"launches, {RC.run_chunk.launches} chunk launches")
        out[f"{name}_fleet_vmap"] = dict(**got, wall_s=round(wall, 3),
                                         launches=RC.run_chunk_fleet
                                         .launches)
    check(out["hello_fleet_vmap"]["ticks"] == HELLO_UART["ticks"], "hello")
    emit({"phase": "fleet_pins", **out})


def fleet_profiled(torch, drive):
    """``drive()`` again under the profiler: the fleet kernel's device
    microseconds, its traced launches, and every kernel's."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lead_in(torch)
        drive()
        torch.cuda.synchronize()
    on_dev = device_events(prof.key_averages())
    kern = [e for e in on_dev if "run_chunk_fleet" in e.key]
    check(len(kern) == 1, "profile: the fleet kernel was not traced")
    return (kern[0].self_device_time_total, kern[0].count,
            sum(e.self_device_time_total for e in on_dev))


def fleet_full_width(torch):
    """The full-width fleet on the stacked FleetTarget: FASE_FLEET_NET's
    gang, and FASE_FLEET_VMAP's run_synchronous of four bc jobs (one
    launch a global chunk), then the same four jobs one after another on
    a TorchTarget each.  Returns the fleet kernel's launches in the two
    stacked runs."""
    from repro_torch.configs.fase_rocket import (fleet_kwargs,
                                                 target_kwargs)
    from repro_torch.configs.registry import FASE_FLEET_NET, FASE_FLEET_VMAP
    from repro_torch.core.fleet import Job
    from repro_torch.core.workloads import graphgen
    from repro_torch.kernels.run_chunk import run_chunk as RC
    cfg = FASE_FLEET_NET
    tk = target_kwargs(cfg)
    kw = fleet_kwargs(cfg)
    for k in ("links", "n_devices"):
        kw.pop(k, None)
    gang_graph = graphgen.rmat(10, 4, weights=False)

    def gang():
        fleet = fleet_of(4, True, cfg["n_cores"], cfg["mem_bytes"],
                         fabric=True, net_cfg=cfg, target_kw=tk, **kw)
        return fleet, *run_gang(torch, fleet, gang_graph, 4)
    RC.run_chunk.launches = RC.run_chunk_fleet.launches = 0
    fleet, rep, wall = gang()
    launches = RC.run_chunk_fleet.launches
    got = gang_summary(rep)
    check(got == GANG_FULL, f"full-width gang {got} != {GANG_FULL}")
    ft = fleet.fleet_target
    check(launches == ft.dispatch_count > 0 and RC.run_chunk.launches == 0,
          f"full-width gang: {launches} fleet launches for "
          f"{ft.dispatch_count} global chunks, {RC.run_chunk.launches} "
          f"chunk launches")
    check(ft.sts.mem.is_cuda and tuple(ft.sts.mem.shape) ==
          (4, cfg["mem_bytes"] // 8), "the stacked images are not on the "
          "card at full width")
    kern_us, traced, dev_us = fleet_profiled(torch, gang)
    emit({"phase": "fleet_gang_full_width", "config": "FASE_FLEET_NET",
          "boards": 4, "n_cores": cfg["n_cores"],
          "mem_bytes": cfg["mem_bytes"], "workload":
          "bc 4T a board on partition(rmat(10,4), 4)", **got,
          "wall_s": round(wall, 3), "instr_per_s": got["instret"] / wall,
          "global_chunks": ft.dispatch_count, "launches": launches,
          "device_us_per_global_chunk": kern_us / traced,
          "host_ms_between_chunks":
          (wall * 1e6 - kern_us) / launches / 1e3,
          "device_busy_share": dev_us / (wall * 1e6)})
    gang_launches = launches

    vk = fleet_kwargs(FASE_FLEET_VMAP)
    tc = vk.pop("target_cfg")
    vk.pop("fleet_vmap")
    for k in ("links", "n_devices"):
        vk.pop(k, None)
    graphs = [graphgen.rmat(10, 4, seed=s, weights=True) for s in SYNC_SEEDS]

    def jobs():
        return [Job("bc", ["g.bin", "4", "1"], files={"g.bin": gr})
                for gr in graphs]

    def sync():
        fr = fleet_of(4, True, tc["n_cores"], tc["mem_bytes"],
                      target_kw={k: v for k, v in tc.items()
                                 if k not in ("n_cores", "mem_bytes")},
                      **vk)
        torch.cuda.synchronize()
        t0 = time.time()
        res = fr.run_synchronous(jobs())
        torch.cuda.synchronize()
        return fr, res, time.time() - t0
    RC.run_chunk.launches = RC.run_chunk_fleet.launches = 0
    fr, res, wall = sync()
    launches = RC.run_chunk_fleet.launches
    got = tuple((r.report.ticks, sum(r.report.instret),
                 r.report.traffic_total) for r in res)
    check(got == SYNC_FULL, f"run_synchronous {got} != {SYNC_FULL}")
    n = fr.fleet_target.dispatch_count
    check(launches == n > 0 and RC.run_chunk.launches == 0,
          f"run_synchronous: {launches} launches for {n} global chunks")
    kern_us, traced, dev_us = fleet_profiled(torch, sync)
    instret = sum(i for _, i, _ in got)
    # the same four jobs one after another, a TorchTarget each
    RC.run_chunk.launches = 0
    seq = fleet_of(4, False, tc["n_cores"], tc["mem_bytes"],
                   target_kw={k: v for k, v in tc.items()
                              if k not in ("n_cores", "mem_bytes")}, **vk)
    torch.cuda.synchronize()
    t0 = time.time()
    seq_res = [seq.run_job(d, j) for d, j in zip(seq.devices, jobs())]
    torch.cuda.synchronize()
    seq_wall = time.time() - t0
    check(tuple((r.report.ticks, sum(r.report.instret),
                 r.report.traffic_total) for r in seq_res) == SYNC_FULL,
          "the four jobs one after another differ")
    emit({"phase": "fleet_sync_full_width", "config": "FASE_FLEET_VMAP",
          "boards": 4, "n_cores": tc["n_cores"],
          "mem_bytes": tc["mem_bytes"],
          "workload": "bc 4T on rmat(10,4,seed) a board",
          "seeds": list(SYNC_SEEDS), "job_ticks": [t for t, _, _ in got],
          "instret": instret, "wall_s": round(wall, 3),
          "instr_per_s": instret / wall, "global_chunks": n,
          "launches": launches,
          "launches_per_global_chunk": launches / n,
          "device_us_per_global_chunk": kern_us / traced,
          "host_ms_between_chunks": (wall * 1e6 - kern_us) / launches / 1e3,
          "device_busy_share": dev_us / (wall * 1e6),
          "sequential_torch_targets": dict(
              wall_s=round(seq_wall, 3), instr_per_s=instret / seq_wall,
              chunk_launches=RC.run_chunk.launches)})
    return gang_launches + launches


def time_run_chunk_fleet(torch, latency):
    """The fleet kernel and its plain version (the eager flat form) on one
    global chunk of ``CHUNK_CYCLES`` ticks a board at the full-width shape
    (FASE_FLEET_VMAP: 4 boards of 4 cores and 64 MiB, each running the
    guest loop of ``loop_target``), from the same stack; then the kernel
    back to back on equal global chunks.  Also the wrapper's refusals."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.fase_rocket import target_kwargs
    from repro_torch.configs.registry import FASE_FLEET_VMAP as cfg
    from repro_torch.core.fleet.vmap import FleetTarget
    from repro_torch.core.target import cpu
    from repro_torch.kernels.run_chunk import run_chunk as RC
    D = cfg["n_devices"]
    ft = FleetTarget(D, cfg["n_cores"], cfg["mem_bytes"],
                     **target_kwargs(cfg))
    loop = loop_target(torch, cfg["n_cores"], 1 << 20)
    small = state_fields(loop.st)
    for d in range(D):
        board = ft.view(d).st
        for name, v in small.items():
            if name == "mem":
                board.mem[:v.shape[0]].copy_(v)
            else:
                getattr(board, name).copy_(v)
    budgets = [CHUNK_CYCLES] * D

    def chunk(route):
        return cpu.run_chunk_fleet(ft.sts, ft.n_cores, ft.mem_bytes,
                                   budgets, ft.issue_width, ft.block_words,
                                   ft.block_cache, ft.fetch_kernel,
                                   ft.dtlb_ways, route)
    chunk("kernel")                                  # past the start-up
    snap = fleet_state(ft)
    trips0 = RC.run_chunk_fleet.trips
    sub_k = chunk("kernel")
    trips = RC.run_chunk_fleet.trips - trips0
    got = fleet_state(ft)
    for name, v in snap.items():
        getattr(ft.sts, name).copy_(v)
    torch.cuda.synchronize()
    t0 = time.time()
    sub_r = chunk("ref")
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    check(sub_k == sub_r, f"timed global chunk: substeps {sub_k} != "
          f"{sub_r}")
    compare_states(torch, got, fleet_state(ft), "timed global chunk")
    ms = time_ms(torch, lambda: chunk("kernel"), 50, warmup=5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lead_in(torch)
        for _ in range(20):
            chunk("kernel")
        torch.cuda.synchronize()
    on_dev = device_events(prof.key_averages())
    kern = [e for e in on_dev if "run_chunk_fleet" in e.key]
    check(len(kern) == 1 and kern[0].count == 20,
          f"profile: the fleet kernel was not traced 20 times: "
          f"{[(e.key, e.count) for e in on_dev]}")
    dev_ms = kern[0].self_device_time_total / kern[0].count / 1e3
    # bytes: every board's state fields read once and written once
    nbytes = 2 * sum(v.numel() * v.element_size() for k, v in
                     state_fields(ft.sts).items() if k != "mem")
    refused = 0
    n_past, limit = past_largest_cluster()
    wide = cpu.make_fleet_state(2, n_past, 1 << 20, device="cuda")
    bad = cpu.make_fleet_state(2, 2, 1 << 20, device="cuda")
    bad.ticks = bad.ticks[:1]
    for call in (lambda: RC.run_chunk_fleet(
                     cpu.make_fleet_state(2, 2, 1 << 20, device="cpu"), 2,
                     1 << 20, [64, 64]),
                 lambda: RC.run_chunk_fleet(wide, n_past, 1 << 20,
                                            [64, 64]),
                 lambda: RC.run_chunk_fleet(bad, 2, 1 << 20, [64, 64]),
                 lambda: RC.run_chunk_fleet(ft.sts, ft.n_cores,
                                            ft.mem_bytes, [64])):
        try:
            call()
        except ValueError:
            refused += 1
            continue
        fail("the run_chunk_fleet wrapper accepted an input it must refuse")
    return dict(shape=dict(D=D, W=cfg["mem_bytes"] // 8, L=cfg["n_cores"],
                           chunk_cycles=CHUNK_CYCLES, substeps=sub_k),
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, round_trips=trips,
                # every board runs the same loop and the CTAs run side by
                # side: the launch's chain is one board's, a D-th of the sum
                latency_bound_ms=trips / D * latency["page_ns"] * 1e-6,
                max_abs_err=0.0,
                wrapper_refused=refused)


def phase_fleet(torch, latency):
    """Returns the fleet kernel's launches on the full-width paths, its
    timing, and its cluster launches (the boards past one CTA)."""
    from repro_torch.kernels.run_chunk import run_chunk as RC
    t0 = time.time()
    sync_in_lockstep(torch)
    RC.run_chunk_fleet.cluster_launches = 0
    wide_boards(torch, fleet=True)
    cluster_launches = RC.run_chunk_fleet.cluster_launches
    fleet_pins(torch)
    launches = fleet_full_width(torch)
    timing = time_run_chunk_fleet(torch, latency)
    emit({"phase": "run_chunk_fleet_timing", **timing})
    emit({"phase": "fleet", "seconds": round(time.time() - t0, 1)})
    return launches, timing, cluster_launches


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------
def serve_requests(vocab, seed=0):
    """``SERVE_MIX`` as seeded prompts (tokens in [2, vocab), so none is
    the eos 1 or the padding 0)."""
    import numpy as np
    rng = np.random.RandomState(seed)

    def tok(n):
        return rng.randint(2, vocab, n).tolist()
    shared, pfx = tok(128), tok(64)
    out = []
    for kind, n, max_new in SERVE_MIX:
        head = {"S": shared, "A": pfx, "X": pfx}.get(kind, [])
        out.append((head + tok(n - len(head)), max_new))
    return out


def strip_eos(out, eos):
    out = list(out)
    while out and out[-1] == eos:
        out.pop()
    return out


def new_engine(torch, cfg, params, impl, device="cuda"):
    from repro_torch.serving.engine import Request, ServeEngine
    eng = ServeEngine(cfg, params, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                      impl=impl, device=device)
    for rid, (prompt, max_new) in enumerate(serve_requests(cfg.vocab)):
        eng.submit(Request(rid=rid, prompt=prompt, max_new=max_new, eos=1))
    return eng


class RouterLog:
    """Installed over ``models.core.moe`` (``with RouterLog(M) as log``):
    each MoE call appends its router's f32 probabilities ``(T, E)`` and
    each token's top-k set, sorted (the ``K`` experts whose outputs it
    sums, whatever their order), computed from the call's input as
    ``moe`` computes them, to ``log.calls``."""

    def __init__(self, M):
        self.M, self.real, self.calls = M, M.moe, []

    def __enter__(self):
        import torch
        real = self.real

        def moe(p, cfg, x2d):
            probs = torch.softmax(x2d.float() @ p["router"].float(), dim=-1)
            top = torch.argsort(probs, dim=-1, descending=True,
                                stable=True)[:, :cfg.top_k]
            self.calls.append((probs, top.sort(dim=-1).values))
            return real(p, cfg, x2d)
        self.M.moe = moe
        return self

    def __exit__(self, *exc):
        self.M.moe = self.real

    def take(self):
        calls, self.calls = self.calls, []
        return calls


def router_flips(torch, kcalls, rcalls):
    """The first MoE call of one decode step in which the two routes sent
    some token to another expert set, as ``(call, [(token, gap), ...])``:
    ``gap`` the largest difference of the token's router probabilities
    between the routes; ``None`` when they routed every token alike.  The
    calls after it are not looked at: their inputs carry the routing that
    differed.  Also the largest probability difference over the calls
    before it (the noise the routers saw)."""
    check(len(kcalls) == len(rcalls), "the routes made different numbers "
          "of MoE calls in one step")
    noise = 0.0
    for c, ((kprobs, ktop), (rprobs, rtop)) in enumerate(zip(kcalls,
                                                             rcalls)):
        diff = (kprobs - rprobs.to(kprobs.device)).abs().amax(dim=-1)
        rows = (ktop != rtop.to(ktop.device)).any(dim=-1)
        if bool(rows.any()):
            return (c, [(t, float(diff[t])) for t in
                        rows.nonzero().flatten().tolist()]), noise
        noise = max(noise, float(diff.max()))
    return None, noise


def lockstep(torch, cfg, params, ref_params=None, ref_device="cuda",
             max_steps=None, resync=False, routing=None, run=None,
             strict=True, engine=None):
    """The kernel route and the plain route, one decode step each in
    turn, on the same schedule.  After every step, on the slots that
    carried a request: the logits agree within SERVE_LOGIT_TOL, and where
    the argmaxes differ on a token the engine uses (one it emits or feeds
    back — not one made while the slot is still fed its prompt), the
    kernel route's token is a near tie: its logit on the plain route is
    within SERVE_LOGIT_TOL of the plain route's best.  The plain route
    then goes on from the kernel route's tokens, so every step of the run
    is compared.  ``ref_params``/``ref_device``: the plain route's
    parameters and device (default: the kernel route's; the CPU for the
    card-against-CPU check).  ``max_steps``: compare only the first
    steps.  ``resync``: the plain route starts every step from the kernel
    route's whole decode state, so that each step compares one step's
    work.  ``routing`` (a :class:`RouterLog`): a step in which the routes
    routed a token to different experts is excused from the logit checks
    if, at the first MoE call that did, every such token's router
    probabilities agreed between the routes within ``ROUTER_TIE`` (a near
    tie of its top-k), and fails otherwise.  ``run`` names the run in its
    line; ``strict=False`` returns the failures (``stats["failures"]``)
    where it would fail.  ``engine(impl, params, device)`` makes each
    route's engine with its requests submitted (default: ``new_engine``,
    ``SERVE_MIX`` on ``SERVE_SLOTS`` slots).  Returns the kernel engine,
    the comparison's numbers, the attention inputs (block table, lengths)
    of the step with the most valid KV rows while every slot was busy,
    and the longest PageS and PageCP lists of a step's command batch."""
    if engine is None:
        def engine(impl, p, device):
            return new_engine(torch, cfg, p, impl, device=device)
    ek = engine("kernel", params, "cuda")
    er = engine("ref", params if ref_params is None else ref_params,
                ref_device)
    most = {"page_set": 0, "page_copy": 0}
    stats = {"steps": 0, "max_logit_abs_err": 0.0, "max_abs_logit": 0.0,
             "used_tokens": 0, "near_ties": [], "page_set_steps": 0,
             "tolerance": SERVE_LOGIT_TOL, "resync": resync,
             "plain_device": str(ref_device)}
    if routing is not None:
        stats.update(router_flip_steps=0, router_flips=[],
                     router_tie=ROUTER_TIE, router_prob_noise=0.0)
    bad, busiest, best = [], None, -1
    ek.begin()
    er.begin()
    while max_steps is None or ek.steps < max_steps:
        if resync:
            for name, t in ek.state.items():
                er.state[name].copy_(t)
        a = ek.step()
        kcalls = routing.take() if routing is not None else None
        b = er.step()
        rcalls = routing.take() if routing is not None else None
        check(a == b, "kernel and plain routes disagree on the schedule")
        if not a:
            break
        check(ek.step_slots == er.step_slots,
              "kernel and plain routes busy different slots")
        most["page_set"] = max(most["page_set"], len(ek.batch.page_zeros))
        stats["page_set_steps"] += bool(ek.batch.page_zeros)
        most["page_copy"] = max(most["page_copy"],
                                len(ek.batch.page_copies))
        rows = torch.tensor(ek.step_slots)
        lk = ek.logits.cpu()[rows].float()
        lr = er.logits.cpu()[rows].float()
        check(bool(torch.isfinite(lk).all()),
              f"step {ek.steps}: non-finite logits on the kernel route")
        er._cur.copy_(ek._cur)
        if not torch.equal(er._stop_mask.cpu(), ek._stop_mask.cpu()):
            bad.append(f"step {ek.steps}: the routes' stop masks differ")
            break                        # the schedules part here
        lens = ek.state["seq_lens"].clamp(max=ek.max_seq)
        n = int(lens[rows.to(lens.device)].sum())
        if len(ek.step_slots) == ek.slots and n > best:
            best = n
            busiest = (ek.state["block_tables"].clone(), lens.clone())
        if routing is not None:
            first, noise = router_flips(torch, kcalls, rcalls)
            stats["router_prob_noise"] = max(stats["router_prob_noise"],
                                             noise)
            if first is not None:
                c, tokens = first
                stats["router_flip_steps"] += 1
                for t, gap in tokens:
                    stats["router_flips"].append(
                        {"step": ek.steps, "call": c, "token": t,
                         "prob_gap": gap})
                    if gap > ROUTER_TIE:
                        bad.append(f"step {ek.steps} MoE call {c} token "
                                   f"{t}: routed apart with router "
                                   f"probabilities {gap} apart")
                continue                 # this step's logits are excused
        err = float((lk - lr).abs().max())
        stats["max_logit_abs_err"] = max(stats["max_logit_abs_err"], err)
        stats["max_abs_logit"] = max(stats["max_abs_logit"],
                                     float(lr.abs().max()))
        if err > SERVE_LOGIT_TOL:
            bad.append(f"step {ek.steps}: logits differ by {err}")
        tk, tr = lk.argmax(-1).tolist(), lr.argmax(-1).tolist()
        for i, slot in enumerate(ek.step_slots):
            if ek._slot_tokens[slot]:      # still fed its prompt
                continue
            stats["used_tokens"] += 1
            if tk[i] != tr[i]:
                gap = float(lr[i].max() - lr[i, tk[i]])
                stats["near_ties"].append(
                    {"step": ek.steps, "slot": slot, "gap": gap})
                if gap > SERVE_LOGIT_TOL:
                    bad.append(f"step {ek.steps} slot {slot}: the "
                               f"kernel's token is {gap} below the "
                               f"plain route's best")
    stats["steps"] = ek.steps
    if routing is not None:
        stats["router_flips"] = sorted(stats["router_flips"],
                                       key=lambda f: -f["prob_gap"])[:16]
        stats["router_flip_share"] = stats["router_flip_steps"] / ek.steps
        if stats["router_flip_steps"] > ROUTER_FLIP_SHARE * ek.steps:
            bad.append(f"{stats['router_flip_steps']} of {ek.steps} steps "
                       "routed some token apart")
    if ek.traffic.by_cat != er.traffic.by_cat or ek.kv.stats != er.kv.stats:
        bad.append("traffic or page statistics differ")
    stats["failures"] = bad
    emit({"phase": "serve_vs_plain", "arch": cfg.name, "run": run,
          "dtype": str(ek.params["embed"].dtype).split(".")[1],
          **stats, "failures": bad[:8], "n_failures": len(bad)})
    check(not strict or not bad,
          f"kernel route against the plain route: {bad[:4]}")
    return ek, stats, busiest, most


def attention_bound_ms(q, kp, bt, lens, window=0):
    """Least time of one paged_attention call: q read and out written
    once, the table and lengths read once, and each K and V pool row the
    call attends read once: the distinct (page, offset) rows over every
    sequence's attended slots (all ``P * page`` at length 0; with
    ``window``, the ring slots it keeps), so a page that several tables
    hold (a shared prefix, the windowed engine's zero page) counts once,
    as after its first read it comes from L2.  The multiply-adds (4 * H *
    D a row) are far below the bf16 peak."""
    import torch
    B, H, D = q.shape
    page, Hkv = kp.shape[1], kp.shape[2]
    pos = torch.arange(bt.shape[1] * page)
    n = torch.as_tensor(lens).long().cpu()[:, None]
    if window:
        attended = (n - 1 - pos) % pos.numel() < window
    else:
        attended = (pos < n) | (n == 0)
    rows = (bt.long().cpu()[:, pos // page] * page + pos % page)[attended]
    nbytes = (2 * B * H * D * q.element_size() + 4 * B + 4 * bt.numel() +
              2 * rows.unique().numel() * Hkv * D * kp.element_size())
    return nbytes / HBM_BYTES_PER_S * 1e3


def time_serving_kernels(torch, eng, busiest, most, errs):
    """Each serving kernel, its plain version and the one PyTorch call
    that computes the same (where there is one), at the serve run's
    shapes: paged_attention on layer 0's pools with the busiest step's
    block table and lengths (and at ``LONG_SHAPE``, full); page_set on the
    K and V pools (every layer) in one launch and page_copy on the K pool,
    with the largest id lists the run gave them; page_gather, which no
    path calls, on the K pool with a table of 8 pages (one id repeated),
    beside ``index_select``, its library call and plain version alike.
    ``device_ms`` is a launch's device time without the host's
    (``graph_ms``)."""
    from repro_torch.kernels.page_ops import ops as page_ops
    from repro_torch.kernels.paged_attention import ops as attn_ops
    cfg, dev = eng.cfg, eng.device
    out = {}
    bt, lens = busiest
    kp, vp = eng.state["kpool"][0, 0], eng.state["vpool"][0, 0]
    B, H, D = SERVE_SLOTS, cfg.n_heads, cfg.d_head
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    q = torch.randn((B, H, D), generator=g, device=dev).to(torch.bfloat16)
    err = attention_err(torch, q, kp, vp, bt, lens)
    out["paged_attention"] = dict(
        ms=time_ms(torch, lambda: attn_ops.paged_decode(q, kp, vp, bt, lens),
                   2000),
        device_ms=graph_ms(torch, lambda: attn_ops.paged_decode(
            q, kp, vp, bt, lens), 500),
        long_context=time_long_attention(torch, dev),
        plain_ms=time_ms(torch, lambda: attn_ops.paged_decode(
            q, kp, vp, bt, lens, impl="ref"), 200),
        bound_ms=attention_bound_ms(q, kp, bt, lens),
        library_ms=None, max_abs_err=max(errs["paged_attention"], err),
        shape=dict(q=list(q.shape), pool=list(kp.shape),
                   block_table=list(bt.shape), lens=lens.tolist(),
                   dtype="bfloat16"))
    pool, vpool = eng.state["kpool"], eng.state["vpool"]
    both = (pool, vpool)
    layers = pool.shape[0] * pool.shape[1]
    page_bytes = pool[0, 0, 0].numel() * pool.element_size()
    n_pages = pool.shape[2]
    k_set, k_cp = max(most["page_set"], 1), max(most["page_copy"], 1)
    ids = torch.arange(k_set, dtype=torch.int32, device=dev) * 3 % n_pages
    src = torch.arange(k_cp, dtype=torch.int32, device=dev) % n_pages
    pairs = torch.stack([src, (src + 7) % n_pages], 1).contiguous()
    got, want = (pool.clone(), vpool.clone()), (pool.clone(), vpool.clone())
    page_ops.page_set(got, ids, 0.0)
    page_ops.page_set(want, ids, 0.0, impl="ref")
    page_ops.page_copy(got[0], pairs)
    page_ops.page_copy(want[0], pairs, impl="ref")
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "page ops at the serve shape: kernel differs from the plain "
          "version")
    del got, want
    il, sl, dl = ids.long(), pairs[:, 0].long(), pairs[:, 1].long()

    def lib_copy():
        pool[:, :, dl] = pool[:, :, sl]

    def lib_set():
        pool.index_fill_(2, il, 0.0)
        vpool.index_fill_(2, il, 0.0)
    out["page_set"] = dict(
        ms=time_ms(torch, lambda: page_ops.page_set(both, ids, 0.0), 200),
        device_ms=graph_ms(torch, lambda: page_ops.page_set(both, ids, 0.0),
                           50),
        plain_ms=time_ms(torch, lambda: page_ops.page_set(
            both, ids, 0.0, impl="ref"), 50),
        library_ms=time_ms(torch, lib_set, 200),
        bound_ms=(2 * k_set * layers * page_bytes + 4 * k_set) /
        HBM_BYTES_PER_S * 1e3,
        max_abs_err=errs["page_set"],
        shape=dict(pools=2, pool=list(pool.shape), ids=k_set,
                   dtype="bfloat16"))
    out["page_copy"] = dict(
        ms=time_ms(torch, lambda: page_ops.page_copy(pool, pairs), 200),
        plain_ms=time_ms(torch, lambda: page_ops.page_copy(
            pool, pairs, impl="ref"), 50),
        library_ms=time_ms(torch, lib_copy, 200),
        bound_ms=(2 * k_cp * layers * page_bytes + 8 * k_cp) /
        HBM_BYTES_PER_S * 1e3,
        max_abs_err=errs["page_copy"],
        shape=dict(pool=list(pool.shape), pairs=k_cp, dtype="bfloat16"))
    table = torch.tensor(GATHER_TABLE, dtype=torch.int32, device=dev)
    got = page_ops.page_gather(pool, table)
    check(torch.equal(got, page_ops.page_gather(pool, table, impl="ref")),
          "page_gather at the serve shape: kernel differs from the plain "
          "version")
    del got
    k_g = table.shape[0]
    gather_ms = time_ms(torch, lambda: pool.index_select(-4, table), 200)
    out["page_gather"] = dict(
        ms=time_ms(torch, lambda: page_ops.page_gather(pool, table), 200),
        plain_ms=gather_ms, library_ms=gather_ms,
        bound_ms=(2 * k_g * layers * page_bytes + 4 * k_g) /
        HBM_BYTES_PER_S * 1e3,
        max_abs_err=errs["page_gather"],
        shape=dict(pool=list(pool.shape), table=k_g, dtype="bfloat16"))
    return out


def time_long_attention(torch, dev):
    """paged_attention at ``LONG_SHAPE`` with every slot at 32 768 tokens:
    the kernel through its wrapper and on the device alone, its plain
    version, the byte bound, and the largest difference between the
    two."""
    from repro_torch.kernels.paged_attention import ops as attn_ops
    B, H, Hkv, D, page, P = LONG_SHAPE
    args = attention_inputs(torch, dev, *LONG_SHAPE, torch.bfloat16, 7,
                            LONG_TIMED_LENS)
    err = attention_err(torch, *args)
    out = dict(ms=time_ms(torch, lambda: attn_ops.paged_decode(*args), 50),
               device_ms=graph_ms(torch, lambda: attn_ops.paged_decode(
                   *args), 20),
               plain_ms=time_ms(torch, lambda: attn_ops.paged_decode(
                   *args, impl="ref"), 5, warmup=1),
               bound_ms=attention_bound_ms(args[0], args[1], args[3],
                                           args[4]),
               max_abs_err=err,
               shape=dict(q=[B, H, D], pool=[B * P, page, Hkv, D],
                          block_table=[B, P], lens=list(LONG_TIMED_LENS),
                          dtype="bfloat16"))
    del args
    torch.cuda.empty_cache()
    return out


def serve_profile(torch, cfg, params, out_dir, warm=40, steps=16):
    """A ``torch.profiler`` window over ``steps`` decode steps of a fresh
    kernel-route engine after ``warm`` unprofiled ones: launches, device
    time and the device's busy share per step (against the pace of the
    ``steps`` unprofiled steps before it, whose host time the engine
    splits into scheduling, enqueueing and polling), and paged_attention's
    device time per launch.  The tables go to ``out_dir`` when one is
    given."""
    from torch.profiler import ProfilerActivity, profile
    eng = new_engine(torch, cfg, params, "kernel")
    eng.begin()
    for _ in range(warm):
        eng.step()
    torch.cuda.synchronize()
    eng.host_s = dict.fromkeys(eng.host_s, 0.0)
    t0 = time.time()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.time() - t0) / steps
    host_ms = {k: v / steps * 1e3 for k, v in eng.host_s.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lead_in(torch)
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    on_dev = device_events(ka)
    dev_us = sum(e.self_device_time_total for e in on_dev) / steps
    attn = [e for e in on_dev if "paged_attention" in e.key]
    n_attn = sum(e.count for e in attn)
    launches = (sum(e.count for e in ka if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
        "cuLaunchKernelEx")) - LEAD_IN_LAUNCHES) / steps
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = "" if cfg.name == SERVE_ARCH else f"_{cfg.name}"
        with open(os.path.join(out_dir, f"serve_profile{tag}.txt"),
                  "w") as f:
            f.write(ka.table(sort_by="self_cpu_time_total", row_limit=40))
            f.write("\n")
            f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    out = {"phase": "serve_profile", "arch": cfg.name, "steps": steps,
           "ms_per_step_unprofiled": wall * 1e3,
           "host_ms_per_step_unprofiled": host_ms,
           "enqueue_us_per_launch": host_ms["enqueue"] * 1e3 / launches,
           "kernel_launches_per_step": launches,
           "device_us_per_step": dev_us,
           "device_busy_share": dev_us / (wall * 1e6),
           "paged_attention_device_us": (
               sum(e.self_device_time_total for e in attn) / n_attn
               if n_attn else None),
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    return out


def phase_serve(torch, errs, profile_dir):
    from repro_torch.configs import CONFIGS
    from repro_torch.models import core as M
    cfg = CONFIGS[SERVE_ARCH]
    t0 = time.time()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    from repro_torch.kernels.page_ops import page_ops
    from repro_torch.kernels.paged_attention import paged_attention
    counters = [(k, "launches") for k in (
        paged_attention.paged_attention, page_ops.page_set,
        page_ops.page_copy, page_ops.page_gather)]
    line, eng = serve_run(torch, cfg, params, counters)
    launches, streams = line["launches"], line["streams"]
    emit({"phase": "serve", "init_params_s": round(init_s, 3),
          "prompt_tokens": sum(len(p) for p, _ in
                               serve_requests(cfg.vocab)),
          "warm_steps": SERVE_WARM_STEPS, **line})
    check(launches["paged_attention"] == eng.steps * cfg.n_layers,
          f"paged_attention launches {launches['paged_attention']} != "
          f"steps x layers {eng.steps * cfg.n_layers}")
    for name, n in launches.items():
        check(n > 0 or name == "page_gather",
              f"the serve run never launched the {name} kernel")
    check(eng.kv.stats["prefix_hits"] >= 3 and eng.kv.stats["cow"] >= 1,
          f"the request mix gave no prefix hits or COW: {eng.kv.stats}")
    # the kernel route against the plain route, step by step
    del eng
    ek, stats, busiest, most = lockstep(torch, cfg, params)
    check({str(r.rid): strip_eos(r.out, r.eos) for r in ek.finished} ==
          streams,
          "the lockstep kernel run differs from the timed run")
    # the same schedule: one page_set launch (K and V) per allocating step
    check(launches["page_set"] == stats["page_set_steps"],
          f"page_set launches {launches['page_set']} != allocating steps "
          f"{stats['page_set_steps']}")
    timing = time_serving_kernels(torch, ek, busiest, most, errs)
    if profile_dir:
        del ek
        serve_profile(torch, cfg, params, profile_dir)
    return launches, timing


def time_window_attention(torch, eng, busiest, errs):
    """The windowed paged_attention at the jamba run's shape (its layer's
    pools, the busiest step's table and lengths) and at the wrapped ring
    of ``WINDOW_RING_SHAPE``: through the wrapper, on the device alone,
    its plain version, its byte bound."""
    from repro_torch.kernels.paged_attention import ops as attn_ops
    cfg, dev = eng.cfg, eng.device
    bt, lens = busiest
    kp, vp = eng.state["kpool"][0, 0], eng.state["vpool"][0, 0]
    B, H, D = SERVE_SLOTS, cfg.n_heads, cfg.d_head
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    q = torch.randn((B, H, D), generator=g, device=dev).to(torch.bfloat16)
    win = cfg.sliding_window
    err = attention_err(torch, q, kp, vp, bt, lens, window=win)

    def call(*a, impl="kernel"):
        return lambda: attn_ops.paged_decode(*a, impl=impl, window=win)
    ring = attention_inputs(torch, dev, *WINDOW_RING_SHAPE, torch.bfloat16,
                            9, WINDOW_RING_TIMED_LENS)
    ring_err = attention_err(torch, *ring, window=win)
    rB, rH, rHkv, rD, rpage, rP = WINDOW_RING_SHAPE
    out = dict(
        ms=time_ms(torch, call(q, kp, vp, bt, lens), 2000),
        device_ms=graph_ms(torch, call(q, kp, vp, bt, lens), 500),
        plain_ms=time_ms(torch, call(q, kp, vp, bt, lens, impl="ref"), 200),
        bound_ms=attention_bound_ms(q, kp, bt, lens, window=win),
        library_ms=None,
        max_abs_err=max(errs["paged_attention_window"], err, ring_err),
        wrapped_ring=dict(
            ms=time_ms(torch, call(*ring), 200),
            device_ms=graph_ms(torch, call(*ring), 50),
            plain_ms=time_ms(torch, call(*ring, impl="ref"), 10, warmup=2),
            bound_ms=attention_bound_ms(ring[0], ring[1], ring[3], ring[4],
                                        window=win),
            max_abs_err=ring_err,
            shape=dict(q=[rB, rH, rD], pool=[rB * rP, rpage, rHkv, rD],
                       block_table=[rB, rP], lens=list(WINDOW_RING_TIMED_LENS),
                       window=win, dtype="bfloat16")),
        shape=dict(q=list(q.shape), pool=list(kp.shape),
                   block_table=list(bt.shape), lens=lens.tolist(),
                   window=win, dtype="bfloat16"))
    del ring
    return out


def serve_run(torch, cfg, params, counters):
    """A warm engine's ``SERVE_WARM_STEPS`` steps, then the timed run of
    ``SERVE_MIX`` on the kernel route with every counter set to 0 just
    before it: the run's line (ms a step, tok/s, launches, peak bytes,
    streams) and the engine."""
    from repro_torch.training.optim import tree_leaves
    warm = new_engine(torch, cfg, params, "kernel")
    for _ in range(SERVE_WARM_STEPS):
        warm.step()
    torch.cuda.synchronize()
    del warm
    eng = new_engine(torch, cfg, params, "kernel")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for obj, attr in counters:
        setattr(obj, attr, 0)
    t0 = time.time()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {attr if attr != "launches" else obj.__name__:
                getattr(obj, attr) for obj, attr in counters}
    gen = sum(len(r.out) for r in done)
    fed = sum(len(p) for p, _ in serve_requests(cfg.vocab))
    line = {"arch": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model,
            "params": sum(t.numel() for t in tree_leaves(params)),
            "slots": SERVE_SLOTS, "max_seq": SERVE_MAX_SEQ,
            "requests": len(SERVE_MIX), "finished": len(done),
            "decode_steps": eng.steps, "wall_s": round(wall, 3),
            "ms_per_step": wall / eng.steps * 1e3, "generated_tokens": gen,
            "tokens_per_s": gen / wall, "fed_tokens_per_s": (fed + gen) / wall,
            "host_s": eng.host_s, "kv_stats": eng.kv.stats,
            "traffic": eng.traffic.by_cat, "launches": launches,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "streams": {str(r.rid): strip_eos(r.out, r.eos)
                        for r in sorted(done, key=lambda r: r.rid)}}
    check(len(done) == len(SERVE_MIX), f"{cfg.name}: not every request "
          "finished")
    for rid, out in line["streams"].items():
        check(0 < len(out) <= SERVE_MIX[int(rid)][2] and any(out),
              f"{cfg.name} request {rid}: degenerate stream {out}")
    check(bool(torch.isfinite(eng.logits).all()),
          f"{cfg.name}: non-finite logits")
    return line, eng


def serve_jamba(torch, errs, profile_dir):
    """jamba-v0.1-52b at full width, one hybrid period (``JAMBA_LAYERS``):
    the timed run on the kernels (the windowed ``paged_attention`` once a
    step, ``page_set`` on allocating steps), a profiled window, then the
    kernel route against the plain route one step at a time
    (``lockstep(resync=True)`` with the router's near ties accounted), and
    the windowed kernel's timing at the run's shapes."""
    from repro_torch.configs import CONFIGS
    from repro_torch.kernels.page_ops import page_ops
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.models import core as M
    cfg = CONFIGS[JAMBA_ARCH].scaled(n_layers=JAMBA_LAYERS)
    check(M.period_layout(cfg).count("attn") == 1 and
          M.n_scan_steps(cfg) == 1, "jamba's cut is not one hybrid period")
    t0 = time.time()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    counters = [(paged_attention.paged_attention, "launches"),
                (paged_attention.paged_attention, "window_launches"),
                (page_ops.page_set, "launches"),
                (page_ops.page_copy, "launches"),
                (page_ops.page_gather, "launches")]
    line, eng = serve_run(torch, cfg, params, counters)
    launches = line["launches"]
    prof = serve_profile(torch, cfg, params, profile_dir, warm=SERVE_WARM_STEPS,
                         steps=FAMILY_PROFILE_STEPS)
    emit({"phase": "serve_jamba", "init_params_s": round(init_s, 3),
          "window": cfg.sliding_window,
          "pages_per_seq": eng.pages_per_seq,
          "weight_bytes": 2 * line["params"],
          "weight_bound_ms": 2 * line["params"] / HBM_BYTES_PER_S * 1e3,
          "launches_per_step": prof["kernel_launches_per_step"],
          "device_ms_per_step": prof["device_us_per_step"] / 1e3,
          "device_busy_share": prof["device_busy_share"], **line})
    check(launches["window_launches"] == eng.steps,
          f"windowed paged_attention launches {launches['window_launches']}"
          f" != steps {eng.steps} (one attention sublayer)")
    check(launches["paged_attention"] == 0,
          "the jamba run launched the unwindowed paged_attention")
    check(launches["page_set"] > 0, "the jamba run never launched page_set")
    for name in ("kpool", "vpool"):
        check(not eng.state[name][:, :, eng.zero_page].any(),
              "the zero page was written")
    del eng
    with RouterLog(M) as log:
        ek, stats, busiest, _ = lockstep(torch, cfg, params, resync=True,
                                         routing=log, run="seed 0")
    timing = time_window_attention(torch, ek, busiest, errs)
    del ek
    router_rule(torch, cfg, params, stats)
    del params
    torch.cuda.empty_cache()
    return launches["window_launches"], timing


class PlantedFault:
    """Installed over ``models.core.paged_decode`` (``with
    PlantedFault(M, scale, drop_window)``): the kernel route's attention
    output ``1 + scale`` times the kernel's, or (``drop_window``) the
    kernel's without the window, which attends only the written slots;
    the plain route's untouched.  A control for the lockstep rule."""

    def __init__(self, M, scale, drop_window):
        self.M, self.real = M, M.paged_decode
        self.scale, self.drop_window = scale, drop_window

    def __enter__(self):
        real, scale, drop = self.real, self.scale, self.drop_window

        def paged_decode(q, kp, vp, bt, lens, impl="kernel", window=0):
            if impl != "kernel":
                return real(q, kp, vp, bt, lens, impl=impl, window=window)
            o = real(q, kp, vp, bt, lens, window=0 if drop else window)
            return (o.float() * (1 + scale)).to(o.dtype)
        self.M.paged_decode = paged_decode
        return self

    def __exit__(self, *exc):
        self.M.paged_decode = self.real


def router_rule(torch, cfg, params, stats):
    """The readings behind the jamba lockstep's rule: ``stats`` (the run
    at seed 0) and the honest runs at the other ``JAMBA_SEEDS``, then the
    runs with each of ``ROUTER_FAULTS`` planted at seed 0, which the rule
    must fail."""
    from repro_torch.models import core as M

    def reading(st):
        return {"router_prob_noise": st["router_prob_noise"],
                "max_flip_gap": max([f["prob_gap"] for f in
                                     st["router_flips"]], default=0.0),
                "router_flip_share": st["router_flip_share"],
                "max_logit_abs_err": st["max_logit_abs_err"],
                "failures": len(st["failures"]),
                "first_failure": (st["failures"] or [None])[0]}
    honest, planted = {"seed 0": reading(stats)}, {}
    for name, scale, drop in ROUTER_FAULTS:
        with PlantedFault(M, scale, drop), RouterLog(M) as log:
            _, st, _, _ = lockstep(torch, cfg, params, resync=True,
                                   routing=log, run=f"planted: {name}",
                                   strict=False)
        planted[name] = reading(st)
    for seed in JAMBA_SEEDS[1:]:
        seeded = M.init_params(cfg, seed=seed, device="cuda")
        with RouterLog(M) as log:
            _, st, _, _ = lockstep(torch, cfg, seeded, resync=True,
                                   routing=log, run=f"seed {seed}")
        honest[f"seed {seed}"] = reading(st)
        del seeded, st
        torch.cuda.empty_cache()
    emit({"phase": "router_rule", "arch": cfg.name,
          "router_tie": ROUTER_TIE, "router_flip_share": ROUTER_FLIP_SHARE,
          "honest": honest, "planted": planted})
    excused = [name for name, r in planted.items() if not r["failures"]]
    check(not excused, f"the jamba lockstep rule excused planted faults "
          f"{excused}")


def serve_xlstm(torch, profile_dir):
    """xlstm-350m whole: the timed run (no hand-written kernel on its
    path: every counter stays 0), a profiled window, then its first
    ``XLSTM_CPU_STEPS`` decode steps on the card against the same steps on
    the CPU with the parameters copied over, under the lockstep rule: on
    an f32 copy, and in bf16 one step at a time (see
    ``XLSTM_CPU_STEPS``)."""
    from repro_torch.configs import CONFIGS
    from repro_torch.kernels.page_ops import page_ops
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.models import core as M
    from repro_torch.training.optim import tree_map
    cfg = CONFIGS[XLSTM_ARCH]
    params = M.init_params(cfg, seed=0, device="cuda")
    counters = [(paged_attention.paged_attention, "launches"),
                (paged_attention.paged_attention, "window_launches"),
                (page_ops.page_set, "launches"),
                (page_ops.page_copy, "launches")]
    line, eng = serve_run(torch, cfg, params, counters)
    prof = serve_profile(torch, cfg, params, profile_dir, warm=SERVE_WARM_STEPS,
                         steps=FAMILY_PROFILE_STEPS)
    emit({"phase": "serve_xlstm",
          "launches_per_step": prof["kernel_launches_per_step"],
          "device_ms_per_step": prof["device_us_per_step"] / 1e3,
          "device_busy_share": prof["device_busy_share"], **line})
    check(not any(line["launches"].values()),
          f"the xlstm run launched a kernel: {line['launches']}")
    check("kpool" not in eng.state, "an xlstm decode state has KV pools")
    del eng
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the f32 products of the card are not IEEE")
    f32 = tree_map(lambda t: t.float(), params)
    lockstep(torch, cfg, f32, ref_params=tree_map(lambda t: t.cpu(), f32),
             ref_device="cpu", max_steps=XLSTM_CPU_STEPS, run="f32")
    del f32
    lockstep(torch, cfg, params, ref_params=tree_map(lambda t: t.cpu(),
                                                     params),
             ref_device="cpu", max_steps=XLSTM_CPU_STEPS, resync=True,
             run="bf16")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------
def flash_err(torch, q, k, v, causal, window=0):
    """Largest |kernel - plain version| of flash_attention on one input
    set (``flash_mha`` on both routes, with ``window``); fails beyond
    ``ATTN_TOL`` or on a non-finite output, and where a bfloat16 case at
    D = 64 or 128 did not run the tensor-core design."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import ATTN_TOL
    got = ops.flash_mha(q, k, v, causal, window=window)
    want_design = "tensor-core" if q.dtype == torch.bfloat16 and \
        q.shape[-1] in (64, 128) else "scalar"
    check(FA.flash_attention.last_design == want_design,
          f"flash_attention q {tuple(q.shape)} {q.dtype}: ran the "
          f"{FA.flash_attention.last_design} design, not {want_design}")
    want = ops.flash_mha(q, k, v, causal, impl="ref", window=window)
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape,
          "flash_attention: kernel output dtype/shape differs")
    check(bool(torch.isfinite(got).all()), "flash_attention: non-finite")
    diff = (got.float() - want.float()).abs()
    atol, rtol = ATTN_TOL[str(q.dtype).split(".")[1]]
    over = float((diff - rtol * want.float().abs()).max())
    check(over <= atol, f"flash_attention q {tuple(q.shape)} k "
          f"{tuple(k.shape)} {q.dtype} causal={causal} window={window}: "
          f"kernel differs from "
          f"the plain version by {over} beyond rtol {rtol} > atol {atol} "
          f"(max abs diff {float(diff.max())})")
    return float(diff.max())


def check_flash_attention(torch, dev):
    """flash_attention == its plain version on the card: the shapes of
    tests/test_kernels.py as (BH, S, D) problems (B = BH, one head) —
    (2,256,64) f32, (1,128,128) f32, (3,384,64) bf16 causal, (2,256,64)
    non-causal — S = 1 and S = 200 (no multiple of a tile) causal and not,
    the training path's (32, 4096, 128) bf16 causal, and flash_mha's GQA
    fold at the path's shape (B 1, S 4096, H 32, Hkv 8, D 128); S = 129
    and 4097 (one row and one key past a 128 tile) causal and not, and a
    D = 64 GQA case, in bf16.  Prints which design each case ran."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import ATTN_TOL
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((2, 256, 1, 1, 64), f32, True), ((1, 128, 1, 1, 128), f32, True),
             ((3, 384, 1, 1, 64), bf16, True),
             ((2, 256, 1, 1, 64), f32, False)]
    for S in (1, 200):
        cases += [((2, S, 1, 1, 64), f32, c) for c in (True, False)]
        cases += [((1, S, 4, 2, 128), bf16, c) for c in (True, False)]
    for S in (129, 4097):
        cases += [((1, S, 4, 2, 128), bf16, c) for c in (True, False)]
    cases += [((2, 300, 8, 2, 64), bf16, True),
              ((1, 200, 4, 4, 16), bf16, True)]
    path = [((32, 4096, 1, 1, 128), bf16, True),
            ((1, 4096, 32, 8, 128), bf16, True)]
    errs, designs = [], []
    for i, (shape, dtype, causal) in enumerate(cases + path):
        errs.append(flash_err(torch, *flash_inputs(torch, dev, *shape, dtype,
                                                   100 + i), causal))
        designs.append({"shape": list(shape), "dtype": str(dtype)[6:],
                        "causal": causal,
                        "design": FA.flash_attention.last_design,
                        "max_abs_err": errs[-1]})
    emit({"phase": "flash_designs", "cases": designs})
    q, k, v = flash_inputs(torch, dev, 1, 8, 2, 1, 16, f32, 0)
    for bad in (lambda: FA.flash_attention(q.cpu(), k, v),
                lambda: FA.flash_attention(q.half(), k.half(), v.half()),
                lambda: FA.flash_attention(q[..., :8].contiguous(),
                                           k[..., :8].contiguous(),
                                           v[..., :8].contiguous()),
                lambda: FA.flash_attention(q.transpose(1, 2), k, v)):
        try:
            bad()
        except ValueError:
            continue
        fail("the flash_attention wrapper accepted an input it must refuse")
    emit({"phase": "kernel_vs_plain", "kernel": "flash_attention",
          "cases": len(errs), "tolerance": ATTN_TOL, "max_abs_err": max(errs),
          "path_max_abs_err": {str(shape): e for (shape, _, _), e in
                               zip(path, errs[len(cases):])}})
    return {"flash_attention": max(errs)}


#: jamba-v0.1-52b's attention (H 32, Hkv 8, D 128, bf16) at its prefill
#: run's S = 2 x window; the plain version's (BH, S, S) f32 scores fit for
#: one GQA group of 4 heads (4.3 GB), not for all 32 (34 GB)
JAMBA_ATTN = (1, 16384, 32, 8, 128)
JAMBA_SLICE = (1, 16384, 4, 1, 128)


def check_flash_window(torch, dev):
    """The windowed kernel == its plain version on the card, in both
    designs: window 1, 64 with S not a multiple of a tile, S - 1, and a
    window whose first tile is wholly masked for the tile's later rows; f32
    and bf16 at D 16 and 64 (bf16 D 64 is the tensor-core design);
    jamba's heads at S = 16 384 with its 8192 window on one GQA group (the
    plain version's scores fit for 4 heads); then the windowed backward
    (the kernel route's gradients) against autograd through the plain
    version.  Counts the windowed launches."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import ATTN_TOL
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for dtype in (f32, bf16):
        for D in (16, 64):
            cases += [((1, 200, 4, 2, D), dtype, 1),
                      ((1, 300, 4, 2, D), dtype, 64),
                      ((2, 129, 4, 2, D), dtype, 128),
                      ((1, 520, 4, 2, D), dtype, 3)]
    cases += [((1, 4097, 8, 2, 128), bf16, 4096),
              ((1, 1000, 8, 2, 128), bf16, 200),
              ((1, 4096, 32, 8, 128), bf16, 1024),
              (JAMBA_SLICE, bf16, 8192)]
    before = FA.flash_attention.window_launches
    errs, designs = [], []
    for i, (shape, dtype, window) in enumerate(cases):
        errs.append(flash_err(torch, *flash_inputs(torch, dev, *shape, dtype,
                                                   300 + i), True, window))
        designs.append({"shape": list(shape), "dtype": str(dtype)[6:],
                        "window": window,
                        "design": FA.flash_attention.last_design,
                        "max_abs_err": errs[-1]})
    launched = FA.flash_attention.window_launches - before
    check(launched == len(cases), f"windowed flash_attention launches "
          f"{launched} != {len(cases)} cases")
    check({d["design"] for d in designs} == {"scalar", "tensor-core"},
          "the windowed cases did not run both designs")
    bwd = {}
    for shape, dtype, window in (((2, 256, 1, 1, 64), f32, 64),
                                 ((1, 300, 4, 2, 16), f32, 5),
                                 ((1, 4096, 32, 8, 128), bf16, 1024)):
        q, k, v = flash_inputs(torch, dev, *shape, dtype, 17)
        do = flash_inputs(torch, dev, *shape, dtype, 18)[0]
        grads = []
        for impl in ("kernel", "ref"):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            ops.flash_mha(*leaves, causal=True, impl=impl,
                          window=window).backward(do)
            grads.append([t.grad for t in leaves])
        torch.cuda.synchronize()
        tol = FLASH_BWD_REL_L2[str(dtype).split(".")[1]]
        rel = {}
        for name, a, b in zip("qkv", *grads):
            check(a.dtype == dtype and bool(torch.isfinite(a).all()),
                  f"windowed flash backward d{name}: dtype or non-finite")
            rel[f"d{name}"] = float((a.float() - b.float()).norm() /
                                    b.float().norm().clamp(min=1e-30))
            check(rel[f"d{name}"] <= tol, f"windowed flash backward {shape} "
                  f"{dtype} window {window} d{name}: relative L2 "
                  f"{rel[f'd{name}']} > {tol}")
        bwd[f"{shape}/{str(dtype).split('.')[1]}/w{window}"] = rel
        del grads
    emit({"phase": "flash_window_vs_plain", "cases": designs,
          "tolerance": ATTN_TOL, "max_abs_err": max(errs),
          "backward_rel_l2": bwd, "backward_tolerance": FLASH_BWD_REL_L2})
    return max(errs)


def attended_pairs(S, window):
    """(query, key) pairs a causal call with ``window`` (0: none)
    attends: the work its bound counts."""
    w = window if 0 < window < S else S
    return w * (w + 1) // 2 + (S - w) * w


def time_flash_window(torch, dev, worst):
    """The windowed kernel at jamba's prefill shape (``JAMBA_ATTN``,
    window 8192): its time over all 32 heads against its bound, which
    counts the attended ``2·2·pairs·D`` operations a head (not S²/2);
    then on one GQA group (``JAMBA_SLICE``), where the plain version fits,
    the kernel, the plain version and SDPA with the same boolean mask
    (measured only, never on the path)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ops
    W = WINDOW

    def bound(B, S, H, Hkv, D):
        flops = 4 * B * H * attended_pairs(S, W) * D
        nbytes = 2 * (2 * B * S * H * D + 2 * B * S * Hkv * D)
        return (max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
                "operations" if flops / BF16_FLOP_PER_S >
                nbytes / HBM_BYTES_PER_S else "bytes", flops, nbytes)
    q, k, v = flash_inputs(torch, dev, *JAMBA_ATTN, torch.bfloat16, 21)
    ms = time_ms(torch, lambda: ops.flash_mha(q, k, v, window=W), 10,
                 warmup=2)
    design = FA.flash_attention.last_design
    b_ms, b_by, flops, nbytes = bound(*JAMBA_ATTN)
    del q, k, v
    q, k, v = flash_inputs(torch, dev, *JAMBA_SLICE, torch.bfloat16, 22)
    worst = max(worst, flash_err(torch, q, k, v, True, W))
    S = JAMBA_SLICE[1]
    mask = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
    mask &= ~torch.ones_like(mask).tril(-W)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    lib_err = float((sdpa().transpose(1, 2).float() - ops.flash_mha(
        q, k, v, impl="ref", window=W).float()).abs().max())
    slice_ms = time_ms(torch, lambda: ops.flash_mha(q, k, v, window=W), 20,
                       warmup=3)
    plain_ms = time_ms(torch, lambda: ops.flash_mha(q, k, v, impl="ref",
                                                    window=W), 3, warmup=1)
    library_ms = time_ms(torch, sdpa, 10, warmup=2)
    sb_ms, _, _, _ = bound(*JAMBA_SLICE)
    out = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, flops=flops,
               bytes=nbytes, design=design, max_abs_err=worst,
               slice=dict(shape=list(JAMBA_SLICE), ms=slice_ms,
                          plain_ms=plain_ms, library_ms=library_ms,
                          library_max_abs_err=lib_err, bound_ms=sb_ms),
               plain_ms=plain_ms, library_ms=library_ms,
               shape=dict(q=list(JAMBA_ATTN[:3]) + [JAMBA_ATTN[4]],
                          kv=[JAMBA_ATTN[0], JAMBA_ATTN[1], JAMBA_ATTN[3],
                              JAMBA_ATTN[4]], dtype="bfloat16", window=W,
                          note="plain_ms and library_ms are on the slice"))
    emit({"phase": "flash_window_timing", **out})
    return out


def path_shape(cfg):
    """flash_attention's shape on the train run: (B, S, H, Hkv, D)."""
    return (TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.d_head)


def check_flash_backward(torch, dev, cfg):
    """The kernel route's gradients (CUDA forward, attention_bwd) against
    autograd through the plain version, at (2, 256, 64) f32 and at the
    path's GQA shape in bf16, each of dq, dk, dv within
    ``FLASH_BWD_REL_L2``."""
    from repro_torch.kernels.flash_attention import ops
    out = {}
    for shape, dtype in (((2, 256, 1, 1, 64), torch.float32),
                         (path_shape(cfg), torch.bfloat16)):
        q, k, v = flash_inputs(torch, dev, *shape, dtype, 7)
        do = flash_inputs(torch, dev, *shape, dtype, 8)[0]
        grads = []
        for impl in ("kernel", "ref"):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            ops.flash_mha(*leaves, causal=True, impl=impl).backward(do)
            grads.append([t.grad for t in leaves])
        torch.cuda.synchronize()
        tol = FLASH_BWD_REL_L2[str(dtype).split(".")[1]]
        rel = {}
        for name, a, b in zip("qkv", *grads):
            check(a.dtype == dtype and bool(torch.isfinite(a).all()),
                  f"flash backward d{name}: dtype or non-finite")
            rel[f"d{name}"] = float((a.float() - b.float()).norm() /
                                    b.float().norm())
            check(rel[f"d{name}"] <= tol, f"flash backward {shape} {dtype} "
                  f"d{name}: relative L2 {rel[f'd{name}']} > {tol}")
        out[f"{shape}/{str(dtype).split('.')[1]}"] = rel
    emit({"phase": "flash_backward_vs_plain", "rel_l2": out,
          "tolerance": FLASH_BWD_REL_L2})


def train_flops(cfg, tokens):
    """Model FLOPs of one train step: 6·N·T (N every parameter, the
    embedding included) plus the causal attention's 3 × 2·H·S²·D a layer
    (forward, and twice that backward), per sequence of S = ``tokens``.
    The recompute of the checkpointed layers is not model work."""
    attn = 3 * 2 * cfg.n_heads * tokens ** 2 * cfg.d_head * cfg.n_layers
    return 6 * cfg.param_count() * tokens + attn


def gemm_flops(cfg, tokens):
    """FLOPs of one train step's bf16 GEMMs: the layers' projections and
    MLP four times (forward, recompute, and twice that backward), the LM
    head three times (it is outside the checkpointed layers)."""
    D, Dh = cfg.d_model, cfg.d_head
    layer = (2 * D * cfg.n_heads * Dh + 2 * D * cfg.n_kv_heads * Dh +
             3 * D * cfg.d_ff)
    return 2 * tokens * (4 * layer * cfg.n_layers + 3 * D * cfg.vocab)


def train_profile(torch, cfg, out_dir, s_per_step):
    """A ``torch.profiler`` window over one more full-width train step
    after the timed run: device time by kernel, launches, the device's
    busy share against the unprofiled step time.  Before it, unprofiled,
    the step's split by CUDA events — ``loss_and_grads`` (forward,
    recompute, backward) and ``adamw_update`` — and the plain attention
    backward of one layer alone at the path's shape."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention.ref import attention_bwd
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import core as M
    from repro_torch.training.optim import (AdamWConfig, adamw_update,
                                            init_opt_state)
    params = M.init_params(cfg, 0, device="cuda")
    opt = init_opt_state(params)
    step = make_train_step(cfg)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                         generator=g, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step(params, opt, batch)                                  # warm
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    _, grads = loss_and_grads(cfg, params, batch)
    ev[1].record()
    adamw_update(AdamWConfig(), params, grads, opt)
    ev[2].record()
    torch.cuda.synchronize()
    del grads
    q, k, v = flash_inputs(torch, params["embed"].device, *path_shape(cfg),
                           torch.bfloat16, 2)
    do = flash_inputs(torch, q.device, *path_shape(cfg), torch.bfloat16,
                      3)[0]
    split = {"loss_and_grads_ms": ev[0].elapsed_time(ev[1]),
             "adamw_update_ms": ev[1].elapsed_time(ev[2]),
             "attention_bwd_ms_per_layer": time_ms(
                 torch, lambda: attention_bwd(q, k, v, do, True), 3,
                 warmup=1)}
    del q, k, v, do
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lead_in(torch)
        step(params, opt, batch)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    on_dev = device_events(ka)
    dev_us = sum(e.self_device_time_total for e in on_dev)
    launches = sum(e.count for e in ka if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
        "cuLaunchKernelEx")) - LEAD_IN_LAUNCHES
    top = sorted(on_dev, key=lambda e: -e.self_device_time_total)[:12]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "train_profile.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=-1))
    fa = [e for e in on_dev if "flash_attention" in e.key]
    gemm = {"bf16": [], "f32": []}
    for e in on_dev:
        name = e.key.lower()
        if "nvjet" in name or ("gemm" in name and "bf16" in name):
            gemm["bf16"].append(e)
        elif "gemm" in name:
            gemm["f32"].append(e)
    gemm_ms = {t: sum(e.self_device_time_total for e in es) / 1e3
               for t, es in gemm.items()}
    flops = gemm_flops(cfg, TRAIN_BATCH * TRAIN_SEQ)
    out = {"phase": "train_profile", "split_ms": split,
           "gemm_ms": gemm_ms,
           "gemm_calls": {t: sum(e.count for e in es)
                          for t, es in gemm.items()},
           "bf16_gemm_flops": flops,
           "bf16_gemm_tflop_per_s": flops / gemm_ms["bf16"] / 1e9,
           "device_ms_per_step": dev_us / 1e3,
           # host time a launch waited for room in the device's queue:
           # the host ran ahead of the device
           "host_ms_command_buffer_full": sum(
               e.self_cpu_time_total for e in ka
               if e.key == "Command Buffer Full") / 1e3,
           "kernel_launches_per_step": launches,
           "device_busy_share": dev_us / (s_per_step * 1e6),
           "flash_attention_device_ms": (
               sum(e.self_device_time_total for e in fa) /
               sum(e.count for e in fa) / 1e3 if fa else None),
           "top_device_ms": {e.key[:80]: e.self_device_time_total / 1e3
                             for e in top}}
    emit(out)
    return out


def time_flash(torch, dev, cfg, worst):
    """flash_attention, its plain version and SDPA (measured only, never
    on the path) at the path's shape: q (1, 4096, 32, 128), K/V with 8
    heads, bf16, causal."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ops
    B, S, H, Hkv, D = path_shape(cfg)
    q, k, v = flash_inputs(torch, dev, B, S, H, Hkv, D, torch.bfloat16, 9)
    worst = max(worst, flash_err(torch, q, k, v, True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True).transpose(1, 2)
    torch.cuda.synchronize()
    flops = 2 * B * H * S * S * D            # two products, causal half
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * Hkv * D)
    return dict(
        ms=time_ms(torch, lambda: ops.flash_mha(q, k, v), 20, warmup=3),
        plain_ms=time_ms(torch, lambda: ops.flash_mha(q, k, v, impl="ref"),
                         3, warmup=1),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20, warmup=3),
        library_max_abs_err=float((lib.float() - ops.flash_mha(
            q, k, v, impl="ref").float()).abs().max()),
        bound_ms=max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / BF16_FLOP_PER_S >
        nbytes / HBM_BYTES_PER_S else "bytes", flops=flops, bytes=nbytes,
        design=FA.flash_attention.last_design,
        max_abs_err=worst,
        shape=dict(q=[B, S, H, D], kv=[B, S, Hkv, D], dtype="bfloat16",
                   causal=True))


def timed_steps(torch, cfg, batch=None, seq=None, steps=None):
    """``train``'s steps again, each timed on the host clock around a
    device sync: seed-0 parameters, the pipeline's batches and
    ``make_train_step`` (what ``train`` calls), without its checkpoint
    and restart bookkeeping (the train run's batch, sequence and steps by
    default).  Returns each step's loss, grad norm and seconds."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import core as M
    from repro_torch.training.data import TokenPipeline
    from repro_torch.training.optim import init_opt_state
    params = M.init_params(cfg, 0, device="cuda")
    opt = init_opt_state(params)
    step = make_train_step(cfg)
    pipe = TokenPipeline(cfg.vocab, batch or TRAIN_BATCH, seq or TRAIN_SEQ)
    out = []
    for _ in range(steps or TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).cuda() for k, v in next(pipe).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        loss = float(metrics["loss"])
        out.append({"loss": loss, "grad_norm": float(metrics["grad_norm"]),
                    "seconds": time.perf_counter() - t0})
    pipe.close()
    return out


def route_check(torch, cfg, losses):
    """One train step's loss, grad norm and attention-leaf gradients from
    seed-0 parameters and the pipeline's first batch (what ``train``'s
    first step saw) on the kernel route and on the plain route
    (``impl="ref"``)."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import core as M
    from repro_torch.training.data import TokenPipeline
    from repro_torch.training.optim import global_norm
    params = M.init_params(cfg, 0, device="cuda")
    pipe = TokenPipeline(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ)
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(pipe).items()}
    pipe.close()
    got, attn = {}, {}
    for impl in ("kernel", "ref"):
        loss, grads = loss_and_grads(cfg, params, batch, impl)
        got[impl] = (float(loss), float(global_norm(grads)))
        attn[impl] = {n: grads["blocks"][0][n] for n in ATTN_LEAVES}
        del grads
    (lk, gk), (lr, gr) = got["kernel"], got["ref"]
    leaf, per_layer = {}, {}
    for n in ATTN_LEAVES:
        a, b = attn["kernel"][n].float(), attn["ref"][n].float()
        leaf[n] = float((a - b).norm() / b.norm())
        per_layer[n] = ((a - b).flatten(1).norm(dim=1) /
                        b.flatten(1).norm(dim=1)).tolist()
    out = {"phase": "train_vs_plain", "loss_kernel": lk, "loss_plain": lr,
           "grad_norm_kernel": gk, "grad_norm_plain": gr,
           "attn_grad_rel_l2": leaf, "attn_grad_rel_l2_by_layer": per_layer,
           "train_first_loss": losses[0],
           "tolerance": {"loss_atol": TRAIN_LOSS_ATOL,
                         "grad_norm_rtol": TRAIN_GN_RTOL,
                         "attn_grad_rel_l2": TRAIN_LEAF_REL_L2}}
    emit(out)
    check(abs(lk - lr) <= TRAIN_LOSS_ATOL, f"train step: kernel-route loss "
          f"{lk} vs plain {lr} beyond {TRAIN_LOSS_ATOL}")
    check(abs(gk - gr) <= TRAIN_GN_RTOL * gr, f"train step: kernel-route "
          f"grad norm {gk} vs plain {gr} beyond rtol {TRAIN_GN_RTOL}")
    for n, e in leaf.items():
        check(math.isfinite(e) and e <= TRAIN_LEAF_REL_L2, f"train step: "
              f"kernel-route gradient of {n} vs plain: relative L2 {e} > "
              f"{TRAIN_LEAF_REL_L2}")
    check(abs(lk - losses[0]) <= TRAIN_LOSS_ATOL, f"train step: loss {lk} "
          f"from seed-0 parameters is not train's first loss {losses[0]}")


def restart_check(torch):
    """The reference's fault test on the card at smoke width: fail at step
    6 with checkpoints every 4 gives 12 losses, and the steps after the
    restore equal an uninterrupted run's (deterministic algorithms on,
    warning where an operation has none)."""
    from repro_torch.configs import CONFIGS
    from repro_torch.training.train_loop import FailureInjector, train
    cfg = CONFIGS[TRAIN_ARCH].smoke()
    dirs = [tempfile.mkdtemp(prefix="chip_smoke_ckpt_") for _ in range(2)]
    logs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        hit = train(cfg, steps=10, ckpt_dir=dirs[0], ckpt_every=4,
                    injector=FailureInjector([6]), log=logs.append)
        clean = train(cfg, steps=10, ckpt_dir=dirs[1], ckpt_every=4,
                      log=logs.append)
    finally:
        torch.use_deterministic_algorithms(False)
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    diff = max(abs(a - b) for a, b in zip(hit[6:], clean[4:])) \
        if len(hit) == 12 else None
    emit({"phase": "train_restart", "arch": f"{TRAIN_ARCH} smoke",
          "losses": hit, "uninterrupted": clean, "max_abs_diff": diff,
          "exact": hit[6:] == clean[4:], "tolerance": RESTART_ATOL,
          "log": logs})
    check(len(hit) == 12 and len(clean) == 10, f"restart run took "
          f"{len(hit)} steps, uninterrupted {len(clean)}")
    check(hit[:6] == clean[:6], "restart run differs before the failure")
    check(diff <= RESTART_ATOL, f"restart run differs from the "
          f"uninterrupted run after the restore by {diff}")
    check(any(m.startswith("FAILURE: injected") for m in logs),
          "the injected failure was not logged")


def phase_train(torch, dev, errs, profile_dir):
    from repro_torch.configs import CONFIGS
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.training.train_loop import train
    gc.collect()
    torch.cuda.empty_cache()                 # the serve phase's 17 GB
    cfg = CONFIGS[TRAIN_ARCH].scaled(n_layers=TRAIN_LAYERS)
    check_flash_backward(torch, dev, cfg)
    logs = []
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.flash_attention.launches = 0                   # just before the path
    t0 = time.time()
    try:
        losses = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                       seq=TRAIN_SEQ, ckpt_dir=ckdir,
                       ckpt_every=TRAIN_STEPS + 1, log=logs.append)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = FA.flash_attention.launches           # just after it
    peak = torch.cuda.max_memory_allocated()
    records = timed_steps(torch, cfg)
    timed = [r["seconds"] for r in records[1:]]
    s_step = sum(timed) / len(timed)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_SEQ) * TRAIN_BATCH
    emit({"phase": "train", "arch": TRAIN_ARCH, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": cfg.param_count(),
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": len(losses),
          "wall_s": round(wall, 3),
          "first_timed_step_s": records[0]["seconds"],
          "s_per_step": s_step, "tokens_per_s": tokens / s_step,
          "model_flops_per_step": flops,
          "model_tflop_per_s": flops / s_step / 1e12,
          "losses": losses, "timed_losses": [r["loss"] for r in records],
          "grad_norms": [r["grad_norm"] for r in records],
          "flash_attention_launches": launches,
          "launches_per_step": launches / len(losses),
          "peak_device_bytes": peak, "log": logs})
    check(len(losses) == TRAIN_STEPS and all(
        math.isfinite(x) for x in losses), f"train losses {losses}")
    check(all(math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
              for r in records), "non-finite or zero grad norm")
    check(all(abs(r["loss"] - x) <= TRAIN_LOSS_ATOL
              for r, x in zip(records, losses)), "the timed steps' losses "
          f"{[r['loss'] for r in records]} are not train's {losses}")
    check(launches == 2 * TRAIN_LAYERS * TRAIN_STEPS,
          f"flash_attention launches {launches} != 2 x layers x steps "
          f"{2 * TRAIN_LAYERS * TRAIN_STEPS} (forward and recompute)")
    if profile_dir:
        train_profile(torch, cfg, profile_dir, s_step)
        gc.collect()
        torch.cuda.empty_cache()
    route_check(torch, cfg, losses)
    gc.collect()
    torch.cuda.empty_cache()
    restart_check(torch)
    return launches, time_flash(torch, dev, cfg, errs["flash_attention"])


# ---------------------------------------------------------------------------
# the families on the training and prefill paths; the dry run
# ---------------------------------------------------------------------------
#: jamba's gradients: one hybrid period at full width (13.26 G parameters:
#: 26.5 GB of bf16 weights and as much of gradients; AdamW's f32 moments
#: would add 106 GB, so this run stops at the gradients) over one sequence
#: of FAMILY_GRAD_SEQ tokens: each Mamba scan chunk is recomputed in the
#: backward (models/core.py), so a Mamba layer keeps ~2 (B, S, 8192, 16)
#: f32 tensors, ~1 GB at 1024 tokens
FAMILY_GRAD_SEQ = 1024
#: xlstm-350m whole through ``train``: one sequence of XLSTM_SEQ tokens a
#: step (each sLSTM token is ~30 launches a layer), the first step warm
XLSTM_ARCH, XLSTM_SEQ, XLSTM_STEPS = "xlstm-350m", 512, 3
#: jamba's prefill past its window: one period, B = 1, S = 2 x window
#: (prefill_32k's 32 768 x 32 cut: its Mamba transients do not fit beside
#: 27.5 GB of weights); the plain route held beside the kernel route at
#: PREFILL_CHECK_SEQ, the longest S past the window (a multiple of the
#: 256-token scan chunk) at which the plain attention's (32, S, S) f32
#: scores (10.9 GB, about three live at once) fit beside the weights
PREFILL_SEQ, PREFILL_CHECK_SEQ = 2 * WINDOW, 9216
#: the fault planted in the kernel route's attention output to show the
#: families' route checks can fail (2^-5 high, as the serve lockstep's
#: ROUTER_FAULTS plant it)
PLANTED_SCALE = 2.0 ** -5
#: the batches jamba's gradients are read on: both on seed-0 parameters
#: (the first with the planted fault too), the first on seed-1 ones
JAMBA_GRAD_TOKEN_SEEDS = (11, 13)
#: jamba's gradient limits (loss, grad norm relative, attention leaf
#: relative L2), PERF.md section 2: from three honest readings on the
#: card (batches 11 and 13 on seed-0 parameters, batch 11 on seed-1 ones:
#: loss gaps 1.2e-4 / 4.4e-4 / 1.04e-3, grad norms 4.4e-4-7.2e-4, leaves
#: 0.039-0.041) and the planted 2^-5 attention fault (loss 2.3e-3, leaves
#: 0.105-0.106; it leaves the grad norm alone): loss and leaf near the
#: geometric mean of the largest honest and the planted reading, the grad
#: norm's the train limit.  One attention layer's bf16 rounding moves the
#: loss through seven Mamba and four MoE layers more than qwen3's 12
#: dense ones, whose 5e-4 stays
JAMBA_GRAD_LIMITS = (1.5e-3, TRAIN_GN_RTOL, 6.5e-2)
#: the dry run's cells at production size (started with the build, they
#: run on the host's CPU beside the card's phases, a minute or two each):
#: the train step's layouts, prefill's online KV chunks (jamba's window,
#: its MoE dispatch), decode's KV pool sharded over its pages with a
#: MoE dispatch of row-sharded tokens, and one decode row (jamba's whole
#: depth at ``long_500k``) contracted on the weights' own shards
DRYRUN_CELLS = (("qwen3-8b", "train_4k", False),
                ("jamba-v0.1-52b", "prefill_32k", True),
                ("phi3.5-moe-42b-a6.6b", "decode_32k", False),
                ("deepseek-coder-33b", "prefill_32k", False),
                ("jamba-v0.1-52b", "long_500k", False))
DRYRUN_TIMEOUT = 900
#: the most a decode step of rows the data axes do not shard may
#: all-gather a device: no weight, table or head gathered for one row (the
#: reference's program gathers 544 bytes at jamba's period; the port's
#: gathers of every dense weight read 761 MB at whole depth)
ONE_ROW_GATHER_BYTES = 1 << 20
#: each cell's argument and peak bytes a device before the pool was
#: sharded, prefill ran the online chunks and the MoE dispatch moved rows
#: (the dryrun phase's line on torch 2.11, the card's host), and
#: deepseek-coder-33b's before its 56 query heads were kept whole with the
#: query rows split over "model" (the 64-cell sweep on the card's host,
#: torch 2.11), and jamba-v0.1-52b long_500k's before its one row stopped
#: gathering the weights (the same sweep's parent, torch 2.11), printed
#: beside the run's own
DRYRUN_PARENT = {
    ("qwen3-8b", "train_4k", "16x16"): (323_545_092, 3_153_803_284),
    ("jamba-v0.1-52b", "prefill_32k", "2x16x16"): (438_550_528,
                                                   105_867_174_032),
    ("phi3.5-moe-42b-a6.6b", "decode_32k", "16x16"): (550_083_735_616,
                                                      1_375_206_199_628),
    ("deepseek-coder-33b", "prefill_32k", "16x16"): (262_539_264,
                                                     38_722_484_748),
    ("jamba-v0.1-52b", "long_500k", "16x16"): (775_688_716,
                                               1_919_354_416)}
#: qwen3-8b train_4k's peak a device on 16 x 16 (GiB) when DTensor laid
#: out every operator itself, weights gathered whole and the vocabulary
#: gathered for the loss (fake tensors, torch 2.11, the card's host): the
#: reading the phase prints its own beside
QWEN_TRAIN_PEAK_GIB_GREEDY = 238.0


class RouterReplay:
    """Installed over ``models.core.moe`` (``with RouterReplay(M) as
    rr``): with ``rr.mode = "record"`` each MoE call runs the model's
    ``moe`` and keeps its routing (each token's top-k experts); with
    ``"replay"`` the i-th call dispatches by the i-th recorded routing
    (``models.core.moe_dispatch`` with its own router's probabilities)
    and notes the tokens its own router would have sent elsewhere, with
    the largest gap of their router probabilities to the recorded call's
    (``rr.flips``).  The plain route replays the kernel route's routing,
    so the two are compared on the same experts: a near tie of a router
    that bf16 rounding tips would otherwise send tokens to other experts
    (the serve lockstep's ``ROUTER_TIE``), and one sequence of thousands
    of tokens has such ties in every run."""

    def __init__(self, torch, M):
        self.torch, self.M, self.real = torch, M, M.moe
        self.mode, self.calls, self.i, self.flips = "record", [], 0, []

    def __enter__(self):
        torch = self.torch

        def moe(p, cfg, x2d):
            probs, own = self.M.route(p, cfg, x2d)
            if self.mode == "record":
                self.calls.append((own, probs.detach()))
                return self.M.moe_dispatch(p, cfg, x2d, probs, own)
            idx, rprobs = self.calls[self.i]
            self.i += 1
            apart = (own.sort(dim=-1).values !=
                     idx.sort(dim=-1).values).any(dim=-1)
            if bool(apart.any()):
                gap = (probs.detach() - rprobs).abs().amax(dim=-1)[apart]
                self.flips.append((self.i - 1, int(apart.sum()),
                                   float(gap.max())))
            return self.M.moe_dispatch(p, cfg, x2d, probs, idx)
        self.M.moe = moe
        return self

    def replay(self):
        self.mode, self.i, self.flips = "replay", 0, []

    def __exit__(self, *exc):
        self.M.moe = self.real


class PlantedAttention:
    """Installed over ``models.core.flash_mha``: the kernel route's
    attention output ``1 + scale`` times the kernel's (the plain route's
    untouched).  A control: the families' route checks must fail it."""

    def __init__(self, M, scale):
        self.M, self.real, self.scale = M, M.flash_mha, scale

    def __enter__(self):
        real, scale = self.real, self.scale

        def flash_mha(q, k, v, causal=True, impl="kernel", window=0):
            o = real(q, k, v, causal, impl=impl, window=window)
            if impl != "kernel":
                return o
            return (o.float() * (1 + scale)).to(o.dtype)
        self.M.flash_mha = flash_mha
        return self

    def __exit__(self, *exc):
        self.M.flash_mha = self.real


def grad_run(torch, cfg, params, batch, impl):
    """One ``loss_and_grads``: loss, grad norm, the attention leaves'
    gradients (f32 copies), seconds and peak device bytes; the rest of
    the gradients are freed."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.training.optim import global_norm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    loss, grads = loss_and_grads(cfg, params, batch, impl)
    gn = float(global_norm(grads))
    torch.cuda.synchronize()
    out = dict(loss=float(loss), grad_norm=gn,
               attn={n: grads["blocks"][0][n].float().clone()
                     for n in ATTN_LEAVES},
               seconds=time.time() - t0,
               peak=torch.cuda.max_memory_allocated())
    del grads
    return out


def route_gaps(a, b, limits=None):
    """Kernel route ``a`` against plain route ``b``: the loss gap, the grad
    norm's relative gap, each attention leaf's relative L2 error, and
    whether each is within ``limits`` (loss, grad norm, leaf; by default
    PERF.md section 2's train limits)."""
    loss_atol, gn_rtol, leaf_l2 = limits or (
        TRAIN_LOSS_ATOL, TRAIN_GN_RTOL, TRAIN_LEAF_REL_L2)
    leaf = {n: float((a["attn"][n] - b["attn"][n]).norm() /
                     b["attn"][n].norm()) for n in ATTN_LEAVES}
    loss = abs(a["loss"] - b["loss"])
    gn = abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
    ok = (loss <= loss_atol and gn <= gn_rtol and
          all(math.isfinite(e) and e <= leaf_l2 for e in leaf.values()))
    return dict(loss_gap=loss, grad_norm_rel_gap=gn, attn_grad_rel_l2=leaf,
                within=ok)


def jamba_grads(torch, cfg, params, pseed, token_seeds, plant):
    """jamba (one period, full width, parameters from seed ``pseed``)
    ``loss_and_grads`` on the kernel route, then on the plain route
    replaying its MoE routing, on a batch from each of ``token_seeds``;
    with ``plant``, then the kernel route with the attention fault planted
    (replaying too) on the first batch: each honest pair within
    JAMBA_GRAD_LIMITS, the planted one beyond them.  The attention kernel
    runs twice a pair's kernel route (forward and the period's recompute);
    at S <= window it is the unwindowed instantiation."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import core as M
    runs = []
    for i, tseed in enumerate(token_seeds):
        g = torch.Generator(device="cuda").manual_seed(tseed)
        tok = torch.randint(0, cfg.vocab, (1, FAMILY_GRAD_SEQ + 1),
                            generator=g, device="cuda", dtype=torch.int32)
        batch = {"tokens": tok[:, :-1].contiguous(),
                 "labels": tok[:, 1:].contiguous()}
        with RouterReplay(torch, M) as rr:
            FA.flash_attention.launches = 0
            FA.flash_attention.window_launches = 0
            k = grad_run(torch, cfg, params, batch, "kernel")
            launches = (FA.flash_attention.launches,
                        FA.flash_attention.window_launches)
            rr.replay()
            r = grad_run(torch, cfg, params, batch, "ref")
            flips = rr.flips
            f = None
            if plant and i == 0:
                rr.replay()
                with PlantedAttention(M, PLANTED_SCALE):
                    f = grad_run(torch, cfg, params, batch, "kernel")
        for q in (k, r, f):
            if q is not None:
                q["routes_ok"] = math.isfinite(q["loss"]) and \
                    math.isfinite(q["grad_norm"]) and q["grad_norm"] > 0
        honest = route_gaps(k, r, JAMBA_GRAD_LIMITS)
        planted = None if f is None else route_gaps(f, r, JAMBA_GRAD_LIMITS)
        emit({"phase": "jamba_grads", "arch": JAMBA_ARCH,
              "layers": cfg.n_layers, "params": cfg.param_count(),
              "seq": FAMILY_GRAD_SEQ, "params_seed": pseed,
              "tokens_seed": tseed,
              "loss_kernel": k["loss"], "loss_plain": r["loss"],
              "grad_norm_kernel": k["grad_norm"],
              "grad_norm_plain": r["grad_norm"],
              "honest": honest, "planted": planted,
              "planted_scale": PLANTED_SCALE if f is not None else None,
              "plain_router_flips": flips,
              "flash_attention_launches": launches[0],
              "flash_attention_window_launches": launches[1],
              "seconds": {"kernel": k["seconds"], "plain": r["seconds"]},
              "peak_device_bytes": {"kernel": k["peak"], "plain": r["peak"]},
              "tolerance": dict(zip(("loss_atol", "grad_norm_rtol",
                                     "attn_grad_rel_l2"),
                                    JAMBA_GRAD_LIMITS))})
        runs.append((k, r, f, honest, planted, launches))
    for k, r, f, honest, planted, launches in runs:
        check(all(q["routes_ok"] for q in (k, r, f) if q is not None),
              "jamba gradients: a non-finite or zero loss or grad norm")
        check(launches == (2, 0), f"jamba gradients: flash_attention "
              f"launches {launches} != (2, 0) (forward and recompute, "
              f"unwindowed)")
        check(honest["within"], f"jamba gradients: kernel route against "
              f"plain route beyond the limits: {honest}")
        check(planted is None or not planted["within"],
              f"jamba gradients: the planted attention fault passed the "
              f"limits: {planted}")


def jamba_prefill(torch, cfg, params):
    """``make_prefill_step`` on one jamba period at PREFILL_SEQ tokens: the
    windowed kernel on its one attention sublayer, finite last-token
    logits; then at PREFILL_CHECK_SEQ the kernel route against the plain
    route (replaying the kernel route's MoE routing) within
    SERVE_LOGIT_TOL, and the planted fault's reading."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import core as M
    g = torch.Generator(device="cuda").manual_seed(12)
    tok = torch.randint(0, cfg.vocab, (1, PREFILL_SEQ), generator=g,
                        device="cuda", dtype=torch.int32)
    step = make_prefill_step(cfg)
    FA.flash_attention.launches = FA.flash_attention.window_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    logits = step(params, {"tokens": tok})
    torch.cuda.synchronize()
    secs, peak = time.time() - t0, torch.cuda.max_memory_allocated()
    launches = (FA.flash_attention.launches,
                FA.flash_attention.window_launches)
    check(tuple(logits.shape) == (1, cfg.vocab) and
          bool(torch.isfinite(logits).all()),
          f"jamba prefill: logits {tuple(logits.shape)} or non-finite")
    check(launches == (0, 1), f"jamba prefill at {PREFILL_SEQ}: "
          f"flash_attention launches {launches} != (0, 1) windowed")
    short = {"tokens": tok[:, :PREFILL_CHECK_SEQ].contiguous()}
    plain = make_prefill_step(cfg, impl="ref")
    with RouterReplay(torch, M) as rr:
        lk = step(params, short).float()
        rr.replay()
        torch.cuda.reset_peak_memory_stats()
        lr = plain(params, short).float()
        plain_peak = torch.cuda.max_memory_allocated()
        flips = rr.flips
        rr.replay()
        with PlantedAttention(M, PLANTED_SCALE):
            lf = step(params, short).float()
    diff = float((lk - lr).abs().max())
    planted = float((lf - lr).abs().max())
    emit({"phase": "jamba_prefill", "arch": JAMBA_ARCH,
          "layers": cfg.n_layers, "seq": PREFILL_SEQ,
          "window": cfg.sliding_window, "seconds": secs,
          "tokens_per_s": PREFILL_SEQ / secs, "peak_device_bytes": peak,
          "flash_attention_window_launches": launches[1],
          "check_seq": PREFILL_CHECK_SEQ, "max_abs_logit_diff": diff,
          "planted_max_abs_logit_diff": planted,
          "planted_scale": PLANTED_SCALE, "plain_router_flips": flips,
          "plain_peak_device_bytes": plain_peak,
          "tolerance": SERVE_LOGIT_TOL})
    check(diff <= SERVE_LOGIT_TOL, f"jamba prefill at {PREFILL_CHECK_SEQ}: "
          f"kernel route against plain route {diff} > {SERVE_LOGIT_TOL}")
    check(planted > SERVE_LOGIT_TOL, f"jamba prefill at "
          f"{PREFILL_CHECK_SEQ}: the planted attention fault moved the "
          f"logits {planted} <= {SERVE_LOGIT_TOL}")
    return launches[1]


def xlstm_train(torch):
    """xlstm-350m whole through ``train`` (AdamW) for XLSTM_STEPS steps,
    then the same steps timed: losses and grad norms finite, the timed
    losses ``train``'s."""
    from repro_torch.configs import CONFIGS
    from repro_torch.training.train_loop import train
    cfg = CONFIGS[XLSTM_ARCH]
    logs = []
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        losses = train(cfg, steps=XLSTM_STEPS, batch=1, seq=XLSTM_SEQ,
                       ckpt_dir=ckdir, ckpt_every=XLSTM_STEPS + 1,
                       log=logs.append)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.synchronize()
    wall, peak = time.time() - t0, torch.cuda.max_memory_allocated()
    records = timed_steps(torch, cfg, 1, XLSTM_SEQ, XLSTM_STEPS)
    timed = [r["seconds"] for r in records[1:]]
    s_step = sum(timed) / len(timed)
    emit({"phase": "xlstm_train", "arch": XLSTM_ARCH,
          "layers": cfg.n_layers, "params": cfg.param_count(), "batch": 1,
          "seq": XLSTM_SEQ, "steps": len(losses), "wall_s": wall,
          "s_per_step": s_step, "tokens_per_s": XLSTM_SEQ / s_step,
          "losses": losses, "timed_losses": [r["loss"] for r in records],
          "grad_norms": [r["grad_norm"] for r in records],
          "peak_device_bytes": peak, "log": logs})
    check(len(losses) == XLSTM_STEPS and all(math.isfinite(x)
                                             for x in losses),
          f"xlstm train losses {losses}")
    check(all(math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
              for r in records), "xlstm: non-finite or zero grad norm")
    check(all(abs(r["loss"] - x) <= TRAIN_LOSS_ATOL
              for r, x in zip(records, losses)), "xlstm: the timed steps' "
          f"losses {[r['loss'] for r in records]} are not train's {losses}")


def phase_families(torch, dev, errs):
    """jamba's gradients and long prefill, xlstm's training, and the
    windowed kernel's timing at jamba's prefill shape."""
    from repro_torch.configs import CONFIGS
    from repro_torch.models import core as M
    t0 = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = CONFIGS[JAMBA_ARCH].scaled(n_layers=JAMBA_LAYERS)
    params = M.init_params(cfg, seed=0, device="cuda")
    jamba_grads(torch, cfg, params, 0, JAMBA_GRAD_TOKEN_SEEDS, plant=True)
    gc.collect()
    torch.cuda.empty_cache()
    window_launches = jamba_prefill(torch, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    params = M.init_params(cfg, seed=1, device="cuda")
    jamba_grads(torch, cfg, params, 1, JAMBA_GRAD_TOKEN_SEEDS[:1],
                plant=False)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    xlstm_train(torch)
    t = time_flash_window(torch, dev, errs["flash_attention_window"])
    emit({"phase": "families", "seconds": round(time.time() - t0, 1)})
    return window_launches, t


def start_background(only):
    """The host's share of the panels, one process after another in the
    background (they take one of the host's cores from the card's
    phases): with ``panels``, each of ``repro_torch.bench.PANELS`` at
    ``--quick`` on the port's PySim; with ``speed_panels``, each of
    ``SPEED_PANELS`` the same way; with ``fleet_panels``, each of
    ``FLEET_PANELS`` at full size on PySim; with ``lm_panels``,
    ``serving_traffic`` on the host (the smoke sweep's engine on the CPU,
    co-residency at full size on PySim) and ``hillclimb --quick`` (its
    dry-run cells at production size on ``meta`` tensors).  Each is
    ``python -m repro_torch.bench.<name> ... --out DIR``.  Returns ``{name:
    (DIR, times)}``; a thread puts each run's exit code and wall seconds
    in ``times["rc"]`` and ``times["wall"]``, and its process in
    ``times["proc"]`` while it runs."""
    import threading
    from repro_torch.bench import FLEET_PANELS, PANELS, SPEED_PANELS
    jobs = []
    if "panels" in only:
        jobs += [(name, ["--quick", "--target", "pysim"]) for name in PANELS]
    if "speed_panels" in only:
        jobs += [(name, ["--quick", "--target", "pysim"])
                 for name in SPEED_PANELS]
    if "fleet_panels" in only:
        jobs += [(name, ["--target", "pysim"]) for name in FLEET_PANELS]
    if "lm_panels" in only:
        jobs += [("serving_traffic", ["--target", "pysim"]),
                 ("hillclimb", ["--quick"])]
    runs = {name: (tempfile.mkdtemp(prefix=f"chip_smoke_{name}_"), {})
            for name, _ in jobs}

    def serial():
        for name, argv in jobs:
            out, times = runs[name]
            start = time.time()
            with open(os.path.join(out, "log"), "w") as log:
                times["proc"] = subprocess.Popen(
                    [sys.executable, "-m", f"repro_torch.bench.{name}",
                     *argv, "--out", out],
                    cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                    env=dict(os.environ,
                             PYTHONPATH=os.path.join(ROOT, "src")))
                times["rc"] = times["proc"].wait()
            times["wall"] = time.time() - start
    threading.Thread(target=serial, daemon=True).start()
    return runs


def background_result(runs, name, deadline):
    """``name``'s background run once it has ended (by ``deadline``),
    checked to have exited 0: its output directory and its wall seconds."""
    out, times = runs[name]
    while "wall" not in times and time.time() < deadline:
        time.sleep(0.2)
    with open(os.path.join(out, "log")) as f:
        log = f.read()
    check(times.get("rc") == 0, f"{name} on the host: rc {times.get('rc')}"
          f" (wall {times.get('wall')})\n{log[-3000:]}")
    return out, times["wall"]


def same_files(name, card_dir, sim_dir):
    """Every ``torch_*.json`` of ``card_dir`` against the file of the same
    name in ``sim_dir``: the same files, the same modelled numbers
    (tolerance 0), and each of the card's names the card.  Returns the
    card's and the host's results by file."""
    from repro_torch.bench import panels
    files = sorted(f for f in os.listdir(card_dir) if f.startswith("torch_"))
    check(files and files == sorted(f for f in os.listdir(sim_dir)
                                    if f.startswith("torch_")),
          f"panel {name}: files {files}")
    out = {}
    for f in files:
        with open(os.path.join(card_dir, f)) as fh:
            card = json.load(fh)
        with open(os.path.join(sim_dir, f)) as fh:
            sim = json.load(fh)
        diff = panels.differences(card, sim)
        check(not diff, f"panel {name}, {f}: the card's modelled numbers "
              f"differ from the host's: {diff}")
        check(card["target"] == "card" and card["card"],
              f"panel {name}: {f} names no card")
        out[f] = card["result"], sim["result"]
    return out


def phase_panels(torch, runs):
    """The paper's eight FASE panels at ``--quick`` on the card
    (``TorchTarget`` on the CUDA device, through each panel's own
    ``run``), each file's modelled numbers equal to the same panel's PySim
    run started by ``start_background`` (tolerance 0: every field but the
    wall seconds); the wall of each beside PySim's."""
    import importlib
    from repro_torch.bench import PANELS
    t_phase = time.time()
    out = {}
    deadline = time.time() + PANELS_TIMEOUT
    for name in PANELS:
        sim_dir, sim_wall = background_result(runs, name, deadline)
        card_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_card_")
        twin = importlib.import_module(f"repro_torch.bench.{name}")
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):   # its row lines
            twin.run(quick=True, target="card", out_dir=card_dir)
        wall = time.time() - t0
        files = same_files(name, card_dir, sim_dir)
        out[name] = {"files": sorted(files), "card_wall_s": round(wall, 3),
                     "pysim_wall_s": round(sim_wall, 3)}
        shutil.rmtree(card_dir, ignore_errors=True)
        shutil.rmtree(sim_dir, ignore_errors=True)
    emit({"phase": "panels", "quick": True, "modelled_equal_to_pysim": True,
          "tolerance": 0, "panels": out,
          "seconds": round(time.time() - t_phase, 1)})


def phase_speed_panels(torch, runs):
    """The two speed panels at ``--quick`` on the card, through each
    twin's own ``run``: ``target_speed`` (its kernel rows on ``run_chunk``,
    with and without the fetch-block cache, its eager row on the eager
    loop with the standalone ``walk_fetch_block``, its fleet row on
    ``run_chunk_fleet``) and ``speedup`` (CoreMark on the card against
    PySim).  Each row's modelled numbers equal the same twin's run on the
    port's PySim (``start_background``), tolerance 0; the twin itself
    exits 1 where a row's launches are not one a chunk (a substep, a
    dispatch) or the quick gate fails.  Before them, ``run_chunk`` with
    ``block_cache=False`` (the ``kernel_nocache`` row's path) against the
    eager route with the same knob after every chunk on hello@UART.
    Returns the launches of each kernel on the two panels' paths."""
    import importlib
    from repro_torch.bench import SPEED_PANELS
    from repro_torch.bench import target_speed as TS
    from repro_torch.kernels.page_walk import page_walk
    from repro_torch.kernels.run_chunk import run_chunk as RC
    t_phase = time.time()
    chunks = []
    nocache, n_chunks = routes_in_lockstep(
        torch, "hello", [], HELLO_PINS, target_opts=dict(block_cache=False),
        keep=chunks, mode="fase", n_cores=1, mem=1 << 22)
    last = chunks[-1][1]
    hits, walks = int(last["fetch_hits"].sum()), int(last["fetch_walks"].sum())
    check(hits == 0 and walks > 0, f"block_cache=False: the kernel route "
          f"counted {hits} fetch-block hits and {walks} walks")
    del chunks, last
    emit({"phase": "nocache_vs_plain", "workload": "hello@uart",
          "target_opts": {"block_cache": False}, "chunks": n_chunks,
          "fields_equal_after_every_chunk": True, "tolerance": 0,
          "fetch_hits": hits, "fetch_walks": walks, "launches": nocache})
    counters = {"run_chunk": RC.run_chunk,
                "run_chunk_fleet": RC.run_chunk_fleet,
                "walk_fetch_block": page_walk.walk_fetch_block}
    out, launches = {}, {}
    deadline = time.time() + PANELS_TIMEOUT
    for name in SPEED_PANELS:
        twin = importlib.import_module(f"repro_torch.bench.{name}")
        card_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_card_")
        printed = io.StringIO()
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(printed):   # its row lines
                _, n = counted(counters, lambda: twin.run(
                    quick=True, target="card", out_dir=card_dir))
        except SystemExit as e:
            fail(f"speed panel {name} on the card exited {e.code}:\n"
                 f"{printed.getvalue()[-3000:]}")
        wall = time.time() - t0
        sim_dir, sim_wall = background_result(runs, name, deadline)
        with open(os.path.join(card_dir, f"torch_{name}.json")) as f:
            card = json.load(f)
        with open(os.path.join(sim_dir, f"torch_{name}.json")) as f:
            sim = json.load(f)
        check(card["target"] == "card" and card["card"],
              f"speed panel {name}: its file names no card")
        if name == "target_speed":
            rows = card["result"]["rows"]
            got = (TS.modelled_rows(card),
                   {r["name"]: r["runs"] for r in rows if "runs" in r})
            want = (TS.modelled_rows(sim),
                    {r["name"]: r["runs"]
                     for r in sim["result"]["rows"] if "runs" in r})
            check(n["run_chunk"] > 0 and n["run_chunk_fleet"] > 0 and
                  n["walk_fetch_block"] > 0, f"target_speed: launches {n}")
            out[name] = {
                "rows": {r["name"]: {k: r.get(k) for k in (
                    "instructions", "ticks", "ips", "wall_s", "runs",
                    "substeps", "dispatches", "launches")
                    if r.get(k) is not None} for r in rows},
                "kernel_vs_eager_speedup":
                card["result"]["kernel_vs_eager_speedup"],
                "fleet_aggregate_vs_one_board":
                card["result"]["fleet_aggregate_vs_one_board"]}
        else:
            got = [(r["instret"], r["model_s"]) for r in card["result"][:2]]
            want = [(r["instret"], r["model_s"]) for r in sim["result"][:2]]
            check(got[0] == got[1] and n["run_chunk"] > 0,
                  f"speedup: rows {got}, launches {n}")
            out[name] = {"rows": {r["target"]: {
                k: r[k] for k in ("instret", "model_s", "wall_s",
                                  "inst_per_s", "wall_per_iter")}
                for r in card["result"][:2]},
                "ratio": card["result"][2]["value"]}
        check(got == want, f"speed panel {name}: the card's modelled "
              f"numbers differ from PySim's: {got} != {want}")
        out[name].update(card_wall_s=round(wall, 3),
                         pysim_process_s=round(sim_wall, 3), launches=n)
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        shutil.rmtree(card_dir, ignore_errors=True)
        shutil.rmtree(sim_dir, ignore_errors=True)
    emit({"phase": "speed_panels", "quick": True,
          "modelled_equal_to_pysim": True, "tolerance": 0, "panels": out,
          "launches": launches, "seconds": round(time.time() - t_phase, 1)})
    return launches


def serve_counters():
    """The serving path's kernels and their launch counters."""
    from repro_torch.kernels.page_ops import page_ops
    from repro_torch.kernels.paged_attention import paged_attention
    return {"paged_attention": paged_attention.paged_attention,
            "page_set": page_ops.page_set, "page_copy": page_ops.page_copy}


def counted(counters, fn):
    """``fn()`` with every counter of ``counters`` (name -> the kernel's
    wrapper, or ``(wrapper, attribute)``) set to 0 just before it;
    returns its result and the counts read just after."""
    def ref(c):
        return c if isinstance(c, tuple) else (c, "launches")
    for c in counters.values():
        setattr(*ref(c), 0)
    out = fn()
    return out, {name: getattr(*ref(c)) for name, c in counters.items()}


def phase_fleet_panels(torch, runs):
    """The four fleet panels (``repro_torch.bench.FLEET_PANELS``) at full
    size on the card, every board a ``TorchTarget`` on the CUDA device
    (one ``run_chunk`` launch a chunk; migration's serving panel runs the
    smoke engine on the card): each file's modelled numbers equal to the
    checked-in ``results/<name>.json`` (the reference's full-size runs)
    and to the same panel's PySim run (``start_background``), tolerance
    0; results/fleet_scale.json's makespans (``FLEET_SCALE``) and
    results/migration.json's PCIe row (``MIGRATION_PCIE``) pinned; the
    card's wall of each beside PySim's.  Returns the launches of each
    kernel on these paths."""
    import importlib
    from repro_torch.bench import FLEET_PANELS, panels
    from repro_torch.core.interface import TorchTarget
    from repro_torch.kernels.run_chunk import run_chunk as RC
    t_phase = time.time()
    counters = {"run_chunk": RC.run_chunk,
                "run_chunk_trace": (RC.run_chunk, "trace_launches"),
                "run_chunk_fleet": RC.run_chunk_fleet, **serve_counters()}
    real, boards = panels.make_target, []

    def make_target(target, n_cores, mem):
        t = real(target, n_cores, mem)
        check(target == "card" and isinstance(t, TorchTarget) and
              t.device.type == "cuda", f"a {type(t).__name__} board on "
              f"{target}")
        boards.append(n_cores)
        return t
    out, launches, results = {}, {}, {}
    deadline = time.time() + PANELS_TIMEOUT
    panels.make_target = make_target
    try:
        for name in FLEET_PANELS:
            twin = importlib.import_module(f"repro_torch.bench.{name}")
            card_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_card_")
            boards.clear()
            t0 = time.time()
            with contextlib.redirect_stdout(io.StringIO()):
                result, n = counted(counters, lambda: twin.run(
                    quick=False, target="card", out_dir=card_dir))
            wall = time.time() - t0
            with open(os.path.join(ROOT, "results", f"{name}.json")) as f:
                want = json.load(f)
            diff = panels.differences(result, want)
            check(not diff and not want["quick"], f"fleet panel {name}: the"
                  f" card's modelled numbers differ from results/{name}"
                  f".json: {diff}")
            sim_dir, sim_wall = background_result(runs, name, deadline)
            _, sim = same_files(name, card_dir, sim_dir)[f"torch_{name}.json"]
            check(n["run_chunk"] > 0 and n["run_chunk_fleet"] == 0,
                  f"fleet panel {name}: launches {n}")
            results[name] = result
            for k, v in n.items():
                launches[k] = launches.get(k, 0) + v
            out[name] = {"card_wall_s": round(wall, 3),
                         "card_rows_wall_s":
                         round(sum(panels.walls(result)), 3),
                         "pysim_rows_wall_s":
                         round(sum(panels.walls(sim)), 3),
                         "pysim_process_s": round(sim_wall, 3),
                         "boards": len(boards), "launches": n}
            shutil.rmtree(card_dir, ignore_errors=True)
            shutil.rmtree(sim_dir, ignore_errors=True)
    finally:
        panels.make_target = real
    scale = {(r["link"], r["n_devices"]): r["makespan_ticks"]
             for r in results["fleet_scale"]["scale"]}
    check(scale == FLEET_SCALE, f"fleet_scale {scale} != {FLEET_SCALE}")
    row = next(r for r in results["migration"]["migration"]
               if r["link"] == "pcie")
    got = dict(baseline=row["baseline_ticks"], migrated=row["migrated_ticks"],
               pages=row["full"]["pages"], src_bytes=row["full"]["src_bytes"],
               dst_bytes=row["full"]["dst_bytes"])
    check(got == MIGRATION_PCIE, f"migration {got} != {MIGRATION_PCIE}")
    check(all(r["output_identical"] for r in results["migration"]
              ["migration"]), "a migrated job's output differs")
    emit({"phase": "fleet_panels", "quick": False,
          "modelled_equal_to_results": True, "tolerance": 0,
          "fleet_scale_pins": {f"{k}_{n}": v for (k, n), v in scale.items()},
          "migration_pcie_pin": got, "panels": out, "launches": launches,
          "seconds": round(time.time() - t_phase, 1)})
    return launches


#: the LM examples the ``lm_panels`` phase runs on the card, with their
#: short argv
#: torch_quickstart.py on the card against the same example on the host,
#: from the same weights: each step's loss within QUICKSTART_LOSS_ATOL and
#: grad norm within QUICKSTART_GN_RTOL (relative), the tolerances the
#: port's train runs are held to against the reference's
#: (tests/test_torch_training.py TRAIN_LOSS_ATOL, GRAD_REL_L2).  Labels
#: shifted by one token move the losses by 2e-2 (a planted fault in the
#: quickstart, against tests/test_torch_examples_lm.py)
QUICKSTART_LOSS_ATOL, QUICKSTART_GN_RTOL = 5e-3, 5e-2
LM_EXAMPLES = (("torch_quickstart.py", ["--steps", "5", "--decode", "8"]),
               ("torch_serve_paged.py", []),
               ("torch_train_lm.py", ["20"]))


def run_example(script, argv):
    """``examples/<script>`` run in this process as ``__main__`` with
    ``argv`` (the card by default): its globals and what it printed."""
    import runpy
    saved = sys.argv
    sys.argv = [script, *argv]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            g = runpy.run_path(os.path.join(ROOT, "examples", script),
                               run_name="__main__")
    finally:
        sys.argv = saved
    return g, buf.getvalue()


def quickstart_steps(printed):
    """The losses and grad norms that ``torch_quickstart.py`` printed."""
    rows = [x for x in printed.splitlines() if x.startswith("step ")]
    return ([float(x.split("loss=")[1].split()[0]) for x in rows],
            [float(x.split("gnorm=")[1]) for x in rows])


def host_drawn_params(M):
    """``M.init_params`` drawn on the host and moved to the device asked
    for: the card's and the host's runs of an example start from the
    same weights.  Returns it and the real one."""
    from repro_torch.training.optim import tree_map
    draw = M.init_params

    def init_params(cfg, seed=0, device="cuda"):
        return tree_map(lambda t: t.to(device), draw(cfg, seed, "cpu"))
    return init_params, draw


def lm_examples(torch):
    """The three LM examples at a short argv on the card: quickstart's
    losses and grad norms against the same example on the host (both from
    weights drawn on the host) within QUICKSTART_LOSS_ATOL and
    QUICKSTART_GN_RTOL, its greedy streams whole; serve_paged's schedule,
    page statistics and traffic the reference example's (its tokens are
    the port's own); train_lm's run with its injected failure replayed.
    Returns each one's line and the launches of each kernel."""
    import numpy as np
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import core as M
    counters = {"flash_attention": FA.flash_attention, **serve_counters()}
    out, launches = {}, dict.fromkeys(counters, 0)
    for script, argv in LM_EXAMPLES:
        ckdir = tempfile.mkdtemp(prefix="chip_smoke_train_lm_")
        argv = argv + (["--ckpt-dir", ckdir] if "train" in script else [])
        if "quickstart" in script:
            M.init_params, draw = host_drawn_params(M)
        t0 = time.time()
        try:
            (g, printed), n = counted(counters,
                                      lambda: run_example(script, argv))
            torch.cuda.synchronize()
            wall = time.time() - t0
            if "quickstart" in script:
                host_g, host_printed = run_example(
                    script, argv + ["--device", "cpu"])
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
            if "quickstart" in script:
                M.init_params = draw
        line = {"wall_s": round(wall, 3), "launches": n,
                "printed": printed.strip().splitlines()[-2:]}
        if "quickstart" in script:
            losses, gnorms = quickstart_steps(printed)
            host_losses, host_gnorms = quickstart_steps(host_printed)
            check(len(losses) == 5 and all(map(math.isfinite, losses)) and
                  len(g["out"]) == 8 and n["flash_attention"] > 0 and
                  n["paged_attention"] > 0,
                  f"{script}: losses {losses}, launches {n}")
            check(len(host_losses) == 5 and all(
                abs(a - b) <= QUICKSTART_LOSS_ATOL and
                abs(u - v) <= QUICKSTART_GN_RTOL * abs(v)
                for a, b, u, v in zip(losses, host_losses, gnorms,
                                      host_gnorms)),
                f"{script} on the card against the host: losses {losses} "
                f"vs {host_losses}, grad norms {gnorms} vs {host_gnorms}")
            line.update(losses=losses, host_losses=host_losses,
                        grad_norms=gnorms, host_grad_norms=host_gnorms,
                        greedy_equal_to_host=bool(
                            (np.stack(g["out"], 1) ==
                             np.stack(host_g["out"], 1)).all()))
        elif "serve" in script:
            eng = g["eng"]
            check(eng.steps == 150 and eng.kv.stats == {
                "alloc": 14, "cow": 0, "prefix_hits": 4, "freed": 14} and
                eng.traffic.h2d_bytes == 11_344 and
                eng.traffic.d2h_bytes == 2_700 and
                len(g["done"]) == 6 and n["paged_attention"] ==
                150 * g["cfg"].n_layers and n["page_set"] > 0,
                f"{script}: steps {eng.steps}, kv {eng.kv.stats}, traffic "
                f"{eng.traffic}, launches {n}")
        else:
            losses = g["losses"]
            check(len(losses) == 30 and all(map(math.isfinite, losses)) and
                  n["flash_attention"] > 0,
                  f"{script}: {len(losses)} losses, launches {n}")
        out[script] = line
        for k, v in n.items():
            launches[k] += v
    return out, launches


#: the counts of a serving_traffic row that a stream's length reaches: a
#: greedy near tie may move these between the card and the host, and
#: nothing else
STREAM_COUNTS = {"steps", "d2h", "finished"}


def sweep_engine(cfg, poll):
    """The ``serving_traffic`` sweep's engine at ``poll``, for
    ``lockstep``."""
    from repro_torch.bench import serving_traffic as ST
    return lambda impl, params, device: ST.new_engine(cfg, params, poll,
                                                      device, impl)


def phase_lm_panels(torch, runs, dry_cells, rates):
    """The LM-side twins and examples on the card:

    * ``serving_traffic`` at the reference's size (the smoke sweep, and
      co-residency at full size on a 2-core ``TorchTarget``): the modelled
      numbers equal to the same twin's host run (``start_background``:
      the sweep's engine on the CPU with the same weights, co-residency on
      PySim) and co-residency's to the checked-in
      ``results/serving_coresidency.json``, tolerance 0; each poll's
      engine on the card against the same engine on the CPU by
      ``lockstep``'s rule, and a row apart from the host's only in its
      ``STREAM_COUNTS`` and only where that poll's lockstep found a near
      tie;
    * the sweep at full width (qwen3-8b whole; each sweep runs its first
      poll's engine once untimed before its rows): its rows, and each poll's
      engine on the kernel route against the plain route by ``lockstep``;
    * ``roofline`` over the ``dryrun`` phase's cells and the card's
      measured rates; ``hillclimb --quick`` (run on the host in the
      background): every variant ``OK``, its direction read from its
      counts;
    * the three LM examples at a short argv.

    Returns the launches of each kernel on these paths."""
    from repro_torch.bench import panels, roofline, serving_traffic as ST
    from repro_torch.configs import CONFIGS
    t_phase = time.time()
    deadline = time.time() + PANELS_TIMEOUT
    counters = serve_counters()
    launches = dict.fromkeys(counters, 0)

    def add(n):
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
    card_dir = tempfile.mkdtemp(prefix="chip_smoke_serving_traffic_card_")
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        rows, n = counted(counters, lambda: ST.run(
            quick=False, target="card", out_dir=card_dir))
    wall = time.time() - t0
    add(n)
    # each row's steps, and the untimed warm-up run's (the first poll's
    # engine: the first row's steps)
    check(n["paged_attention"] == (sum(r["steps"] for r in rows) +
                                   rows[0]["steps"]) *
          CONFIGS["qwen3-8b"].smoke().n_layers and n["page_set"] > 0,
          f"serving_traffic launches {n}")
    sim_dir, sim_wall = background_result(runs, "serving_traffic", deadline)
    files = {}
    for f in ("torch_serving_traffic.json",
              "torch_serving_coresidency.json"):
        with open(os.path.join(card_dir, f)) as fh:
            files[f] = json.load(fh)
        check(files[f]["card"], f"{f} names no card")
    with open(os.path.join(ROOT, "results", "serving_coresidency.json")) as fh:
        co_want = json.load(fh)
    diff = panels.differences(files["torch_serving_coresidency.json"],
                              co_want)
    check(not diff, f"co_residency on the card against results/serving_"
          f"coresidency.json: {diff}")
    with open(os.path.join(sim_dir, "torch_serving_traffic.json")) as fh:
        host_sweep = json.load(fh)["result"]
    sweep_diff = panels.differences(files["torch_serving_traffic.json"],
                                    host_sweep)
    with open(os.path.join(sim_dir, "torch_serving_coresidency.json")) as fh:
        check(not panels.differences(files["torch_serving_coresidency.json"],
                                     json.load(fh)),
              "co_residency on the card differs from PySim's")
    # the card's bf16 against the host's, step by step: a greedy near tie
    # (a differing token within lockstep's tolerance) may move the counts,
    # nothing else may
    cfg, params = ST.model("smoke", "card")
    near_tie = {}
    for poll in ST.POLLS:
        _, stats, _, _ = lockstep(
            torch, cfg, params, ref_params=panels.lm_params(cfg, "cpu"),
            ref_device="cpu", run=f"serving_traffic poll {poll} card vs cpu",
            engine=sweep_engine(cfg, poll))
        near_tie[poll] = stats["near_ties"]
    host_rows = {r["poll_every"]: panels.modelled(r) for r in host_sweep}
    for row in panels.modelled(files["torch_serving_traffic.json"]):
        poll = row["poll_every"]
        moved = {k for k in row if row[k] != host_rows[poll].get(k)}
        check(not moved or (near_tie[poll] and moved <= STREAM_COUNTS),
              f"the sweep's poll {poll} row differs between the card and "
              f"the host in {sorted(moved)} (near ties in its lockstep: "
              f"{near_tie[poll]}): {sweep_diff}")
    # the sweep at full width: the kernel route's rows, then each poll's
    # engine on both routes in lockstep
    cfg, params = ST.model("qwen3-8b", "card")
    full_rows, n = counted(counters, lambda: ST.sweep(cfg, params, "card"))
    add(n)
    check(n["paged_attention"] == (sum(r["steps"] for r in full_rows) +
                                   full_rows[0]["steps"]) * cfg.n_layers,
          f"serving_traffic at full width: launches {n}")
    panels.save_json(ST.file_name("qwen3-8b"), full_rows, "card", False,
                     card_dir)
    full_vs_plain = {}
    for poll in ST.POLLS:
        ek, stats, _, _ = lockstep(torch, cfg, params,
                                   run=f"serving_traffic qwen3-8b poll "
                                       f"{poll}",
                                   engine=sweep_engine(cfg, poll))
        row = next(r for r in full_rows if r["poll_every"] == poll)
        full_vs_plain[poll] = {"steps": stats["steps"],
                               "max_logit_abs_err":
                               stats["max_logit_abs_err"],
                               "near_ties": len(stats["near_ties"])}
        check(stats["steps"] == row["steps"] and ek.traffic.d2h_bytes ==
              row["d2h"], f"qwen3-8b poll {poll}: the lockstep run differs "
              f"from the timed sweep")
    del params, ek
    gc.collect()
    torch.cuda.empty_cache()
    # the dry run's readings
    table = roofline.run(target="card", out_dir=card_dir, cells=dry_cells,
                         measured=rates)
    check(len(table) == len(dry_cells) and all(
        r["model_flops"] > 0 and r["useful_flop_frac"] > 0 and
        0 < r["roofline_frac"] <= 1 for r in table),
        f"roofline over the dry run's cells: {table}")
    hc_dir, hc_wall = background_result(runs, "hillclimb", deadline)
    with open(os.path.join(hc_dir, "torch_hillclimb.json")) as fh:
        climb = json.load(fh)["result"]
    check([r["variant"] for r in climb] == ["baseline", "tp_serve"] and
          all(r["status"] == "OK" for r in climb) and
          climb[1]["vs_baseline"]["moved"] in ("down", "up", "same"),
          f"hillclimb --quick: {climb}")
    examples, n = lm_examples(torch)
    add(n)
    emit({"phase": "lm_panels",
          "serving_traffic": {
              "rows": files["torch_serving_traffic.json"]["result"],
              "card_wall_s": round(wall, 3),
              "host_rows_wall_s": round(sum(panels.walls(host_sweep)), 3),
              "host_process_s": round(sim_wall, 3),
              "modelled_equal_to_host": not sweep_diff,
              "card_vs_cpu_near_ties": near_tie},
          "co_residency_equal_to_results": True, "tolerance": 0,
          "serving_traffic_full_width": {
              "arch": cfg.name, "layers": cfg.n_layers,
              "d_model": cfg.d_model, "rows": full_rows,
              "kernel_vs_plain": full_vs_plain},
          "roofline": [{k: r.get(k) for k in (
              "arch", "shape", "mesh", "model_flops", "useful_flop_frac",
              "roofline_frac", "roofline_measured")} for r in table],
          "hillclimb_quick": {"wall_s": round(hc_wall, 1),
                              "vs_baseline": climb[1]["vs_baseline"]},
          "examples": examples, "launches": launches,
          "seconds": round(time.time() - t_phase, 1)})
    shutil.rmtree(card_dir, ignore_errors=True)
    shutil.rmtree(sim_dir, ignore_errors=True)
    shutil.rmtree(hc_dir, ignore_errors=True)
    return launches


def start_dryrun():
    """``python -m repro_torch.launch.dryrun`` on each of DRYRUN_CELLS at
    production size, started at once in the background (``meta`` tensors
    on the host's CPU, no card): ``[(cell, out path, Popen, times)]``, where
    a thread puts each process's wall seconds in ``times["wall"]`` when it
    ends."""
    import threading

    def clock(proc, times):
        proc.wait()
        times["wall"] = time.time() - times["start"]
    runs = []
    for arch, shape, multi_pod in DRYRUN_CELLS:
        path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_dry_"),
                            "cell.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", path] + \
            (["--multi-pod"] if multi_pod else [])
        times = {"start": time.time()}
        with open(path + ".log", "w") as log:    # no pipe for it to fill
            proc = subprocess.Popen(
                cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
        threading.Thread(target=clock, args=(proc, times),
                         daemon=True).start()
        runs.append(((arch, shape, multi_pod), path, proc, times))
    return runs


def dryrun_pool_bytes(arch, shape):
    """The bytes of a decode cell's whole KV pools (both), from the
    decode state's shapes on the ``meta`` device."""
    from repro_torch.configs import CONFIGS
    from repro_torch.launch import steps as st
    state = st.abstract_decode_state(CONFIGS[arch], st.SHAPES[shape]["batch"],
                                     st.SHAPES[shape]["seq"])
    return sum(state[n].numel() * state[n].element_size()
               for n in ("kpool", "vpool"))


def dryrun_pool_ways(arch, shape, cell):
    """The devices a decode cell's KV pools are split over, by the
    reference's rule (``sharding.decode_state_specs``): the data axes
    where they divide the batch, then "model" where it divides a row's
    pages (neither at one row of 129 pages: the pools whole on every
    device, as the reference's)."""
    from repro_torch.configs import CONFIGS
    from repro_torch.launch import steps as st
    from repro_torch.models.core import pages_per_seq
    tp = cell["mesh_shape"]["model"]
    dp = cell["n_chips"] // tp
    pages = pages_per_seq(CONFIGS[arch], st.SHAPES[shape]["seq"])
    return (dp if st.SHAPES[shape]["batch"] % dp == 0 else 1) * \
        (tp if pages % tp == 0 else 1)


def phase_dryrun(torch, dev, runs):
    """The dry-run cells started by ``start_dryrun`` (they ran beside the
    card's phases), each report read back and ``OK``, a decode cell's KV
    pools a device the whole pools over the devices that split them, a
    decode whose rows the data axes do not shard all-gathering at most
    ``ONE_ROW_GATHER_BYTES`` a device; the card's measured rates beside
    the data sheet's the roofline divides by.  Returns the
    cells' reports and the rates."""
    from repro_torch.bench.roofline import measured_rates
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import steps as st
    rates = measured_rates(torch, dev)
    out = []
    for (arch, shape, multi_pod), path, proc, times in runs:
        try:
            proc.wait(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        wall = times.get("wall", time.time() - times["start"])
        with open(path + ".log") as f:
            log = f.read()
        check(proc.returncode == 0, f"dryrun {arch} {shape} multi_pod="
              f"{multi_pod}: rc {proc.returncode}\n{log[-3000:]}")
        with open(path) as f:
            cell = json.load(f)[0]
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
        check(cell["status"] == "OK", f"dryrun {arch} {shape}: {cell}")
        pool = cell["per_device"].get("kv_pool_bytes")
        if pool is not None:
            whole = dryrun_pool_bytes(arch, shape)
            ways = dryrun_pool_ways(arch, shape, cell)
            check(pool * ways == whole, f"dryrun {arch} {shape}: the KV "
                  f"pools hold {pool} bytes a device, not the whole pools' "
                  f"{whole} over {ways} devices")
        dp = cell["n_chips"] // cell["mesh_shape"]["model"]
        if st.SHAPES[shape]["batch"] % dp:
            gathered = cell["collective_bytes_per_device"].get(
                "all-gather", 0)
            check(gathered <= ONE_ROW_GATHER_BYTES, f"dryrun {arch} {shape}:"
                  f" one row all-gathers {gathered} bytes a device, over "
                  f"{ONE_ROW_GATHER_BYTES}")
        parent = DRYRUN_PARENT.get((arch, shape, cell["mesh"]))
        out.append({**cell, "wall_s": round(wall, 1),
                    "parent_per_device": parent and {
                        "argument_bytes": parent[0], "peak_bytes": parent[1]}})
    qwen = next(c for c in out if (c["arch"], c["shape"], c["mesh"]) ==
                ("qwen3-8b", "train_4k", "16x16"))
    emit({"phase": "dryrun", "cells": out, "measured": rates,
          "qwen3_train_4k_peak_gib":
          qwen["per_device"]["peak_bytes"] / 2 ** 30,
          "qwen3_train_4k_peak_gib_greedy_layout":
          QWEN_TRAIN_PEAK_GIB_GREEDY,
          "data_sheet": {"bf16_flop_per_s": DR.PEAK_FLOPS,
                         "hbm_bytes_per_s": DR.HBM_BW,
                         "link_bytes_per_s": DR.LINK_BW}})
    return out, rates


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=DEFAULT_SCALE,
                    choices=sorted(FULL_WIDTH))
    ap.add_argument("--only", nargs="+", choices=PHASES, default=PHASES,
                    help="run only these phases (the final ok line needs "
                         "all of them)")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "smoke_out"),
                    help="directory for the --profile tables")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this check runs on a GPU only", file=sys.stderr)
        return 1

    t_start = time.time()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # the host's PySim panels need no kernel: they start before the build
    host = start_background(args.only)
    dry = []
    try:
        phase_build()
        dry = start_dryrun() if "dryrun" in args.only else []
        return run_phases(torch, dev, args, smi, t_start, dry, host)
    finally:
        procs = [proc for _, _, proc, _ in dry] + \
            [times["proc"] for _, times in host.values() if "proc" in times]
        for proc in procs:                # stop what a failed run left
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_phases(torch, dev, args, smi, t_start, dry, host):
    """Every phase of ``args.only`` in order; returns the exit code."""
    errs = dict.fromkeys(REPLACES, 0.0)
    kernels = []
    # each kernel's launches on the paths after its own, by phase
    more = {}
    if "kernel" in args.only:
        errs = phase_kernel(torch, dev)
    if {"kernel", "full", "telemetry", "fleet"} & set(args.only):
        from repro_torch.configs.registry import FASE_ROCKET_PCIE
        latency = phase_latency(torch, dev, FASE_ROCKET_PCIE["mem_bytes"] // 8)
    walk_launches = None
    cluster_timing = None
    # with both phases, bc@PCIe's one eager run is the telemetry phase's
    # armed run, held against both kernel routes after every chunk
    bc_chunks = [] if {"chunk", "telemetry"} <= set(args.only) else None
    if "chunk" in args.only:
        walk_launches, cluster_launches = phase_chunk(torch, bc_chunks)
        timing = cluster_timing = time_cluster(torch)
        for name, n in zip(("run_chunk_cluster", "run_chunk_trace_cluster"),
                           cluster_launches):
            t = timing[name]
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": n,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": "bytes", "library_ms": None,
                "us_per_substep": t["us_per_substep"], "shape": t["shape"],
                "note": "the cluster instantiation of run_chunk "
                        "(run_chunk_kernel<TRACE, true, true>): a board "
                        "past one CTA; launches are the cluster_boards "
                        "runs' (500 and 1025 cores, and 512 at "
                        "cta_lanes 32), one a chunk"})
    if "full" in args.only:
        launches, t, c = phase_full(torch, args.scale,
                                    errs["walk_fetch_block"], latency,
                                    args.out if args.profile else None)
        kernels.append({
            "name": "run_chunk", "route": "cuda",
            "source": SOURCES["run_chunk"],
            "replaces": REPLACES["run_chunk"], "launches": launches,
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "device_ms": c["device_ms"], "round_trips": c["round_trips"],
            "latency_bound_ms": c["latency_bound_ms"],
            "load_latency_ns": latency, "shape": c["shape"],
            "note": "no pallas_call: the chunk loop the reference leaves "
                    "to XLA's while_loop, with walk_fetch_block as its "
                    "device function"})
        kernels.append({
            "name": "walk_fetch_block", "route": "cuda",
            "source": SOURCES["walk_fetch_block"],
            "replaces": REPLACES["walk_fetch_block"],
            "launches": walk_launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shape": t["shape"],
            "note": "launched standalone by the eager route "
                    "(chunk_kernel='ref', phase chunk_vs_plain); on the "
                    "kernel route its device functions run inside "
                    "run_chunk"})
    if "coremark" in args.only:
        phase_coremark(torch)
    if "panels" in args.only:
        phase_panels(torch, host)
    if "speed_panels" in args.only:
        more["speed_panels"] = phase_speed_panels(torch, host)
    if "telemetry" in args.only:
        launches, c, bc_walks = phase_telemetry(torch, args.scale, latency,
                                                bc_chunks)
        if bc_chunks is not None:
            bc_chunks.clear()         # the card's copies of bc's chunks
            walk = next((k for k in kernels
                         if k["name"] == "walk_fetch_block"), None)
            if walk is not None:      # bc's eager walks ran armed
                walk["launches"] += bc_walks
                walk["note"] += ("; bc@pcie's eager walks are the armed "
                                 "run's in telemetry_goldens, held against "
                                 "both kernel routes")
        kernels.append({
            "name": "run_chunk_trace", "route": "cuda",
            "source": SOURCES["run_chunk_trace"],
            "replaces": REPLACES["run_chunk_trace"], "launches": launches,
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "device_ms": c["device_ms"],
            "untraced_device_ms": c["untraced_device_ms"],
            "us_per_substep": c["us_per_substep"],
            "untraced_us_per_substep": c["untraced_us_per_substep"],
            "round_trips": c["round_trips"],
            "latency_bound_ms": c["latency_bound_ms"],
            "load_latency_ns": latency, "shape": c["shape"],
            "note": "no pallas_call: the traced instantiation of run_chunk "
                    "(run_chunk_kernel<true>), the commit-trace ring of the "
                    "reference's substep; launches are the full-width armed "
                    "run's, one a chunk"})
    if "fleet" in args.only:
        launches, c, cluster_launches = phase_fleet(torch, latency)
        kernels.append({
            "name": "run_chunk_fleet", "route": "cuda",
            "source": SOURCES["run_chunk_fleet"],
            "replaces": REPLACES["run_chunk_fleet"], "launches": launches,
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "device_ms": c["device_ms"], "round_trips": c["round_trips"],
            "latency_bound_ms": c["latency_bound_ms"],
            "load_latency_ns": latency, "shape": c["shape"],
            "note": "no pallas_call: the reference's flat-fleet loop, one "
                    "CTA a board; launches are the full-width gang's and "
                    "run_synchronous's, one a global chunk"})
        t = (cluster_timing or time_cluster(torch))["run_chunk_fleet_cluster"]
        kernels.append({
            "name": "run_chunk_fleet_cluster", "route": "cuda",
            "source": SOURCES["run_chunk_fleet_cluster"],
            "replaces": REPLACES["run_chunk_fleet_cluster"],
            "launches": cluster_launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "us_per_substep": t["us_per_substep"],
            "shape": t["shape"],
            "note": "the cluster instantiation of the fleet kernel "
                    "(run_chunk_fleet_kernel<true, true>): one cluster a "
                    "board past one CTA; launches are the 2 x 500-core "
                    "fleet's and the 2 x 288-core one's at cta_lanes 32, "
                    "one a global chunk"})
    if "fleet_panels" in args.only:
        more["fleet_panels"] = phase_fleet_panels(torch, host)
    if "serve" in args.only:
        launches, timing = phase_serve(torch, errs,
                                       args.out if args.profile else None)
        for name, t in timing.items():
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": "bytes", "library_ms": t["library_ms"],
                **{k: t[k] for k in ("device_ms", "long_context") if k in t},
                "shape": t["shape"]})
            if name == "page_gather":
                kernels[-1].update(note="no path of the system calls "
                                        "page_gather; checked and timed "
                                        "alone")
        gc.collect()
        torch.cuda.empty_cache()
        n_window, t = serve_jamba(torch, errs,
                                  args.out if args.profile else None)
        kernels.append({
            "name": "paged_attention_window", "route": "cuda",
            "source": SOURCES["paged_attention_window"],
            "replaces": REPLACES["paged_attention_window"],
            "launches": n_window, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "wrapped_ring": t["wrapped_ring"], "shape": t["shape"],
            "note": "the windowed instantiation of paged_attention "
                    "(paged_attention_kernel<..., true>): jamba's ring "
                    "under its 8192-token window; launches are the jamba "
                    "serve run's, one a decode step"})
        serve_xlstm(torch, args.out if args.profile else None)
    if "train" in args.only:
        launches, t = phase_train(torch, dev, errs,
                                  args.out if args.profile else None)
        kernels.append({
            "name": "flash_attention", "route": "cuda",
            "source": SOURCES["flash_attention"],
            "replaces": REPLACES["flash_attention"], "launches": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_max_abs_err": t["library_max_abs_err"],
            "design": t["design"],
            "shape": t["shape"]})
    if "families" in args.only:
        launches, t = phase_families(torch, dev, errs)
        kernels.append({
            "name": "flash_attention_window", "route": "cuda",
            "source": SOURCES["flash_attention_window"],
            "replaces": REPLACES["flash_attention_window"],
            "launches": launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "design": t["design"],
            "slice": t["slice"], "shape": t["shape"],
            "note": "the windowed instantiation of flash_attention (the "
                    "reference's _online_attn mask): jamba's attention at "
                    "its prefill run's S = 2 x window; launches are the "
                    "jamba prefill's"})
    dry_cells, rates = phase_dryrun(torch, dev, dry) \
        if "dryrun" in args.only else ([], None)
    if "lm_panels" in args.only:
        more["lm_panels"] = phase_lm_panels(torch, host, dry_cells, rates)
    for k in kernels:                 # the launches on the new paths too
        by_path = {phase: n[k["name"]] for phase, n in more.items()
                   if n.get(k["name"])}
        if by_path:
            k["launches_by_path"] = {"own": k["launches"], **by_path}
            k["launches"] += sum(by_path.values())
    if set(args.only) != set(PHASES):
        emit({"phase": "partial", "ran": list(args.only),
              "seconds": round(time.time() - t_start, 1)})
        print("chip_smoke: partial run, no verdict", file=sys.stderr)
        return 4
    emit({"phase": "total", "seconds": round(time.time() - t_start, 1)})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
