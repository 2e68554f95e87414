"""Assigned architectures (public-literature configs) and the target
configurations of the paper's own system (FASE on Rocket).

The language-model entries are shape constants only: no weights exist
for them, and :func:`repro_torch.models.core.init_params` makes seeded
random ones.  Every layout runs through the serving and training paths:
dense, MoE, the attention/Mamba hybrid with its sliding window, and
xLSTM.  The ``FASE_*`` entries carry
the target, fleet, fabric and telemetry knobs key for key with the
reference; the modules they configure (``core/fleet``, ``core/net``,
``telemetry``) are ported.
"""
from __future__ import annotations

from ..models.config import ModelConfig

CONFIGS: dict[str, ModelConfig] = {}


def _add(cfg: ModelConfig):
    CONFIGS[cfg.name] = cfg
    return cfg


# --- [vlm] InternVL2-76B backbone (InternLM2): frontend = patch embeds ----
internvl2_76b = _add(ModelConfig(
    name="internvl2-76b", n_layers=80, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=28672, vocab=128256, frontend="vision"))

# --- [audio] MusicGen-medium: decoder over EnCodec tokens ------------------
musicgen_medium = _add(ModelConfig(
    name="musicgen-medium", n_layers=48, d_model=1536, n_heads=24,
    n_kv_heads=24, d_ff=6144, vocab=2048, frontend="audio"))

# --- dense -----------------------------------------------------------------
deepseek_coder_33b = _add(ModelConfig(
    name="deepseek-coder-33b", n_layers=62, d_model=7168, n_heads=56,
    n_kv_heads=8, d_ff=19200, vocab=32256))

chatglm3_6b = _add(ModelConfig(
    name="chatglm3-6b", n_layers=28, d_model=4096, n_heads=32,
    n_kv_heads=2, d_ff=13696, vocab=65024))

qwen3_8b = _add(ModelConfig(
    name="qwen3-8b", n_layers=36, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=12288, vocab=151936, qk_norm=True))

llama3_405b = _add(ModelConfig(
    name="llama3-405b", n_layers=126, d_model=16384, n_heads=128,
    n_kv_heads=8, d_ff=53248, vocab=128256))

# --- MoE ---------------------------------------------------------------
llama4_scout = _add(ModelConfig(
    name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, d_ff=8192, vocab=202048, arch_type="moe",
    n_experts=16, top_k=1, moe_d_ff=8192))

phi35_moe = _add(ModelConfig(
    name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=6400, vocab=32064, arch_type="moe",
    n_experts=16, top_k=2, moe_d_ff=6400))

# --- hybrid (Jamba: 1 attn : 7 mamba per period, MoE every 2nd layer) ------
jamba_v01 = _add(ModelConfig(
    name="jamba-v0.1-52b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=14336, vocab=65536, arch_type="hybrid",
    hybrid_period=8, moe_every=2, n_experts=16, top_k=2, moe_d_ff=14336,
    sliding_window=8192))

# --- ssm (xLSTM: alternating mLSTM/sLSTM blocks) ----------------------------
xlstm_350m = _add(ModelConfig(
    name="xlstm-350m", n_layers=24, d_model=1024, n_heads=4,
    n_kv_heads=4, d_ff=4096, vocab=50304, arch_type="ssm", xlstm=True))

# --- the paper's own target (FASE on Rocket) is a core config, not an LM ---
# ``link`` selects the host<->target channel backend by name from
# repro_torch.core.channel.CHANNELS ("uart" | "pcie" | "oracle").  The queue-pair
# knobs feed repro_torch.core.cq.AsyncHtpSession: ``session`` picks the sync or
# async engine, ``qp_depth`` the in-flight transaction cap, and
# ``qp_coalesce_ticks`` the doorbell-coalescing window (target ticks).
# On the UART they are inert — the async engine is tick-identical there.
# The target_* knobs drive the TorchTarget interpreter
# (repro_torch.core.target.cpu.run_chunk_fast): batched-issue width,
# fetch-block size, block-cache enable, and the translate/fetch
# implementation for block fills ("kernel": the CUDA kernel for a CUDA
# image | "ref": its plain version); they trade speed only — every
# setting is bit-identical to the reference.  The port has the fast path
# alone, so there is no target_fast_path knob.
# The telem_* knobs provision the out-of-band telemetry lane
# (repro_torch.telemetry): counter-sample cadence, the fraction of link
# bandwidth the side-band lane is granted, the commit-trace ring depth
# per hart, and the backlog bound past which frames are dropped.
# Telemetry is armed per-run (FaseRuntime's ``telemetry=`` kwarg via
# ``fase_rocket.telemetry_kwargs``), never implicitly — golden ticks
# are pinned both ways.
FASE_ROCKET = dict(n_cores=4, mem_bytes=1 << 26, clock_hz=100_000_000,
                   link="uart", baud=921600, l1=32 << 10, l2=256 << 10,
                   session="async", qp_depth=8, qp_coalesce_ticks=50,
                   target_issue_width=8,
                   target_block_words=16, target_block_cache=True,
                   target_fetch_kernel="kernel", target_dtlb_ways=8,
                   telem_interval_ticks=100_000, telem_bandwidth_frac=0.1,
                   telem_trace_slots=4096, telem_backlog_ticks=1 << 20)

# the same target behind a modelled PCIe/AXI-DMA link (the scale-up
# direction: bandwidth-rich, latency-dominated — batching + queue-pair
# overlap matter; the coalescing window widens to the 1 us setup latency)
FASE_ROCKET_PCIE = {**FASE_ROCKET, "link": "pcie", "qp_depth": 16,
                    "qp_coalesce_ticks": 100}

# a fleet of the PCIe target: N modelled FPGAs, each with its own link and
# queue pair, behind the repro.core.fleet routing/orchestration layer.
# ``n_devices`` sizes the fleet, ``placement`` picks the job placement
# policy ("round_robin" | "least_loaded" | "least_loaded_blind" |
# "affinity"), ``device_links`` (one link name per device) models a
# mixed-link farm — None keeps every board on the config's ``link`` —
# and ``provision_us`` is the FireSim-style re-imaging cost charged
# whenever a board's resident image changes (0 = historical free
# provisioning).
FASE_FLEET = {**FASE_ROCKET_PCIE, "n_devices": 4,
              "placement": "round_robin", "device_links": None,
              "provision_us": 0.0}

# vmapped fleet: all boards' targets live in ONE stacked CpuState and a
# global chunk across the fleet is a single XLA dispatch
# (repro.core.fleet.vmap.FleetTarget, ROADMAP item 1).  Bit-identical to
# FASE_FLEET; ``fase_rocket.fleet_kwargs`` derives the FleetTarget's
# target_cfg from the config's n_cores/mem_bytes/target_* knobs.
FASE_FLEET_VMAP = {**FASE_FLEET, "fleet_vmap": True}

# provisioning-aware fleet: bitstream flash + ELF load cost several ms of
# modelled time per re-image, and the provision-aware least_loaded policy
# trades that charge off against queue depth (benchmarks/migration.py
# measures it against the provision-blind greedy).
FASE_FLEET_PROVISION = {**FASE_FLEET, "n_devices": 2,
                        "placement": "least_loaded",
                        "provision_us": 5_000.0}

# fabric-attached fleet (repro.core.net): the net_* knobs size the
# modelled inter-board switch — per-port bandwidth, crossbar propagation
# latency (target ticks), flit/header framing and ingress credits per
# port.  ``fase_rocket.net_kwargs`` filters them into the keyword
# surface of repro.core.net.Switch; pass the switch as
# ``FleetRuntime(fabric=...)`` to attach a NicEndpoint per device and
# enable gang scheduling (benchmarks/net_scale.py sweeps these knobs).
FASE_FLEET_NET = {**FASE_FLEET, "net_gbits_per_s": 16.0,
                  "net_latency_ticks": 500, "net_flit_bytes": 64,
                  "net_header_bytes": 16, "net_credits": 8}


def get(name: str) -> ModelConfig:
    return CONFIGS[name]
