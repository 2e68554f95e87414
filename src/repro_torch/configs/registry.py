"""Target configurations of the paper's own system (FASE on Rocket).

The reference registry also carries the language-model configurations of
its serving/training layer; the port holds only the ``FASE_*`` target
entries until that layer is ported.  The fleet, fabric and telemetry
knobs are carried so the entries stay key-for-key comparable with the
reference; the modules they configure are not ported yet.
"""
from __future__ import annotations

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
# (repro.telemetry in the reference): counter-sample cadence, the fraction of link
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
