"""Multi-device fleet layer: sharded FPGA targets behind one routing and
orchestration subsystem (ROADMAP: "multi-channel scale-out").

A single FASE deployment is one queue pair: one target behind one
:class:`~repro_torch.core.channel.Channel`, driven by one
:class:`~repro_torch.core.cq.AsyncHtpSession`.  A production validation farm is
N of those — FireSim-style: many emulated devices serving independent
workloads concurrently, each with its own link, its own submission
streams, and its own completion queue.  This package is that layer:

  * :class:`~repro_torch.core.fleet.device.Device` — one modelled FPGA: a
    target factory, a dedicated channel, the device's
    :class:`~repro_torch.core.cq.AsyncHtpSession` queue pair, and cumulative
    per-device stats (the device "clock" is its serial occupancy);
  * :mod:`~repro_torch.core.fleet.placement` — pluggable placement policies
    (``round_robin`` / ``least_loaded`` / ``affinity``) deciding which
    device owns a job or a serving slot;
  * :class:`~repro_torch.core.fleet.router.FleetRouter` — the session-shaped
    routing front end: submission streams are re-keyed ``(device, hart)``
    and each transaction is forwarded to the owning device's queue pair
    (a one-device router is tick-identical to using its session
    directly);
  * :class:`~repro_torch.core.fleet.runtime.FleetRuntime` — the orchestrator:
    shards replicated / multi-process workloads across the fleet via the
    placement policy, runs each job through a full
    :class:`~repro_torch.core.runtime.FaseRuntime` over the owning device's
    queue pair, and aggregates completions and stats into a
    :class:`~repro_torch.core.fleet.runtime.FleetReport`.

Devices are independent: nothing serialises across device boundaries
except explicit dependency tokens (a token's ``tick`` is modelled time,
which every device shares as a unit), so aggregate throughput on
independent workloads scales with device count — the
``benchmarks/fleet_scale.py`` claim.

Device lifecycle is billed: ``Device.provision()`` charges a FireSim-
style re-imaging cost whenever the board's resident image changes
(``provision_us``; the provision-aware ``least_loaded`` policy trades
that charge off against queue depth), and
:meth:`~repro_torch.core.fleet.runtime.FleetRuntime.migrate` live-migrates a
paused job between boards by shipping an HTP-captured checkpoint
(:mod:`repro_torch.core.snapshot`) over both devices' links — wire bytes,
provision latency and downtime all land in the
:class:`~repro_torch.core.fleet.runtime.MigrationReport`
(``benchmarks/migration.py``).

With a modelled interconnect attached (``FleetRuntime(fabric=Switch())``,
:mod:`repro_torch.core.net`) devices stop being islands: every board gets a
:class:`~repro_torch.core.net.NicEndpoint` on an adjacent switch port and one
:class:`~repro_torch.core.net.GangJob` can span N boards, with shared pages,
remote hfutex wakes and cross-device TLB shootdowns carried on the
fabric instead of the host router (``benchmarks/net_scale.py``).
"""
from .device import Device, DeviceStats                     # noqa: F401
from .placement import (POLICIES, AffinityPolicy,           # noqa: F401
                        LeastLoadedAdaptivePolicy,
                        LeastLoadedBlindPolicy, LeastLoadedPolicy,
                        PlacementPolicy, RoundRobinPolicy, image_key_of,
                        make_policy)
from .router import FleetRouter                             # noqa: F401
from .runtime import (FleetReport, FleetRuntime, Job,       # noqa: F401
                      JobResult, MigrationReport, RunningJob)
from .vmap import FleetTarget, FleetTargetView              # noqa: F401
