"""Fleet-wide single-launch execution: D boards in one stacked state.

The port of the reference's ``repro.core.fleet.vmap``.  An N-board fleet
of :class:`~repro_torch.core.interface.TorchTarget`\\ s runs N chunk
launches a global chunk and N copies of the host-side driver loop; a
:class:`FleetTarget` instead owns ONE stacked
:class:`~repro_torch.core.target.cpu.CpuState` whose every tensor carries
a leading board axis ``(D, ...)`` (``cpu.make_fleet_state``), advanced by
:func:`repro_torch.core.target.cpu.run_chunk_fleet` — on the card one
launch of the fleet chunk kernel, one CTA a board; on the CPU the eager
flat form of ``D * n_cores`` lanes — so a global chunk is one call
(``FleetTarget.dispatch_count`` counts them; on the card it equals the
kernel's launches).

Two classes:

  * :class:`FleetTarget` — owns the stacked state and the global chunk
    (:meth:`~FleetTarget.run_global`);
  * :class:`FleetTargetView` — board ``d``'s full
    :class:`~repro_torch.core.interface.Target` façade: a
    :class:`~repro_torch.core.interface.TorchTarget` whose state is
    ``cpu.board_state`` — views into the stack — so every host op of
    the target (redirect, the batched reads and writes, the page ops)
    acts on board ``d`` in place, and a queue pair and runtime drive it
    exactly like a plain target.

The views stay valid because nothing rebinds the stack's tensors: the
global chunk writes them in place, and re-provisioning a board copies a
power-on state into its slice (the reference rebinds its stacked pytree
there instead).  Semantics are bit-identical to D independent targets:
boards are shared-nothing inside the fleet chunk, a view's ``run``
issues a one-hot budget vector, and a board whose budget is 0 is left
untouched, which is what keeps every golden tick when boards take turns.

Commit-trace capture (``trace_arm``) stays a single-target affair, as in
the reference: a view refuses to arm.
"""
from __future__ import annotations

import torch

from ..interface import TorchTarget
from ..target import cpu as _cpu

_TRACE_MSG = ("commit-trace capture is single-device; run this device on "
              "a plain TorchTarget (fleet_vmap=False) to arm the trace ring")


class FleetTarget:
    """The stacked-state owner: D boards' CPU state in one set of tensors
    on ``device`` (default ``"cuda"``; a missing card raises), one launch
    per global chunk on the card.

    ``view(d)`` hands out board ``d``'s Target façade; ``run_global``
    advances every board by its budget in one call.  The interpreter
    knobs are :class:`~repro_torch.core.interface.TorchTarget`'s;
    ``chunk_kernel="ref"`` asks for the eager flat form on the card."""

    def __init__(self, n_devices: int, n_cores: int, mem_bytes: int,
                 chunk_cycles: int = 1 << 30, issue_width: int = 8,
                 block_words: int = 16, block_cache: bool = True,
                 fetch_kernel: str = "kernel", dtlb_ways: int = 8,
                 chunk_kernel: str = "kernel", device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "FleetTarget(device='cuda'): no CUDA device is available; "
                "pass device='cpu' to run the fleet on the CPU")
        if chunk_kernel not in _cpu.CHUNK_IMPLS:
            raise ValueError(f"chunk_kernel must be one of "
                             f"{_cpu.CHUNK_IMPLS}, got {chunk_kernel!r}")
        if mem_bytes <= 0 or mem_bytes & (mem_bytes - 1):
            raise ValueError(f"mem_bytes must be a power of two, got "
                             f"{mem_bytes}")
        self.n_devices = n_devices
        self.n_cores = n_cores
        self.mem_bytes = mem_bytes
        self.chunk_cycles = chunk_cycles
        self.issue_width = issue_width
        self.block_words = block_words
        self.block_cache = block_cache
        self.fetch_kernel = fetch_kernel
        self.dtlb_ways = dtlb_ways
        self.chunk_kernel = chunk_kernel
        self.sts = _cpu.make_fleet_state(n_devices, n_cores, mem_bytes,
                                         device=self.device)
        #: global chunks run (on the card: launches of the fleet kernel)
        self.dispatch_count = 0
        self._views = [FleetTargetView(self, d) for d in range(n_devices)]

    def view(self, d: int) -> "FleetTargetView":
        return self._views[d]

    def provision_view(self, d: int) -> "FleetTargetView":
        """Reset board ``d`` to its power-on state (the stacked analogue
        of a Device.provision building a fresh target) and return its
        view.  The fresh state is copied into the board's slice, so every
        view of the stack stays valid."""
        fresh = _cpu.make_state(self.n_cores, self.mem_bytes,
                                device=self.device)
        board = self._views[d].st
        for name in _cpu.STATE_FIELDS:
            getattr(board, name).copy_(getattr(fresh, name))
        return self._views[d]

    def run_global(self, budgets) -> None:
        """ONE call for the whole fleet: advance board ``i`` by up to
        ``budgets[i]`` ticks (0 = bit-exactly untouched)."""
        budgets = [min(int(b), self.chunk_cycles) for b in budgets]
        subs = _cpu.run_chunk_fleet(
            self.sts, self.n_cores, self.mem_bytes, budgets,
            self.issue_width, self.block_words, self.block_cache,
            self.fetch_kernel, self.dtlb_ways, self.chunk_kernel)
        for v, n in zip(self._views, subs):
            v.substeps += n
        self.dispatch_count += 1


class FleetTargetView(TorchTarget):
    """Board ``d``'s full Target-protocol façade over the stack.

    Its state is views into the stack (``cpu.board_state``), so every
    :class:`~repro_torch.core.interface.TorchTarget` host op applies to
    the board in place; ``run`` issues a one-hot global chunk.  Drop-in
    for a ``TorchTarget`` behind a queue pair."""

    def __init__(self, ft: FleetTarget, d: int):
        # the state is the stack's board d; nothing of its own to build
        self.ft = ft
        self.d = d
        self.device = ft.device
        self.nc = ft.n_cores
        self.mem_bytes = ft.mem_bytes
        self.chunk_cycles = ft.chunk_cycles
        self.issue_width = ft.issue_width
        self.block_words = ft.block_words
        self.block_cache = ft.block_cache
        self.fetch_kernel = ft.fetch_kernel
        self.dtlb_ways = ft.dtlb_ways
        self.chunk_kernel = ft.chunk_kernel
        self.substeps = 0
        self.st = _cpu.board_state(ft.sts, d)

    def run(self, max_cycles: int = 1 << 62):
        budgets = [0] * self.ft.n_devices
        budgets[self.d] = min(max_cycles, self.chunk_cycles)
        self.ft.run_global(budgets)

    # -- telemetry: single-target only, as in the reference ---------------
    def trace_arm(self, slots):
        raise NotImplementedError(_TRACE_MSG)

    def trace_trigger(self, spec):
        if spec is not None:
            self.trace_arm(0)

    def trace_drain(self, c=None, limit=None):
        # the unarmed ring, as the reference view returns it
        return ([], 0) if c is not None else [([], 0)] * self.nc
