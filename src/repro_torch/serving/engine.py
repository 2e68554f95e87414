"""Continuous-batching serving engine — FASE's host runtime at pod scale.

The port of :mod:`repro.serving.engine` on the single-session path.  The
mapping (DESIGN.md §2, Layer B):

  * decode slots = the paper's CPUs: a fixed-width decode step runs every
    iteration; the host scheduler parks/fills slots exactly like FASE
    redirects parked cores (non-preemptive continuous batching);
  * the per-step **command batch** = HTP: one dense array set (new tokens,
    block tables, page copy/zero lists) crosses host->device per step —
    here as one int32 buffer, one copy — and is lowered to a virtual
    :class:`~repro_torch.core.session.HtpTransaction` dispatched on the
    ``"serve"`` stream of an :class:`~repro_torch.core.cq.AsyncHtpSession`
    (own modelled link by default, or a FASE runtime's session passed in as
    ``htp_session``), its bytes accounted per category;
  * the page lists are carried out on the device before the step's decode:
    PageS with one ``page_set`` launch over the K and V pools of every
    layer, PageCP with ``page_copy`` on each (the reference books them and
    never applies them); a layout without attention (xLSTM) has no pools,
    and its page lists are booked alone, as the reference books them;
  * the device-side **stop mask** = HFutex: per-slot stop conditions
    (EOS / max-len) accumulate on device and the host polls the packed
    mask every ``poll_every`` steps instead of syncing each step.

The step runs eagerly and updates the decode state in place (the
reference's jitted step donates it).  The KV pool is global: page ids
from :class:`~repro_torch.serving.pages.PagedKVManager` address it
directly, and a slot without a request writes into a spare dump page
behind the manager's pages instead of into page 0, which another slot may
own.  Token streams, step counts, page statistics and per-category
traffic bytes are the reference's wherever the reference is well defined
(every page id below ``pages_per_seq``); beyond that every request gets
the tokens it gets when run alone.

Under a sliding window the block table is a ring that decode reads
whole, unallocated entries included.  The reference reads its own row's
page there; in the global pool page 0 belongs to another request, so a
windowed engine keeps a **zero page** behind the dump page that nothing
writes, and points every unallocated entry of a running request at it:
the request reads zeros there, as a fresh decode state holds.  Admission
resets only a slot's length, as the reference's does: its Mamba, mLSTM
and sLSTM states and its conv tail carry into the next request (ROADMAP
Queue C, "Recorded"), and MoE layers dispatch every slot as a token, idle
ones included.

With ``fleet=`` (a :class:`~repro_torch.core.fleet.FleetRuntime` or
:class:`~repro_torch.core.fleet.FleetRouter`) the decode slots are
sharded across the fleet's boards: each step's command batch is split by
owning board and routed over that board's modelled link on its
``(device, "serve")`` stream, and ``slot_policy="least_loaded"``
re-places slots every ``rebalance_every`` steps, billing each move as
``"slot_migrate"`` traffic on both links.  The fleet only routes command
batches: the decode step itself still runs on the one ``device``.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.channel import make_channel
from ..core.cq import AsyncHtpSession
from ..core.fleet.placement import make_policy
from ..core.session import HtpRequest, HtpTransaction
from ..kernels.page_ops import ops as page_ops
from ..models import core as M
from ..models.config import ModelConfig
from .htp import CommandBatch
from .pages import PagedKVManager

#: submission-stream key for Layer-B serving traffic on a shared session
SERVE_STREAM = "serve"


@dataclass
class _SlotLoad:
    """Device-shaped view (id + clock) the fleet placement policy can
    rank during serving slot rebalancing."""

    id: object
    clock: int


@dataclass
class Request:
    rid: int
    prompt: list
    max_new: int = 16
    eos: int = 1
    out: list = field(default_factory=list)
    done: bool = False


@dataclass
class TrafficStats:
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    by_cat: dict = field(default_factory=dict)

    def add(self, cat, n, d2h=False):
        if d2h:
            self.d2h_bytes += n
        else:
            self.h2d_bytes += n
        self.by_cat[cat] = self.by_cat.get(cat, 0) + n


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, slots: int = 4,
                 max_seq: int = 512, poll_every: int = 4,
                 htp_session: AsyncHtpSession | None = None,
                 link: str = "pcie", fleet=None,
                 slot_policy: str = "sticky", rebalance_every: int = 8,
                 impl: str = "kernel", device="cuda"):
        """``params`` live on ``device`` (default the GPU; raises without
        one).  ``impl`` picks the kernels (``"kernel"``) or their plain
        versions (``"ref"``) for decode attention and the page commands."""
        self.device = M.resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.poll_every = poll_every
        self.impl = impl
        # command batches dispatch on the "serve" stream; pass a FASE
        # runtime's session to share (and contend on) its modelled link,
        # or a fleet (FleetRuntime / FleetRouter) to shard decode slots
        # across N devices — each device then carries only its own slots'
        # command traffic on its own link, on stream (device, "serve")
        self.router = None
        self._dev_slots: list = []    # (device_id, [its slot indices])
        # slot placement across the fleet: "sticky" keeps the static
        # slot%N sharding for a slot's whole lifetime; "least_loaded"
        # re-places slots mid-run (every ``rebalance_every`` steps, via
        # the fleet placement policy over channel-model span projections)
        # whenever a move strictly improves the projected per-step
        # makespan — each move re-ships the slot's block-table row and
        # resident KV pages over BOTH links (billed, category
        # "slot_migrate"), so a move costs real modelled time up front.
        assert slot_policy in ("sticky", "least_loaded")
        self.slot_policy = slot_policy
        self.rebalance_every = max(rebalance_every, 1)
        self.slot_migrations = 0
        self._slot_placement = None
        self.step_spans: list = []    # per-step slowest-device span
        if fleet is not None:
            assert htp_session is None, \
                "htp_session and fleet are mutually exclusive: a fleet " \
                "routes every batch to its own devices' links"
            self.router = fleet.router() if hasattr(fleet, "router") \
                else fleet
            dev_ids = list(self.router.devices)
            # sticky slot->device sharding (affinity): a slot's KV pages
            # and block tables live on one board for its whole lifetime
            # (the starting assignment under "least_loaded" too)
            self._dev_slots = [
                (dev_ids[k], [s for s in range(slots)
                              if s % len(dev_ids) == k])
                for k in range(len(dev_ids))]
            if slot_policy == "least_loaded":
                self._slot_placement = make_policy("least_loaded")
            self.htp = None
        else:
            self.htp = htp_session or AsyncHtpSession(
                None, make_channel(link))
        # moving one resident KV page between boards re-ships its K+V
        # planes (f32, the reference's pool) — the modelled price of a
        # slot migration
        self._kv_page_bytes = (2 * cfg.n_layers * M.PAGE_SIZE *
                               cfg.n_kv_heads * cfg.d_head * 4)
        self.link_tick = 0            # modelled completion of the last batch
        # the ring's width under a sliding window, as the reference takes
        # it from its decode state's block table
        self.pages_per_seq = M.pages_per_seq(cfg, max_seq)
        self.kv = PagedKVManager(slots * self.pages_per_seq * 2)
        #: the pool page idle slots write into (no request reads it)
        self.dump_page = self.kv.n_pages
        #: under a sliding window, the all-zero page the unallocated ring
        #: entries of a running request point at (nothing writes it)
        self.zero_page = self.kv.n_pages + 1 if cfg.sliding_window else None
        self.state = M.make_decode_state(
            cfg, slots, max_seq,
            n_pages=self.kv.n_pages + 1 + (self.zero_page is not None),
            device=self.device)
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}      # slot -> request
        self.traffic = TrafficStats()
        self.steps = 0
        self.logits = None            # the last step's (slots, vocab)
        self.step_slots: list = []    # the slots it decoded a request in
        self.batch = None             # the last step's CommandBatch
        #: host seconds per part of a step, summed over steps: scheduling
        #: (admission, page manager, command batch, modelled link),
        #: enqueueing the device work (upload, page ops, decode step; the
        #: host does not wait on the device there) and polling (waiting
        #: for the device, then one device->host copy)
        self.host_s = dict.fromkeys(("schedule", "enqueue", "poll"), 0.0)
        self.begin()

    # -- scheduling ------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.slots):
            if slot in self.active or not self.queue:
                continue
            req = self.queue.popleft()
            self.kv.start_seq(req.rid, tuple(req.prompt))
            self.active[slot] = req
            # host->device: prompt prefill here is token-by-token decode
            # (simple engine); the block table + seq_len update is the
            # command batch
            self._slot_tokens[slot] = list(req.prompt)
            self._slot_eos[slot] = req.eos
            self._slot_maxlen[slot] = len(req.prompt) + req.max_new
            self.state["seq_lens"][slot] = 0
            self._stop_mask[slot] = False
            self.traffic.add("admit", 8 * len(req.prompt))

    # -- dispatch --------------------------------------------------------
    def _slot_of_rid(self) -> dict:
        return {req.rid: slot for slot, req in self.active.items()}

    def _device_of_slot(self, slot: int):
        for dev, slots in self._dev_slots:
            if slot in slots:
                return dev
        return self._dev_slots[0][0]

    def _dispatch(self, cb: CommandBatch, cmd_owners=None) -> int:
        """Ship one step's command batch over the modelled link(s).

        Single-session: the whole batch is one wire transaction on the
        ``"serve"`` stream.  Fleet: the batch is sharded by owning device
        — each device receives a sub-batch of its slots' overrides /
        block-table rows and the page commands its slots' sequences
        generated (``cmd_owners``; unattributed commands land on the
        first device) on its own ``(device, "serve")`` stream, and the
        step's link completion is the slowest device's."""
        base = self.link_tick
        if self.router is None:
            done = self.htp.submit(cb.to_transaction(), base,
                                   stream=SERVE_STREAM).done
            self.step_spans.append(done - base)
            return done
        # page commands route to the board that owns the generating
        # sequence's slot (its KV pages live there)
        copy_owners, zero_owners = cmd_owners or ([], [])
        rid_slot = self._slot_of_rid()
        first = self._dev_slots[0][0]

        def owner_dev(rid):
            slot = rid_slot.get(rid)
            return self._device_of_slot(slot) if slot is not None \
                else first
        done = base
        for dev, slots in self._dev_slots:
            sub = CommandBatch(
                override=cb.override[slots], eos=cb.eos[slots],
                max_lens=cb.max_lens[slots],
                block_tables=cb.block_tables[slots],
                page_copies=[p for rid, p in zip(copy_owners,
                                                 cb.page_copies)
                             if owner_dev(rid) == dev],
                page_zeros=[p for rid, p in zip(zero_owners,
                                                cb.page_zeros)
                            if owner_dev(rid) == dev])
            txn = sub.to_transaction()
            if not txn.requests:
                continue
            res = self.router.submit(txn, base,
                                     stream=(dev, SERVE_STREAM))
            done = max(done, res.done)
        self.step_spans.append(done - base)
        return done

    # -- slot migration ---------------------------------------------------
    def _proj_span(self, dev, n_slots: int) -> int:
        """Projected per-step link span of ``dev`` carrying ``n_slots``
        decode slots, from its channel model (per-transaction latency +
        serialisation of the slots' command bytes).  Projections — not
        measured spans — drive rebalancing, so an emptied slow board
        never looks attractive just because it currently carries
        nothing."""
        if n_slots == 0:
            return 0
        ch = self.router.devices[dev].session.channel
        per_slot = 8 + 4 * self.pages_per_seq    # override + table row
        return ch.latency_ticks + ch.ticks_for_bytes(per_slot * n_slots)

    def _rebalance(self):
        """Move one decode slot off the board binding the projected
        per-step makespan onto the board that would carry it cheapest
        (re-using the fleet ``least_loaded`` placement policy over
        projected spans), charging the block-table row + resident-KV
        re-shipment on both links.  Only a strict projected-makespan
        improvement moves anything, so a balanced fleet is a fixed
        point."""
        counts = {d: len(s) for d, s in self._dev_slots}
        devs = list(counts)
        cur = {d: self._proj_span(d, counts[d]) for d in devs}
        src = max(devs, key=lambda d: cur[d])
        # destination = cheapest board AFTER receiving one more slot
        dst = self._slot_placement.place(
            None, [_SlotLoad(d, self._proj_span(d, counts[d] + 1))
                   for d in devs]).id
        if src == dst:
            return
        after = max(self._proj_span(d, counts[d] - (d == src) +
                                    (d == dst)) for d in devs)
        if after >= max(cur.values()):
            return
        src_slots = next(s for d, s in self._dev_slots if d == src)
        dst_slots = next(s for d, s in self._dev_slots if d == dst)
        if not src_slots:
            return

        # cheapest move first: an idle slot ships only its table row;
        # an active one also re-ships its resident KV pages
        def move_pages(slot):
            req = self.active.get(slot)
            if req is None:
                return 0
            return len(self.kv.seqs[req.rid].pages)
        slot = min(src_slots, key=lambda s: (move_pages(s), s))
        nbytes = 4 * self.pages_per_seq + \
            move_pages(slot) * self._kv_page_bytes
        # d2h off the source board, h2d onto the destination — the KV
        # planes cross both links, FIFO on each board's serve stream
        out = HtpTransaction().add(HtpRequest(
            "PageR", cpu=slot, category="slot_migrate", nbytes=nbytes,
            virtual=True))
        r1 = self.router.submit(out, self.link_tick,
                                stream=(src, SERVE_STREAM))
        back = HtpTransaction().add(HtpRequest(
            "PageW", cpu=slot, category="slot_migrate", nbytes=nbytes,
            virtual=True))
        r2 = self.router.submit(back, r1.done,
                                stream=(dst, SERVE_STREAM))
        self.link_tick = max(self.link_tick, r2.done)
        self.traffic.add("slot_migrate", nbytes, d2h=True)
        self.traffic.add("slot_migrate", nbytes)
        src_slots.remove(slot)
        dst_slots.append(slot)
        self.slot_migrations += 1

    # -- the device step ---------------------------------------------------
    def _upload(self, cb: CommandBatch):
        """The step's commands as one int32 buffer on the device (one
        host->device copy): overrides, eos, max_lens, the block tables
        (idle slots pointed at the dump page; under a window, the
        unallocated entries of the others at the zero page), PageS ids,
        PageCP pairs."""
        S, P = self.slots, self.pages_per_seq
        bt = cb.block_tables.copy()
        idle = [s for s in range(S) if s not in self.active]
        bt[idle] = self.dump_page
        if self.zero_page is not None:
            for slot, req in self.active.items():
                bt[slot, len(self.kv.seqs[req.rid].pages):] = self.zero_page
        buf = np.concatenate([
            cb.override.astype(np.int32), cb.eos.astype(np.int32),
            cb.max_lens.astype(np.int32), bt.reshape(-1),
            np.asarray(cb.page_zeros, np.int32).reshape(-1),
            np.asarray(cb.page_copies, np.int32).reshape(-1)])
        host = torch.from_numpy(buf)
        if self.device.type == "cuda":
            # from pageable memory the copy would first wait for the
            # stream to drain; from pinned memory it queues behind it
            host = host.pin_memory()
        dev = host.to(self.device, non_blocking=True)
        o = 3 * S + S * P
        z = o + len(cb.page_zeros)
        return (dev[:S], dev[S:2 * S], dev[2 * S:3 * S],
                dev[3 * S:o].view(S, P), dev[o:z], dev[z:].view(-1, 2))

    def _device_step(self, cb: CommandBatch):
        override, eos, max_lens, bt, zeros, copies = self._upload(cb)
        st = self.state
        pools = "kpool" in st    # none without attention: booked only
        if pools and zeros.numel():        # K and V in one launch
            page_ops.page_set((st["kpool"], st["vpool"]), zeros, 0.0,
                              impl=self.impl)
        if pools and copies.numel():
            for pool in (st["kpool"], st["vpool"]):
                page_ops.page_copy(pool, copies, impl=self.impl)
        st["block_tables"] = bt
        # host override (prompt feed / fresh admissions) else the
        # device-resident autoregressive token — no per-step d2h sync
        tokens = torch.where(override >= 0, override, self._cur).long()
        logits, _ = M.decode_step(self.cfg, self.params, st, tokens,
                                  impl=self.impl)
        nxt = logits.argmax(dim=-1).to(torch.int32)
        stopped = (nxt == eos) | (st["seq_lens"] >= max_lens)
        self._stop_mask |= stopped
        nxt = torch.where(self._stop_mask, eos, nxt)
        # device-side output ring: emitted token at input position
        idx = (st["seq_lens"] - 1).clamp(0, self.max_seq - 1).long()
        self._out_buf[self._rows, idx] = nxt
        self._cur = nxt
        self.logits = logits

    def _poll(self):
        """One device->host copy of the stop mask, the lengths and the
        output ring; harvest finished requests."""
        S = self.slots
        packed = torch.cat([self._stop_mask.to(torch.int32),
                            self.state["seq_lens"],
                            self._out_buf.reshape(-1)]).cpu().numpy()
        mask, lens = packed[:S] != 0, packed[S:2 * S]
        buf = packed[2 * S:].reshape(S, self.max_seq)
        self.traffic.add("poll", mask.nbytes + 8 * S, d2h=True)
        for slot, req in list(self.active.items()):
            if self._slot_tokens[slot]:
                continue                     # still prefilling
            p_len = len(req.prompt)
            gen = buf[slot, p_len - 1:lens[slot] - 1]
            req.out = [int(t) for t in gen]
            self.traffic.add("tokens_out", gen.nbytes, d2h=True)
            if mask[slot]:
                req.done = True
                if req.out and req.out[-1] == req.eos:
                    req.out.pop()
                self.finished.append(req)
                self.kv.finish_seq(req.rid)
                del self.active[slot]

    # -- main loop ---------------------------------------------------------
    def begin(self):
        """Start a run: no prompt feed pending, a clear stop mask, zero
        tokens and output ring, no finished requests."""
        dev = self.device
        self._slot_tokens = {s: [] for s in range(self.slots)}
        self._slot_eos = {s: 0 for s in range(self.slots)}
        self._slot_maxlen = {s: 0 for s in range(self.slots)}
        self._stop_mask = torch.zeros((self.slots,), dtype=torch.bool,
                                      device=dev)
        self._cur = torch.zeros((self.slots,), dtype=torch.int32, device=dev)
        self._out_buf = torch.zeros((self.slots, self.max_seq),
                                    dtype=torch.int32, device=dev)
        self._rows = torch.arange(self.slots, device=dev)
        self.finished = []

    def step(self) -> bool:
        """One iteration: admit, ship the command batch, run one decode
        step on the device, poll when due.  False when nothing is left to
        run (no request active after admission)."""
        t0 = time.perf_counter()
        self._admit()
        if not self.active:
            return False
        # assemble the command batch (HTP analogue): overrides for
        # prompt-phase slots, block-table updates, page commands
        cb = CommandBatch.empty(self.slots, self.pages_per_seq)
        for slot, req in self.active.items():
            pending = self._slot_tokens[slot]
            if pending:
                cb.override[slot] = pending.pop(0)
            self.kv.append_token(req.rid)
            cb.eos[slot] = self._slot_eos[slot]
            cb.max_lens[slot] = self._slot_maxlen[slot]
            cb.block_tables[slot] = self.kv.block_table(
                req.rid, self.pages_per_seq)
        copies, zeros = self.kv.drain_commands()
        cb.page_copies = [p for _, p in copies]
        cb.page_zeros = [p for _, p in zeros]
        cb.account(self.traffic)
        self.step_slots = sorted(self.active)
        # dispatch over the modelled device link(s): one wire batch per
        # decode step, FIFO on the serving stream(s)
        self.link_tick = self._dispatch(
            cb, ([rid for rid, _ in copies], [rid for rid, _ in zeros]))
        if self._slot_placement is not None and \
                (self.steps + 1) % self.rebalance_every == 0:
            self._rebalance()
        self.batch = cb
        t1 = time.perf_counter()
        self._device_step(cb)
        self.steps += 1
        t2 = time.perf_counter()
        # d2h sync only every poll_every steps: the stop mask and the
        # output ring accumulate on device meanwhile (HFutex analogue)
        if self.steps % self.poll_every == 0 or \
                all(not self._slot_tokens[s] for s in self.active):
            self._poll()
        hs = self.host_s
        hs["schedule"] += t1 - t0
        hs["enqueue"] += t2 - t1
        hs["poll"] += time.perf_counter() - t2
        return True

    def run(self, max_steps: int = 4096):
        """Serve everything submitted (at most ``max_steps`` decode steps);
        returns the requests finished in this run."""
        self.begin()
        while (self.queue or self.active) and self.steps < max_steps:
            if not self.step():
                break
        return self.finished
