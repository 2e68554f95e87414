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
    PageS with the ``page_set`` kernel, PageCP with ``page_copy``, on the
    K and V pools of every layer (the reference books them and never
    applies them);
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
the tokens it gets when run alone.  A ``fleet`` (slots sharded across
devices) is not ported yet.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.channel import make_channel
from ..core.cq import AsyncHtpSession
from ..kernels.page_ops import ops as page_ops
from ..models import core as M
from ..models.config import ModelConfig
from .htp import CommandBatch
from .pages import PagedKVManager

#: submission-stream key for Layer-B serving traffic on a shared session
SERVE_STREAM = "serve"


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
                 link: str = "pcie", fleet=None, impl: str = "kernel",
                 device="cuda"):
        """``params`` live on ``device`` (default the GPU; raises without
        one).  ``impl`` picks the kernels (``"kernel"``) or their plain
        versions (``"ref"``) for decode attention and the page commands."""
        if fleet is not None:
            raise NotImplementedError(
                "ROADMAP Queue A 7: fleet-sharded serving (slots across "
                "devices, slot migration) is not ported yet")
        self.device = M.resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.poll_every = poll_every
        self.impl = impl
        self.htp = htp_session or AsyncHtpSession(None, make_channel(link))
        self.step_spans: list = []    # per-step link span
        self.link_tick = 0            # modelled completion of the last batch
        self.pages_per_seq = M.pages_per_seq(cfg, max_seq)
        self.kv = PagedKVManager(slots * self.pages_per_seq * 2)
        #: the pool page idle slots write into (no request reads it)
        self.dump_page = self.kv.n_pages
        self.state = M.make_decode_state(cfg, slots, max_seq,
                                         n_pages=self.kv.n_pages + 1,
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

    # -- the device step ---------------------------------------------------
    def _upload(self, cb: CommandBatch):
        """The step's commands as one int32 buffer on the device (one
        host->device copy): overrides, eos, max_lens, the block tables
        (idle slots pointed at the dump page), PageS ids, PageCP pairs."""
        S, P = self.slots, self.pages_per_seq
        bt = cb.block_tables.copy()
        idle = [s for s in range(S) if s not in self.active]
        bt[idle] = self.dump_page
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
        for pool in (st["kpool"], st["vpool"]):
            if zeros.numel():
                page_ops.page_set(pool, zeros, 0.0, impl=self.impl)
            if copies.numel():
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
        # dispatch over the modelled device link: one wire batch per
        # decode step, FIFO on the serving stream
        base = self.link_tick
        self.link_tick = self.htp.submit(cb.to_transaction(), base,
                                         stream=SERVE_STREAM).done
        self.step_spans.append(self.link_tick - base)
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
