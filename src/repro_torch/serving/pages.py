"""Host-side paged KV manager — FASE §V-C re-instantiated for serving.

The runtime owns the authoritative ("software") view of the page pool:
refcounted physical pages, per-sequence block tables, and prefix sharing
(copy-on-write forks).  Device state is only touched through the per-step
command batch (:mod:`repro_torch.serving.htp`), mirroring the paper's rule that
the host reaches target memory exclusively through page-level HTP ops.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..models.core import PAGE_SIZE


class OutOfPages(Exception):
    pass


@dataclass
class SeqPages:
    pages: list = field(default_factory=list)    # page ids, COW-shared ok
    length: int = 0


class PagedKVManager:
    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.free = list(range(n_pages - 1, -1, -1))
        self.refcnt = {}
        self.seqs: dict[int, SeqPages] = {}
        self.prefix_index: dict[tuple, list[int]] = {}
        # pending device commands (drained by the engine each step),
        # attributed to the sequence that caused them — under a sharded
        # fleet a page command belongs on the board holding that
        # sequence's slot, so the engine routes by owner
        self.pending_copies: list[tuple[int, tuple[int, int]]] = []
        self.pending_zeros: list[tuple[int, int]] = []
        self.stats = {"alloc": 0, "cow": 0, "prefix_hits": 0, "freed": 0}

    def _alloc(self, owner: int = -1) -> int:
        if not self.free:
            raise OutOfPages
        p = self.free.pop()
        self.refcnt[p] = 1
        self.stats["alloc"] += 1
        # lazy-init: PageS(0) on device
        self.pending_zeros.append((owner, p))
        return p

    def _unref(self, p: int):
        self.refcnt[p] -= 1
        if self.refcnt[p] == 0:
            del self.refcnt[p]
            self.free.append(p)
            self.stats["freed"] += 1

    # ------------------------------------------------------------------
    def start_seq(self, seq_id: int, prompt_tokens: tuple) -> SeqPages:
        """Allocate pages for a new sequence, sharing full pages with any
        previously-registered identical prefix (refcount, COW on write)."""
        sp = SeqPages()
        n_full = len(prompt_tokens) // PAGE_SIZE
        for i in range(n_full):
            key = prompt_tokens[:(i + 1) * PAGE_SIZE]
            hit = self.prefix_index.get(key)
            if hit is not None and any(p not in self.refcnt for p in hit):
                del self.prefix_index[key]     # stale: pages were freed
                hit = None
            if hit is not None:
                page = hit[i]
                self.refcnt[page] += 1
                self.stats["prefix_hits"] += 1
                sp.pages.append(page)
            else:
                sp.pages.append(self._alloc(seq_id))
        # register every full-page prefix boundary for future sharing
        for i in range(n_full):
            key = prompt_tokens[:(i + 1) * PAGE_SIZE]
            self.prefix_index.setdefault(key, list(sp.pages[:i + 1]))
        # tail page (partial) is always private
        if len(prompt_tokens) % PAGE_SIZE or not prompt_tokens:
            sp.pages.append(self._alloc(seq_id))
        sp.length = len(prompt_tokens)
        self.seqs[seq_id] = sp
        return sp

    def ensure_writable_tail(self, seq_id: int):
        """COW break before appending a token into a shared page."""
        sp = self.seqs[seq_id]
        page_idx = sp.length // PAGE_SIZE
        while page_idx >= len(sp.pages):
            sp.pages.append(self._alloc(seq_id))
        page = sp.pages[page_idx]
        if self.refcnt[page] > 1:
            new = self._alloc(seq_id)
            self.pending_zeros.remove((seq_id, new))
            # PageCP on device
            self.pending_copies.append((seq_id, (page, new)))
            self._unref(page)
            sp.pages[page_idx] = new
            self.stats["cow"] += 1
        return sp.pages[page_idx]

    def append_token(self, seq_id: int):
        page = self.ensure_writable_tail(seq_id)
        self.seqs[seq_id].length += 1
        return page

    def finish_seq(self, seq_id: int):
        sp = self.seqs.pop(seq_id)
        for p in sp.pages:
            self._unref(p)

    def block_table(self, seq_id: int, width: int) -> list[int]:
        sp = self.seqs[seq_id]
        bt = list(sp.pages[:width])
        bt += [0] * (width - len(bt))
        return bt

    def drain_commands(self):
        """Pending device commands as ``(owner_seq_id, payload)`` pairs
        (owner ``-1`` = unattributed), cleared on return."""
        copies, zeros = self.pending_copies, self.pending_zeros
        self.pending_copies, self.pending_zeros = [], []
        return copies, zeros
