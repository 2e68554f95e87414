"""The per-step host->device command batch — HTP at pod scale.

FASE ships Redirect/PageS/PageCP/RegW requests over a narrow UART; the
serving engine ships exactly one dense command batch per decode step over
the dispatch link: token overrides (Redirect analogues), block tables
(MMU/page-table analogues), and page copy/zero lists (PageCP/PageS).

A ``CommandBatch`` *is* an HTP transaction at pod scale:
:meth:`CommandBatch.to_transaction` lowers it to an ordered
:class:`~repro_torch.core.session.HtpTransaction` of typed requests (with
serving wire sizes overriding the Table II defaults), and
:meth:`CommandBatch.account` books those requests' bytes per category so
the Layer-B traffic benchmarks mirror the paper's Fig 13.  The requests
carry the serving slot as their ``cpu`` field — decode slots are the
paper's CPUs.

The lowered requests are ``virtual`` (timing/accounting-only): the
engine dispatches them through an
:class:`~repro_torch.core.cq.AsyncHtpSession` on the ``"serve"``
submission stream, where they occupy the modelled link and charge
controller cycles but are never applied to a target — so a FASE runtime
(Layer A) and the serving engine (Layer B) can share one session and
contend on one channel.  The port's engine carries the page lists out on
the device itself, with the ``page_set`` / ``page_copy`` kernels on its
KV pools (the reference never applies them).  The requests' ``nbytes``
overrides are honoured by the session for both the serial and the pipelined path
(:meth:`HtpRequest.wire_bytes` prefers the override in direct mode too).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.session import HtpRequest, HtpTransaction

# Serving analogue ops: a subset of Table II (the reference's protocol
# linter pins the set; the port's analysis layer is ROADMAP Queue A 8).
_SERVING_OPS = ("Redirect", "SetMMU", "PageCP", "PageS")


@dataclass
class CommandBatch:
    override: np.ndarray          # (slots,) int64; -1 = no override
    eos: np.ndarray               # (slots,) int32
    max_lens: np.ndarray          # (slots,) int32
    block_tables: np.ndarray      # (slots, pages) int32
    page_copies: list = field(default_factory=list)   # [(src, dst)]
    page_zeros: list = field(default_factory=list)    # [page]

    @classmethod
    def empty(cls, slots: int, pages: int) -> "CommandBatch":
        return cls(
            override=np.full((slots,), -1, np.int64),
            eos=np.zeros((slots,), np.int32),
            max_lens=np.full((slots,), 1 << 30, np.int32),
            block_tables=np.zeros((slots, pages), np.int32),
        )

    def to_transaction(self) -> HtpTransaction:
        """Lower to one ordered HTP transaction: token overrides are
        Redirect analogues, block-table rows SetMMU analogues, page
        copy/zero lists PageCP/PageS analogues.  Serving wire sizes
        override the Table II defaults via ``nbytes``; every request is
        ``virtual`` so submitting the transaction models link occupancy
        without touching any target."""
        txn = HtpTransaction()
        row_bytes = self.block_tables.nbytes // max(
            self.block_tables.shape[0], 1)
        for slot in range(self.override.shape[0]):
            if self.override[slot] >= 0:
                txn.add(HtpRequest("Redirect", cpu=slot,
                                   args=(int(self.override[slot]),),
                                   category="overrides", nbytes=8,
                                   virtual=True))
            txn.add(HtpRequest("SetMMU", cpu=slot,
                               args=(self.block_tables[slot],),
                               category="block_tables", nbytes=row_bytes,
                               virtual=True))
        for src, dst in self.page_copies:
            txn.add(HtpRequest("PageCP", args=(src, dst),
                               category="page_cmds", nbytes=8,
                               virtual=True))
        for page in self.page_zeros:
            txn.add(HtpRequest("PageS", args=(page, 0),
                               category="page_cmds", nbytes=8,
                               virtual=True))
        # every request above carries nbytes= with virtual=True
        return txn

    def account(self, traffic) -> None:
        # closed-form byte totals of to_transaction() — account() runs
        # once per decode step, so no per-request objects here
        traffic.add("overrides", 8 * int((self.override >= 0).sum()))
        traffic.add("block_tables", self.block_tables.nbytes)
        traffic.add("page_cmds",
                    8 * (len(self.page_copies) + len(self.page_zeros)))
