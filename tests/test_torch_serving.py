"""The port's serving engine: twins of ``tests/test_serving.py``, the
reference's engine reproduced where it is well defined, and every request
given its single-slot stream where it is not.

The reference keeps a per-row KV pool and indexes it with the page
manager's global ids (``models/core.py:600`` against
``serving/pages.py:26``): it is well defined only while every id stays
below ``pages_per_seq``.  On such runs the port gives the same token
streams, step counts, page statistics and per-category traffic bytes
(parameters carried over with ``repro_torch.models.convert``).  Beyond
them the port's global pool gives each request the tokens it gets alone
and the reference does not (ROADMAP Queue C).  Streams are compared
without trailing eos tokens: a request stopped between two polls carries
eos until the next poll (``serving/engine.py:364``), in both engines, and
the polls fall elsewhere with one slot than with four."""
import functools
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.models import core as JM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JEngine
from repro_torch.configs import CONFIGS
from repro_torch.kernels.page_ops import ops as page_ops
from repro_torch.models import core as M
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.pages import PagedKVManager


@functools.lru_cache(maxsize=None)
def _params():
    """The reference's seeded smoke parameters and the port's copy."""
    jp = JM.init_params(JCONFIGS["qwen3-8b"].smoke(), 0)
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _run(engine, request, params, slots, reqs, poll_every=4, max_seq=128,
         cfg=None, **kw):
    cfg = cfg or CONFIGS["qwen3-8b"].smoke()
    eng = engine(cfg, params, slots=slots, max_seq=max_seq,
                 poll_every=poll_every, **kw)
    for rid, prompt, max_new in reqs:
        eng.submit(request(rid=rid, prompt=list(prompt), max_new=max_new,
                           eos=1))
    done = eng.run()
    return eng, {r.rid: r.out for r in done}


def _strip(out, eos=1):
    out = list(out)
    while out and out[-1] == eos:
        out.pop()
    return out


# -- twins of tests/test_serving.py -------------------------------------------
def test_engine_batches_and_finishes():
    cfg = CONFIGS["qwen3-8b"].smoke()
    params = M.init_params(cfg, 0, device="cpu")
    eng = ServeEngine(cfg, params, slots=2, max_seq=128, poll_every=4,
                      device="cpu")
    for i in range(4):
        eng.submit(Request(rid=i, prompt=[5 + i, 7, 11], max_new=6, eos=1))
    done = eng.run()
    assert len(done) == 4
    assert all(len(r.out) <= 7 for r in done)
    assert eng.traffic.by_cat["block_tables"] > 0
    # d2h polls are amortised: far fewer polls than steps
    assert eng.traffic.by_cat["poll"] < eng.steps * 16


def test_greedy_determinism_across_batching():
    cfg = CONFIGS["qwen3-8b"].smoke()
    params = M.init_params(cfg, 0, device="cpu")
    outs = []
    for slots in (1, 2):
        eng = ServeEngine(cfg, params, slots=slots, max_seq=128,
                          poll_every=2, device="cpu")
        eng.submit(Request(rid=0, prompt=[9, 8, 7], max_new=5, eos=1))
        done = eng.run()
        outs.append(done[0].out)
    assert outs[0] == outs[1]


def test_command_batch_account_matches_transaction():
    """account()'s closed-form byte totals must equal the per-category
    wire bytes of the lowered HtpTransaction."""
    from repro_torch.serving.engine import TrafficStats
    from repro_torch.serving.htp import CommandBatch
    cb = CommandBatch.empty(slots=3, pages=4)
    cb.override[0] = 42
    cb.override[2] = 7
    cb.block_tables[:] = np.arange(12, dtype=np.int32).reshape(3, 4)
    cb.page_copies = [(1, 2), (3, 4)]
    cb.page_zeros = [5]
    traffic = TrafficStats()
    cb.account(traffic)
    by_cat = {}
    for req in cb.to_transaction():
        by_cat[req.category] = by_cat.get(req.category, 0) + \
            req.wire_bytes()
    assert by_cat == traffic.by_cat


def test_prefix_sharing_and_cow():
    kv = PagedKVManager(64)
    prompt = tuple(range(M.PAGE_SIZE * 2 + 3))
    kv.start_seq(1, prompt)
    a1 = kv.stats["alloc"]
    kv.start_seq(2, prompt)
    assert kv.stats["prefix_hits"] == 2          # two full pages shared
    assert kv.stats["alloc"] == a1 + 1           # only a private tail
    sp = kv.seqs[2]
    sp.length = M.PAGE_SIZE                      # points into shared page
    kv.append_token(2)
    assert kv.stats["cow"] == 1
    kv.finish_seq(1)
    kv.finish_seq(2)
    assert not kv.refcnt


# -- the reference's engine, where it is well defined ---------------------------
#: (slots, requests, poll_every): the runs of tests/test_serving.py
REFERENCE_RUNS = {
    "batches": (2, [(i, [5 + i, 7, 11], 6) for i in range(4)], 4),
    "one_slot": (1, [(0, [9, 8, 7], 5)], 2),
    "two_slots": (2, [(0, [9, 8, 7], 5)], 2),
}


@pytest.mark.parametrize("run", sorted(REFERENCE_RUNS))
def test_engine_matches_the_reference(run):
    slots, reqs, poll_every = REFERENCE_RUNS[run]
    jp, tp = _params()
    je, jout = _run(JEngine, JRequest, jp, slots, reqs, poll_every,
                    cfg=JCONFIGS["qwen3-8b"].smoke())
    te, tout = _run(ServeEngine, Request, tp, slots, reqs, poll_every,
                    device="cpu")
    assert tout == jout
    assert te.steps == je.steps
    assert te.kv.stats == je.kv.stats
    assert te.traffic.by_cat == je.traffic.by_cat
    assert te.traffic.h2d_bytes == je.traffic.h2d_bytes
    assert te.traffic.d2h_bytes == je.traffic.d2h_bytes
    assert te.step_spans == je.step_spans and te.link_tick == je.link_tick


# -- beyond it: every request gets the stream it gets alone -----------------
def _probe(vocab):
    """Six requests at 4 slots and max_seq 128 (2 pages a sequence):
    prompts of 3 to 70 tokens, some crossing a page boundary, so page ids
    run past pages_per_seq."""
    rng = np.random.default_rng(7)
    return [(i, rng.integers(2, vocab, n).tolist(), 6)
            for i, n in enumerate([3, 70, 5, 66, 9, 20])]


def test_every_request_gets_its_single_slot_stream():
    jp, tp = _params()
    reqs = _probe(CONFIGS["qwen3-8b"].smoke().vocab)
    eng, four = _run(ServeEngine, Request, tp, 4, reqs, device="cpu")
    assert eng.kv.n_pages > eng.pages_per_seq
    alone = {}
    for r in reqs:
        alone.update(_run(ServeEngine, Request, tp, 1, [r],
                          device="cpu")[1])
    assert sorted(four) == sorted(alone) == list(range(len(reqs)))
    for rid in four:
        assert _strip(four[rid]) == _strip(alone[rid]), rid
    assert sum(len(_strip(o)) for o in four.values()) >= 20
    # the reference on the same run: rows whose pages lie past
    # pages_per_seq read NaN through take_along_axis and emit token 0
    _, ref = _run(JEngine, JRequest, jp, 4, reqs,
                  cfg=JCONFIGS["qwen3-8b"].smoke())
    bad = [rid for rid, out in ref.items() if out and not any(out)]
    assert bad and all(_strip(alone[rid]) != ref[rid] for rid in bad)


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_mix_copies_a_page_on_a_stale_prefix_hit(monkeypatch):
    """chip_smoke.py's request mix at its slots and max_seq on a one-layer
    model: two prefix hits on the shared 128 tokens, one stale hit on a
    reused page, so one copy-on-write break whose PageCP the engine
    applies to both pools with page_copy (the copied sequence, request 4,
    and the stale hitter, request 5, still get their single-slot
    streams).  The eos token's head column is zeroed so that no request
    stops early and the schedule is the mix's alone, as at full width."""
    smoke = _chip_smoke()
    cfg = CONFIGS[smoke.SERVE_ARCH].smoke().scaled(
        n_layers=1, d_model=16, n_heads=2, n_kv_heads=1, d_head=8, d_ff=16)
    params = M.init_params(cfg, 0, device="cpu")
    params["lm_head"][:, 1] = 0.0
    calls = []
    real = page_ops.page_copy

    def counted(pool, pairs, impl="kernel"):
        calls.append(pairs.tolist())
        return real(pool, pairs, impl=impl)
    monkeypatch.setattr(page_ops, "page_copy", counted)
    reqs = [(rid, p, mx) for rid, (p, mx) in
            enumerate(smoke.serve_requests(cfg.vocab))]
    eng, outs = _run(ServeEngine, Request, params, smoke.SERVE_SLOTS, reqs,
                     max_seq=smoke.SERVE_MAX_SEQ, cfg=cfg, device="cpu")
    assert eng.kv.stats["prefix_hits"] == 3 and eng.kv.stats["cow"] == 1
    assert len(calls) == 2 and calls[0] == calls[1]   # K and V pools
    assert all(len(_strip(o)) == 16 for o in outs.values())
    for rid in (4, 5):
        _, alone = _run(ServeEngine, Request, params, 1, [reqs[rid]],
                        max_seq=smoke.SERVE_MAX_SEQ, cfg=cfg, device="cpu")
        assert _strip(outs[rid]) == _strip(alone[rid]), rid


def test_page_commands_reach_both_pools():
    """A step's PageS list zeroes those pages and its PageCP list copies
    pages, on every layer of the K and the V pool, before the decode."""
    from repro_torch.serving.htp import CommandBatch
    cfg = CONFIGS["qwen3-8b"].smoke()
    eng = ServeEngine(cfg, M.init_params(cfg, 0, device="cpu"), slots=2,
                      max_seq=128, device="cpu")
    for name in ("kpool", "vpool"):
        eng.state[name].copy_(torch.randn(eng.state[name].shape))
    before = {n: eng.state[n].clone() for n in ("kpool", "vpool")}
    cb = CommandBatch.empty(2, eng.pages_per_seq)
    cb.page_zeros = [3, 4]
    cb.page_copies = [(5, 6), (6, 7)]
    eng._device_step(cb)
    for name in ("kpool", "vpool"):
        pool, old = eng.state[name], before[name]
        assert not pool[:, :, 3:5].any()
        assert torch.equal(pool[:, :, 6], old[:, :, 5])
        assert torch.equal(pool[:, :, 7], old[:, :, 6])   # the old page 6
        # idle slots wrote their K/V into the dump page only
        assert torch.equal(pool[:, :, :3], old[:, :, :3])
        assert not torch.equal(pool[:, :, eng.dump_page],
                               old[:, :, eng.dump_page])


def test_unported_and_default_device_surfaces():
    cfg = CONFIGS["qwen3-8b"].smoke()
    params = M.init_params(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A 7"):
        ServeEngine(cfg, params, fleet=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(cfg, params)


def test_engine_keeps_its_last_batch_and_host_time_split():
    """The engine exposes the last step's command batch (the page lists
    ``chip_smoke.py`` sizes its page-op timing from) and sums the host
    time of a step by part."""
    from repro_torch.serving.htp import CommandBatch
    cfg = CONFIGS["qwen3-8b"].smoke()
    eng = ServeEngine(cfg, M.init_params(cfg, 0, device="cpu"), slots=2,
                      max_seq=128, device="cpu")
    assert eng.batch is None and not any(eng.host_s.values())
    eng.submit(Request(rid=0, prompt=[5, 6, 7], max_new=2))
    assert eng.step()
    assert isinstance(eng.batch, CommandBatch)
    assert len(eng.batch.page_zeros) == 1          # the prompt's one page
    assert eng.batch.override[0] == 5
    eng.run()
    assert set(eng.host_s) == {"schedule", "enqueue", "poll"}
    assert all(v > 0 for v in eng.host_s.values())
