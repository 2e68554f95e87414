"""Deterministic R-MAT-style graph generator (GAPBS uses Kronecker graphs
with 2^k vertices; we generate a scaled-down equivalent host-side and ship
it to the target as a file through the I/O bypass)."""
from __future__ import annotations

import numpy as np


def rmat(scale: int, avg_degree: int = 8, seed: int = 42,
         weights: bool = False) -> bytes:
    n = 1 << scale
    m_dir = n * avg_degree // 2
    rng = np.random.default_rng(seed)
    a, b, c = 0.57, 0.19, 0.19
    src = np.zeros(m_dir, dtype=np.int64)
    dst = np.zeros(m_dir, dtype=np.int64)
    for bit in range(scale):
        r1 = rng.random(m_dir)
        r2 = rng.random(m_dir)
        go_right = r1 > (a + b)
        # quadrant probabilities
        right_top = r2 < c / (c + (1 - a - b - c))
        top = np.where(go_right, right_top, r2 < a / (a + b))
        src |= (go_right.astype(np.int64) << bit)
        dst |= ((~top).astype(np.int64) << bit)
    # symmetrise, dedup, drop self loops
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    keep = u != v
    u, v = u[keep], v[keep]
    eid = u * n + v
    eid = np.unique(eid)
    u, v = eid // n, eid % n
    m = len(u)
    order = np.argsort(u * n + v, kind="stable")
    u, v = u[order], v[order]
    rowptr = np.zeros(n + 1, dtype=np.uint64)
    np.add.at(rowptr, u + 1, 1)
    rowptr = np.cumsum(rowptr).astype(np.uint64)
    colidx = v.astype(np.uint64)
    header = np.array([n, m, 1 if weights else 0], dtype=np.uint64)
    parts = [header.tobytes(), rowptr.tobytes(), colidx.tobytes()]
    if weights:
        w = (rng.integers(1, 16, size=m)).astype(np.uint64)
        parts.append(w.tobytes())
    return b"".join(parts)


def partition(data: bytes, n_parts: int) -> list[bytes]:
    """1-D vertex partition of one serialised graph into ``n_parts``
    subgraphs (contiguous vertex ranges, intra-partition edges kept and
    reindexed to local ids, cut edges dropped) — the per-board inputs of
    a gang-scheduled multi-node GAPBS run.  Deterministic: same bytes in,
    same partitions out."""
    assert n_parts >= 1
    hdr = np.frombuffer(data[:24], dtype=np.uint64)
    n, m, has_w = int(hdr[0]), int(hdr[1]), int(hdr[2])
    off = 24
    rowptr = np.frombuffer(data[off:off + 8 * (n + 1)], dtype=np.uint64)
    off += 8 * (n + 1)
    colidx = np.frombuffer(data[off:off + 8 * m], dtype=np.uint64)
    off += 8 * m
    w = np.frombuffer(data[off:off + 8 * m], dtype=np.uint64) \
        if has_w else None
    deg = np.diff(rowptr.astype(np.int64))
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    out = []
    bounds = [n * p // n_parts for p in range(n_parts + 1)]
    for p in range(n_parts):
        lo, hi = bounds[p], bounds[p + 1]
        nn = hi - lo
        keep = (src >= lo) & (src < hi) & \
            (colidx.astype(np.int64) >= lo) & (colidx.astype(np.int64) < hi)
        u = src[keep] - lo
        v = colidx[keep].astype(np.int64) - lo
        mm = len(u)
        rp = np.zeros(nn + 1, dtype=np.uint64)
        np.add.at(rp, u + 1, 1)
        rp = np.cumsum(rp).astype(np.uint64)
        parts = [np.array([nn, mm, has_w], dtype=np.uint64).tobytes(),
                 rp.tobytes(), v.astype(np.uint64).tobytes()]
        if has_w:
            parts.append(w[keep].tobytes())
        out.append(b"".join(parts))
    return out
