"""Hill-climbs on the port's dry run: three (arch x shape) pairs, each
re-lowered under the variants meant to drive its dominant roofline term
down, every variant's row saying how that term moved.

The twin of the reference's ``benchmarks/hillclimb.py``, the same pairs
and variants through the port's ``launch/dryrun.py::run_cell``:

  A qwen3-8b/decode_32k   — paged decode; variant ``tp_serve`` (no FSDP
                            gathers of the parameters);
  B xlstm-350m/train_4k   — variant ``dp_only`` (no tensor parallelism);
  C llama3-405b/train_4k  — variants ``micro4``/``micro2`` (fewer
                            microbatches, fewer FSDP regathers).

``--quick`` takes the first pair.  Each variant's row carries
``vs_baseline``: the baseline's dominant term, its seconds in both runs,
their ratio, and ``moved`` (``down``, ``up`` or ``same``, read from the
two counts, nothing assumed).  The cells run on the host's CPU (``meta``
tensors, a fake process group) and need no card, so the panel takes no
``--target`` and its file names none (``"target": "host"``).  Writes
``results/torch_hillclimb.json``.
"""
from __future__ import annotations

import time

from . import panels

PAIRS = [
    ("qwen3-8b", "decode_32k", ["tp_serve"]),
    ("xlstm-350m", "train_4k", ["dp_only"]),
    ("llama3-405b", "train_4k", ["micro4", "micro2"]),
]


def moved(base: dict, res: dict) -> dict | None:
    """How the baseline's dominant roofline term moved in ``res``; None
    when either cell is not ``OK``."""
    if base.get("status") != "OK" or res.get("status") != "OK":
        return None
    term = base["roofline"]["dominant"]
    was, now = base["roofline"][term], res["roofline"][term]
    return dict(term=term, baseline_s=was, variant_s=now,
                ratio=now / was if was else None,
                moved="down" if now < was else "up" if now > was else
                "same",
                dominant_now=res["roofline"]["dominant"])


def run(quick=False, out_dir=None, n_layers=None):
    """Every variant of :data:`PAIRS` (the first pair with ``quick``);
    ``n_layers`` cuts every model's depth (widths and shapes as they
    are)."""
    from ..launch.dryrun import run_cell
    out = []
    for arch, shape, variants in PAIRS[:1] if quick else PAIRS:
        base = None
        for variant in ["baseline"] + variants:
            t0 = time.time()
            try:
                res = run_cell(arch, shape, False, variant=variant,
                               n_layers=n_layers)
            except Exception as e:  # noqa: BLE001 - report, keep going
                res = {"arch": arch, "shape": shape, "variant": variant,
                       "status": f"FAIL {type(e).__name__}: "
                                 f"{str(e)[:200]}"}
                print(res, flush=True)
            res = {**res, "variant": variant, "wall_s": time.time() - t0}
            if variant == "baseline":
                base = res
            else:
                res["vs_baseline"] = moved(base, res)
                v = res["vs_baseline"]
                if v:
                    print(f"hillclimb,{arch}|{shape}|{variant},"
                          f"{v['variant_s']*1e6:.0f},{v['term']} "
                          f"{v['moved']} x{v['ratio']:.3f}", flush=True)
            out.append(res)
    path = panels.save_json("hillclimb", out, "host", quick, out_dir)
    print("saved", path, flush=True)
    return out


if __name__ == "__main__":
    raise SystemExit(panels.main(run, __doc__, ["hillclimb"],
                                 host_only=True))
