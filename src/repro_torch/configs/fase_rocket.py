"""The paper's own target system (Rocket on KCU105, Table III).

``runtime_kwargs`` filters a target config down to the keyword surface
of :class:`~repro_torch.core.runtime.FaseRuntime` (link/baud + the queue-pair
session knobs) and ``fleet_kwargs`` down to
:class:`~repro.core.fleet.FleetRuntime` (device count, placement policy,
per-device link mix), so benchmarks can instantiate either straight
from a registry entry.
"""
from .registry import (FASE_FLEET, FASE_FLEET_NET,        # noqa: F401
                       FASE_FLEET_PROVISION, FASE_ROCKET,
                       FASE_ROCKET_PCIE)

CONFIG = FASE_ROCKET

_RUNTIME_KEYS = ("link", "baud", "session")
_RENAMED = {"qp_depth": "queue_depth", "qp_coalesce_ticks": "coalesce_ticks"}


def runtime_kwargs(cfg: dict = FASE_ROCKET) -> dict:
    out = {k: cfg[k] for k in _RUNTIME_KEYS if k in cfg}
    out.update({new: cfg[old] for old, new in _RENAMED.items()
                if old in cfg})
    return out


_TARGET_RENAMED = {"target_issue_width": "issue_width",
                   "target_block_words": "block_words",
                   "target_block_cache": "block_cache",
                   "target_fetch_kernel": "fetch_kernel",
                   "target_dtlb_ways": "dtlb_ways"}


def target_kwargs(cfg: dict = FASE_ROCKET) -> dict:
    """Keyword surface of :class:`~repro_torch.core.interface.TorchTarget`'s
    interpreter from a registry target config (the caller
    supplies ``n_cores``/``mem_bytes`` positionally)."""
    return {new: cfg[old] for old, new in _TARGET_RENAMED.items()
            if old in cfg}


_TELEM_RENAMED = {"telem_interval_ticks": "interval_ticks",
                  "telem_bandwidth_frac": "bandwidth_frac",
                  "telem_trace_slots": "trace_slots",
                  "telem_backlog_ticks": "backlog_ticks"}


def telemetry_kwargs(cfg: dict = FASE_ROCKET) -> dict:
    """Keyword surface of :class:`~repro_torch.telemetry.TelemetryHub` from
    a registry target config — pass as ``FaseRuntime(telemetry=...)`` (or
    inside ``FleetRuntime``'s ``runtime_kwargs``) to arm the bridges
    with the config's provisioned lane."""
    return {new: cfg[old] for old, new in _TELEM_RENAMED.items()
            if old in cfg}


_NET_RENAMED = {"net_gbits_per_s": "gbits_per_s",
                "net_latency_ticks": "latency_ticks",
                "net_flit_bytes": "flit_bytes",
                "net_header_bytes": "header_bytes",
                "net_credits": "credits"}


def net_kwargs(cfg: dict = FASE_FLEET_NET) -> dict:
    """Keyword surface of :class:`~repro.core.net.Switch` from a registry
    target config — build the fabric as ``Switch(**net_kwargs(cfg))``
    and pass it to ``FleetRuntime(fabric=...)``."""
    return {new: cfg[old] for old, new in _NET_RENAMED.items()
            if old in cfg}


_FLEET_KEYS = ("n_devices", "placement", "provision_us")
_FLEET_RENAMED = {"device_links": "links"}


def fleet_kwargs(cfg: dict = FASE_FLEET) -> dict:
    """Keyword surface of ``FleetRuntime`` from a registry target config
    (the caller supplies ``make_target``).  Per-device queue pairs reuse
    the config's link/session/queue-pair knobs.  When the config sets
    ``fleet_vmap`` (FASE_FLEET_VMAP) the output also carries
    ``fleet_vmap=True`` plus a ``target_cfg`` derived from the config's
    ``n_cores``/``mem_bytes`` and target_* knobs, so
    ``FleetRuntime(**fleet_kwargs(cfg))`` builds the stacked
    single-dispatch :class:`~repro.core.fleet.vmap.FleetTarget` with no
    ``make_target`` at all."""
    out = runtime_kwargs(cfg)
    out.update({k: cfg[k] for k in _FLEET_KEYS if k in cfg})
    out.update({new: cfg[old] for old, new in _FLEET_RENAMED.items()
                if old in cfg and cfg[old] is not None})
    if cfg.get("fleet_vmap"):
        tk = target_kwargs(cfg)
        tk.pop("fast_path", None)   # the vmapped kernel IS the fast path
        out["fleet_vmap"] = True
        out["target_cfg"] = dict(n_cores=cfg["n_cores"],
                                 mem_bytes=cfg["mem_bytes"], **tk)
    return out
