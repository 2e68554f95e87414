"""Static protocol linter for the Host-Target Protocol.

Three passes, all static (no target, no modelled time):

  * :func:`lint_specs` — internal consistency of the Table II tables:
    every spec carries at least its payload, responses match documented
    sizes, the direct-mode baseline covers the same request set, and the
    serving-analogue subset is well-formed.  This absorbs (and retires)
    the import-time ``_check_specs`` copy ``core/htp.py`` used to run
    and the ``_check_serving_specs`` copy in ``serving/htp.py``.
  * :func:`lint_builders` — the :class:`~repro_torch.core.session.\
HtpTransaction` builder surface, checked from its AST against
    ``SPECS`` and the declarative argument signatures
    (:data:`repro_torch.analysis.footprints.ARG_SPECS`): every opcode has a
    builder, no builder names an unknown opcode, and each builder's
    ``args`` tuple has exactly the declared arity.
  * :func:`lint_sources` — every transaction-building module:

      - any ``HtpRequest("Op", ...)`` construction with a literal opcode
        must name a Table II request (``unknown-op``);
      - a request carrying an ``nbytes=`` wire-size override must be
        ``virtual=True`` — overrides exist for Layer-B serving
        analogues, and a *real* request with a faked size would corrupt
        byte accounting (``nbytes-not-virtual``; this replaces the
        per-decode-step runtime assert in ``serving/htp.py``);
      - **host-sync lint**: a blocking per-element target read
        (``reg_read``/``csr_read``/``mem_read_word``/``page_read``/
        ``get_*``) on a target receiver inside a lexical loop is the
        exact antipattern that makes host accessor overhead dominate
        (ROADMAP item 1: a RegR×31 context save must be one device
        fetch, not 31 round trips).  Its write-side twin flags blocking
        per-element mutators (``reg_write``/``csr_write``/
        ``mem_write_word``/``page_*``) in loops — each is one blocking
        ``device_put``; batch them into one staged ``commit_batch``
        update (``host-sync-write``).  Suppress a justified, bounded
        case with ``# analysis: allow-host-sync`` on the offending
        line.

Zero findings over the shipped tree is enforced by
``tests/test_analysis.py`` and the ``analysis-gate`` CI job.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path

from ..core import htp
from .footprints import ARG_SPECS

#: serving analogue ops (mirrors serving/htp.py's _SERVING_OPS contract)
SERVING_OPS = ("Redirect", "SetMMU", "PageCP", "PageS")

#: accessor names whose per-element use in a loop blocks on the device
BLOCKING_READS = frozenset({
    "reg_read", "csr_read", "mem_read_word", "page_read",
    "get_ticks", "get_uticks", "get_instret", "get_priv"})

#: mutator names whose per-element use in a loop issues one blocking
#: device_put each (the write-side twin of BLOCKING_READS): batch them
#: into one staged ``commit_batch`` update instead
BLOCKING_WRITES = frozenset({
    "reg_write", "csr_write", "mem_write_word",
    "page_write", "page_set", "page_copy"})

#: line pragma that allowlists one justified host-sync site
PRAGMA = "analysis: allow-host-sync"

#: modules the source passes scan by default (repo-relative)
DEFAULT_SCAN = (
    "src/repro_torch/core/session.py",
    "src/repro_torch/core/cq.py",
    "src/repro_torch/core/snapshot.py",
    "src/repro_torch/core/runtime/runtime.py",
    "src/repro_torch/core/runtime/vm.py",
    "src/repro_torch/core/runtime/syscalls.py",
    "src/repro_torch/core/runtime/loader.py",
    "src/repro_torch/core/fleet/device.py",
    "src/repro_torch/core/fleet/router.py",
    "src/repro_torch/core/fleet/runtime.py",
    "src/repro_torch/core/net/fabric.py",
    "src/repro_torch/core/net/nic.py",
    "src/repro_torch/core/net/gang.py",
    "src/repro_torch/telemetry/stream.py",
    "src/repro_torch/telemetry/bridges.py",
    "src/repro_torch/telemetry/replay.py",
    "src/repro_torch/telemetry/triggers.py",
    "src/repro_torch/telemetry/timeline.py",
    "src/repro_torch/telemetry/load.py",
    "src/repro_torch/serving/htp.py",
    "src/repro_torch/serving/engine.py",
    "src/repro_torch/serving/pages.py",
)


@dataclass(frozen=True)
class LintFinding:
    code: str                     # spec-table | builder-* | unknown-op |
                                  # nbytes-not-virtual | host-sync
    message: str
    file: str = "<tables>"
    line: int = 0

    def __str__(self):
        return f"{self.file}:{self.line}: [{self.code}] {self.message}"


# ---------------------------------------------------------------------------
# pass 1: table consistency (the retired import-time checks, shared)
# ---------------------------------------------------------------------------
def lint_specs(specs=None, direct=None, payload=None,
               serving_ops=SERVING_OPS) -> list[LintFinding]:
    """Table II / direct-baseline / serving-subset consistency.  The
    table arguments exist so tests can lint deliberately-corrupted
    copies; production callers lint the live tables."""
    specs = specs if specs is not None else htp.SPECS
    direct = direct if direct is not None else htp.DIRECT_BYTES
    payload = payload if payload is not None else htp.payload_bytes
    out = []

    def bad(msg):
        out.append(LintFinding("spec-table", msg))

    if set(direct) != set(specs):
        bad(f"direct table out of sync with SPECS: "
            f"-{set(specs) - set(direct)} +{set(direct) - set(specs)}")
    for name, spec in specs.items():
        if spec.req_bytes < 1:
            bad(f"{name}: request must carry at least an opcode byte")
        if spec.ctrl_cycles < 1:
            bad(f"{name}: controller execution cannot be free")
        try:
            pb = payload(name)
        except KeyError:
            bad(f"{name}: no payload_bytes entry")
            continue
        if spec.total_bytes < pb:
            bad(f"{name}: wire size {spec.total_bytes} below intrinsic "
                f"payload {pb}")
        if name in direct and direct[name] <= 0:
            bad(f"{name}: direct-mode baseline must be positive")
    # documented fixed shapes (paper Table II)
    for name, attr, want in (("PageR", "resp_bytes", htp.PAGE),
                             ("Next", "resp_bytes", 2 + 3 * htp.WORD)):
        if name in specs and getattr(specs[name], attr) != want:
            bad(f"{name}: {attr} must be {want}")
    if "PageW" in specs and specs["PageW"].req_bytes < htp.PAGE:
        bad("PageW: request must carry a whole page")
    for op in serving_ops:
        if op not in specs:
            bad(f"serving analogue {op} missing from SPECS")
    if set(ARG_SPECS) != set(specs):
        bad(f"footprint ARG_SPECS out of sync with SPECS: "
            f"-{set(specs) - set(ARG_SPECS)} "
            f"+{set(ARG_SPECS) - set(specs)}")
    return out


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------
def _htp_request_calls(tree: ast.AST):
    """Yield every ``HtpRequest(...)`` Call node."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else \
                fn.attr if isinstance(fn, ast.Attribute) else None
            if name == "HtpRequest":
                yield node


def _literal_op(call: ast.Call):
    args = list(call.args)
    for kw in call.keywords:
        if kw.arg == "op":
            args.insert(0, kw.value)
    if args and isinstance(args[0], ast.Constant) and \
            isinstance(args[0].value, str):
        return args[0].value
    return None


def _kw(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


# ---------------------------------------------------------------------------
# pass 2: builder surface of HtpTransaction
# ---------------------------------------------------------------------------
def lint_builders(session_path: str | Path | None = None
                  ) -> list[LintFinding]:
    path = Path(session_path) if session_path is not None else \
        Path(__file__).resolve().parents[1] / "core" / "session.py"
    tree = ast.parse(path.read_text())
    out: list[LintFinding] = []
    built: dict[str, int] = {}    # op -> line of a builder constructing it
    cls = next((n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
                and n.name == "HtpTransaction"), None)
    if cls is None:
        return [LintFinding("builder-missing",
                            "class HtpTransaction not found",
                            str(path))]
    for call in _htp_request_calls(cls):
        op = _literal_op(call)
        if op is None:
            continue
        if op not in htp.SPECS:
            out.append(LintFinding(
                "unknown-op", f"builder constructs unknown op {op!r}",
                str(path), call.lineno))
            continue
        built.setdefault(op, call.lineno)
        # arity: the positional args tuple must match the declared
        # signature (Tick/Next/… build with no args tuple at all)
        want = len(ARG_SPECS[op])
        atup = call.args[2] if len(call.args) >= 3 else _kw(call, "args")
        got = len(atup.elts) if isinstance(atup, ast.Tuple) else \
            0 if atup is None else None
        if got is not None and got != want:
            out.append(LintFinding(
                "builder-arity",
                f"{op} builder passes {got} args, Table II declares "
                f"{ARG_SPECS[op]!r}", str(path), call.lineno))
    for op in htp.SPECS:
        if op not in built:
            out.append(LintFinding(
                "builder-missing",
                f"no HtpTransaction builder constructs {op!r}",
                str(path)))
    return out


# ---------------------------------------------------------------------------
# pass 3: transaction-building modules
# ---------------------------------------------------------------------------
def _is_target_receiver(expr: ast.AST) -> bool:
    """Does this call receiver look like a live target?  The convention
    across the repo: targets are reachable as ``t`` / ``*.t`` /
    ``target`` / ``*.target`` (session.t, self.target, rt.target …)."""
    try:
        src = ast.unparse(expr)
    except Exception:                               # pragma: no cover
        return False
    return src == "t" or src == "target" or src.endswith(".t") or \
        src.endswith(".target")


def _scan_module(path: Path) -> list[LintFinding]:
    text = path.read_text()
    lines = text.splitlines()
    tree = ast.parse(text)
    out: list[LintFinding] = []
    rel = str(path)
    for call in _htp_request_calls(tree):
        op = _literal_op(call)
        if op is not None and op not in htp.SPECS:
            out.append(LintFinding(
                "unknown-op",
                f"HtpRequest names unknown op {op!r}", rel, call.lineno))
        nb = _kw(call, "nbytes")
        if nb is not None and not (isinstance(nb, ast.Constant)
                                   and nb.value is None):
            virt = _kw(call, "virtual")
            if not (isinstance(virt, ast.Constant) and
                    virt.value is True):
                out.append(LintFinding(
                    "nbytes-not-virtual",
                    "wire-size override on a non-virtual request "
                    "(overrides are for Layer-B serving analogues only)",
                    rel, call.lineno))
    # host-sync: blocking target reads/writes lexically inside a loop
    # body (reads serialize on device_get, writes on device_put — both
    # have one-batch session surfaces: fetch_batch / commit_batch)
    for loop in ast.walk(tree):
        if not isinstance(loop, (ast.For, ast.While)):
            continue
        for node in ast.walk(loop):
            if node is loop or not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not isinstance(fn, ast.Attribute):
                continue
            if fn.attr in BLOCKING_READS:
                code, noun, fix = ("host-sync", "read",
                                   "one device fetch (see HtpSession "
                                   "read batching)")
            elif fn.attr in BLOCKING_WRITES:
                code, noun, fix = ("host-sync-write", "write",
                                   "one staged commit_batch update "
                                   "(see HtpSession write batching)")
            else:
                continue
            if not _is_target_receiver(fn.value):
                continue
            span = lines[node.lineno - 1:
                         getattr(node, "end_lineno", node.lineno)]
            if any(PRAGMA in ln for ln in span):
                continue
            out.append(LintFinding(
                code,
                f"per-element blocking device {noun} "
                f"`{ast.unparse(fn)}` inside a loop — batch it into "
                f"{fix} or annotate `# {PRAGMA}`", rel, node.lineno))
    return out


def lint_sources(paths=None, root: str | Path | None = None
                 ) -> list[LintFinding]:
    root = Path(root) if root is not None else \
        Path(__file__).resolve().parents[3]
    if paths is None:
        paths = [root / p for p in DEFAULT_SCAN]
    out: list[LintFinding] = []
    for p in paths:
        p = Path(p)
        if p.exists():
            out.extend(_scan_module(p))
        else:
            out.append(LintFinding("unknown-op",
                                   f"scan target missing: {p}", str(p)))
    return out


def lint_all(root: str | Path | None = None) -> list[LintFinding]:
    """Every pass over the shipped tree; empty list = clean."""
    return lint_specs() + lint_builders() + lint_sources(root=root)
