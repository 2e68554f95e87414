"""Builds the port's CUDA sources with ``nvcc`` and loads them via ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers,
so a build takes seconds) and becomes ``build/lib<name>_<hash>.so`` under
the checkout root — or under ``$REPRO_TORCH_BUILD_DIR`` — at first use.
The hash is of the source text, so an edited source rebuilds and an
unchanged one is reused.  A failed build raises with ``nvcc``'s output;
nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    exe = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(exe):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in %s): the CUDA kernels "
            "of repro_torch are built from source at first use" % exe)
    return exe


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return src, build_dir() / f"lib{name}_{digest}.so"


def load_all(names) -> dict[str, ctypes.CDLL]:
    """Build (one ``nvcc`` per source, all started together) and load the
    named kernels' libraries."""
    procs = []
    for name in names:
        if name in _libs:
            continue
        src, out = _target(name)
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((name, tmp, out, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, out, cmd, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for name in names:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)[1]))
    return {name: _libs[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    return load_all([name])[name]


_entries: dict[tuple, ctypes._CFuncPtr] = {}


def entry(lib: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``fn`` of ``csrc/<lib>.cu`` (built and loaded at
    the first call), returning an ``int`` CUDA error code."""
    key = (lib, fn)
    if key not in _entries:
        f = getattr(load(lib), fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _entries[key] = f
    return _entries[key]


def check_tensor(op, name, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    whose shape matches ``shape`` (entries of None match any extent)."""
    ok = (t.device == device and t.dtype == dtype and t.is_contiguous()
          and t.dim() == len(shape)
          and all(w is None or w == n for w, n in zip(shape, t.shape)))
    if not ok:
        raise ValueError(
            f"{op}: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}{'' if t.is_contiguous() else ' (not contiguous)'}")


def launch(op, fn, args, device):
    """Call the C entry point ``fn`` with ``args`` on ``device`` (the
    launch goes to the current device) and raise on a CUDA error."""
    import torch
    if device.index in (None, torch.cuda.current_device()):
        rc = fn(*args)
    else:
        with torch.cuda.device(device):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{op}: kernel launch failed with CUDA error {rc}")
