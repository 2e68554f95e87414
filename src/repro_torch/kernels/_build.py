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
