"""Builds a CUDA source of the port for the host: ``g++`` under the CPU
emulation of ``tests/cuda_shim`` (see its ``cuda_runtime.h``), into a
shared library whose C entry points are the source's own, loaded with
ctypes.  Tests that use it skip where ``g++`` is not on ``PATH``."""
from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SHIM = ROOT / "tests" / "cuda_shim"
CSRC = ROOT / "src" / "repro_torch" / "csrc"


def build(name: str, out_dir: Path) -> ctypes.CDLL:
    """``csrc/<name>.cu`` as ``out_dir/lib<name>_shim.so``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ on PATH to build the kernel source for the "
                    "host")
    out = Path(out_dir) / f"lib{name}_shim.so"
    cmd = [gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
           "-Wall", "-Wno-unknown-pragmas", f"-I{SHIM}", f"-I{CSRC}",
           "-x", "c++", str(CSRC / f"{name}.cu"), "-o", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def entry(lib: ctypes.CDLL, fn: str, argtypes):
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f
