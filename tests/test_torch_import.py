"""The PyTorch port must stand on its own: importing its entry point
pulls in neither JAX nor any module of the JAX package."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parent.parent / "src")

PORT_MODULES = [
    "repro_torch.run",
    "repro_torch.core.interface",
    "repro_torch.core.target.convert",
    "repro_torch.kernels.page_walk.ops",
    "repro_torch.configs.fase_rocket",
    "repro_torch.models.core",
    "repro_torch.serving.engine",
    "repro_torch.launch.serve",
    "repro_torch.kernels.paged_attention.ops",
    "repro_torch.kernels.page_ops.ops",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.training.train_loop",
    "repro_torch.training.checkpoint",
    "repro_torch.training.optim",
    "repro_torch.training.data",
    "repro_torch.launch.train",
    "repro_torch.launch.steps",
]


@pytest.mark.parametrize("module", PORT_MODULES)
def test_port_imports_no_jax_and_no_reference_package(module):
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_have_no_jax_or_reference_imports():
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    root = Path(SRC) / "repro_torch"
    files = list(root.rglob("*.py")) + [Path(SRC).parent / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        assert not pat.search(f.read_text()), f


def test_cuda_default_raises_without_a_card():
    """The entry points default to the GPU and must not quietly run on
    the CPU when there is none."""
    import torch
    from repro_torch.core.interface import TorchTarget
    from repro_torch.run import run_workload
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchTarget(1, 1 << 20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_workload("hello", [], n_cores=1, mem=1 << 22)


def test_serving_entry_points_default_to_the_card():
    """init_params, the decode state, ServeEngine and the serve launcher
    default to the GPU and raise without one."""
    import torch
    from repro_torch.configs import CONFIGS
    from repro_torch.launch.serve import main
    from repro_torch.models import core as M
    from repro_torch.serving.engine import ServeEngine
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = CONFIGS["qwen3-8b"].smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_decode_state(cfg, 1, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, M.init_params(cfg, 0, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smoke", "--requests", "1"])


def test_training_entry_points_default_to_the_card():
    """train and the train launcher default to the GPU and raise without
    one."""
    import torch
    from repro_torch.configs import CONFIGS
    from repro_torch.launch.train import main
    from repro_torch.training.train_loop import train
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(CONFIGS["qwen3-8b"].smoke(), steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smoke", "--steps", "1"])


def test_unported_surfaces_raise():
    from repro_torch.core.interface import TorchTarget
    from repro_torch.core.runtime import FaseRuntime
    t = TorchTarget(1, 1 << 20, device="cpu")
    for call in (lambda: t.trace_arm(16), lambda: t.trace_trigger(None),
                 lambda: t.trace_drain()):
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(NotImplementedError):
        FaseRuntime(t, telemetry={"interval_ticks": 1000})
    with pytest.raises(ValueError):
        TorchTarget(1, 1 << 20, device="cpu", fetch_kernel="pallas")


def test_unported_serving_surfaces_raise():
    """Fleet-sharded serving and the non-dense decode sublayers are later
    slices (ROADMAP Queue A 7 and 9)."""
    import torch
    from repro_torch.configs import CONFIGS
    from repro_torch.models import core as M
    from repro_torch.serving.engine import ServeEngine
    cfg = CONFIGS["qwen3-8b"].smoke()
    with pytest.raises(NotImplementedError, match="Queue A 7"):
        ServeEngine(cfg, {}, fleet=object(), device="cpu")
    moe = CONFIGS["llama4-scout-17b-a16e"].smoke()
    state = M.make_decode_state(cfg, 1, 64, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A 9"):
        M.decode_step(moe, {}, state, torch.zeros((1,), dtype=torch.long))
