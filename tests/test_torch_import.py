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
    "repro_torch.kernels.run_chunk.run_chunk",
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
    "repro_torch.core.snapshot",
    "repro_torch.telemetry.load",
    "repro_torch.core.fleet",
    "repro_torch.core.fleet.vmap",
    "repro_torch.core.net",
    "repro_torch.core.target.pysim",
    "repro_torch.telemetry",
    "repro_torch.telemetry.stream",
    "repro_torch.telemetry.triggers",
    "repro_torch.telemetry.bridges",
    "repro_torch.telemetry.replay",
    "repro_torch.telemetry.timeline",
    "repro_torch.telemetry.__main__",
    "repro_torch.analysis",
    "repro_torch.analysis.footprints",
    "repro_torch.analysis.trace",
    "repro_torch.analysis.detector",
    "repro_torch.analysis.lint",
    "repro_torch.analysis.cli",
    "repro_torch.analysis.__main__",
    "repro_torch.models.convert",
    "repro_torch.launch.mesh",
    "repro_torch.launch.dryrun",
    "repro_torch.distributed.sharding",
    "repro_torch.distributed.dtensor",
    "repro_torch.bench",
    "repro_torch.bench.__main__",
    "repro_torch.bench.timing",
    "repro_torch.bench.decode_kernels",
    "repro_torch.bench.paged_attention_timeline",
    "repro_torch.bench.port_kernels",
    "repro_torch.bench.dryrun_sweep",
    "repro_torch.bench.panels",
] + [f"repro_torch.bench.{name}" for name in (
    "htp_vs_direct", "stall_breakdown", "gapbs_accuracy",
    "coremark_accuracy", "baud_sweep", "hfutex_bench", "scale_sweep",
    "arg_prefetch", "fleet_scale", "net_scale", "stall_attribution",
    "migration", "serving_traffic", "roofline", "hillclimb",
    "target_speed", "speedup")] + [
    f"repro_torch.configs.{name}" for name in (
    "chatglm3_6b", "deepseek_coder_33b", "internvl2_76b", "jamba_v0_1_52b",
    "llama3_405b", "llama4_scout_17b_a16e", "musicgen_medium",
    "phi35_moe_42b", "qwen3_8b", "xlstm_350m")]


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
    files = list(root.rglob("*.py")) + [Path(SRC).parent / "chip_smoke.py"] \
        + sorted((Path(SRC).parent / "examples").glob("torch_*.py"))
    assert len(files) > 20
    for f in files:
        assert not pat.search(f.read_text()), f


def test_port_sources_start_no_interpreter_that_imports_jax_or_reference():
    """No import of JAX or of the JAX package anywhere in a line either:
    not in a string run by ``python -c``, nor through ``import_module``
    (a child interpreter escapes the import test above)."""
    import re
    pat = re.compile(r"\b(import|from)\s+(jax|jaxlib|repro)([\s.,;'\"]|$)"
                     r"|import_module\(\s*['\"](jax|jaxlib|repro)['\".]",
                     re.M)
    root = Path(SRC) / "repro_torch"
    files = list(root.rglob("*.py")) + [Path(SRC).parent / "chip_smoke.py"] \
        + sorted((Path(SRC).parent / "examples").glob("torch_*.py"))
    assert len(files) > 20
    assert pat.search('"import jax",') and pat.search("from repro.launch")
    assert not pat.search("from repro_torch.launch import dryrun")
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
    """What the port refuses: the stacked fleet's commit-trace ring (the
    reference refuses it too: the ring is single-device) and a Pallas
    fetch kernel.  A TorchTarget's ring and the runtime's telemetry hub
    are ported and work."""
    from repro_torch.core.fleet.vmap import FleetTarget
    from repro_torch.core.interface import TorchTarget
    from repro_torch.core.runtime import FaseRuntime
    from repro_torch.telemetry import TelemetryHub
    t = TorchTarget(1, 1 << 20, device="cpu")
    t.trace_arm(16)
    t.trace_trigger(("instret", 3))
    assert t.trace_drain() == [([], 0)] and t.trace_drain(0) == ([], 0)
    rt = FaseRuntime(t, telemetry={"interval_ticks": 1000})
    assert isinstance(rt.telemetry, TelemetryHub)
    view = FleetTarget(1, 1, 1 << 20, device="cpu").view(0)
    with pytest.raises(NotImplementedError, match="single-device"):
        view.trace_arm(16)
    with pytest.raises(ValueError):
        TorchTarget(1, 1 << 20, device="cpu", fetch_kernel="pallas")


def test_unported_serving_surfaces_raise():
    """The non-dense decode sublayers are ported (ROADMAP Queue A 9b): an
    MoE decode step runs; fleet-sharded serving (Queue A 7) is ported,
    and an engine over a fleet shards its slots across the boards."""
    import torch
    from repro_torch.configs import CONFIGS
    from repro_torch.core.fleet import FleetRouter
    from repro_torch.core.fleet.device import Device
    from repro_torch.models import core as M
    from repro_torch.serving.engine import ServeEngine
    cfg = CONFIGS["qwen3-8b"].smoke()
    router = FleetRouter([Device(i, None) for i in range(2)])
    eng = ServeEngine(cfg, M.init_params(cfg, 0, device="cpu"), slots=4,
                      max_seq=64, fleet=router, device="cpu")
    assert eng._dev_slots == [(0, [0, 2]), (1, [1, 3])]
    moe = CONFIGS["llama4-scout-17b-a16e"].smoke()
    state = M.make_decode_state(moe, 1, 64, device="cpu")
    logits, _ = M.decode_step(moe, M.init_params(moe, 0, device="cpu"),
                              state, torch.zeros((1,), dtype=torch.long))
    assert logits.shape == (1, moe.vocab) and int(state["seq_lens"]) == 1
