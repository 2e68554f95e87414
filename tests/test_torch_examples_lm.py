"""The port's LM example twins (``examples/torch_{quickstart,serve_paged,
train_lm}.py``) on the CPU (``--device cpu``) at a short argv, run in
this process as scripts (``runpy``):

* ``torch_serve_paged.py`` prints the reference example's lines; the
  token lines differ (the port draws its own seeded weights, and the
  reference's requests outside slot 0 decode token 0: its serve fault),
  the steps, page statistics and traffic lines are equal;
* ``torch_quickstart.py`` against the reference's ``quickstart.py`` from
  the reference's step-0 parameters: losses and grad norms a step within
  ``tests/test_torch_training.py``'s ``TRAIN_LOSS_ATOL`` and
  ``GRAD_REL_L2``, the same greedy streams;
* ``torch_train_lm.py`` from the reference's step-0 parameters (carried
  over with ``params_from_jax`` where ``train`` draws them, also on the
  restart) against the reference's ``train`` with the same injected
  failure: losses within ``tests/test_torch_training.py``'s
  ``TRAIN_LOSS_ATOL``, replayed steps included;
* each example refuses to run without a card unless given ``--device
  cpu``."""
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from test_torch_training import GRAD_REL_L2, TRAIN_LOSS_ATOL

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"


def _run(monkeypatch, capsys, script, *argv):
    """``script`` run as ``__main__`` with ``argv``: its globals and what
    it printed."""
    monkeypatch.setattr(sys, "argv", [script, *argv])
    g = runpy.run_path(str(EXAMPLES / script), run_name="__main__")
    return g, capsys.readouterr().out


def test_serve_paged_prints_the_reference_examples_counts(monkeypatch,
                                                          capsys):
    _, want = _run(monkeypatch, capsys, "serve_paged.py")
    _, got = _run(monkeypatch, capsys, "torch_serve_paged.py",
                  "--device", "cpu")

    def lines(out):
        return [ln for ln in out.splitlines() if not ln.startswith("req ")]
    assert lines(got) == lines(want)
    assert lines(got)[0].startswith("steps=150 kv=")
    reqs = [ln for ln in got.splitlines() if ln.startswith("req ")]
    assert len(reqs) == 6 and all(": 8 tokens -> " in ln for ln in reqs)


def test_quickstart_trains_and_decodes(monkeypatch, capsys):
    """The port's quickstart against the reference's ``examples/
    quickstart.py`` from the same step-0 parameters (carried over with
    ``params_from_jax`` where the example draws them) and the same
    batches: each step's loss within ``TRAIN_LOSS_ATOL`` and grad norm
    within ``GRAD_REL_L2`` (both as printed, to 4 and 3 decimals), then
    the same greedy streams."""
    from repro.configs import CONFIGS as JCONFIGS
    from repro.models import core as JM
    from repro_torch.models import core as M
    from repro_torch.models.convert import params_from_jax
    jp = jax.device_get(JM.init_params(JCONFIGS["qwen3-8b"].smoke(), 0))
    draws = []

    def reference_params(cfg, seed=0, device="cuda"):
        draws.append(seed)
        return params_from_jax(jp, device=device)
    monkeypatch.setattr(M, "init_params", reference_params)
    want_g, want = _run(monkeypatch, capsys, "quickstart.py")
    g, out = _run(monkeypatch, capsys, "torch_quickstart.py", "--device",
                  "cpu")
    assert draws == [0]

    def steps(printed):
        rows = [ln for ln in printed.splitlines() if ln.startswith("step ")]
        return (np.array([float(ln.split("loss=")[1].split()[0])
                          for ln in rows]),
                np.array([float(ln.split("gnorm=")[1]) for ln in rows]))
    (loss, gnorm), (want_loss, want_gnorm) = steps(out), steps(want)
    assert len(loss) == len(want_loss) == 5
    assert np.isfinite(loss).all() and (gnorm > 0).all()
    np.testing.assert_allclose(loss, want_loss, rtol=0, atol=TRAIN_LOSS_ATOL)
    np.testing.assert_allclose(gnorm, want_gnorm, rtol=GRAD_REL_L2)
    got_out = np.stack(g["out"], 1)
    assert got_out.shape == (2, 8)
    np.testing.assert_array_equal(got_out, np.stack(want_g["out"], 1))
    assert "greedy decode: [[" in out


def test_train_lm_matches_the_reference_train(monkeypatch, capsys,
                                              tmp_path):
    from repro.configs import CONFIGS as JCONFIGS
    from repro.models import core as JM
    from repro.training.train_loop import FailureInjector as JInjector
    from repro.training.train_loop import train as jax_train
    from repro_torch.models import core as M
    from repro_torch.models.convert import params_from_jax
    steps = 6
    jcfg = JCONFIGS["chatglm3-6b"].smoke()
    jp = jax.device_get(JM.init_params(jcfg, 0))
    draws = []

    def reference_params(cfg, seed=0, device="cuda"):
        draws.append(seed)
        return params_from_jax(jp, device=device)
    monkeypatch.setattr(M, "init_params", reference_params)
    g, out = _run(monkeypatch, capsys, "torch_train_lm.py", str(steps),
                  "--device", "cpu", "--ckpt-dir", str(tmp_path / "port"))
    want = jax_train(jcfg, steps=steps, batch=8, seq=64,
                     ckpt_dir=str(tmp_path / "jax"), ckpt_every=50,
                     injector=JInjector(fail_at_steps=[steps // 2]),
                     log=lambda *a: None)
    got = g["losses"]
    # no checkpoint before the failure: both restart from fresh weights
    assert draws == [0, 0]
    assert len(got) == len(want) == steps + steps // 2
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAIN_LOSS_ATOL)
    assert "FAILURE: injected node failure at step 3" in out
    assert f"{len(got)} steps run (incl. replay)" in out


@pytest.mark.parametrize("script", ["torch_quickstart.py",
                                    "torch_serve_paged.py",
                                    "torch_train_lm.py"])
def test_examples_refuse_to_run_without_a_card(script, monkeypatch,
                                               tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = ["2", "--ckpt-dir", str(tmp_path)] if "train" in script else []
    monkeypatch.setattr(sys, "argv", [script, *argv])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runpy.run_path(str(EXAMPLES / script), run_name="__main__")
