"""The DTensor routes of the model (``repro_torch.distributed.dtensor``:
the weights gathered over the data axes for a use, Megatron's layout of
a sublayer's input and output, the vocab-parallel embedding and loss, the
MoE dispatch of row-sharded tokens) compute the plain model's numbers.
The dry run only counts them on ``meta`` tensors; here four processes of
a real gloo group on the CPU run them on seeded values
(``tests/torch_dtensor_worker.py``) against the plain functions on the
whole tensors.  Jax-free."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORKER = str(ROOT / "tests" / "torch_dtensor_worker.py")


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(case, world=4):
    """Rank 0's JSON line of ``case`` over ``world`` processes."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world),
                               str(port), case], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


def test_loss_and_gradients_on_a_two_by_two_mesh_are_the_plain_ones():
    """qwen3-8b at smoke width on (2, 2): the loss within 1e-5 relative
    (f32 log-sum-exp over vocabulary shards), every gradient leaf within
    5e-2 relative L2 (bf16 partial sums reduced in another order than the
    plain products; a leaf computed wrongly, or summed over the wrong
    ranks, is off by its own size)."""
    out = run_ranks("loss")
    assert out["loss_rel"] < 1e-5, out
    assert out["grad_rel"] < 5e-2, out


def test_moe_dispatch_of_row_sharded_tokens_routes_as_the_plain_one():
    """phi3.5-moe at smoke width, 8 token rows sharded over "data": the
    dispatch assigns every token the plain dispatch's experts, slots and
    drops (its routing tensors equal), and the output rows agree to bf16
    rounding."""
    out = run_ranks("moe")
    assert out["routing_equal"], out
    assert out["aux"] < 1e-6 and out["rel"] < 2e-2, out
