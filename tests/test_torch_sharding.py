"""The port's sharding rules and abstract inputs (``repro_torch.distributed
.sharding``, ``repro_torch.launch.steps``) — the twin of
``tests/test_sharding.py``: the same three tests on the port, on its local
1x1 mesh (a one-rank fake process group, torn down after each test), and
the abstract trees held against ``jax.eval_shape`` of the reference leaf by
leaf, for every configuration at full size, on the ``meta`` device (nothing
is allocated)."""
import jax
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.launch import steps as jst
from repro.models import core as JM
from repro_torch.configs import CONFIGS
from repro_torch.distributed import sharding as sh
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import fake_world, make_local_mesh
from repro_torch.models import core as M
from repro_torch.training.optim import tree_leaves


@pytest.fixture
def local_mesh():
    with fake_world(1):
        yield make_local_mesh()


def _same_structure(tree, specs, width=None):
    """Both trees have the same keys and list lengths; each spec has one
    entry a dim of its leaf (``width`` entries, for placements)."""
    if isinstance(tree, dict):
        assert set(tree) == set(specs)
        for k in tree:
            _same_structure(tree[k], specs[k], width)
    elif isinstance(tree, list):
        assert isinstance(specs, list) and len(tree) == len(specs)
        for a, b in zip(tree, specs):
            _same_structure(a, b, width)
    else:
        assert isinstance(specs, tuple)
        assert len(specs) == (tree.dim() if width is None else width)


def test_param_specs_cover_tree(local_mesh):
    for name in ("qwen3-8b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b",
                 "xlstm-350m"):
        cfg = CONFIGS[name].smoke()
        params = st.abstract_params(cfg)
        specs = sh.param_specs(cfg, local_mesh)
        shardings = sh.make_shardings(local_mesh, specs)
        # structures must match exactly
        _same_structure(params, specs)
        _same_structure(params, shardings, local_mesh.ndim)
        for policy in ("tp_only", "dp_only"):
            _same_structure(params, sh.param_specs(cfg, local_mesh,
                                                   policy=policy))


def test_input_specs_all_cells():
    for name, cfg in CONFIGS.items():
        for shape in st.SHAPES:
            ok, why = st.cell_supported(cfg, shape)
            if not ok:
                assert "full-attn" in why
                continue
            specs = st.input_specs(cfg, shape)
            assert "params" in specs
            assert all(t.device.type == "meta" for t in tree_leaves(specs))


def test_long500k_skips_are_exactly_the_quadratic_archs():
    skips = [n for n, c in CONFIGS.items()
             if not st.cell_supported(c, "long_500k")[0]]
    assert set(skips) == {
        "internvl2-76b", "musicgen-medium", "deepseek-coder-33b",
        "chatglm3-6b", "qwen3-8b", "llama3-405b",
        "llama4-scout-17b-a16e", "phi3.5-moe-42b-a6.6b"}
    assert st.SHAPES == jst.SHAPES and st.PREFIX_LEN == jst.PREFIX_LEN


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = tuple(getattr(k, "key", getattr(k, "idx", None))
                    for k in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _torch_leaves(tree):
    return {path: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for path, t in _leaves_with_paths(tree)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_abstract_trees_equal_the_references_eval_shape(name):
    """``abstract_params`` and ``abstract_opt_state`` equal the
    reference's ``jax.eval_shape`` leaf by leaf in shape and dtype at full
    size; ``abstract_decode_state`` too at decode_32k's batch and length,
    but for the KV pools, whose ``(B, pages)`` axes the port keeps as one
    global pages axis.  Every leaf is on ``meta``."""
    cfg, jcfg = CONFIGS[name], JCONFIGS[name]
    params = st.abstract_params(cfg)
    assert all(t.device.type == "meta" for t in tree_leaves(params))
    assert _torch_leaves(params) == _jax_leaves(jst.abstract_params(jcfg))
    opt = st.abstract_opt_state(cfg)
    jopt = jst.abstract_opt_state(jcfg)
    assert _torch_leaves(opt) == _jax_leaves(jopt)
    B, S = st.SHAPES["decode_32k"]["batch"], st.SHAPES["decode_32k"]["seq"]
    got = _torch_leaves(st.abstract_decode_state(cfg, B, S))
    want = _jax_leaves(jst.abstract_decode_state(jcfg, B, S))
    for pool in (("kpool",), ("vpool",)):
        if pool in want:
            shape, dtype = want.pop(pool)
            want[pool] = (shape[:2] + (shape[2] * shape[3],) + shape[4:],
                          dtype)
    assert got == want
