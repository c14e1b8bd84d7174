"""The port's sharding rules, mesh shapes, int8 quantization and step-deadline
policy held to the JAX package in this process (no process group).

The rules read only a mesh's axis names and shape, so the JAX package's run
on an ``AbstractMesh`` and the port's on a ``MeshShape``; each walks its own
package's trees, the port's drawn by its ``init_*`` and carried to the JAX
package's classes by name. Spec trees compare as plain values.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.distributed.sharding as jsh
import repro.models.attention as jattn
import repro.models.ffn as jffn
import repro.models.recsys as jrec
import repro.models.stacked as jstacked
import repro.models.transformer as jtf
import repro.optim.adafactor as jada
from repro.optim.grad_compress import dequantize_tensor as jax_dequantize, quantize_tensor as jax_quantize
from repro_torch.common.tree_utils import flatten_with_paths, tree_leaves
from repro_torch.configs.base import get_arch
from repro_torch.distributed import sharding as sh
from repro_torch.index.convert import from_arrays as index_from_arrays
from repro_torch.launch.mesh import (
    MeshShape, axis_size, batch_axes, make_host_mesh, make_production_mesh,
)
from repro_torch.models import recsys, stacked, transformer
from repro_torch.models.convert import to_arrays
from repro_torch.optim.adafactor import Adafactor
from repro_torch.optim.grad_compress import dequantize_tensor, quantize_tensor
from repro_torch.train.elastic import BackupStepPolicy

MESHES = [((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
MESH_IDS = ["data2xmodel2", "pod2xdata2xmodel2"]
TAIL = "gemma3-27b+tail"  # 8 layers over a period of 6: one group and two tail layers
LM_CASES = ["qwen3-4b", "phi3.5-moe-42b-a6.6b", TAIL]
_JAX_CLASSES = {c.__name__: c for c in (
    jtf.LMParams, jtf.LayerParams, jtf.DecodeState, jstacked.StackedLMParams, jstacked.StackedDecodeState,
    jattn.AttnParams, jattn.LayerKVCache, jffn.DenseFFNParams, jffn.MoEParams, jada.FactoredMoment,
    jrec.EmbedTables, jrec.DLRMParams, jrec.DINParams, jrec.MINDParams)}


def _to_jax(tree):
    """A port tree (numpy leaves) in the JAX package's classes, by name."""
    if tree is None:
        return None
    if type(tree).__name__ in _JAX_CLASSES:
        return _JAX_CLASSES[type(tree).__name__](*(_to_jax(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_to_jax(v) for v in tree)
    return tree


def _plain(tree):
    """Either package's spec tree as plain values."""
    name = type(tree).__name__
    if name == "PartitionSpec":
        return ("P",) + tuple(tuple(p) if isinstance(p, (list, tuple)) else p for p in tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (name,) + tuple(_plain(v) for v in tree)
    if isinstance(tree, (tuple, list)):
        return tuple(_plain(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, np.ndarray, jax.Array)):
        a = tree.cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
        return ("array", a.dtype.str, a.shape, a.tobytes())
    return tree


def _meshes(i):
    return MeshShape(*MESHES[i]), AbstractMesh(*MESHES[i])


def _lm_cfg(case):
    if case == TAIL:
        return dataclasses.replace(get_arch("gemma3-27b").reduced().lm, n_layers=8)
    return get_arch(case).reduced().lm


@functools.lru_cache(maxsize=None)
def _lm(case):
    """(port flat params, port stacked params, the same as the JAX classes)."""
    flat = transformer.init_lm(_lm_cfg(case), torch.Generator().manual_seed(0), device="cpu")
    stk = stacked.stack_params(flat, _lm_cfg(case))
    return flat, stk, _to_jax(to_arrays(flat)), _to_jax(to_arrays(stk))


FSDP_KV = [(True, True), (False, False), (True, False)]


@pytest.mark.parametrize("fsdp,kv_shard", FSDP_KV)
@pytest.mark.parametrize("case", LM_CASES)
@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
def test_lm_param_and_adafactor_specs_equal_jax(mesh, case, fsdp, kv_shard):
    port_mesh, jax_mesh = _meshes(mesh)
    flat, stk, jflat, jstk = _lm(case)
    for rule, jrule, p, jp in ((sh.lm_param_specs, jsh.lm_param_specs, flat, jflat),
                               (sh.stacked_lm_param_specs, jsh.stacked_lm_param_specs, stk, jstk)):
        got = rule(p, port_mesh, fsdp=fsdp, kv_shard=kv_shard)
        want = jrule(jp, jax_mesh, fsdp=fsdp, kv_shard=kv_shard)
        assert _plain(got) == _plain(want)
        assert _plain(sh.adafactor_state_specs(got)) == _plain(jsh.adafactor_state_specs(want))


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
def test_adafactor_specs_shard_the_moments_adafactor_makes(mesh):
    """Every moment's spec places its leaf (the ranks split every sharded dim)."""
    port_mesh, _ = _meshes(mesh)
    _, stk, _, _ = _lm("qwen3-4b")
    specs = sh.adafactor_state_specs(sh.stacked_lm_param_specs(stk, port_mesh))
    moments = Adafactor().init(stk).moments
    pairs = list(zip(tree_leaves(moments), tree_leaves(specs)))
    assert len(pairs) == len(tree_leaves(moments)) > 0
    for m, s in pairs:
        sh.NamedSharding(port_mesh, s).shard_shape(tuple(m.shape))


@pytest.mark.parametrize("stacked_layout", [False, True], ids=["flat", "stacked"])
@pytest.mark.parametrize("batch", [1, 8], ids=["batch-below-shards", "batch-above-shards"])
@pytest.mark.parametrize("case", ["qwen3-4b", TAIL])
@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
def test_kv_cache_and_decode_state_specs_equal_jax(mesh, case, batch, stacked_layout):
    port_mesh, jax_mesh = _meshes(mesh)
    cfg = _lm_cfg(case)
    init = stacked.init_decode_state_stacked if stacked_layout else transformer.init_decode_state
    state = init(cfg, batch, 32, dtype=torch.float32, device="cpu")
    jstate = _to_jax(to_arrays(state))
    kv = cfg.n_kv_heads
    assert _plain(sh.kv_cache_spec(port_mesh, batch, kv, stacked=stacked_layout)) == \
        _plain(jsh.kv_cache_spec(jax_mesh, batch, kv, stacked=stacked_layout))
    got = sh.decode_state_specs(state, port_mesh, batch, kv, stacked=stacked_layout)
    assert _plain(got) == _plain(jsh.decode_state_specs(jstate, jax_mesh, batch, kv, stacked=stacked_layout))
    assert type(got) is type(state)


@pytest.mark.parametrize("arch", ["dlrm-rm2", "din", "mind"])
@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
def test_recsys_specs_equal_jax(mesh, arch):
    port_mesh, jax_mesh = _meshes(mesh)
    rc = get_arch(arch).reduced().recsys
    init = {"dlrm-rm2": recsys.init_dlrm, "din": recsys.init_din, "mind": recsys.init_mind}[arch]
    params = init(rc, torch.Generator().manual_seed(0), device="cpu")
    got = sh.recsys_param_specs(params, port_mesh)
    assert _plain(got) == _plain(jsh.recsys_param_specs(_to_jax(to_arrays(params)), jax_mesh))
    assert got.tables.table == sh.P("model", None)
    for cands in (False, True):
        assert _plain(sh.recsys_batch_spec(port_mesh, 64, candidates=cands)) == \
            _plain(jsh.recsys_batch_spec(jax_mesh, 64, candidates=cands))


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
def test_gnn_batch_and_index_specs_equal_jax(mesh, tiny_index):
    port_mesh, jax_mesh = _meshes(mesh)
    assert _plain(sh.gnn_specs(port_mesh)) == _plain(jsh.gnn_specs(jax_mesh))
    for seq in (False, True):
        assert _plain(sh.lm_batch_specs(port_mesh, seq)) == _plain(jsh.lm_batch_specs(jax_mesh, seq))
    port_index = index_from_arrays(tiny_index, "cpu")
    assert _plain(sh.index_specs(port_index, port_mesh)) == _plain(jsh.index_specs(tiny_index, jax_mesh))


# ------------------------------------------------------------------ meshes without a process group
def test_mesh_shape_coordinates_are_row_major():
    m = MeshShape((2, 2, 2), ("pod", "data", "model"))
    assert m.coords() == [m.coord_of(r) for r in range(8)]
    assert m.coord_of(6) == (1, 1, 0) and m.size == 8
    assert batch_axes(m) == ("pod", "data") and axis_size(m, "pod") == 2
    assert batch_axes(MeshShape((2, 2), ("data", "model"))) == ("data",)
    assert axis_size(MeshShape((2, 2), ("data", "model")), "pod") == 1
    with pytest.raises(ValueError):
        MeshShape((2, 2), ("data", "data"))


def test_host_and_production_meshes_over_a_world_of_one():
    m = make_host_mesh(device="cpu")
    assert (m.axis_names, m.sizes, m.coord, m.group("data"), m.group(("data", "model"))) == \
        (("data", "model"), (1, 1), (0, 0), None, None)
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="256 ranks" if not multi_pod else "512 ranks"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_placement_of_a_world_of_one_is_the_whole():
    m = make_host_mesh(device="cpu")
    x = torch.arange(12.0).reshape(3, 4)
    s = sh.NamedSharding(m, sh.P("data", "model"))
    assert torch.equal(s.shard(x), x) and torch.equal(s.gather(s.shard(x)), x)
    assert torch.equal(sh.reshard(x, s, sh.NamedSharding(m, sh.P())), x)


# ------------------------------------------------------------------ int8 quantization
def _quant_inputs():
    rng = np.random.default_rng(5)
    ties = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5], np.float32)  # scale 1: halves round to even
    return {
        "normal": (rng.standard_normal((33, 17)) * 3e-3).astype(np.float32),
        "ties": ties,
        "zeros": np.zeros((4, 4), np.float32),
        "wide": (rng.standard_normal(1000) * np.exp(rng.uniform(-20, 5, 1000))).astype(np.float32),
    }


@pytest.mark.parametrize("name", sorted(_quant_inputs()))
def test_quantize_tensor_equals_jax_to_the_bit(name):
    g = _quant_inputs()[name]
    jq, js = jax_quantize(jnp.asarray(g))
    q, s = quantize_tensor(torch.from_numpy(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(dequantize_tensor(q, s).numpy(), np.asarray(jax_dequantize(jq, js)))
    if name == "ties":
        assert q.tolist() == [127, 2, -4, 0, 0, 2, 126]


# ------------------------------------------------------------------ the step-deadline policy
def test_backup_step_policy():
    """The JAX package's scenario (tests/test_train_fault_tolerance.py)."""
    import time

    p = BackupStepPolicy(slack=2.0, alpha=1.0)
    p.start()
    time.sleep(0.01)
    p.finish()
    assert p.ewma > 0
    p.start()
    assert not p.overrun()
    time.sleep(2.2 * p.ewma + 0.02)
    assert p.overrun()


def test_meta_init_gives_the_shapes_without_drawing():
    """Placements and sharded restores take their targets from an init on
    the meta device, which draws nothing."""
    cfg = _lm_cfg(TAIL)
    meta = stacked.init_lm_stacked(cfg, device="meta")
    _, stk, _, _ = _lm(TAIL)
    got, want = flatten_with_paths(meta), flatten_with_paths(stk)
    assert list(got) == list(want)
    assert all(v.is_meta and v.shape == want[k].shape and v.dtype == want[k].dtype for k, v in got.items())
