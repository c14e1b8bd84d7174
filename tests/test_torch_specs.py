"""The port's cell builder held to the JAX package's at full width, in this
process: every runnable cell on (data 16, model 16), and the qwen3-4b,
dlrm-rm2 and schnet cells on (pod 2, data 16, model 16).

JAX builds its cells on an ``AbstractMesh`` (``jax.eval_shape`` over the
inits, nothing allocated) and the port on a ``MeshShape`` (``meta``
tensors). Per cell: the kind and donated argnums; every argument leaf's
shape and dtype by path (the port holds uint32 words as int32 bits); every
in- and out-placement's spec by path; and the per-rank argument bytes, the
sums of ``NamedSharding.shard_shape`` bytes. JAX's cells are built once per
module and kept as plain values.
"""

import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
import repro.launch.specs as jspecs
from repro_torch.common.tree_utils import flatten_with_paths
from repro_torch.configs.base import all_arch_names, get_arch
from repro_torch.launch import specs
from repro_torch.launch.dryrun import shard_bytes
from repro_torch.launch.mesh import MeshShape

MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
POD_ARCHS = ("qwen3-4b", "dlrm-rm2", "schnet")
CASES = [("16x16", a) for a in all_arch_names()] + [("2x16x16", a) for a in POD_ARCHS]
SKIPPED = {("granite-3-8b", "long_500k"), ("phi3.5-moe-42b-a6.6b", "long_500k"), ("qwen3-4b", "long_500k")}


def _key(k) -> str:
    for attr in ("name", "idx", "key"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _jax_flat(tree) -> dict:
    return {"/".join(_key(k) for k in path): leaf for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _part(p):
    if isinstance(p, (list, tuple)):
        return p[0] if len(p) == 1 else tuple(p)  # JAX keeps ("data",) as "data": the same split
    return p


def _spec(s) -> tuple:
    """Either package's PartitionSpec as plain values."""
    return tuple(_part(p) for p in s)


def _jax_dtype(dt) -> str:
    name = np.dtype(dt).name
    return "int32" if name == "uint32" else name  # the port's words are int32 bits


def _summary_jax(cell) -> dict:
    args = _jax_flat(cell.args)
    shardings = _jax_flat(cell.in_shardings)
    return {
        "kind": cell.kind,
        "donate": tuple(cell.donate),
        "args": {p: (tuple(a.shape), _jax_dtype(a.dtype)) for p, a in args.items()},
        "in_specs": {p: _spec(s.spec) for p, s in shardings.items()},
        "out_specs": {p: _spec(s.spec) for p, s in _jax_flat(cell.out_shardings).items()},
        "arg_bytes": sum(math.prod(shardings[p].shard_shape(a.shape)) * np.dtype(a.dtype).itemsize
                         for p, a in args.items()),
    }


def _summary_port(cell) -> dict:
    return {
        "kind": cell.kind,
        "donate": tuple(cell.donate),
        "args": {p: (tuple(a.shape), str(a.dtype).removeprefix("torch."))
                 for p, a in flatten_with_paths(cell.args).items()},
        "in_specs": {p: _spec(s.spec) for p, s in flatten_with_paths(cell.in_shardings).items()},
        "out_specs": {p: _spec(s.spec) for p, s in flatten_with_paths(cell.out_shardings).items()},
        "arg_bytes": shard_bytes(cell.args, cell.in_shardings),
    }


@pytest.fixture(scope="module")
def jax_cells():
    """{(mesh, arch): {shape: summary, or None where build_cell skips it}}."""
    out = {}
    for mesh_name, arch_name in CASES:
        mesh = AbstractMesh(*MESHES[mesh_name])
        arch = jconfigs.get_arch(arch_name)
        out[(mesh_name, arch_name)] = {
            s: (None if (cell := jspecs.build_cell(arch, s, mesh)) is None else _summary_jax(cell))
            for s in arch.shapes
        }
    return out


def test_the_same_cells_and_skips(jax_cells):
    assert sorted(jconfigs.all_arch_names()) == sorted(all_arch_names())
    port, ref = {}, {}
    for arch_name in all_arch_names():
        arch = get_arch(arch_name)
        for s in arch.shapes:
            port[(arch_name, s)] = specs.build_cell(arch, s, MeshShape(*MESHES["16x16"])) is not None
            ref[(arch_name, s)] = jax_cells[("16x16", arch_name)][s] is not None
    assert port == ref
    assert sum(port.values()) == 37
    assert {k for k, ok in port.items() if not ok} == SKIPPED


@pytest.mark.parametrize("mesh_name,arch_name", CASES, ids=[f"{m}-{a}" for m, a in CASES])
def test_cells_equal_jax_at_full_width(jax_cells, mesh_name, arch_name):
    mesh = MeshShape(*MESHES[mesh_name])
    arch = get_arch(arch_name)
    for shape_name, want in jax_cells[(mesh_name, arch_name)].items():
        cell = specs.build_cell(arch, shape_name, mesh)
        if want is None:
            assert cell is None
            continue
        assert all(a.is_meta for a in flatten_with_paths(cell.args).values())  # nothing allocated
        got = _summary_port(cell)
        for key in ("kind", "donate", "args", "in_specs", "out_specs", "arg_bytes"):
            assert got[key] == want[key], (shape_name, key)


def test_meta_args_allocate_nothing():
    cell = specs.build_cell(get_arch("dlrm-mlperf"), "train_batch", MeshShape(*MESHES["16x16"]))
    table = cell.args[0].tables.table
    assert table.is_meta and table.shape[0] * table.shape[1] * 4 > 9e10  # 96 GB of tables, on no device
    assert isinstance(cell.args[0].tables.offsets, torch.Tensor)
