"""The port's distributed training layer held to the JAX package across ranks:
the placements' index maps, both vocab-parallel lookups with their
gradients, ``compressed_psum``, ``reshard_state`` and
``restore_checkpoint(shardings=)``.

The JAX side runs once, in one subprocess with 8 host devices
(``jax_dist_reference.py``); the port's side runs once, in one spawned gloo
world of 4 ranks (``torch_dist_worker.run_cases``); the two start together,
on the same numpy inputs, and every test reads their results. The index maps
of the placements need no process group, so they run here.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.common.tree_utils import tree_leaves
from repro_torch.configs.base import get_arch
from repro_torch.distributed.sharding import (
    NamedSharding, PartitionSpec, adafactor_state_specs, stacked_lm_param_specs,
)
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import stacked
from repro_torch.models.convert import to_arrays
from repro_torch.optim.adafactor import Adafactor

import jax_dist_reference as ref
import torch_dist_worker as worker
from torch_mesh_worker import spawn_world

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
STATE_SEED = 3
REF_TIMEOUT_S = 300
# compressed_psum, M = the largest |target| of any rank. The mean: 4 ranks'
# dequantized float32 summed in another order than XLA's; each of the 3 partial
# sums rounds once, by at most 2^-24 of a partial sum <= 4 M, so the means differ
# by at most 3 * 2^-22 * M / 4 < 2^-20 * M. The residuals: XLA compiles
# max / 127 into max * float32(1 / 127) and target - q * scale into one fused
# multiply-add, so they differ from the op-by-op form (which the port computes,
# and which equals JAX's eager quantize_tensor to the bit) by a rounding or two
# of a value <= M.
CP_ATOL = 2.0 ** -20
CP_ERR_ATOL = 2.0 ** -22
GRAD_RTOL = 1e-6  # index_add_ and XLA's scatter-add sum duplicate ids in other orders


def _write_jax_checkpoint(directory, monkeypatch_zstd):
    """The reduced LM's stacked params (the ranks' ``_lm_state`` draw) saved by
    the JAX package, in its zlib codec (the port cannot read zstd)."""
    import jax.numpy as jnp

    import repro.ckpt.checkpoint as jckpt
    from repro.models import attention as jattn, ffn as jffn, stacked as jstacked, transformer as jtf

    classes = {c.__name__: c for c in (jstacked.StackedLMParams, jtf.LayerParams, jattn.AttnParams,
                                       jffn.DenseFFNParams, jffn.MoEParams)}

    def to_jax(node):
        if node is None:
            return None
        if type(node).__name__ in classes:
            return classes[type(node).__name__](*(to_jax(v) for v in node))
        if isinstance(node, tuple):
            return tuple(to_jax(v) for v in node)
        return jnp.asarray(node)

    state = worker._lm_state(get_arch(worker.LM_ARCH).reduced().lm, STATE_SEED)
    monkeypatch_zstd(jckpt, "zstandard", None)
    jckpt.save_checkpoint(directory, worker.CKPT_STEP, {"params": to_jax(to_arrays(state["params"]))})
    return state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX reference's results, the port's results by rank, the state)."""
    root = tmp_path_factory.mktemp("dist")
    ckpt = str(root / "ckpt")
    with pytest.MonkeyPatch.context() as mp:
        state = _write_jax_checkpoint(ckpt, mp.setattr)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), os.path.dirname(__file__)]))
    out = str(root / "ref.pkl")
    proc = subprocess.Popen([sys.executable, ref.__file__, out, ckpt], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        (root / "world").mkdir()
        port = spawn_world(worker.WORLD, {"runner": "torch_dist_worker:run_cases", "ckpt_dir": ckpt,
                                          "state_seed": STATE_SEED}, str(root / "world"))
        log, _ = proc.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f), port, state


def _coord(mesh, rank):
    return MeshShape(*mesh).coord_of(rank)


# ------------------------------------------------------------------ placements, no process group
def _port_map(mesh, spec, shape):
    try:
        dm = NamedSharding(mesh, PartitionSpec(*spec)).devices_indices_map(shape)
    except ValueError as exc:
        return ("ValueError", str(exc))
    return {c: tuple((s.start, s.stop, s.step) for s in idx) for c, idx in dm.items()}


@pytest.mark.parametrize("case", range(len(ref.PLACEMENTS)))
def test_placement_index_maps_equal_jax_by_coordinate(runs, case):
    shape, names, spec, gshape = ref.PLACEMENTS[case]
    want = runs[0]["placements"][case]
    got = _port_map(MeshShape(shape, names), spec, gshape)
    if isinstance(want, tuple):  # JAX's device_put refuses a dimension its shards do not divide
        assert want[0] == "ValueError" and got[0] == "ValueError", (want, got)
        return
    assert got == want


def _lm_trees(arch, full=False):
    """The stacked params and Adafactor moments on the meta device (shapes,
    no draw), at the reduced config or, with ``full``, at the published one."""
    cfg = get_arch(arch) if full else get_arch(arch).reduced()
    params = stacked.init_lm_stacked(cfg.lm, device="meta")
    return params, Adafactor().init(params).moments


def _assert_rule_maps_equal(runs, mesh_shape, arch, full):
    mesh = MeshShape(*mesh_shape)
    params, moments = _lm_trees(arch, full)
    specs = stacked_lm_param_specs(params, mesh, fsdp=True, kv_shard=False)
    for what, tree, spec_tree in (("params", params, specs), ("moments", moments, adafactor_state_specs(specs))):
        want = runs[0]["rules"][(mesh_shape[0], arch, full, what)]
        leaves, spec_leaves = tree_leaves(tree), tree_leaves(spec_tree)
        assert len(leaves) == len(spec_leaves) == len(want)
        for i, (x, s) in enumerate(zip(leaves, spec_leaves)):
            assert _port_map(mesh, tuple(s), tuple(x.shape)) == want[i], f"{what} leaf {i} ({s}, {tuple(x.shape)})"


@pytest.mark.parametrize("mesh_shape", ref.RULE_MESHES, ids=lambda m: "x".join(m[1]))
@pytest.mark.parametrize("arch", ref.RULE_ARCHS)
def test_lm_and_adafactor_placements_equal_jax_by_coordinate(runs, mesh_shape, arch):
    _assert_rule_maps_equal(runs, mesh_shape, arch, full=False)


@pytest.mark.parametrize("mesh_shape", ref.FULL_RULE_MESHES, ids=lambda m: "x".join(map(str, m[0])))
def test_full_size_qwen3_placements_equal_jax_by_coordinate(runs, mesh_shape):
    """The index maps by which chip_smoke.py's distributed phase cuts
    qwen3-4b at full width and depth, held to JAX's at those shapes."""
    _assert_rule_maps_equal(runs, mesh_shape, ref.LM_ARCH, full=True)


# ------------------------------------------------------------------ the gloo world
def test_mesh_coordinates_and_axis_groups(runs):
    port = runs[1]
    for rank in range(worker.WORLD):
        for name, shape in (("a", worker.MESH_A), ("b", worker.MESH_B)):
            mesh = MeshShape(*shape)
            coord, groups = port[rank]["mesh"][name]
            assert coord == mesh.coord_of(rank)
            for i, axis in enumerate(mesh.axis_names):  # the ranks that differ from this one in that axis only
                want = sorted(r for r in range(worker.WORLD)
                              if all(a == b for j, (a, b) in enumerate(zip(mesh.coord_of(r), coord)) if j != i))
                assert groups[axis] == want
        assert "256 ranks" in port[rank]["production"]  # the production shape is never shrunk


@pytest.mark.parametrize("variant", ["psum", "scattered"])
def test_lookup_outputs_equal_jax_to_the_bit(runs, variant):
    jax_shards, _ = runs[0]["lookups"][variant]
    x = worker.inputs()
    for rank in range(worker.WORLD):
        got, _ = runs[1][rank][f"lookup/{variant}"]
        idx, want = jax_shards[_coord(worker.MESH_A, rank)]
        np.testing.assert_array_equal(got, want)
        rows = x["ids"][tuple(slice(*s) for s in idx)[0]]
        dead = (rows < 0) | (rows >= x["table"].shape[0])
        assert dead.any() or variant == "scattered"
        assert not got[dead].any(), "an id no shard owns gives a zero row"


@pytest.mark.parametrize("variant", ["psum", "scattered"])
def test_lookup_table_gradients_are_jax_and_the_plain_gathers(runs, variant):
    """Each rank's table-shard gradient is its rows of JAX's gradient, which
    is the plain gather's: not scaled by the model axis, and summed over the
    data axis's batch shards."""
    _, jax_grad = runs[0]["lookups"][variant]
    x = worker.inputs()
    plain = worker.plain_lookup_grad(x["table"], x["ids"], x["w"])
    np.testing.assert_allclose(jax_grad, plain, rtol=GRAD_RTOL, atol=1e-6)
    n_model = worker.MESH_A[0][1]
    r_local = x["table"].shape[0] // n_model
    for rank in range(worker.WORLD):
        _, got = runs[1][rank][f"lookup/{variant}"]
        m = _coord(worker.MESH_A, rank)[1]
        want = jax_grad[m * r_local: (m + 1) * r_local]
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=1e-6)
        assert not np.allclose(got, n_model * want), "the gradient came back scaled by the model axis"


@pytest.mark.parametrize("step", range(worker.CP_STEPS))
def test_compressed_psum_equals_jax_on_a_data_axis_of_4(runs, step):
    jax_mean, jax_err = runs[0]["compressed_psum"][step]
    x = worker.inputs()
    for rank in range(worker.WORLD):
        mean, err = runs[1][rank]["compressed_psum"][step]
        for k in mean:
            # M: the largest |target| of any rank this step (target = g + the last residual)
            prev = [runs[1][r]["compressed_psum"][step - 1][1][k] if step else 0.0 for r in range(worker.WORLD)]
            m_max = max(float(np.abs(x["grads"][step][r][k] + prev[r]).max()) for r in range(worker.WORLD))
            np.testing.assert_allclose(mean[k], jax_mean[k][rank], rtol=0, atol=CP_ATOL * m_max)
            np.testing.assert_allclose(err[k], jax_err[k][rank], rtol=0, atol=CP_ERR_ATOL * m_max)
            assert mean[k].dtype == np.float32


def test_reshard_state_equals_a_fresh_placement(runs):
    for rank in range(worker.WORLD):
        r = runs[1][rank]["reshard"]
        assert r["leaves"] > 20
        assert all(r["a_to_b_equal_fresh"]) and len(r["a_to_b_equal_fresh"]) == r["leaves"]
        assert all(r["b_to_a_equal_first"]) and all(r["gathered_equal_whole"])
        assert (r["gathered_on_0"] is None) == (rank != 0) and all(r["gathered_on_0"] or [True])
    state = runs[2]
    mesh_b = MeshShape(*worker.MESH_B)
    specs = worker._state_specs(state, mesh_b)
    want = [NamedSharding(mesh_b, s).shard_shape(tuple(x.shape))
            for x, s in zip(tree_leaves(state), tree_leaves(specs))]
    assert runs[1][0]["reshard"]["shard_shapes"] == want


@pytest.mark.parametrize("mesh", ["a", "b"])
def test_restore_checkpoint_with_shardings_gives_each_rank_jax_slice(runs, mesh):
    shape = worker.MESH_A if mesh == "a" else worker.MESH_B
    step_j, jax_leaves = runs[0]["restores"][mesh]
    for rank in range(worker.WORLD):
        step, leaves = runs[1][rank][f"restore/{mesh}"]
        assert step == step_j == worker.CKPT_STEP
        assert len(leaves) == len(jax_leaves)
        for got, by_coord in zip(leaves, jax_leaves):
            _, want = by_coord[_coord(shape, rank)]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
