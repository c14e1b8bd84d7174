"""One cell of each step kind, run by both packages on the CPU, and the
port's dry-run counts held to the JAX package's HLO analysis.

Each case patches the same small ``ShapeSpec`` into both packages' shape
tables (the JAX package is not edited) and builds the cell at the arch's
``reduced()`` config: the port's on a ``DeviceMesh`` of one rank (the recsys
lookups go through the vocab-parallel functions), JAX's on a 1 x 1 mesh,
jitted. The inputs are the port's ``dryrun.draw_args`` from a seed, carried
to JAX's classes by name. Tolerances:
  * float32 outputs within 1e-5 x max |reference| (the Adafactor second
    moments, squares of gradients, through their square roots: the RMS
    gradients they hold); the bf16 logits and caches of the serving steps
    within 2e-2 of JAX's in relative norm;
  * the bf16 LM train step: the loss within rtol 2e-2 and, per leaf, the
    parameter update and the Adafactor moments within 15% of JAX's in
    relative norm (the two frameworks round bf16 products at other places;
    see ``tests/test_torch_encoder.py``);
  * retrieval ids equal.
FLOPs: the port's meta pass (``dryrun.count_cell``) within 1% of
``repro.launch.hlo_flops.analyze`` on JAX's compiled HLO of the same cell.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.configs.base as jbase
import repro.launch.specs as jspecs
import repro.models.attention as jattn
import repro.models.ffn as jffn
import repro.models.recsys as jrec
import repro.models.schnet as jschnet
import repro.models.stacked as jstacked
import repro.models.transformer as jtf
import repro.optim.adafactor as jada
from repro.launch.hlo_flops import analyze
from repro_torch.common.tree_utils import flatten_with_paths
from repro_torch.configs import base
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import DeviceMesh, MeshShape

_JAX_CLASSES = {c.__name__: c for c in (
    jtf.LMParams, jtf.LayerParams, jstacked.StackedLMParams, jstacked.StackedDecodeState, jattn.AttnParams,
    jattn.LayerKVCache, jffn.DenseFFNParams, jffn.MoEParams, jada.AdafactorState, jada.FactoredMoment,
    jrec.EmbedTables, jrec.DLRMParams, jrec.DINParams, jrec.MINDParams, jschnet.SchNetParams,
    jschnet.InteractionParams)}

# (arch, shape table, shape name, small ShapeSpec fields)
CASES = {
    "lm-train": ("qwen3-4b", "LM_SHAPES", "train_4k", dict(kind="train", seq_len=32, global_batch=8)),
    "lm-prefill": ("qwen3-4b", "LM_SHAPES", "prefill_32k", dict(kind="prefill", seq_len=32, global_batch=2)),
    "lm-decode": ("qwen3-4b", "LM_SHAPES", "decode_32k", dict(kind="decode", seq_len=32, global_batch=2)),
    "gnn-molecule": ("schnet", "GNN_SHAPES", "molecule", dict(kind="batched_graphs", n_nodes=6, n_edges=10,
                                                              batch=4)),
    "gnn-full-graph": ("schnet", "GNN_SHAPES", "full_graph_sm", dict(kind="full_graph", n_nodes=40, n_edges=120,
                                                                     d_feat=12)),
    "gnn-minibatch": ("schnet", "GNN_SHAPES", "minibatch_lg", dict(kind="minibatch", n_nodes=500, n_edges=2000,
                                                                   batch_nodes=4, fanout=(3, 2))),
    "rank-train": ("dlrm-rm2", "RECSYS_SHAPES", "train_batch", dict(kind="rank_train", batch=16)),
    "rank-serve": ("mind", "RECSYS_SHAPES", "serve_p99", dict(kind="rank_serve", batch=8)),
    "din-retrieval": ("din", "RECSYS_SHAPES", "retrieval_cand", dict(kind="retrieval", batch=1,
                                                                     n_candidates=5000)),
    "mind-dense-retrieval": ("mind", "RECSYS_SHAPES", "retrieval_cand", dict(kind="retrieval", batch=1,
                                                                             n_candidates=20000)),
}
TOL = 1e-5
BF16_RTOL = 2e-2
BF16_LEAF = 0.15


def _np_leaf(x):
    if x.dtype == torch.bfloat16:
        return x.float().numpy().astype(ml_dtypes.bfloat16)
    return x.numpy().copy()


def _to_jax(tree):
    """A port tree (tensors) as the JAX package's classes with numpy leaves."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return _np_leaf(tree)
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if type(tree).__name__ in _JAX_CLASSES:
        return _JAX_CLASSES[type(tree).__name__](*(_to_jax(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_to_jax(v) for v in tree)
    return tree


def _key(k) -> str:
    for attr in ("name", "idx", "key"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _jax_flat(tree) -> dict:
    """{path: numpy leaf}, bf16 leaves as float32, and the set of bf16 paths."""
    out, bf16 = {}, set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key, a = "/".join(_key(k) for k in path), np.asarray(leaf)
        if a.dtype == ml_dtypes.bfloat16:
            a = a.astype(np.float32)
            bf16.add(key)
        out[key] = a
    return out, bf16


def _port_flat(tree) -> dict:
    """{path: a numpy copy of each tensor leaf} (bf16 as float32)."""
    return {p: (v.float() if v.dtype == torch.bfloat16 else v).numpy().copy()
            for p, v in flatten_with_paths(tree).items() if isinstance(v, torch.Tensor)}


def _run_case(name):
    arch_name, table, shape_name, fields = CASES[name]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(getattr(base, table), shape_name, base.ShapeSpec(shape_name, **fields))
        mp.setitem(getattr(jbase, table), shape_name, jbase.ShapeSpec(shape_name, **fields))
        arch, jarch = base.get_arch(arch_name).reduced(), jconfigs.get_arch(arch_name).reduced()
        cell = specs.build_cell(arch, shape_name, DeviceMesh((1, 1), ("data", "model"), device="cpu"))
        jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
        jcell = jspecs.build_cell(jarch, shape_name, jmesh)
        args = dryrun.draw_args(cell, "cpu", torch.Generator().manual_seed(7), arch=arch)
        if name == "lm-decode":  # a written cache, so the step attends over values
            rng = np.random.default_rng(3)
            caches = tuple(c._replace(k=torch.from_numpy(rng.standard_normal(c.k.shape, np.float32)).to(torch.bfloat16),
                                      v=torch.from_numpy(rng.standard_normal(c.v.shape, np.float32)).to(torch.bfloat16))
                           for c in args[2].caches)
            args = (args[0], args[1], args[2]._replace(caches=caches))
        before = _port_flat(args)
        jargs = _to_jax(args)
        got = cell.fn(*args)
        # the dry run's count: a meta pass on the mesh's shape (the lookups as at one rank)
        cost, _, _, _ = dryrun.count_cell(specs.build_cell(arch, shape_name, MeshShape((1, 1), ("data", "model"))))
        with jax.set_mesh(jmesh):
            compiled = jax.jit(jcell.fn, in_shardings=jcell.in_shardings,
                               out_shardings=jcell.out_shardings).lower(*jargs).compile()
            want = compiled(*jargs)
        want, bf16 = _jax_flat(want)
        return {"got": _port_flat(got), "want": want, "bf16": bf16, "before": before, "flops": cost["flops"],
                "jax_flops": analyze(compiled.as_text())["flops"]}


@pytest.fixture(scope="module")
def runs():
    return {}


def _case(runs, name):
    if name not in runs:
        runs[name] = _run_case(name)
    return runs[name]


@pytest.mark.parametrize("name", [n for n in CASES if n != "lm-train"])
def test_cell_step_equals_jax(runs, name):
    r = _case(runs, name)
    got, want = r["got"], r["want"]
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        if name == "mind-dense-retrieval" and path == "0":  # ids
            np.testing.assert_array_equal(g, w, err_msg=path)
        elif path in r["bf16"]:  # the serving steps' bf16 logits and caches
            err = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
            assert err <= BF16_RTOL, (path, err)
        elif np.issubdtype(w.dtype, np.floating):
            if "/moments/" in path:  # squares of gradients: held as the RMS gradient they keep
                g, w = np.sqrt(g), np.sqrt(w)
            if not w.size:
                continue
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= TOL * scale, (path, float(np.abs(g - w).max()), scale)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


def test_bf16_lm_train_step_with_accumulation_equals_jax(runs):
    r = _case(runs, "lm-train")
    got, want, before = r["got"], r["want"], r["before"]
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["2"], want["2"], rtol=BF16_RTOL)  # the loss
    assert got["1/step"] == want["1/step"] == 1
    rel = lambda a, b: float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
    for path, w in want.items():
        if path.startswith("0/"):  # the parameters: hold the update each took
            err = rel(got[path] - before[path], w - before[path])
        elif path.startswith("1/moments/"):
            err = rel(got[path], w) if w.size else 0.0
        else:
            continue
        assert err <= BF16_LEAF, f"{path}: {err:.4f}"


def _prefill_kv_twice(cfg, shape) -> int:
    """The wk and wv products that the prefill runs twice a layer
    (``prefill_cache``, then ``attn_forward``), and XLA's CSE merges into one."""
    kv = cfg.n_kv_heads * cfg.resolved_head_dim()
    return cfg.n_layers * 2 * 2 * shape["global_batch"] * shape["seq_len"] * cfg.d_model * kv


# products the port runs that JAX's compiled program does not (ROADMAP, queue 3 notes)
EXPLAINED = {"lm-prefill": lambda: _prefill_kv_twice(base.get_arch("qwen3-4b").reduced().lm, CASES["lm-prefill"][3])}


@pytest.mark.parametrize("name", list(CASES))
def test_counted_flops_equal_the_hlo_analysis(runs, name):
    r = _case(runs, name)
    assert r["jax_flops"] > 0
    flops = r["flops"] - (EXPLAINED[name]() if name in EXPLAINED else 0)
    assert abs(flops - r["jax_flops"]) <= 0.01 * r["jax_flops"], (r["flops"], flops, r["jax_flops"])


def test_micro_batch_extrapolation_counts_every_micro_batch():
    """The dry run counts micro-batches 1 and 2 of an LM train cell and
    extrapolates: the same counts as a pass over all of them."""
    arch = base.get_arch("gemma3-27b").reduced()  # a group of 6 and two tail layers
    shape = base.ShapeSpec("train_4k", "train", seq_len=16, global_batch=16)
    mesh = DeviceMesh((1, 1), ("data", "model"), device="cpu")
    cell = specs.cell_for_shape(arch, shape, mesh)
    with dryrun.OpCounter() as full:
        cell.fn(*cell.args)
    cost, stats, _, counted = dryrun.count_cell(specs.cell_for_shape(arch, shape, mesh))
    assert "extrapolated to 8" in counted
    assert cost == full.record()
    assert stats["ops"] == dict(full.ops) and stats["n_view_ops"] == full.n_views


def test_memoized_meta_counts_equal_a_pass_on_cpu_tensors():
    """OpCounter answers repeated ops on meta tensors from its memo; on CPU
    tensors it runs and counts every op: the same flops, bytes and ops."""
    arch = base.get_arch("qwen3-4b").reduced()
    shape = base.ShapeSpec("train_4k", "train", seq_len=32, global_batch=4)
    mesh = MeshShape((1, 1), ("data", "model"))
    meta = specs.cell_for_shape(arch, shape, mesh)
    with dryrun.OpCounter() as on_meta:
        meta.fn(*meta.args)
    cell = specs.cell_for_shape(arch, shape, mesh)
    args = dryrun.draw_args(cell, "cpu", torch.Generator().manual_seed(0), arch=arch)
    with dryrun.OpCounter() as on_cpu:
        cell.fn(*args)
    assert on_meta._memo and not on_cpu._memo
    assert on_meta.record() == on_cpu.record() and on_meta.ops == on_cpu.ops


def test_dry_run_records_count_a_step_once_for_both_meshes(tmp_path, capsys):
    """run_cell_on_both_meshes writes JAX's record keys for each mesh, with
    the per-device counts the global ones over n_devices and the step
    counted once where both meshes' cells take the same arguments."""
    import json

    recs = dryrun.run_cell_on_both_meshes("mind", "serve_p99", str(tmp_path))
    one, two = recs["16x16"], recs["2x16x16"]
    assert one["status"] == two["status"] == "ok" and (one["n_devices"], two["n_devices"]) == (256, 512)
    assert "on the 16x16 mesh" in two["cost"]["counted"]
    for r in (one, two):
        assert r["memory"]["temp_bytes"] is None and r["memory"]["peak_bytes"] is None and r["collectives"] is None
        assert r["cost_adjusted"]["flops"] == r["cost"]["flops"] / r["n_devices"]
        assert r["op_stats"]["n_ops"] == sum(r["op_stats"]["ops"].values()) > 0
        with open(tmp_path / r["mesh"] / "mind__serve_p99.json") as f:
            assert json.load(f)["cost"]["flops"] == r["cost"]["flops"]
    assert one["memory"]["argument_bytes"] > two["memory"]["argument_bytes"]  # the batch over 32 shards, not 16
    dryrun.main(["--arch", "qwen3-4b", "--shape", "long_500k", "--out", str(tmp_path / "cli")])
    assert "0 ok, 0 failed, 1 skipped" in capsys.readouterr().out


def test_dense_index_at_a_fixed_quantizer_bounds_every_block():
    """build_dense_index with ``scale_zero`` (mind's cell layout): every
    dimension takes the given scale and zero point, and each block's and
    superblock's dequantized max / min bound its candidates from above / below."""
    from repro_torch.core.bounds import unpack_strided
    from repro_torch.core.lsp_dense import DenseIndexConfig, build_dense_index

    scale, zero, bits = 0.01, -1.0, 4
    x = zero + 15 * scale * torch.rand((1500, 8), generator=torch.Generator().manual_seed(3))
    idx = build_dense_index(x, DenseIndexConfig(b=8, c=8, bits=bits, ns_align=4), "cpu", scale_zero=(scale, zero))
    assert idx.n_superblocks % 4 == 0 and idx.cands.shape[0] == idx.n_superblocks * 64
    xs = x[idx.remap.clamp(max=x.shape[0] - 1).long()]
    valid = (idx.remap < x.shape[0])[:, None]
    for pm, rows in ((idx.blk, 8), (idx.sb, 64)):
        assert torch.all(pm.scale == scale) and torch.all(pm.zero == zero)
        hi = unpack_strided(pm.max_packed, bits, pm.granule_words)[:, : pm.n].float() * scale + zero  # [D, n]
        lo = unpack_strided(pm.min_packed, bits, pm.granule_words)[:, : pm.n].float() * scale + zero
        top = torch.where(valid, xs, -1e30).view(pm.n, rows, -1).amax(dim=1).T
        bot = torch.where(valid, xs, 1e30).view(pm.n, rows, -1).amin(dim=1).T
        live = top > -1e29
        assert torch.all((hi >= top - 1e-6)[live]) and torch.all((lo <= bot + 1e-6)[live])


def test_mind_cell_inputs_are_the_sharded_dense_index():
    """dryrun.draw_args for mind's retrieval cell: the shard-stacked words of
    build_dense_index at the cell's fixed quantizer, cut by
    shard_dense_index, in the shapes the cell declares."""
    from repro_torch.core.lsp_dense import DenseIndexConfig, build_dense_index, shard_dense_index

    arch = base.get_arch("mind").reduced()
    shape = base.ShapeSpec("retrieval_cand", "retrieval", batch=1, n_candidates=3000)
    cell = specs.cell_for_shape(arch, shape, MeshShape((1, 4), ("data", "model")))
    args = dryrun.draw_args(cell, "cpu", torch.Generator().manual_seed(5), arch=arch)
    assert [tuple(a.shape) for a in args] == [tuple(a.shape) for a in cell.args]
    assert [a.dtype for a in args] == [a.dtype for a in cell.args]
    g = torch.Generator().manual_seed(5)
    x = specs.MIND_ZERO + 15 * specs.MIND_SCALE * torch.rand((3000, arch.recsys.embed_dim), generator=g)
    cfg = DenseIndexConfig(b=specs.MIND_B, c=specs.MIND_C, bits=specs.MIND_BITS, ns_align=4)
    shards = shard_dense_index(build_dense_index(x, cfg, "cpu", scale_zero=(specs.MIND_SCALE, specs.MIND_ZERO)), 4)
    for s, shard in enumerate(shards):
        assert torch.equal(args[0][s], shard.sb.max_packed) and torch.equal(args[3][s], shard.blk.min_packed)
        assert torch.equal(args[4][s], shard.cands) and torch.equal(args[5][s], shard.remap)
    ids, _ = cell.fn(*args, impl="ref")
    assert ids.shape == (arch.recsys.n_interests, 100) and bool((ids < 3000).all())
