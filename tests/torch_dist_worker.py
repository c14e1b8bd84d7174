"""The distributed training layer's inputs, and the rank body that runs the
port's side of ``test_torch_distributed.py`` in one gloo world.

``inputs()`` makes every case's inputs from numpy seeds; the JAX reference
(``jax_dist_reference.py``, in its own process with 8 host devices) and the
port's ranks both call it. ``run_cases`` is the rank body that
``torch_mesh_worker.spawn_world`` runs (``spec["runner"]``) on 4 ranks:
meshes (data 2, model 2) and (data 1, model 4), the vocab-parallel lookups
with their gradients, ``compressed_psum`` on a data axis of 4,
``reshard_state`` between the two meshes, and ``restore_checkpoint(shardings=)``
of a checkpoint that the JAX package wrote. Each rank returns host numpy
arrays. This module imports numpy at import time, torch and the port only
inside the rank body, so neither side pulls in the other's framework.
"""

from __future__ import annotations

import numpy as np

WORLD = 4
MESH_A = ((2, 2), ("data", "model"))
MESH_B = ((1, 4), ("data", "model"))
LM_ARCH = "qwen3-4b"  # at reduced(): every sharded dimension divides 4
CKPT_STEP = 7
CP_STEPS = 2  # compressed_psum steps; the second runs on the first one's residuals


def inputs() -> dict:
    rng = np.random.default_rng(0)
    table = rng.standard_normal((64, 8)).astype(np.float32)
    ids = rng.integers(0, 64, (16, 3)).astype(np.int32)
    ids[2] = ids[3]  # duplicate ids: the gradient sums them
    ids[0, 0], ids[1, 1], ids[5, 2] = -1, 64, 1000  # owned by no shard: zero rows
    ids[9] = (-7, 90, 64)
    w = rng.standard_normal((16, 3, 8)).astype(np.float32)
    shapes = {"a": (5, 6), "b": (7,), "c": (3, 4, 2)}
    grads = [[{k: (rng.standard_normal(s) * 10.0 ** (r - 2)).astype(np.float32) for k, s in shapes.items()}
              for r in range(WORLD)] for _ in range(CP_STEPS)]
    return dict(table=table, ids=ids, w=w, grads=grads)


def plain_lookup_grad(table, ids, w) -> np.ndarray:
    """The gradient of sum(rows * w) over the table, rows gathered at the
    in-range ids (float64, then float32)."""
    g = np.zeros(table.shape, np.float64)
    ok = (ids >= 0) & (ids < table.shape[0])
    np.add.at(g, ids[ok], w[ok].astype(np.float64))
    return g.astype(np.float32)


def _np_tree(tree):
    from repro_torch.common.tree_utils import flatten_with_paths

    return [v.detach().cpu().numpy() for v in flatten_with_paths(tree).values()]


def _lm_state(cfg, seed: int):
    """Reduced stacked LM params and Adafactor moments drawn from a CPU
    generator (the same on every rank)."""
    import torch

    from repro_torch.common.tree_utils import tree_map
    from repro_torch.models import stacked
    from repro_torch.optim.adafactor import Adafactor

    gen = torch.Generator().manual_seed(seed)
    params = stacked.init_lm_stacked(cfg, gen, device="cpu")
    moments = tree_map(lambda m: torch.rand(m.shape, generator=gen), Adafactor().init(params).moments)
    return {"params": params, "moments": moments}


def _state_specs(state, mesh):
    from repro_torch.distributed.sharding import adafactor_state_specs, stacked_lm_param_specs

    specs = stacked_lm_param_specs(state["params"], mesh, fsdp=True, kv_shard=False)
    return {"params": specs, "moments": adafactor_state_specs(specs)}


def run_cases(spec: dict, report) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.ckpt.checkpoint import restore_checkpoint
    from repro_torch.common.tree_utils import flatten_with_paths, tree_leaves, tree_map
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed.embedding import vocab_parallel_lookup, vocab_parallel_lookup_scattered
    from repro_torch.distributed.sharding import NamedSharding, PartitionSpec as P, device_put, gather_tree
    from repro_torch.launch.mesh import DeviceMesh, batch_axes, make_host_mesh, make_production_mesh
    from repro_torch.optim.grad_compress import compressed_psum, init_error_feedback
    from repro_torch.train.elastic import reshard_state, shardings_for

    rank = dist.get_rank()
    out = {}
    mesh_a = make_host_mesh(model=2, device="cpu")
    mesh_b = DeviceMesh(*MESH_B, device="cpu")
    out["mesh"] = {name: (m.coord, {a: dist.get_process_group_ranks(m.group(a)) if m.group(a) else [rank]
                                    for a in m.axis_names})
                   for name, m in (("a", mesh_a), ("b", mesh_b))}
    try:
        make_production_mesh(device="cpu")
        out["production"] = "built"
    except ValueError as exc:
        out["production"] = str(exc)
    report("mesh")

    # ---- the vocab-parallel lookups on mesh A: this rank's rows and batch shard
    x = inputs()
    table = torch.from_numpy(x["table"])
    ids, w = torch.from_numpy(x["ids"]), torch.from_numpy(x["w"])
    rows = NamedSharding(mesh_a, P("model", None))
    batch = NamedSharding(mesh_a, P(batch_axes(mesh_a), None))
    for name, fn in (("psum", vocab_parallel_lookup), ("scattered", vocab_parallel_lookup_scattered)):
        t_local = rows.shard(table).requires_grad_()
        got = fn(t_local, batch.shard(ids), mesh_a, batch_axes(mesh_a))
        # this rank's slice of the cotangent of the global output, as its layout
        out_spec = (batch_axes(mesh_a) + ("model",)) if name == "scattered" else batch_axes(mesh_a)
        w_local = NamedSharding(mesh_a, P(out_spec, None, None)).shard(w)
        (got * w_local).sum().backward()
        out[f"lookup/{name}"] = (got.detach().numpy(), t_local.grad.numpy())
    report("lookup")

    # ---- compressed_psum over a data axis of 4
    mesh_d = DeviceMesh((WORLD, 1), ("data", "model"), device="cpu")
    grads = [{k: torch.from_numpy(v) for k, v in step[rank].items()} for step in x["grads"]]
    ef = init_error_feedback(grads[0])
    steps = []
    for g in grads:
        mean, ef = compressed_psum(g, ef, mesh_d.group("data"))
        steps.append((tree_map(lambda t: t.numpy(), mean), tree_map(lambda t: t.numpy(), ef.err)))
    out["compressed_psum"] = steps
    report("compressed_psum")

    # ---- reshard_state between the meshes against fresh placements
    cfg = get_arch(LM_ARCH).reduced().lm
    state = _lm_state(cfg, seed=spec["state_seed"])
    shard_a, shard_b = (shardings_for(state, m, lambda path, leaf, specs=flatten_with_paths(_state_specs(state, m)):
                                      specs[path]) for m in (mesh_a, mesh_b))
    on_a = device_put(state, shard_a)
    on_b = reshard_state(on_a, shard_b, shard_a)
    fresh_b = device_put(state, shard_b)
    back_a = reshard_state(on_b, shard_a, shard_b)
    whole = gather_tree(on_b, shard_b)
    whole_0 = gather_tree(on_b, shard_b, dst=0)
    out["reshard"] = {
        "leaves": len(tree_leaves(state)),
        "a_to_b_equal_fresh": [bool(torch.equal(u, v)) for u, v in zip(tree_leaves(on_b), tree_leaves(fresh_b))],
        "b_to_a_equal_first": [bool(torch.equal(u, v)) for u, v in zip(tree_leaves(back_a), tree_leaves(on_a))],
        "gathered_equal_whole": [bool(torch.equal(u, v)) for u, v in zip(tree_leaves(whole), tree_leaves(state))],
        "gathered_on_0": None if rank else [bool(torch.equal(u, v))
                                           for u, v in zip(tree_leaves(whole_0), tree_leaves(state))],
        "shard_shapes": [tuple(t.shape) for t in tree_leaves(on_b)],
    }
    report("reshard")

    # ---- restore_checkpoint(shardings=) of the JAX package's checkpoint onto both meshes
    target = {"params": tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state["params"])}
    for name, mesh in (("a", mesh_a), ("b", mesh_b)):
        specs = _state_specs(state, mesh)["params"]
        shardings = {"params": tree_map(lambda s: NamedSharding(mesh, s), specs)}
        restored, step = restore_checkpoint(spec["ckpt_dir"], target, shardings=shardings)
        out[f"restore/{name}"] = (step, _np_tree(restored))
    report("restore")
    return out
