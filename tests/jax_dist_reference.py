"""The JAX package's side of ``test_torch_distributed.py``, in a process of its
own with 8 host devices (the device count locks at JAX's first use):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        PYTHONPATH=src:tests python tests/jax_dist_reference.py OUT.pkl CKPT_DIR

Writes a pickle of: ``devices_indices_map`` of every placement case and of
the stacked LM and Adafactor rules' leaves (by mesh coordinate, never by
device id), qwen3-4b's at full width and depth too, on the two meshes of
``chip_smoke.py``'s distributed phase; both vocab-parallel lookups on mesh
(data 2, model 2) with the table's gradient; ``compressed_psum`` on a data
axis of 4 for two steps; and ``restore_checkpoint(shardings=)`` of the
checkpoint under CKPT_DIR onto meshes (data 2, model 2) and (data 1, model
4), each coordinate's slices.
"""

from __future__ import annotations

import functools
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_dist_worker import CP_STEPS, LM_ARCH, MESH_A, MESH_B, WORLD, inputs

# (mesh shape, axis names, spec entries, global shape); the last two do not divide
PLACEMENTS = [
    ((2, 2, 2), ("pod", "data", "model"), (("data", "pod"), "model"), (8, 6)),
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), None), (8, 3)),
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data", "model"),), (16,)),
    ((2, 2), ("data", "model"), (None, ("data", "model")), (3, 8)),
    ((2, 2), ("data", "model"), ("model", None), (6, 5)),
    ((2, 2), ("data", "model"), (), (4,)),
    ((2, 2), ("data", "model"), (None, "data", "model"), (2, 4, 6)),
    ((1, 4), ("data", "model"), (("data", "model"), None), (8, 2)),
    ((2, 2, 2), ("pod", "data", "model"), (("data", "pod"), None), (5, 3)),
    ((2, 2), ("data", "model"), ("model",), (3,)),
]
RULE_MESHES = [((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
RULE_ARCHS = ["qwen3-4b", "phi3.5-moe-42b-a6.6b"]
# the placements that chip_smoke.py's distributed phase makes: qwen3-4b at full width and depth
FULL_RULE_MESHES = [MESH_A, MESH_B]


def mesh(shape, names):
    return jax.make_mesh(shape, names, devices=jax.devices()[: int(np.prod(shape))])


def by_coord(m, fn):
    """{mesh coordinate: fn(device)} over every position of ``m.devices``."""
    return {tuple(int(c) for c in coord): fn(m.devices[coord]) for coord in np.ndindex(m.devices.shape)}


def slices(idx):
    return tuple((s.start, s.stop, s.step) for s in idx)


def index_map(m, spec, shape):
    try:
        dm = NamedSharding(m, spec).devices_indices_map(shape)
    except ValueError as exc:
        return ("ValueError", str(exc))
    return by_coord(m, lambda d: slices(dm[d]))


def shards(arr):
    """{coordinate: (slices, data)} of a sharded array."""
    m = arr.sharding.mesh
    got = {s.device: (slices(s.index), np.asarray(s.data)) for s in arr.addressable_shards}
    return by_coord(m, lambda d: got[d])


def lm_shapes(name, full=False):
    """Shapes only (``jax.eval_shape`` allocates nothing), at the reduced
    config or, with ``full``, at the published one."""
    from repro.configs import get_arch
    from repro.models import stacked, transformer
    from repro.optim.adafactor import Adafactor

    arch = get_arch(name)
    cfg = (arch if full else arch.reduced()).lm
    params = jax.eval_shape(lambda: stacked.stack_params(transformer.init_lm(jax.random.PRNGKey(0), cfg), cfg))
    return params, jax.eval_shape(lambda: Adafactor().init(params))


def rule_maps():
    from repro.distributed.sharding import adafactor_state_specs, stacked_lm_param_specs

    cases = [(m, arch, False) for m in RULE_MESHES for arch in RULE_ARCHS]
    cases += [(m, LM_ARCH, True) for m in FULL_RULE_MESHES]
    out = {}
    for (shape, names), arch, full in cases:
        m = mesh(shape, names)
        params, opt = lm_shapes(arch, full)
        specs = stacked_lm_param_specs(params, m, fsdp=True, kv_shard=False)
        state_specs = adafactor_state_specs(specs)
        is_spec = lambda x: isinstance(x, P)
        for what, tree, spec_tree in (("params", params, specs), ("moments", opt.moments, state_specs)):
            leaves = jax.tree_util.tree_leaves(tree)
            spec_leaves = jax.tree_util.tree_leaves(spec_tree, is_leaf=is_spec)
            assert len(leaves) == len(spec_leaves)
            out[(shape, arch, full, what)] = [index_map(m, s, x.shape) for x, s in zip(leaves, spec_leaves)]
    return out


def lookups():
    from repro.distributed.embedding import vocab_parallel_lookup, vocab_parallel_lookup_scattered

    x = inputs()
    m = mesh(*MESH_A)
    table, ids, w = jnp.asarray(x["table"]), jnp.asarray(x["ids"]), jnp.asarray(x["w"])
    out = {}
    with jax.set_mesh(m):
        for name, fn in (("psum", vocab_parallel_lookup), ("scattered", vocab_parallel_lookup_scattered)):
            f = functools.partial(fn, flat_ids=ids, mesh=m, batch_axes=("data",))
            got = f(table)
            grad = jax.grad(lambda t: (f(t) * w).sum())(table)
            out[name] = (shards(got), np.asarray(grad))
    return out


def compressed():
    from jax.experimental.shard_map import shard_map

    from repro.optim.grad_compress import ErrorFeedback, compressed_psum

    x = inputs()
    m = mesh((WORLD,), ("data",))

    def step(g, e):
        first = lambda t: jax.tree.map(lambda a: a[0], t)
        mean, ef = compressed_psum(first(g), ErrorFeedback(first(e)), "data")
        return jax.tree.map(lambda a: a[None], mean), jax.tree.map(lambda a: a[None], ef.err)

    fn = jax.jit(shard_map(step, mesh=m, in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data")),
                           check_rep=False))
    stack = lambda per_rank: {k: jnp.stack([g[k] for g in per_rank]) for k in per_rank[0]}
    err = jax.tree.map(jnp.zeros_like, stack(x["grads"][0]))
    out = []
    for t in range(CP_STEPS):
        mean, err = fn(stack(x["grads"][t]), err)
        out.append((jax.tree.map(np.asarray, mean), jax.tree.map(np.asarray, err)))
    return out


def restores(ckpt_dir):
    from repro.ckpt.checkpoint import restore_checkpoint
    from repro.distributed.sharding import stacked_lm_param_specs

    params, _ = lm_shapes(LM_ARCH)
    out = {}
    for name, (shape, names) in (("a", MESH_A), ("b", MESH_B)):
        m = mesh(shape, names)
        specs = stacked_lm_param_specs(params, m, fsdp=True, kv_shard=False)
        shardings = {"params": jax.tree.map(lambda s: NamedSharding(m, s), specs, is_leaf=lambda x: isinstance(x, P))}
        restored, step = restore_checkpoint(ckpt_dir, {"params": params}, shardings=shardings)
        out[name] = (step, [shards(a) for a in jax.tree_util.tree_leaves(restored)])
    return out


def main(out_path, ckpt_dir):
    assert len(jax.devices()) == 8, jax.devices()
    res = {
        "placements": [index_map(mesh(shape, names), P(*spec), gshape) for shape, names, spec, gshape in PLACEMENTS],
        "rules": rule_maps(),
        "lookups": lookups(),
        "compressed_psum": compressed(),
        "restores": restores(ckpt_dir),
    }
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
