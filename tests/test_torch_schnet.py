"""The port's SchNet against the JAX package's, on the same weights.

The ``reduced()`` schnet config (3 interactions, 16 hidden, 8 RBFs) and the
full one's RBF centres. The port initialises the parameters from a seeded CPU
generator and both packages run the same weights; inputs are numpy seeds; the
JAX side is jitted (``molecule_batch_forward`` is JAX's ``vmap``, the port's
one batched pass over B·N nodes).

Tolerance, float32: max abs error <= 1e-5 x max |reference| for every output
and gradient leaf (products and transcendental functions in another
implementation). The RBF centres are held to the bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import schnet as J
from repro_torch.common.tree_utils import tree_leaves
from repro_torch.configs.base import get_arch
from repro_torch.models import schnet as S
from repro_torch.models.convert import from_arrays, to_arrays

RTOL = 1e-5  # float32: max abs error <= RTOL * max |reference|
N_NODES, N_EDGES, D_FEAT, N_OUT = 40, 120, 12, 5
MOL_B, MOL_N, MOL_E, Z_DIM = 4, 9, 20, 16


def _close(got, want, what, rtol=RTOL):
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)).astype(np.float64)
    want = np.asarray(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, ref = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * ref, f"{what}: max abs error {err:.3g} > {rtol} x max |reference| {ref:.3g}"


def _to_jax(tree):
    classes = {c.__name__: c for c in (J.SchNetParams, J.InteractionParams)}
    if type(tree).__name__ in classes:
        return classes[type(tree).__name__](*(_to_jax(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_to_jax(v) for v in tree)
    return jnp.asarray(tree)


@functools.lru_cache(maxsize=None)
def _case(in_dim, out_dim, seed):
    jcfg, cfg = jax_get_arch("schnet").reduced().gnn, get_arch("schnet").reduced().gnn
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    p = S.init_schnet(cfg, in_dim, out_dim, torch.Generator().manual_seed(seed), device="cpu")
    return jcfg, cfg, p, _to_jax(to_arrays(p))


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N_NODES, D_FEAT)).astype(np.float32)
    es = rng.integers(0, N_NODES, N_EDGES).astype(np.int32)
    ed = rng.integers(0, N_NODES, N_EDGES).astype(np.int32)
    dist = (rng.random(N_EDGES) * 12.0).astype(np.float32)  # some past the 10.0 cutoff
    mask = rng.random(N_EDGES) < 0.8
    return x, es, ed, dist, mask


def _molecules(seed=0):
    rng = np.random.default_rng(seed)
    z = np.eye(Z_DIM, dtype=np.float32)[rng.integers(0, Z_DIM, (MOL_B, MOL_N))]
    pos = (rng.standard_normal((MOL_B, MOL_N, 3)) * 2.0).astype(np.float32)
    es = rng.integers(0, MOL_N, (MOL_B, MOL_E)).astype(np.int32)
    ed = rng.integers(0, MOL_N, (MOL_B, MOL_E)).astype(np.int32)
    mask = rng.random((MOL_B, MOL_E)) < 0.85
    return z, pos, es, ed, mask


def _grads(p, loss_fn):
    """Every leaf's gradient of ``loss_fn(p)`` through torch.autograd, and the loss."""
    leaves = tree_leaves(p)
    for x in leaves:
        x.requires_grad_(True)
    try:
        loss = loss_fn(p)
        return loss, torch.autograd.grad(loss, leaves)
    finally:
        for x in leaves:
            x.requires_grad_(False)


def _close_grads(grads, jgrads, what):
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves)
    for i, (g, jg) in enumerate(zip(grads, jleaves)):
        _close(g, jg, f"{what}: gradient of leaf {i}")


@pytest.mark.parametrize("cfg_name", ["full", "reduced"])
def test_rbf_centres_are_jnp_linspace_to_the_bit(cfg_name):
    jcfg = jax_get_arch("schnet").gnn if cfg_name == "full" else jax_get_arch("schnet").reduced().gnn
    cfg = get_arch("schnet").gnn if cfg_name == "full" else get_arch("schnet").reduced().gnn
    got = S.rbf_centers(cfg).numpy()
    want = np.asarray(jax.jit(lambda: jnp.linspace(0.0, jcfg.cutoff, jcfg.n_rbf))())
    assert got.dtype == np.float32 and np.array_equal(got, want)
    d = np.linspace(0.0, 11.0, 97).astype(np.float32)
    _close(S.rbf_expand(torch.from_numpy(d), cfg), jax.jit(lambda x: J.rbf_expand(x, jcfg))(d), "rbf_expand")
    _close(S.cosine_cutoff(torch.from_numpy(d), cfg.cutoff), jax.jit(lambda x: J.cosine_cutoff(x, jcfg.cutoff))(d),
           "cosine_cutoff")


def test_shifted_softplus_past_twenty():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)`` everywhere; ``F.softplus``'s
    linear switch above 20 would differ in the last bits there."""
    x = np.concatenate([np.linspace(-40, 40, 161), [-100.0, 20.5, 25.0, 88.0]]).astype(np.float32)
    got = S._ssp(torch.from_numpy(x))
    want = np.asarray(jax.jit(J._ssp)(x))
    _close(got, want, "_ssp")
    big = np.abs(x) > 20
    assert np.array_equal(got.numpy()[big], want[big])


def test_schnet_forward_with_edge_mask_and_its_gradients():
    jcfg, cfg, p, jp = _case(D_FEAT, N_OUT, 0)
    x, es, ed, dist, mask = _graph()
    t = [torch.from_numpy(a) for a in (x, es, ed, dist, mask)]
    got = S.schnet_forward(p, cfg, *t)
    jfwd = jax.jit(lambda pp, *a: J.schnet_forward(pp, jcfg, *a))
    _close(got, jfwd(jp, x, es, ed, dist, mask), "schnet_forward")
    _close(S.schnet_forward(p, cfg, *t[:4]), jfwd(jp, x, es, ed, dist, None), "schnet_forward without a mask")

    def port_loss(pp):
        return torch.sum(torch.square(S.schnet_readout(pp, S.schnet_forward(pp, cfg, *t))))

    def jax_loss(pp):
        return jnp.sum(jnp.square(J.schnet_readout(pp, J.schnet_forward(pp, jcfg, x, es, ed, dist, mask))))

    loss, grads = _grads(p, port_loss)
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(jp)
    _close(loss, jloss, "node-level loss")
    _close_grads(grads, jgrads, "schnet_forward")


@pytest.mark.parametrize("pooled", [False, True])
def test_schnet_readout(pooled):
    jcfg, cfg, p, jp = _case(D_FEAT, N_OUT, 0)
    rng = np.random.default_rng(5)
    h = rng.standard_normal((N_NODES, cfg.d_hidden)).astype(np.float32)
    if not pooled:
        _close(S.schnet_readout(p, torch.from_numpy(h)), jax.jit(J.schnet_readout)(jp, h), "node-level readout")
        return
    gids = rng.integers(0, 6, N_NODES).astype(np.int32)
    gids[:3] = [-1, 6, 9]  # dropped, as jax.ops.segment_sum drops them
    got = S.schnet_readout(p, torch.from_numpy(h), torch.from_numpy(gids), 6)
    want = jax.jit(lambda pp, a, g: J.schnet_readout(pp, a, g, 6))(jp, h, gids)
    _close(got, want, "pooled readout")


def test_molecule_batch_forward_against_jax_vmap_and_its_gradients():
    jcfg, cfg, p, jp = _case(Z_DIM, 1, 1)
    z, pos, es, ed, mask = _molecules()
    t = [torch.from_numpy(a) for a in (z, pos, es, ed, mask)]
    got = S.molecule_batch_forward(p, cfg, *t)
    jfwd = jax.jit(lambda pp, *a: J.molecule_batch_forward(pp, jcfg, *a))
    want = jfwd(jp, z, pos, es, ed, mask)
    assert got.shape == (MOL_B, 1)
    _close(got, want, "molecule_batch_forward")
    y = np.random.default_rng(2).standard_normal(MOL_B).astype(np.float32)

    def port_loss(pp):
        return torch.mean(torch.square(S.molecule_batch_forward(pp, cfg, *t)[:, 0] - torch.from_numpy(y)))

    def jax_loss(pp):
        return jnp.mean(jnp.square(J.molecule_batch_forward(pp, jcfg, z, pos, es, ed, mask)[:, 0] - y))

    loss, grads = _grads(p, port_loss)
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(jp)
    _close(loss, jloss, "energy MSE")
    _close_grads(grads, jgrads, "molecule_batch_forward")


def test_segment_sum_drops_out_of_range_ids():
    """``jax.ops.segment_sum`` of ones at ids [0, 1, 5, -1] into 3 segments is [1, 1, 0]."""
    ids = np.array([0, 1, 5, -1], np.int32)
    got = S.segment_sum(torch.ones(4), torch.from_numpy(ids), 3)
    want = np.asarray(jax.ops.segment_sum(jnp.ones(4), ids, num_segments=3))
    assert np.array_equal(got.numpy(), want) and np.array_equal(want, [1.0, 1.0, 0.0])


def test_out_of_range_edges_as_jax():
    """Sources wrap once and clamp, targets outside [0, N) are dropped: in
    ``schnet_forward`` over one graph and, within each graph, in the batch."""
    jcfg, cfg, p, jp = _case(D_FEAT, N_OUT, 0)
    x, es, ed, dist, mask = _graph(3)
    es[:4] = [-1, -N_NODES - 3, N_NODES, N_NODES + 50]
    ed[4:8] = [-1, -5, N_NODES, 10 ** 6]
    got = S.schnet_forward(p, cfg, *(torch.from_numpy(a) for a in (x, es, ed, dist, mask)))
    want = jax.jit(lambda pp, *a: J.schnet_forward(pp, jcfg, *a))(jp, x, es, ed, dist, mask)
    _close(got, want, "schnet_forward with out-of-range edges")

    jcfg, cfg, p, jp = _case(Z_DIM, 1, 1)
    z, pos, es, ed, mask = _molecules(4)
    es[0, :3] = [-1, MOL_N, -MOL_N - 2]  # each would reach another graph if offset first
    ed[1, :3] = [-1, MOL_N, MOL_N + 7]
    ed[2, 0] = -MOL_N
    got = S.molecule_batch_forward(p, cfg, *(torch.from_numpy(a) for a in (z, pos, es, ed, mask)))
    want = jax.jit(lambda pp, *a: J.molecule_batch_forward(pp, jcfg, *a))(jp, z, pos, es, ed, mask)
    _close(got, want, "molecule_batch_forward with out-of-range edges")


def test_params_carry_to_jax_to_the_bit():
    jcfg, cfg, p, jp = _case(D_FEAT, N_OUT, 0)
    back = from_arrays(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert type(back) is S.SchNetParams and type(back.interactions[0]) is S.InteractionParams
    assert isinstance(back.interactions, tuple) and len(back.interactions) == cfg.n_interactions
    for a, b in zip(tree_leaves(p), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    shapes = jax.eval_shape(functools.partial(J.init_schnet, cfg=jcfg, in_dim=D_FEAT, out_dim=N_OUT),
                            jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(jp)
    assert [tuple(s.shape) for s in jax.tree_util.tree_leaves(shapes)] == \
           [tuple(a.shape) for a in jax.tree_util.tree_leaves(jp)]
