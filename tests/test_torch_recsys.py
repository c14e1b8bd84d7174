"""The port's recsys models against the JAX package's, on the same weights.

dlrm-rm2, dlrm-mlperf, din and mind run at their ``reduced()`` configs (the
same code paths as the full ones, tiny widths). The port initialises the
parameters from a seeded CPU generator and both packages run the same weights
(``models/convert.py::to_arrays``, then JAX's classes by name); inputs are
numpy seeds; the JAX side is jitted.

Tolerance, float32: max abs error <= 1e-5 x max |reference| (matrix products
summed in another order), for every forward, loss and gradient leaf. Gathers
(the lookups, out-of-range ids included) are held to the bit. The routing
init's uniform bits equal JAX's; its normals are within 2 ulp of max(|x|, 1)
of JAX's (``common/jax_random.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import recsys as J
from repro_torch.common import jax_random
from repro_torch.common.module import take_rows
from repro_torch.common.tree_utils import tree_leaves
from repro_torch.configs.base import get_arch
from repro_torch.models import recsys as R
from repro_torch.models.convert import from_arrays, to_arrays

RTOL = 1e-5  # float32: max abs error <= RTOL * max |reference|
ARCHS = ["dlrm-rm2", "dlrm-mlperf", "din", "mind"]
B = 16
INIT = {"dlrm": R.init_dlrm, "din": R.init_din, "mind": R.init_mind}


def _close(got, want, what, rtol=RTOL):
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)).astype(np.float64)
    want = np.asarray(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, ref = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * ref, f"{what}: max abs error {err:.3g} > {rtol} x max |reference| {ref:.3g}"


def _to_jax(tree):
    """The port's NamedTuples (numpy leaves) as the JAX package's classes."""
    classes = {c.__name__: c for c in (J.EmbedTables, J.DLRMParams, J.DINParams, J.MINDParams)}
    if type(tree).__name__ in classes:
        return classes[type(tree).__name__](*(_to_jax(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_to_jax(v) for v in tree)
    return jnp.asarray(tree)


def _family(name):
    return "dlrm" if name.startswith("dlrm") else name


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX cfg, port cfg, port params, JAX params, batch of numpy inputs)."""
    jrc, rc = jax_get_arch(name).reduced().recsys, get_arch(name).reduced().recsys
    assert dataclasses.asdict(rc) == dataclasses.asdict(jrc)
    params = INIT[_family(name)](rc, torch.Generator().manual_seed(ARCHS.index(name)), device="cpu")
    rng = np.random.default_rng(ARCHS.index(name))
    vocab = np.asarray(rc.vocab_sizes)
    batch = {"labels": rng.integers(0, 2, B).astype(np.float32)}
    if name.startswith("dlrm"):
        batch["dense"] = rng.standard_normal((B, rc.n_dense)).astype(np.float32)
        batch["sparse_ids"] = rng.integers(0, vocab, (B, rc.n_sparse)).astype(np.int32)
    else:
        batch["target_ids"] = rng.integers(0, vocab, (B, rc.n_sparse)).astype(np.int32)
        batch["hist_ids"] = rng.integers(0, vocab, (B, rc.hist_len, rc.n_sparse)).astype(np.int32)
        lens = rng.integers(1, rc.hist_len + 1, B)
        lens[0] = 0  # a user with no history
        batch["hist_mask"] = np.arange(rc.hist_len)[None, :] < lens[:, None]
    return jrc, rc, params, _to_jax(to_arrays(params)), batch


def _port_fwd(name, rc, p, batch):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    if name.startswith("dlrm"):
        return R.dlrm_forward(p, rc, t["dense"], t["sparse_ids"])
    if name == "din":
        return R.din_forward(p, rc, t["target_ids"], t["hist_ids"], t["hist_mask"])
    return R.mind_interests(p, rc, t["hist_ids"], t["hist_mask"])


def _port_loss(name, rc, p, batch):
    if name != "mind":
        return R.bce_loss(_port_fwd(name, rc, p, batch), torch.from_numpy(batch["labels"]))
    te = R.mind_item_embedding(p, rc, torch.from_numpy(batch["target_ids"]))
    return R.sampled_softmax_loss(R.mind_user_vector(p, rc, _port_fwd(name, rc, p, batch), te), te)


def _jax_fns(name, jrc):
    if name.startswith("dlrm"):
        def fwd(p, b):
            return J.dlrm_forward(p, jrc, b["dense"], b["sparse_ids"])
    elif name == "din":
        def fwd(p, b):
            return J.din_forward(p, jrc, b["target_ids"], b["hist_ids"], b["hist_mask"])
    else:
        def fwd(p, b):
            return J.mind_interests(p, jrc, b["hist_ids"], b["hist_mask"])

    def loss(p, b):
        if name != "mind":
            return J.bce_loss(fwd(p, b), b["labels"])
        te = J.mind_item_embedding(p, jrc, b["target_ids"])
        return J.sampled_softmax_loss(J.mind_user_vector(p, jrc, fwd(p, b), te), te)

    return jax.jit(fwd), jax.jit(jax.value_and_grad(loss, allow_int=True))


@pytest.mark.parametrize("name", ARCHS)
def test_forward_loss_and_every_gradient_match_jax(name):
    jrc, rc, p, jp, batch = _case(name)
    jfwd, jgrad = _jax_fns(name, jrc)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _close(_port_fwd(name, rc, p, batch), jfwd(jp, jb), f"{name} forward")

    leaves = tree_leaves(p)
    floats = [x for x in leaves if x.is_floating_point()]
    for x in floats:
        x.requires_grad_(True)
    try:
        loss = _port_loss(name, rc, p, batch)
        grads = torch.autograd.grad(loss, floats, allow_unused=True)
    finally:
        for x in floats:
            x.requires_grad_(False)
    jloss, jgrads = jgrad(jp, jb)
    _close(loss, jloss, f"{name} loss")
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(leaves)
    it = iter(grads)
    n = 0
    for i, (x, jg) in enumerate(zip(leaves, jleaves)):
        if not x.is_floating_point():
            assert jg.dtype == jax.dtypes.float0  # the tables' int32 offsets
            continue
        g = next(it)
        g = torch.zeros_like(x) if g is None else g  # MIND's label_proj: used by no function
        if np.abs(np.asarray(jg)).max() == 0:
            assert float(g.abs().max()) == 0, f"{name} leaf {i}: JAX's gradient is zero"
        else:
            _close(g, jg, f"{name} gradient of leaf {i}")
        n += 1
    assert n == len(floats)


@pytest.mark.parametrize("name", ARCHS)
def test_params_carry_to_jax_to_the_bit(name):
    """convert.py both ways: the same classes, shapes, dtypes and bits; the
    offsets int32, the MLPs tuples; the tree JAX's own init builds."""
    jrc, rc, p, jp, _ = _case(name)
    back = from_arrays(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert type(back) is type(p) and isinstance(back.tables.offsets, torch.Tensor)
    assert back.tables.offsets.dtype == torch.int32
    for a, b in zip(tree_leaves(p), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    init = {"dlrm": J.init_dlrm, "din": J.init_din, "mind": J.init_mind}[_family(name)]
    shapes = jax.eval_shape(functools.partial(init, cfg=jrc), jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(jp)
    assert [(tuple(s.shape), s.dtype) for s in jax.tree_util.tree_leaves(shapes)] == \
           [(tuple(x.shape), x.dtype) for x in jax.tree_util.tree_leaves(jp)]
    assert p.tables.table.shape[0] % 512 == 0 and p.tables.table.shape[0] >= sum(rc.vocab_sizes)


def test_dlrm_pair_order_is_jax_triu():
    """dlrm-rm2's 27 features give 351 pairs, in jnp.triu_indices's order."""
    rc = get_arch("dlrm-rm2").recsys
    n = rc.n_sparse + 1
    iu, ju = torch.triu_indices(n, n, 1)
    jiu, jju = jnp.triu_indices(n, k=1)
    assert iu.numel() == 351 and rc.embed_dim + 351 == 415
    assert np.array_equal(iu.numpy(), np.asarray(jiu)) and np.array_equal(ju.numpy(), np.asarray(jju))


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_bag_lookup(reduce):
    _, rc, p, jp, _ = _case("din")
    rng = np.random.default_rng(7)
    ids = rng.integers(0, rc.vocab_sizes[1], (B, 12)).astype(np.int32)
    mask = rng.random((B, 12)) < 0.6
    mask[0] = False  # an empty bag
    got = R.bag_lookup(p.tables, 1, torch.from_numpy(ids), torch.from_numpy(mask), reduce)
    want = jax.jit(lambda t, i, m: J.bag_lookup(t, 1, i, m, reduce))(jp.tables, ids, mask)
    _close(got, want, f"bag_lookup {reduce}")


def test_seq_lookup_and_field_lookup_are_the_same_gathers():
    _, rc, p, jp, batch = _case("mind")
    got = R.seq_lookup(p.tables, torch.from_numpy(batch["hist_ids"]), (0, 1))
    want = jax.jit(lambda t, i: J.seq_lookup(t, i, (0, 1)))(jp.tables, batch["hist_ids"])
    assert np.array_equal(got.numpy(), np.asarray(want))
    got = R.field_lookup(p.tables, torch.from_numpy(batch["target_ids"]))
    assert np.array_equal(got.numpy(), np.asarray(jax.jit(J.field_lookup)(jp.tables, batch["target_ids"])))


def test_mind_score_candidates_and_item_embedding():
    jrc, rc, p, jp, batch = _case("mind")
    rng = np.random.default_rng(3)
    cand_ids = rng.integers(0, np.asarray(rc.vocab_sizes), (300, rc.n_sparse)).astype(np.int32)
    emb = R.mind_item_embedding(p, rc, torch.from_numpy(cand_ids))
    jemb = jax.jit(lambda pp, c: J.mind_item_embedding(pp, jrc, c))(jp, cand_ids)
    _close(emb, jemb, "mind_item_embedding")
    # a batched [B, n, F] id tensor keeps its leading shape
    emb3 = R.mind_item_embedding(p, rc, torch.from_numpy(cand_ids.reshape(3, 100, rc.n_sparse)))
    assert emb3.shape == (3, 100, rc.embed_dim) and torch.equal(emb3.reshape(300, -1), emb)
    ints = R.mind_interests(p, rc, torch.from_numpy(batch["hist_ids"]), torch.from_numpy(batch["hist_mask"]))
    got = R.mind_score_candidates(ints, emb)
    want = jax.jit(J.mind_score_candidates)(np.asarray(ints), np.asarray(emb))
    _close(got, want, "mind_score_candidates")


@pytest.mark.parametrize("shape", [(1, 50, 4), (3, 7), (64, 1000)])
def test_routing_init_draw_matches_jax_random(shape):
    """The uniform bits equal JAX's; the normals within 2 ulp of max(|x|, 1)
    (MIND's (1, 50, 4): all equal)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = jax_random.uniform(0, shape, float(lo))
    ju = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), shape, minval=lo))
    assert np.array_equal(u.view(np.uint32), ju.view(np.uint32))
    bits = np.asarray(jax.random.bits(jax.random.PRNGKey(0), shape))
    assert np.array_equal(jax_random.random_bits(0, shape), bits)
    n, jn = jax_random.normal(0, shape), np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape))
    assert n.dtype == np.float32 and n.shape == shape
    assert (np.abs(n - jn) <= 2 * np.spacing(np.maximum(np.abs(jn), np.float32(1.0)))).all()
    if shape == (1, 50, 4):
        assert np.array_equal(n, jn)


def test_out_of_range_rows_wrap_once_then_clamp():
    """JAX's ``t[[4, 5, 7, -1, -6]]`` on 5 rows reads rows 4, 4, 4, 4, 0."""
    t = np.arange(5 * 2, dtype=np.float32).reshape(5, 2)
    idx = np.array([4, 5, 7, -1, -6], np.int32)
    got = take_rows(torch.from_numpy(t), torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), np.asarray(jnp.asarray(t)[idx]))
    assert np.array_equal(got.numpy(), t[[4, 4, 4, 4, 0]])


def test_out_of_range_ids_through_every_lookup():
    """Negative ids, ids past their field (into the next field's rows) and past
    the table, through the lookups, DIN, and MIND's tower: as JAX, no raise."""
    jrc, rc, p, jp, batch = _case("din")
    rows = p.tables.table.shape[0]
    bad = np.array([-1, -7, rc.vocab_sizes[0] + 3, rows + 9, -rows - 40, 2 ** 30], np.int32)
    target = batch["target_ids"].copy()
    target[: len(bad), 0] = bad
    hist = batch["hist_ids"].copy()
    hist[0, : len(bad), 1] = bad
    hist[1, 0, :] = -rows - 1
    got = R.field_lookup(p.tables, torch.from_numpy(target))
    assert np.array_equal(got.numpy(), np.asarray(jax.jit(J.field_lookup)(jp.tables, target)))
    got = R.seq_lookup(p.tables, torch.from_numpy(hist), (0, 1, 2))
    assert np.array_equal(got.numpy(), np.asarray(jax.jit(lambda t, i: J.seq_lookup(t, i, (0, 1, 2)))(jp.tables,
                                                                                                        hist)))
    mask = np.ones(hist.shape[:2], bool)
    got = R.bag_lookup(p.tables, 2, torch.from_numpy(hist[:, :, 1]), torch.from_numpy(mask))
    _close(got, jax.jit(lambda t, i, m: J.bag_lookup(t, 2, i, m))(jp.tables, hist[:, :, 1], mask), "bag_lookup")
    got = R.din_forward(p, rc, torch.from_numpy(target), torch.from_numpy(hist), torch.from_numpy(mask))
    want = jax.jit(lambda pp, a, b, c: J.din_forward(pp, jrc, a, b, c))(jp, target, hist, mask)
    _close(got, want, "din_forward with out-of-range ids")
    mjrc, mrc, mp, mjp, _ = _case("mind")
    items = np.stack([bad, bad[::-1]], axis=1)
    got = R.mind_item_embedding(mp, mrc, torch.from_numpy(items))
    _close(got, jax.jit(lambda pp, c: J.mind_item_embedding(pp, mjrc, c))(mjp, items), "mind_item_embedding")


def test_initialisers_default_to_cuda():
    """With no device named, an initialiser runs on CUDA, or raises without a card."""
    rc = get_arch("mind").reduced().recsys
    if torch.cuda.is_available():
        assert R.init_mind(rc).s_bilinear.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            R.init_mind(rc)
