"""The port's SPLADE encoder against the JAX package's, on the same weights.

JAX initialises the parameters; ``repro_torch.models.convert`` carries them into
the port. Inputs are numpy seeds, with padded rows. Tolerances: forward and loss
rtol 1e-5, atol 1e-6 (float32 matrix products summed in another order);
gradients rtol 1e-4, atol 1e-6 (the backward adds those differences up again).
The bf16-compute path: the loss within rtol 2e-2 of JAX's bf16 loss. Its
gradients cannot be held element by element: bfloat16 keeps 8 bits, the two
frameworks round products and sums at other places, and at this config JAX's
own bf16 gradients lie several percent (relative Frobenius norm, per leaf)
from its float32 ones. So each leaf of the port's bf16 gradient must lie
within twice that distance of JAX's bf16 gradient, and within 15% of it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.module import rms_norm as jax_rms_norm
from repro.common.tree_utils import tree_cast as jax_tree_cast
from repro.configs.base import LMCfg as JaxLMCfg, MoECfg as JaxMoECfg
from repro.models.attention import AttnParams as JaxAttnParams, apply_rope as jax_apply_rope
from repro.models.attention import init_attn as jax_init_attn
from repro.models.ffn import DenseFFNParams as JaxDenseFFNParams
from repro.models.sparse_encoder import SpladeBatch as JaxSpladeBatch
from repro.models.sparse_encoder import encoder_forward as jax_encoder_forward
from repro.models.sparse_encoder import init_encoder as jax_init_encoder
from repro.models.sparse_encoder import splade_loss as jax_splade_loss
from repro.models.transformer import LayerParams as JaxLayerParams, LMParams as JaxLMParams
from repro_torch.common.module import rms_norm
from repro_torch.common.tree_utils import flatten_with_paths, tree_cast
from repro_torch.configs.base import LMCfg, MoECfg
from repro_torch.models.attention import apply_rope, init_attn
from repro_torch.models.convert import from_arrays, to_arrays
from repro_torch.models.sparse_encoder import (
    SparseEncoder, SpladeBatch, encoder_forward, init_encoder, splade_100m_config, splade_loss,
)
from repro_torch.models.transformer import padded_vocab

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
BF16_RTOL = 2e-2
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64, vocab=256, head_dim=16, tie_embeddings=True)
CONFIGS = {
    "tiny": TINY,
    "padded_vocab": {**TINY, "vocab": 300},
    "qk_norm": {**TINY, "qk_norm": True},
    "grouped_heads": {**TINY, "n_heads": 4, "n_kv_heads": 2, "head_dim": 8},
}


def _cfgs(name):
    kw = CONFIGS[name]
    return JaxLMCfg(**kw), LMCfg(**kw)


def _jax_params(jcfg, seed=0):
    return jax_init_encoder(jax.random.PRNGKey(seed), jcfg)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_jax(p):
    """The port's LMParams of numpy leaves as the JAX package's classes."""
    layers = tuple(JaxLayerParams(attn=JaxAttnParams(*map(_jnp, lp.attn)), ffn=JaxDenseFFNParams(*map(_jnp, lp.ffn)),
                                  norm1=_jnp(lp.norm1), norm2=_jnp(lp.norm2)) for lp in p.layers)
    return JaxLMParams(_jnp(p.embed), layers, _jnp(p.final_norm), _jnp(p.lm_head))


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _tokens(seed, b, s, vocab, pad_rows=2):
    """tokens [b, s] and a mask whose first ``pad_rows`` rows end in padding."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), bool)
    for i in range(pad_rows):
        mask[i, s - 1 - 2 * i:] = False
    return tokens, mask


def _batch(seed, vocab, b=6):
    qt, qm = _tokens(seed, b, 7, vocab)
    dt, dm = _tokens(seed + 1, b, 11, vocab, pad_rows=3)
    return qt, qm, dt, dm


def _port_batch(arrs):
    return SpladeBatch(*(torch.from_numpy(a) for a in arrs))


def test_rms_norm_and_rope_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(rms_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
                               np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(g))), **TOL)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = rms_norm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(g))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jax_rms_norm(xb, jnp.asarray(g)).astype(jnp.float32)),
                               rtol=BF16_RTOL, atol=BF16_RTOL)
    pos = np.broadcast_to(np.arange(5) * 3, (3, 5)).astype(np.int32)
    for theta in (10000.0, 500.0):
        np.testing.assert_allclose(apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy(),
                                   np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)), **TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_attn_shapes_equal_jax(name):
    jcfg, cfg = _cfgs(name)
    want = jax_init_attn(jax.random.PRNGKey(0), jcfg)
    got = init_attn(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encoder_forward_equals_jax(name):
    jcfg, cfg = _cfgs(name)
    jp = _jax_params(jcfg)
    params = from_arrays(_np(jp), "cpu")
    assert params.embed.shape[0] == padded_vocab(cfg) == (512 if cfg.vocab == 300 else 256)
    tokens, mask = _tokens(3, 5, 9, cfg.vocab)
    want = np.asarray(jax_encoder_forward(jp, jcfg, jnp.asarray(tokens), jnp.asarray(mask)))
    got = encoder_forward(params, cfg, torch.from_numpy(tokens), torch.from_numpy(mask))
    assert got.shape == (5, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    module = SparseEncoder(cfg, params)
    np.testing.assert_array_equal(module(torch.from_numpy(tokens), torch.from_numpy(mask)).detach().numpy(),
                                  got.numpy())


def _jax_loss_and_grads(jp, jcfg, arrs, dtype=jnp.float32):
    lowp = jax_tree_cast(jp, dtype)
    fn = lambda p: jax_splade_loss(p, jcfg, JaxSpladeBatch(*map(jnp.asarray, arrs)))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(lowp)
    return loss, metrics, jax_tree_cast(grads, jnp.float32)


def _port_loss_and_grads(params, cfg, arrs, dtype=torch.float32):
    lowp = tree_cast(params, dtype)
    flat = flatten_with_paths(lowp)
    for t in flat.values():
        t.requires_grad_()
    loss, metrics = splade_loss(lowp, cfg, _port_batch(arrs))
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {k: g.float() for k, g in zip(flat, grads)}


@pytest.mark.parametrize("name", ["tiny", "grouped_heads"])
def test_splade_loss_metrics_and_gradients_equal_jax(name):
    jcfg, cfg = _cfgs(name)
    jp = _jax_params(jcfg, seed=1)
    arrs = _batch(5, cfg.vocab)
    jloss, jmetrics, jgrads = _jax_loss_and_grads(jp, jcfg, arrs)
    loss, metrics, grads = _port_loss_and_grads(from_arrays(_np(jp), "cpu"), cfg, arrs)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    assert set(metrics) == set(jmetrics) == {"ce", "flops_q", "flops_d"}
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), **TOL, err_msg=k)
    want = {k: np.asarray(v) for k, v in flatten_with_paths(_to_jax_paths(jgrads)).items()}
    assert set(grads) == set(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], **GRAD_TOL, err_msg=k)


def _to_jax_paths(jtree):
    """A JAX LMParams pytree as the port's NamedTuples, so one flatten names both."""
    return from_arrays(_np(jtree), "cpu")


def test_bf16_compute_loss_and_gradients_equal_jax():
    jcfg, cfg = _cfgs("tiny")
    jp = _jax_params(jcfg, seed=2)
    arrs = _batch(7, cfg.vocab)
    jloss, _, jgrads = _jax_loss_and_grads(jp, jcfg, arrs, jnp.bfloat16)
    _, _, jgrads32 = _jax_loss_and_grads(jp, jcfg, arrs)
    loss, _, grads = _port_loss_and_grads(from_arrays(_np(jp), "cpu"), cfg, arrs, torch.bfloat16)
    assert loss.dtype == torch.float32  # the term weights are widened to float32 before the pool
    np.testing.assert_allclose(float(loss), float(jloss), rtol=BF16_RTOL)
    want = {k: np.asarray(v) for k, v in flatten_with_paths(_to_jax_paths(jgrads)).items()}
    want32 = {k: np.asarray(v) for k, v in flatten_with_paths(_to_jax_paths(jgrads32)).items()}
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    for k, g in grads.items():
        err, bf16_err = rel(g.numpy(), want[k]), rel(want[k], want32[k])
        assert err <= min(2 * bf16_err, 0.15), f"{k}: {err:.4f} from JAX's bf16 gradient; JAX bf16 vs f32 {bf16_err:.4f}"


@pytest.mark.parametrize("every_n", [1, 2])
def test_moe_encoder_forward_equals_jax(every_n):
    """MoE feed-forwards (phi3.5's every layer; llama4's every second, with a
    shared expert), a capacity that drops choices at this length."""
    moe = dict(n_experts=4, top_k=2 if every_n == 1 else 1, d_ff_expert=32, n_shared=every_n - 1,
               capacity_factor=0.5, every_n=every_n)
    kw = {**TINY, "n_layers": 2, "tie_embeddings": every_n == 1}
    jcfg, cfg = JaxLMCfg(**kw, moe=JaxMoECfg(**moe)), LMCfg(**kw, moe=MoECfg(**moe))
    jp = _jax_params(jcfg, seed=6)
    params = from_arrays(_np(jp), "cpu")
    assert type(params.layers[every_n - 1].ffn).__name__ == "MoEParams"
    tokens, mask = _tokens(4, 5, 12, cfg.vocab)
    want = np.asarray(jax.jit(jax_encoder_forward, static_argnums=1)(jp, jcfg, jnp.asarray(tokens),
                                                                     jnp.asarray(mask)))
    got = SparseEncoder(cfg, params)(torch.from_numpy(tokens), torch.from_numpy(mask)).detach()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    again = init_encoder(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(_np(jp))] == \
        [tuple(x.shape) for x in flatten_with_paths(again).values()]


@pytest.mark.parametrize("name", ["tiny", "qk_norm"])
def test_converter_round_trips_to_the_bit(name):
    jcfg, cfg = _cfgs(name)
    jp = _jax_params(jcfg, seed=4)
    module = SparseEncoder(cfg, from_arrays(_np(jp), "cpu"))
    back = _to_jax(to_arrays(module.params()))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jp)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    names = [n.replace(".", "/") for n, _ in module.named_parameters()]
    assert sorted(names) == sorted(flatten_with_paths(to_arrays(module.params())))


def test_port_initialiser_bounds_and_std():
    cfg = dataclasses.replace(splade_100m_config(vocab=1000), n_layers=1, d_model=256, n_heads=4, d_ff=512)
    params = init_encoder(cfg, torch.Generator().manual_seed(0), device="cpu")
    again = init_encoder(cfg, torch.Generator().manual_seed(0), device="cpu")
    other = init_encoder(cfg, torch.Generator().manual_seed(1), device="cpu")
    want = jax.eval_shape(lambda: _jax_params(JaxLMCfg(**dataclasses.asdict(cfg))))
    got = _to_jax(to_arrays(params))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert [a.shape for a in jax.tree_util.tree_leaves(got)] == [a.shape for a in jax.tree_util.tree_leaves(want)]
    # a standard normal truncated at ±2 has standard deviation 0.8796
    trunc_std = 0.879596
    lp = params.layers[0]
    for w, std in [(params.embed, 0.02), (lp.attn.wq, 256**-0.5), (lp.ffn.w_down, 512**-0.5)]:
        assert float(w.abs().max()) <= 2 * std * (1 + 1e-6)
        assert float(w.abs().max()) > 1.9 * std
        np.testing.assert_allclose(float(w.std()), trunc_std * std, rtol=0.02)
        assert abs(float(w.mean())) < 0.01 * std
    assert (lp.norm1 == 1).all() and (params.final_norm == 1).all() and params.lm_head is None
    assert all(torch.equal(a, b) for a, b in zip(flatten_with_paths(params).values(),
                                                 flatten_with_paths(again).values()))
    assert not torch.equal(params.embed, other.embed)
