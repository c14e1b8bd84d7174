"""The port's decoder-only LM against the JAX package's, on the same weights.

The five LM archs run at their ``reduced()`` configs (the same code paths as
the full ones, tiny widths), plus gemma3 cut to 8 layers with an odd vocab
(one group of 6, 2 tail layers, padded logit columns). The port initialises
the parameters from a seeded CPU generator (JAX's eager ``init_lm`` compiles
op by op; its tree's structure is held to the port's through ``eval_shape``)
and both packages run the same weights. Inputs are numpy seeds. The prompt (29 tokens) is longer than the local layers'
window (16) and not a multiple of it, so the ring buffer wraps and rolls;
8 teacher-forced decode steps follow it.

Tolerance, float32: max abs error <= 1e-5 x max |reference| (matrix products
summed in another order). bf16: the port's relative error norm against JAX's
bf16 run within twice JAX's own bf16-vs-float32 gap, as
``tests/test_torch_encoder.py`` holds bf16 gradients. The JAX side is jitted
(its eager ``lax.scan`` compiles op by op); each case's JAX results are
computed once and shared.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.tree_utils import tree_cast as jax_tree_cast
from repro.configs import all_arch_names as jax_all_arch_names, get_arch as jax_get_arch
from repro.configs.base import LMCfg as JaxLMCfg, MoECfg as JaxMoECfg
from repro.models import attention as jattn
from repro.models import ffn as jffn
from repro.models import stacked as jstacked
from repro.models import transformer as jtf
from repro_torch.common.tree_utils import tree_cast, tree_leaves, tree_map
from repro_torch.configs.base import MoECfg, get_arch
from repro_torch.core.topk import stable_topk
from repro_torch.models import attention as attn
from repro_torch.models import ffn
from repro_torch.models import stacked
from repro_torch.models import transformer as tf
from repro_torch.models.convert import from_arrays, to_arrays

RTOL = 1e-5  # float32: max abs error <= RTOL * max |reference|
B, S_ALL, PROMPT, STEPS = 2, 40, 29, 8
LM_ARCHS = [n for n in jax_all_arch_names() if jax_get_arch(n).family == "lm"]
TAIL = "gemma3-27b+tail"
OVERRIDES = {TAIL: ("gemma3-27b", dict(n_layers=8, vocab=500))}
CASES = LM_ARCHS + [TAIL]


def _close(got, want, what, rtol=RTOL):
    got = (got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)).astype(np.float64)
    want = np.asarray(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, ref = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * ref, f"{what}: max abs error {err:.3g} > {rtol} x max |reference| {ref:.3g}"


def _rel_norm(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(case):
    name, over = OVERRIDES.get(case, (case, {}))
    jcfg = dataclasses.replace(jax_get_arch(name).reduced().lm, **over)
    cfg = dataclasses.replace(get_arch(name).reduced().lm, **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _tokens(seed, vocab):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S_ALL)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -100, np.int32)], axis=1)
    labels[0, :5] = -100  # ignored positions
    return toks, labels


def _jax_forward_all(flat, stk, toks, labels, cfg):
    return (jtf.lm_forward(flat, cfg, toks), jtf.lm_loss(flat, cfg, toks, labels),
            jstacked.lm_forward_stacked(stk, cfg, toks, remat=False),
            jstacked.lm_loss_stacked(stk, cfg, toks, labels, remat=False))


def _jax_serve(stk, jcfg, toks, dtype):
    """JAX's stacked prefill of the prompt and STEPS teacher-forced decode steps."""
    logits, st = jax.jit(functools.partial(jstacked.lm_prefill_stacked, cfg=jcfg, max_len=S_ALL,
                                           cache_dtype=dtype))(stk, tokens=jnp.asarray(toks[:, :PROMPT]))
    step = jax.jit(functools.partial(jstacked.lm_decode_step_stacked, cfg=jcfg))
    caches = _np(st)
    dec = []
    for i in range(PROMPT, PROMPT + STEPS):
        d, st = step(stk, token=jnp.asarray(toks[:, i:i + 1]), state=st)
        dec.append(np.asarray(d.astype(jnp.float32)))
    return np.asarray(logits.astype(jnp.float32)), caches, dec


@functools.lru_cache(maxsize=None)
def _case(case):
    """The case's configs, weights (JAX trees, port trees), inputs and JAX results."""
    jcfg, cfg = _cfgs(case)
    jp = _to_jax(to_arrays(tf.init_lm(cfg, torch.Generator().manual_seed(CASES.index(case)), device="cpu")))
    js = jstacked.stack_params(jp, jcfg)
    toks, labels = _tokens(CASES.index(case), jcfg.vocab)
    fwd = jax.jit(functools.partial(_jax_forward_all, cfg=jcfg))(jp, js, jnp.asarray(toks), jnp.asarray(labels))
    (logits, aux), (loss, metrics), (logits_s, aux_s), (loss_s, metrics_s) = _np(fwd)
    prefill, caches, dec = _jax_serve(js, jcfg, toks, jnp.float32)
    flat = from_arrays(_np(jp), "cpu")
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, js=js, flat=flat, stk=stacked.stack_params(flat, cfg), toks=toks,
                labels=labels, logits=logits, aux=aux, loss=loss, metrics=metrics, logits_s=logits_s,
                aux_s=aux_s, loss_s=loss_s, metrics_s=metrics_s, prefill=prefill, caches=caches, dec=dec)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ the arch registry and init
@pytest.mark.parametrize("case", CASES)
def test_init_and_stacking_have_jax_structure(case):
    c = _case(case)
    jcfg, cfg = c["jcfg"], c["cfg"]
    port = tf.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.eval_shape(functools.partial(jtf.init_lm, cfg=jcfg), jax.random.PRNGKey(0))
    want_s = jax.eval_shape(functools.partial(jstacked.stack_params, cfg=jcfg), want)
    for got, w in ((port, want), (stacked.stack_params(port, cfg), want_s)):
        assert jax.tree_util.tree_structure(_to_jax(to_arrays(got))) == jax.tree_util.tree_structure(w)
        assert [(tuple(x.shape), x.dtype) for x in tree_leaves(to_arrays(got))] == \
            [(x.shape, x.dtype) for x in jax.tree_util.tree_leaves(w)]
    assert stacked.group_period(cfg) == jstacked.group_period(c["jcfg"])
    # stacking the carried flat weights equals carrying JAX's stacked ones, to the bit
    for a, b in zip(tree_leaves(c["stk"]), tree_leaves(from_arrays(_np(c["js"]), "cpu"))):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ attention
def _qkv(seed, s=64, h=4, g=2, hd=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, s, h, hd)).astype(np.float32),
            rng.standard_normal((2, s, g, hd)).astype(np.float32),
            rng.standard_normal((2, s, g, hd)).astype(np.float32))


FLASH = dict(window=24, q_block=16, k_block=8)  # 4 q blocks, 8 KV blocks; chunks straddle blocks


@pytest.mark.parametrize("kind", ["full", "swa", "chunked"])
def test_flash_attention_equals_jax(kind):
    q, k, v = _qkv(1)
    want = jax.jit(functools.partial(jattn.flash_attention, kind=kind, **FLASH))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = attn.flash_attention(_t(q), _t(k), _t(v), kind, **FLASH)
    _close(got, want, f"flash_attention {kind}")


@pytest.mark.parametrize("kind", ["full", "swa", "chunked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_skipping_masked_blocks_changes_no_bit(kind, dtype, monkeypatch):
    q, k, v = (_t(a).to(dtype) for a in _qkv(2))
    live = []
    real = attn._block_live
    monkeypatch.setattr(attn, "_block_live", lambda *a: live.append(real(*a)) or live[-1])
    skipping = attn.flash_attention(q, k, v, kind, **FLASH)
    assert live.count(False) > 0  # the loop did skip blocks
    monkeypatch.setattr(attn, "_block_live", lambda *a: True)
    every = attn.flash_attention(q, k, v, kind, **FLASH)
    assert torch.equal(skipping, every)


def test_block_live_is_the_mask_having_an_allowed_pair():
    ar = np.arange(24)
    for kind in ("full", "swa", "chunked"):
        for window in (3, 4, 5):
            for q0 in range(12):
                for q1 in range(q0, q0 + 5):
                    for k0 in range(12):
                        for k1 in range(k0, k0 + 5):
                            qp, kp = ar[q0:q1 + 1, None], ar[None, k0:k1 + 1]
                            m = qp >= kp
                            if kind == "swa":
                                m &= qp - kp < window
                            elif kind == "chunked":
                                m &= qp // window == kp // window
                            assert attn._block_live(kind, q0, q1, k0, k1, window) == bool(m.any()), \
                                (kind, window, q0, q1, k0, k1)


@pytest.mark.parametrize("case", LM_ARCHS)
def test_attn_forward_equals_jax_for_every_layer_kind(case):
    c = _case(case)
    jcfg, cfg = c["jcfg"], c["cfg"]
    x = np.random.default_rng(3).standard_normal((B, S_ALL, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S_ALL), (B, S_ALL)).astype(np.int32)
    firsts = {}
    for i in range(cfg.n_layers):
        firsts.setdefault(attn.layer_kind(cfg, i), i)
    assert set(firsts) == {"full": {"full"}, "hybrid_swa": {"swa", "full"},
                           "hybrid_chunked": {"chunked", "nope_global"}}[cfg.attn_pattern]
    for kind, i in firsts.items():
        jp_attn = c["jp"].layers[i].attn
        want = jax.jit(functools.partial(jattn.attn_forward, cfg=jcfg, layer=i))(
            jp_attn, x=jnp.asarray(x), positions=jnp.asarray(pos))
        got = attn.attn_forward(c["flat"].layers[i].attn, cfg, i, _t(x), _t(pos))
        _close(got, want, f"attn_forward layer {i} ({kind})")


# ------------------------------------------------------------------ MoE
def _moe_case(name):
    """(JAX MoECfg, port MoECfg, JAX MoEParams, x) of a MoE check."""
    d = 16 if name == "groups" else 32
    mk = dict(binding=dict(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=0.5),
              groups=dict(n_experts=4, top_k=2, d_ff_expert=8, n_shared=1, capacity_factor=0.125),
              ties=dict(n_experts=4, top_k=2, d_ff_expert=32))[name]
    lm = dict(n_layers=1, d_model=d, n_heads=2, n_kv_heads=2, d_ff=32, vocab=64)
    jp = jffn.init_moe(jax.random.PRNGKey(7), JaxLMCfg(**lm, moe=JaxMoECfg(**mk)))
    if name == "ties":  # experts 0 and 1, and 2 and 3, get equal router probabilities
        r = np.asarray(jp.router).copy()
        r[:, 1], r[:, 3] = r[:, 0], r[:, 2]
        jp = jp._replace(router=jnp.asarray(r))
    shape = (1, 8192, d) if name == "groups" else (2, 24, d)
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    return JaxMoECfg(**mk), MoECfg(**mk), jp, x


@pytest.mark.parametrize("name", ["binding", "groups", "ties"])
def test_moe_ffn_equals_jax(name):
    jmoe, moe, jp, x = _moe_case(name)
    wy, waux = jax.jit(functools.partial(jffn.moe_ffn, cfg=jmoe))(jp, x=jnp.asarray(x))
    p = from_arrays(_np(jp), "cpu")
    assert type(p) is ffn.MoEParams and (p.shared is None) == (moe.n_shared == 0)
    y, aux = ffn.moe_ffn(p, moe, _t(x))
    _close(y, wy, f"moe_ffn {name}")
    _close(aux, waux, f"moe aux {name}")
    # what each case is there for
    s = min(x.shape[1], ffn.MOE_GROUP_TOKENS)
    cap = max(1, int(s * moe.top_k * moe.capacity_factor / moe.n_experts))
    xs = _t(x).reshape(-1, s, x.shape[2])
    probs = torch.softmax((xs @ p.router).float(), dim=-1)
    _, idx = stable_topk(probs, moe.top_k)
    per_expert = torch.nn.functional.one_hot(idx, moe.n_experts).sum(dim=(1, 2))  # [groups, E]
    if name == "binding":
        assert (per_expert > cap).any()  # choices are dropped
    if name == "groups":
        assert xs.shape[0] == 2 and (per_expert > cap).any()
    if name == "ties":
        assert torch.equal(probs[..., 0], probs[..., 1]) and torch.equal(probs[..., 2], probs[..., 3])
        # every token's top 2 is a tied pair, taken lower expert first (lax.top_k's order)
        pairs = (idx == torch.tensor([0, 1])).all(-1) | (idx == torch.tensor([2, 3])).all(-1)
        assert pairs.all() and (idx[..., 0] == 0).any() and (idx[..., 0] == 2).any()


# ------------------------------------------------------------------ forward and loss
@pytest.mark.parametrize("case", CASES)
def test_lm_forward_and_loss_flat_and_stacked_equal_jax(case):
    c = _case(case)
    cfg, toks, labels = c["cfg"], _t(c["toks"]), _t(c["labels"])
    logits, aux = tf.lm_forward(c["flat"], cfg, toks)
    assert logits.shape == (B, S_ALL, tf.padded_vocab(cfg))
    _close(logits, c["logits"], "lm_forward")
    _close(aux, c["aux"], "lm_forward aux")
    loss, metrics = tf.lm_loss(c["flat"], cfg, toks, labels)
    _close(loss, c["loss"], "lm_loss")
    for k in ("ce", "aux"):
        _close(metrics[k], c["metrics"][k], f"lm_loss {k}")
    logits_s, aux_s = stacked.lm_forward_stacked(c["stk"], cfg, toks)  # remat=True: each group checkpointed
    _close(logits_s, c["logits_s"], "lm_forward_stacked")
    loss_s, metrics_s = stacked.lm_loss_stacked(c["stk"], cfg, toks, labels, remat=False)
    _close(loss_s, c["loss_s"], "lm_loss_stacked")
    for k in ("ce", "aux"):
        _close(metrics_s[k], c["metrics_s"][k], f"lm_loss_stacked {k}")


def test_remat_forward_has_the_gradients_of_the_plain_one():
    c = _case("qwen3-4b")
    cfg, toks, labels = c["cfg"], _t(c["toks"]), _t(c["labels"])
    grads = []
    for remat in (False, True):
        p = tree_map(lambda x: x.clone().requires_grad_(), c["stk"])
        leaves = tree_leaves(p)
        loss, _ = stacked.lm_loss_stacked(p, cfg, toks, labels, remat=remat)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ prefill and decode
@pytest.mark.parametrize("case", CASES)
def test_prefill_stacked_caches_and_logits_equal_jax(case):
    c = _case(case)
    logits, st = stacked.lm_prefill_stacked(c["stk"], c["cfg"], _t(c["toks"][:, :PROMPT]), S_ALL, torch.float32)
    _close(logits, c["prefill"], "prefill logits")
    assert int(st.pos) == int(c["caches"].pos) == PROMPT
    want = jax.tree_util.tree_leaves((c["caches"].caches, c["caches"].tail_caches))
    got = tree_leaves((st.caches, st.tail_caches))
    period = stacked.group_period(c["cfg"])
    assert len(got) == len(want) == 2 * (period + c["cfg"].n_layers % period)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"prefill cache leaf {i}")


@pytest.mark.parametrize("case", CASES)
def test_decode_stacked_teacher_forced_equals_jax(case):
    c = _case(case)
    cfg = c["cfg"]
    _, st = stacked.lm_prefill_stacked(c["stk"], cfg, _t(c["toks"][:, :PROMPT]), S_ALL, torch.float32)
    for n, i in enumerate(range(PROMPT, PROMPT + STEPS)):
        logits, st = stacked.lm_decode_step_stacked(c["stk"], cfg, _t(c["toks"][:, i:i + 1]), st)
        _close(logits, c["dec"][n], f"decode step at {i}")
        if cfg.moe is None:  # MoE capacity drops differ between an S-token forward and a 1-token decode
            _close(logits[:, 0], c["logits"][:, i], f"decode step at {i} against the forward", rtol=1e-4)
    assert int(st.pos) == PROMPT + STEPS


@pytest.mark.parametrize("case", CASES)
def test_flat_prefill_then_decode_equals_jax_stacked_path(case):
    c = _case(case)
    cfg = c["cfg"]
    logits, st = tf.lm_prefill(c["flat"], cfg, _t(c["toks"][:, :PROMPT]), S_ALL, torch.float32)
    _close(logits, c["prefill"], "flat prefill logits")
    period = stacked.group_period(cfg)
    n0 = cfg.n_layers // period * period
    jst = c["caches"]
    for i, cache in enumerate(st.caches):
        want = jst.caches[i % period] if i < n0 else jst.tail_caches[i - n0]
        for g, w in zip(cache, want):
            _close(g, w[i // period] if i < n0 else w, f"flat prefill cache of layer {i}")
    for n, i in enumerate(range(PROMPT, PROMPT + STEPS)):
        logits, st = tf.lm_decode_step(c["flat"], cfg, _t(c["toks"][:, i:i + 1]), st)
        _close(logits, c["dec"][n], f"flat decode step at {i}")


def test_reference_flat_prefill_caches_cannot_decode():
    """The JAX ``lm_prefill`` builds [B, L, KV, hd] caches, which its own
    ``lm_decode_step`` (merged [B, L, KV*hd]) cannot read; the port's merged
    caches decode (the decode itself is held above)."""
    c = _case("qwen3-4b")
    jcfg, cfg = c["jcfg"], c["cfg"]
    toks = jnp.asarray(c["toks"][:, :PROMPT])
    _, jst = jax.jit(functools.partial(jtf.lm_prefill, cfg=jcfg, max_len=S_ALL, cache_dtype=jnp.float32))(
        c["jp"], tokens=toks)
    hd = jcfg.resolved_head_dim()
    assert jst.caches[0].k.shape == (B, S_ALL, jcfg.n_kv_heads, hd)
    with pytest.raises(ValueError, match="slice indices must match"):
        jtf.lm_decode_step(c["jp"], jcfg, toks[:, :1], jst)
    _, st = tf.lm_prefill(c["flat"], cfg, _t(c["toks"][:, :PROMPT]), S_ALL, torch.float32)
    assert st.caches[0].k.shape == (B, S_ALL, cfg.n_kv_heads * hd)
    logits, _ = tf.lm_decode_step(c["flat"], cfg, _t(c["toks"][:, PROMPT:PROMPT + 1]), st)
    assert torch.isfinite(logits).all()


def test_bf16_serving_within_twice_jax_bf16_gap():
    c = _case("qwen3-4b")
    cfg = c["cfg"]
    jprefill, _, jdec = _jax_serve(jax_tree_cast(c["js"], jnp.bfloat16), c["jcfg"], c["toks"], jnp.bfloat16)
    p = tree_cast(c["stk"], torch.bfloat16)
    logits, st = stacked.lm_prefill_stacked(p, cfg, _t(c["toks"][:, :PROMPT]), S_ALL, torch.bfloat16)
    assert logits.dtype == st.caches[0].k.dtype == torch.bfloat16
    got = [logits.float().numpy()]
    for i in range(PROMPT, PROMPT + STEPS):
        d, st = stacked.lm_decode_step_stacked(p, cfg, _t(c["toks"][:, i:i + 1]), st)
        got.append(d.float().numpy())
    for n, (g, w, w32) in enumerate(zip(got, [jprefill] + jdec, [c["prefill"]] + c["dec"])):
        err, gap = _rel_norm(g, w), _rel_norm(w, w32)
        assert err <= 2 * gap, f"output {n}: {err:.4f} from JAX's bf16 logits; JAX bf16 vs f32 {gap:.4f}"


# ------------------------------------------------------------------ converters
def _to_jax(tree):
    """The port's parameter NamedTuples (numpy leaves) as the JAX package's classes."""
    classes = {c.__name__: c for c in (jtf.LMParams, jstacked.StackedLMParams, jtf.LayerParams, jattn.AttnParams,
                                       jffn.DenseFFNParams, jffn.MoEParams)}
    if tree is None:
        return None
    if type(tree).__name__ in classes:
        return classes[type(tree).__name__](*(_to_jax(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_to_jax(v) for v in tree)
    return jnp.asarray(tree)


@pytest.mark.parametrize("case", ["phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b", TAIL])
@pytest.mark.parametrize("layout", ["flat", "stacked"])
def test_converters_round_trip_to_the_bit(case, layout):
    c = _case(case)
    jtree = c["jp"] if layout == "flat" else c["js"]
    port = from_arrays(_np(jtree), "cpu")
    assert type(port) is (tf.LMParams if layout == "flat" else stacked.StackedLMParams)
    back = _to_jax(to_arrays(port))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jtree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cast_dtype_forward_within_twice_jax_bf16_gap():
    """``lm_forward_stacked(cast_dtype=bf16)`` casts each group inside the loop:
    the bits of a forward over weights cast beforehand, and within twice JAX's
    own bf16-vs-float32 gap of JAX's cast forward."""
    c = _case("llama4-maverick-400b-a17b")  # MoE every second layer, a shared expert, chunked and NoPE layers
    cfg, toks = c["cfg"], _t(c["toks"])
    want, _ = jax.jit(functools.partial(jstacked.lm_forward_stacked, cfg=c["jcfg"], remat=False,
                                        cast_dtype=jnp.bfloat16))(c["js"], tokens=jnp.asarray(c["toks"]))
    want = np.asarray(want.astype(jnp.float32))
    got, _ = stacked.lm_forward_stacked(c["stk"], cfg, toks, remat=False, cast_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    pre, _ = stacked.lm_forward_stacked(tree_cast(c["stk"], torch.bfloat16), cfg, toks, remat=False)
    assert torch.equal(got, pre)
    err, gap = _rel_norm(got.float().numpy(), want), _rel_norm(want, c["logits_s"])
    assert err <= 2 * gap, f"{err:.4f} from JAX's cast forward; JAX bf16 vs f32 {gap:.4f}"
