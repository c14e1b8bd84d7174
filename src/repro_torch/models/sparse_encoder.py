"""SPLADE-style learned sparse encoder (Formal et al., the paper's LSR model family).

Bidirectional transformer encoder + MLM head; sparse doc/query representation via
  w_t = max_over_positions log(1 + relu(logit_t))
trained with in-batch contrastive loss + FLOPS regularizer (the standard SPLADE
recipe). Its output vectors feed ``repro_torch/index/builder.py`` to build LSP
indexes.

The functions take the parameters as an ``LMParams`` tree, so the trainer can
hand them low-precision copies; ``SparseEncoder`` is the same model as an
``nn.Module`` holding them. Each step is computed as the JAX package computes
it: the embedding scale in the embedding's dtype, RMS norms reduced in float32,
RoPE on the two halves in float32, scores and softmax in float32 with padding
keys at ``NEG_INF``, logits widened to float32 before ``log1p(relu)``, and the
max-pool as ``amax`` (whose gradient splits evenly among tied maxima, as JAX's
does). The token gather is ``F.embedding`` and the grouped-head repeat is an
``expand``: their gradients are sums without atomics, so a CUDA step is
deterministic.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.common import module as cm
from repro_torch.configs.base import LMCfg
from repro_torch.models import attention as attn
from repro_torch.models.transformer import (
    LayerParams, LMParams, embed_tokens, ffn_apply, init_lm, lm_head_logits, positions_of,
)


def encoder_forward(params: LMParams, cfg: LMCfg, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Bidirectional encode: tokens [B, S], mask [B, S] bool -> term weights [B, V] float32."""
    x = embed_tokens(params.embed, cfg, tokens)
    positions = positions_of(tokens)
    for i, lp in enumerate(params.layers):
        x = x + _bidir_attn(lp, cfg, cm.rms_norm(x, lp.norm1), positions, mask)
        y, _ = ffn_apply(lp, cfg, i, cm.rms_norm(x, lp.norm2))  # MoE or dense
        x = x + y
    logits = lm_head_logits(params, x)  # [B, S, V_pad] MLM logits
    w = torch.log1p(torch.relu(logits.float()))
    w = torch.where(mask[:, :, None], w, 0.0)
    return w.amax(dim=1)[:, : cfg.vocab]  # [B, V]


def _repeat_heads(x: torch.Tensor, rep: int) -> torch.Tensor:
    """``jnp.repeat(x, rep, axis=2)`` on [B, S, KV, hd]: each head ``rep`` times in a row."""
    b, s, kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, rep, hd).reshape(b, s, kv * rep, hd)


def _bidir_attn(lp: LayerParams, cfg: LMCfg, x, positions, mask):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim()
    p = lp.attn
    q = (x @ p.wq).reshape(b, s, cfg.n_heads, hd)
    k = (x @ p.wk).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ p.wv).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = cm.rms_norm(q, p.q_gamma)
        k = cm.rms_norm(k, p.k_gamma)
    q = attn.apply_rope(q, positions, cfg.rope_theta)
    k = attn.apply_rope(k, positions, cfg.rope_theta)
    rep = cfg.n_heads // cfg.n_kv_heads
    kr = _repeat_heads(k, rep)
    vr = _repeat_heads(v, rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kr).float() * hd**-0.5
    scores = torch.where(mask[:, None, None, :], scores, attn.NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, vr)
    return o.reshape(b, s, cfg.n_heads * hd) @ p.wo


class SpladeBatch(NamedTuple):
    q_tokens: torch.Tensor  # [B, Sq]
    q_mask: torch.Tensor
    d_tokens: torch.Tensor  # [B, Sd] positive doc per query
    d_mask: torch.Tensor


def splade_loss(params: LMParams, cfg: LMCfg, batch: SpladeBatch, flops_q: float = 3e-4, flops_d: float = 1e-4):
    """In-batch contrastive CE + FLOPS regularizer (SPLADE v2 objective)."""
    qv = encoder_forward(params, cfg, batch.q_tokens, batch.q_mask)  # [B, V]
    dv = encoder_forward(params, cfg, batch.d_tokens, batch.d_mask)
    scores = qv @ dv.T  # [B, B]
    logz = torch.logsumexp(scores, dim=-1)
    gold = torch.diagonal(scores)  # the label of row i is column i
    ce = torch.mean(logz - gold)
    # FLOPS reg: sum over vocab of squared mean activation
    fl_q = torch.sum(torch.square(torch.mean(qv, dim=0)))
    fl_d = torch.sum(torch.square(torch.mean(dv, dim=0)))
    loss = ce + flops_q * fl_q + flops_d * fl_d
    return loss, {"ce": ce, "flops_q": fl_q, "flops_d": fl_d}


def splade_100m_config(vocab: int = 32768) -> LMCfg:
    """~100M-parameter encoder for the end-to-end training example."""
    return LMCfg(
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=2048,
        vocab=vocab,
        head_dim=64,
        attn_pattern="full",
        tie_embeddings=True,
    )


init_encoder = init_lm


class _Params(nn.Module):
    """A NamedTuple of tensors held as parameters under its field names;
    ``tree()`` gives the NamedTuple back, its leaves the parameters themselves."""

    def __init__(self, tree):
        super().__init__()
        self._type = type(tree)
        self._kinds = {}
        for name, value in zip(tree._fields, tree):
            if value is None:
                self.register_parameter(name, None)
                self._kinds[name] = "none"
            elif isinstance(value, torch.Tensor):
                self.register_parameter(name, nn.Parameter(value, requires_grad=value.is_floating_point()))
                self._kinds[name] = "tensor"
            elif hasattr(value, "_fields"):
                setattr(self, name, _Params(value))
                self._kinds[name] = "tree"
            else:  # a tuple of trees (the layers)
                setattr(self, name, nn.ModuleList(_Params(v) for v in value))
                self._kinds[name] = "seq"

    def tree(self):
        def value(name, kind):
            v = getattr(self, name)
            if kind == "tree":
                return v.tree()
            if kind == "seq":
                return tuple(m.tree() for m in v)
            return v

        return self._type(*(value(n, k) for n, k in self._kinds.items()))


class SparseEncoder(_Params):
    """The encoder as a module: ``forward(tokens, mask)`` -> term weights [B, V].

    Its parameters are named as the JAX package's checkpoint keys name them
    (``embed``, ``layers.0.attn.wq``, ...), and ``params()`` returns them as
    the ``LMParams`` tree the functions above and the trainer take (the same
    tensors, not copies). Without ``params`` it is initialised from the CPU
    ``generator`` on ``device`` (CUDA by default)."""

    def __init__(self, cfg: LMCfg, params: Optional[LMParams] = None, generator=None, device=None):
        super().__init__(init_encoder(cfg, generator, device=device) if params is None else params)
        self.cfg = cfg

    def params(self) -> LMParams:
        return self.tree()

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return encoder_forward(self.params(), self.cfg, tokens, mask)
