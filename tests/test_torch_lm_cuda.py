"""The decoder-only LM on the card against the CPU port, at the reduced configs.

Marked ``cuda``: they skip where there is no CUDA device. This file imports
neither JAX nor the JAX package, so it runs on a GPU machine without JAX:
``PYTHONPATH=src python -m pytest -q tests/test_torch_lm_cuda.py``.
tests/test_torch_lm.py holds the CPU port to the JAX package at the same
configs. Matrix products run in full float32 on both devices (TF32 off); sums
run in another order, so max abs error <= 1e-4 x max |reference|, the bound
of the reference's own decode-against-forward check.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.common.tree_utils import tree_leaves, tree_map
from repro_torch.configs.base import MoECfg, all_arch_names, get_arch
from repro_torch.models import attention as attn
from repro_torch.models import ffn, stacked

pytestmark = pytest.mark.cuda

RTOL = 1e-4
LM_ARCHS = [n for n in all_arch_names() if get_arch(n).family == "lm"]
B, S_ALL, PROMPT = 2, 40, 29


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, what, rtol=RTOL):
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape, what
    err, ref = float((got - want).abs().max()), float(want.abs().max())
    assert err <= rtol * ref, f"{what}: max abs error {err:.3g} > {rtol} x max |reference| {ref:.3g}"


def _tokens(vocab, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, vocab, (B, S_ALL)))


@pytest.mark.parametrize("name", LM_ARCHS)
def test_card_equals_cpu_forward_prefill_and_decode(name, cuda):
    cfg = get_arch(name).reduced().lm
    cpu = stacked.init_lm_stacked(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = tree_map(lambda x: x.to(cuda), cpu)
    toks = _tokens(cfg.vocab)
    runs = {}
    for dev, p in (("cpu", cpu), ("cuda", card)):
        t = toks.to(dev)
        logits, _ = stacked.lm_forward_stacked(p, cfg, t, remat=False)
        pre, st = stacked.lm_prefill_stacked(p, cfg, t[:, :PROMPT], S_ALL, torch.float32)
        dec = []
        for i in range(PROMPT, S_ALL):
            d, st = stacked.lm_decode_step_stacked(p, cfg, t[:, i:i + 1], st)
            dec.append(d[:, 0])
        runs[dev] = (logits, pre, torch.stack(dec, 1))
        if cfg.moe is None:  # MoE capacity drops differ between an S-token forward and a 1-token decode
            _close(runs[dev][2], logits[:, PROMPT:], f"{dev}: decode against the forward")
    for what, g, w in zip(("forward", "prefill", "decode"), runs["cuda"], runs["cpu"]):
        _close(g, w, f"{what} card vs CPU")


@pytest.mark.parametrize("kind", ["full", "swa", "chunked"])
def test_flash_attention_card_equals_cpu_and_skipping_changes_no_bit(kind, cuda, monkeypatch):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 64, n, 8, generator=g) for n in (4, 2, 2))
    kw = dict(window=24, q_block=16, k_block=8)
    want = attn.flash_attention(q, k, v, kind, **kw)
    got = attn.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), kind, **kw)
    _close(got, want, f"flash_attention {kind}")
    monkeypatch.setattr(attn, "_block_live", lambda *a: True)
    assert torch.equal(attn.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), kind, **kw), got)


def test_moe_with_binding_capacity_card_equals_cpu(cuda):
    cfg = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b").reduced().lm,
                              moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=64, capacity_factor=0.5))
    p = ffn.init_moe(cfg, torch.Generator().manual_seed(2), device="cpu")
    x = torch.randn(2, 48, cfg.d_model, generator=torch.Generator().manual_seed(3))
    y, aux = ffn.moe_ffn(p, cfg.moe, x)
    yc, auxc = ffn.moe_ffn(tree_map(lambda t: t.to(cuda), p), cfg.moe, x.to(cuda))
    _close(yc, y, "moe_ffn")
    _close(auxc, aux, "moe aux")


def test_cuda_generator_draws_on_the_card(cuda):
    cfg = get_arch("qwen3-4b").reduced().lm
    a = stacked.init_lm_stacked(cfg, torch.Generator(device=cuda).manual_seed(0))
    b = stacked.init_lm_stacked(cfg, torch.Generator(device=cuda).manual_seed(0))
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.device.type == "cuda" and torch.equal(x, y)
    w = a.embed  # std 0.02, truncated at 2 std
    assert float(w.abs().max()) <= 0.04 and abs(float(w.std()) - 0.0176) < 0.002
