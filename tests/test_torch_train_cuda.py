"""The encoder, trainer and checkpoints on the card against the CPU port.

Marked ``cuda``: they skip where there is no CUDA device. This file imports
neither JAX nor the JAX package, so it runs on a GPU machine without JAX:
``PYTHONPATH=src python -m pytest -q tests/test_torch_train_cuda.py``.
tests/test_torch_encoder.py and tests/test_torch_train.py hold the CPU port to
the JAX package at the same tiny config. Matrix products run in full float32
on both devices (TF32 off); sums run in another order, so rtol 1e-4, atol 1e-6.
"""

import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import restore_checkpoint
from repro_torch.common.tree_utils import flatten_with_paths, global_norm, tree_map
from repro_torch.configs.base import LMCfg
from repro_torch.data.pipeline import CounterPipeline, PipelineConfig, splade_synthetic_batch
from repro_torch.models.sparse_encoder import SpladeBatch, encoder_forward, init_encoder, splade_loss
from repro_torch.optim import AdamW
from repro_torch.train.trainer import Trainer, TrainerConfig

CFG = LMCfg(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=300, head_dim=8, tie_embeddings=True)
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _loss(params, b):
    return splade_loss(params, CFG, SpladeBatch(b["q_tokens"], b["q_mask"], b["d_tokens"], b["d_mask"]))


def _batch(device):
    b = CounterPipeline(PipelineConfig(global_batch=8), splade_synthetic_batch(CFG.vocab, 8, 8, 12)).batch_at(0)
    b["q_mask"][:3, -2:] = False  # padded rows
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _params(device):
    return init_encoder(CFG, torch.Generator().manual_seed(0), device=device)


def _loss_and_grads(device):
    params = tree_map(lambda x: x.requires_grad_(), _params(device))
    loss, metrics = _loss(params, _batch(device))
    grads = torch.autograd.grad(loss, list(flatten_with_paths(params).values()))
    return loss.detach(), metrics, dict(zip(flatten_with_paths(params), grads))


def _trainer(device, ckpt_dir=""):
    return Trainer(_loss, AdamW(lr=1e-3, warmup_steps=2, total_steps=50),
                   TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=3, compute_dtype=torch.float32),
                   lambda: _params(device))


def _pipe():
    return CounterPipeline(PipelineConfig(global_batch=8), splade_synthetic_batch(CFG.vocab, 8, 8, 12))


@pytest.mark.cuda
def test_forward_loss_and_gradients_on_the_card_equal_the_cpu(cuda):
    b = _batch(cuda)
    p = _params(cuda)
    got = encoder_forward(p, CFG, b["d_tokens"], b["d_mask"])
    want = encoder_forward(_params("cpu"), CFG, b["d_tokens"].cpu(), b["d_mask"].cpu())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)
    loss, metrics, grads = _loss_and_grads(cuda)
    want_loss, want_metrics, want_grads = _loss_and_grads(torch.device("cpu"))
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(want_metrics[k]), **TOL, err_msg=k)
    for k, g in grads.items():
        np.testing.assert_allclose(g.cpu().numpy(), want_grads[k].numpy(), **TOL, err_msg=k)


@pytest.mark.cuda
def test_three_trainer_steps_and_a_card_checkpoint_restored_on_the_cpu(cuda, tmp_path):
    t = _trainer(cuda, str(tmp_path))
    got = t.run(t.init_or_restore(), _pipe(), 3, log_every=0)
    cpu = _trainer(torch.device("cpu"))
    want = cpu.run(cpu.init_or_restore(), _pipe(), 3, log_every=0)
    flat_got = {k: v.cpu().numpy() for k, v in flatten_with_paths(got).items()}
    for k, v in flatten_with_paths(want).items():
        np.testing.assert_allclose(flat_got[k], v.numpy(), **TOL, err_msg=k)
    restored, step = restore_checkpoint(str(tmp_path), want)  # the card's step-3 checkpoint into CPU leaves
    assert step == 3
    for k, v in flatten_with_paths(restored).items():
        assert v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), flat_got[k], err_msg=k)


@pytest.mark.cuda
def test_a_card_step_is_deterministic_under_deterministic_algorithms(cuda, monkeypatch):
    """No op of the step is one PyTorch flags as nondeterministic on CUDA, and
    two runs give the same bits."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for _ in range(2):
            t = _trainer(cuda)
            state = t.run(t.init_or_restore(), _pipe(), 2, log_every=0)
            runs.append({k: v.cpu() for k, v in flatten_with_paths(state).items()})
    finally:
        torch.use_deterministic_algorithms(False)
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k
    assert float(global_norm(runs[0])) > 0


# ------------------------------------------------------------------ Adafactor and the LM step
def _lm_cfg():
    from repro_torch.configs.base import get_arch

    return get_arch("phi3.5-moe-42b-a6.6b").reduced().lm  # MoE routing and the capacity cut under remat


@pytest.mark.cuda
def test_adafactor_on_the_card_equals_the_cpu(cuda):
    from repro_torch.optim import Adafactor

    rng = np.random.default_rng(0)
    shapes = {"s": (), "b": (7,), "w": (33, 17), "stacked": (3, 40, 24)}
    params = {k: np.asarray(rng.standard_normal(s), np.float32) for k, s in shapes.items()}
    grads = [{k: np.asarray(rng.standard_normal(s) * scale, np.float32) for k, s in shapes.items()}
             for scale in (0.1, 30.0, 1.0)]
    out = []
    for dev in (cuda, torch.device("cpu")):
        opt = Adafactor(lr=1e-2)
        p = {k: torch.from_numpy(v.copy()).to(dev) for k, v in params.items()}
        state = opt.init(p)
        for g in grads:
            p, state, _ = opt.update({k: torch.from_numpy(v).to(dev) for k, v in g.items()}, state, p)
        assert state.step.device.type == dev.type
        out.append({k: v.cpu().numpy() for k, v in flatten_with_paths((p, state)).items()})
    for k, v in out[1].items():
        np.testing.assert_allclose(out[0][k], v, rtol=1e-5, atol=1e-7, err_msg=k)


def _lm_loss_and_grads(device, remat):
    from repro_torch.models.stacked import init_lm_stacked, lm_loss_stacked
    from repro_torch.data.pipeline import lm_synthetic_batch

    cfg = _lm_cfg()
    params = tree_map(lambda x: x.to(device).requires_grad_(),
                      init_lm_stacked(cfg, torch.Generator().manual_seed(0), device="cpu"))
    b = lm_synthetic_batch(cfg.vocab, 4, 32)(np.random.default_rng(0), 0)
    loss, _ = lm_loss_stacked(params, cfg, torch.from_numpy(b["tokens"]).to(device),
                              torch.from_numpy(b["labels"]).to(device), remat=remat)
    grads = torch.autograd.grad(loss, list(flatten_with_paths(params).values()))
    return float(loss.detach()), dict(zip(flatten_with_paths(params), (g.cpu() for g in grads)))


@pytest.mark.cuda
def test_lm_gradients_through_remat_on_the_card_equal_the_cpu(cuda, monkeypatch):
    """The stacked MoE LM's loss and gradients through remat: on the card
    against the CPU, and under deterministic algorithms, to the bit against
    the card's own pass without remat (the recomputation repeats the
    forward's routing exactly)."""
    want_loss, want = _lm_loss_and_grads(torch.device("cpu"), remat=True)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        loss, got = _lm_loss_and_grads(cuda, remat=True)
        plain_loss, plain = _lm_loss_and_grads(cuda, remat=False)
    finally:
        torch.use_deterministic_algorithms(False)
    np.testing.assert_allclose(loss, want_loss, **TOL)
    assert loss == plain_loss
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), **TOL, err_msg=k)
        assert torch.equal(g, plain[k]), k
