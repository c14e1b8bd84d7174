"""The recsys models and SchNet on the card against the CPU port, at the
reduced configs, and MIND's retrieval through the dense LSP kernel.

Marked ``cuda``: they skip where there is no CUDA device. This file imports
neither JAX nor the JAX package, so it runs on a GPU machine without JAX:
``PYTHONPATH=src python -m pytest -q tests/test_torch_recsys_cuda.py``.
tests/test_torch_recsys.py and tests/test_torch_schnet.py hold the CPU port
to the JAX package. Matrix products run in full float32 on both devices (TF32
off); sums run in another order, and SchNet's segment sums use atomics on the
card, so max abs error <= 1e-4 x max |reference|.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.common.tree_utils import tree_leaves, tree_map
from repro_torch.configs.base import get_arch
from repro_torch.core import ops
from repro_torch.core.config import DynamicParams, StaticConfig, combine
from repro_torch.core.lsp_dense import DenseIndexConfig, build_dense_index, retrieve_dense
from repro_torch.eval.metrics import recall_vs_oracle
from repro_torch.models import recsys as R
from repro_torch.models import schnet as S

pytestmark = pytest.mark.cuda

RTOL = 1e-4
ARCHS = ["dlrm-rm2", "dlrm-mlperf", "din", "mind"]
B = 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, what, rtol=RTOL):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    assert got.shape == want.shape, what
    err, ref = float((got - want).abs().max()), float(want.abs().max())
    assert err <= rtol * ref, f"{what}: max abs error {err:.3g} > {rtol} x max |reference| {ref:.3g}"


def _batch(name, rc, seed):
    rng = np.random.default_rng(seed)
    vocab = np.asarray(rc.vocab_sizes)
    out = {"labels": rng.integers(0, 2, B).astype(np.float32)}
    if name.startswith("dlrm"):
        out["dense"] = rng.standard_normal((B, rc.n_dense)).astype(np.float32)
        out["sparse_ids"] = rng.integers(0, vocab, (B, rc.n_sparse)).astype(np.int32)
        out["sparse_ids"][0, :3] = [-1, 10 ** 6, -10 ** 6]  # wrapped and clamped, as in JAX; no device assert
    else:
        out["target_ids"] = rng.integers(0, vocab, (B, rc.n_sparse)).astype(np.int32)
        out["hist_ids"] = rng.integers(0, vocab, (B, rc.hist_len, rc.n_sparse)).astype(np.int32)
        out["hist_ids"][0, 0, :] = -1
        lens = rng.integers(0, rc.hist_len + 1, B)
        out["hist_mask"] = np.arange(rc.hist_len)[None, :] < lens[:, None]
    return out


def _loss(name, rc, p, t):
    if name.startswith("dlrm"):
        return R.bce_loss(R.dlrm_forward(p, rc, t["dense"], t["sparse_ids"]), t["labels"])
    if name == "din":
        return R.bce_loss(R.din_forward(p, rc, t["target_ids"], t["hist_ids"], t["hist_mask"]), t["labels"])
    ints = R.mind_interests(p, rc, t["hist_ids"], t["hist_mask"])
    te = R.mind_item_embedding(p, rc, t["target_ids"])
    return R.sampled_softmax_loss(R.mind_user_vector(p, rc, ints, te), te)


def _loss_and_grads(name, rc, p, t):
    floats = [x for x in tree_leaves(p) if x.is_floating_point()]
    for x in floats:
        x.requires_grad_(True)
    loss = _loss(name, rc, p, t)
    grads = torch.autograd.grad(loss, floats, allow_unused=True)
    return loss, [torch.zeros_like(x) if g is None else g for x, g in zip(floats, grads)]


@pytest.mark.parametrize("name", ARCHS)
def test_recsys_loss_and_gradients_on_the_card_match_the_cpu(cuda, name):
    rc = get_arch(name).reduced().recsys
    init = {"dlrm-rm2": R.init_dlrm, "dlrm-mlperf": R.init_dlrm, "din": R.init_din, "mind": R.init_mind}[name]
    p_cpu = init(rc, torch.Generator().manual_seed(0), device="cpu")
    p_gpu = tree_map(lambda x: x.to(cuda), p_cpu)
    batch = _batch(name, rc, ARCHS.index(name))
    t_cpu = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_gpu = {k: v.to(cuda) for k, v in t_cpu.items()}
    loss_c, grads_c = _loss_and_grads(name, rc, p_cpu, t_cpu)
    loss_g, grads_g = _loss_and_grads(name, rc, p_gpu, t_gpu)
    _close(loss_g, loss_c, f"{name} loss")
    for i, (g, c) in enumerate(zip(grads_g, grads_c)):
        if float(c.abs().max()) == 0:
            assert float(g.abs().max()) == 0, f"{name} gradient {i}"
        else:
            _close(g, c, f"{name} gradient {i}")


def test_schnet_on_the_card_matches_the_cpu(cuda):
    cfg = get_arch("schnet").reduced().gnn
    rng = np.random.default_rng(0)
    n, e = 300, 1200
    p = S.init_schnet(cfg, 24, 5, torch.Generator().manual_seed(0), device="cpu")
    pg = tree_map(lambda x: x.to(cuda), p)
    es = rng.integers(-5, n + 5, e)  # a few out of range: wrapped, clamped and dropped, as in JAX
    ed = rng.integers(-5, n + 5, e)
    args = [torch.from_numpy(a) for a in (rng.standard_normal((n, 24)).astype(np.float32), es, ed,
                                          (rng.random(e) * 12).astype(np.float32), rng.random(e) < 0.9)]
    want = S.schnet_readout(p, S.schnet_forward(p, cfg, *args))
    got = S.schnet_readout(pg, S.schnet_forward(pg, cfg, *(a.to(cuda) for a in args)))
    _close(got, want, "schnet_forward + readout")
    pm = S.init_schnet(cfg, 16, 1, torch.Generator().manual_seed(1), device="cpu")
    pmg = tree_map(lambda x: x.to(cuda), pm)
    bsz, nn_, ne = 8, 30, 64
    mol = [torch.from_numpy(a) for a in (np.eye(16, dtype=np.float32)[rng.integers(0, 16, (bsz, nn_))],
                                         rng.standard_normal((bsz, nn_, 3)).astype(np.float32),
                                         rng.integers(0, nn_, (bsz, ne)), rng.integers(0, nn_, (bsz, ne)),
                                         rng.random((bsz, ne)) < 0.9)]
    _close(S.molecule_batch_forward(pmg, cfg, *(a.to(cuda) for a in mol)),
           S.molecule_batch_forward(pm, cfg, *mol), "molecule_batch_forward")


def test_mind_retrieval_through_the_dequant_kernel(cuda):
    """MIND's item tower into a dense LSP index on the card; the users'
    interests through ``retrieve_dense``, dequant_matmul launched, recall@10
    against ``impl="ref"`` at least 0.99 (chip_smoke.py's dense gate: the
    kernel's bounds sum in another order, so a tie at the cut may fall the
    other way)."""
    # MIND's widths with a smaller item vocabulary; 20,000 distinct items, so no two candidates tie
    rc = dataclasses.replace(get_arch("mind").recsys, vocab_sizes=(200_000, 1_000))
    p = R.init_mind(rc, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    rng = np.random.default_rng(0)
    items = np.stack([rng.permutation(200_000)[:20_000], rng.integers(0, 1_000, 20_000)], axis=1)
    items = torch.from_numpy(items).to(cuda)
    cands = R.mind_item_embedding(p, rc, items)
    idx = build_dense_index(cands, DenseIndexConfig(b=64, c=16, bits=4, kmeans_iters=4, ns_align=8), device=cuda)
    hist = torch.from_numpy(rng.integers(0, 1_000, (16, rc.hist_len, rc.n_sparse))).to(cuda)
    mask = torch.ones(16, rc.hist_len, dtype=torch.bool, device=cuda)
    q = R.mind_interests(p, rc, hist, mask).reshape(-1, rc.embed_dim)
    cfg = combine(StaticConfig(variant="lsp0", gamma=max(8, idx.n_superblocks // 8), gamma0=4, k_max=10),
                  DynamicParams(k=10))
    before = ops.dequant_matmul_kernel.launches
    ids, _ = retrieve_dense(idx, q, cfg)
    assert ops.dequant_matmul_kernel.launches > before
    ref_ids, _ = retrieve_dense(idx, q, cfg, impl="ref")
    assert recall_vs_oracle(ids.cpu().numpy(), ref_ids.cpu().numpy()) >= 0.99
