"""The port's optimizers, trainer and checkpoints against the JAX package's.

The tiny encoder config of ``tests/test_train_fault_tolerance.py``; JAX
initialises its weights and ``repro_torch.models.convert`` carries them across.
The decoder-only LMs (qwen3-4b and phi3.5-moe at their ``reduced()`` configs,
stacked, through remat, with Adafactor) go the other way: the port draws the
weights and the converter carries them to JAX.
Tolerances: one AdamW or Adafactor update and the schedule rtol 1e-6 (the
same float32 operations in the same order; ``cos``, ``pow``, means and the
per-leaf sums of the clipping norm may round their last bit otherwise); six
trainer steps rtol 1e-4, atol 1e-6 (float32 matrix products summed in another
order, then Adam's division by sqrt(v), or Adafactor's by its factored
moments, amplifies them). Checkpoints, resume and the converter: equal to the
bit.
"""

import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt.checkpoint as jax_ckpt
import repro.models.attention as jattn
import repro.models.ffn as jffn
import repro.models.stacked as jstacked
import repro.models.transformer as jtf
from repro.common.tree_utils import flatten_with_paths as jax_flatten_with_paths
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import LMCfg as JaxLMCfg
from repro.data.pipeline import CounterPipeline as JaxCounterPipeline, PipelineConfig as JaxPipelineConfig
from repro.data.pipeline import lm_synthetic_batch as jax_lm_synthetic_batch
from repro.data.pipeline import splade_synthetic_batch as jax_splade_synthetic_batch
from repro.models.sparse_encoder import SpladeBatch as JaxSpladeBatch, init_encoder as jax_init_encoder
from repro.models.sparse_encoder import splade_loss as jax_splade_loss
from repro.optim import Adafactor as JaxAdafactor, AdamW as JaxAdamW
from repro.train.trainer import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from repro.train.trainer import TrainState as JaxTrainState
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.common.tree_utils import flatten_with_paths, tree_map
from repro_torch.configs.base import LMCfg, get_arch
from repro_torch.data.pipeline import CounterPipeline, PipelineConfig, lm_synthetic_batch, splade_synthetic_batch
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import from_arrays, to_arrays
from repro_torch.models.sparse_encoder import SpladeBatch, splade_loss
from repro_torch.models.stacked import init_lm_stacked, lm_loss_stacked
from repro_torch.optim import Adafactor, AdafactorState, AdamW
from repro_torch.train.trainer import Trainer, TrainerConfig, TrainState, make_train_step

TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64, vocab=256, head_dim=16, tie_embeddings=True)
CFG, JCFG = LMCfg(**TINY), JaxLMCfg(**TINY)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)


def _jax_params(seed=0):
    return jax_init_encoder(jax.random.PRNGKey(seed), JCFG)


def _port_params(seed=0):
    return from_arrays(jax.tree_util.tree_map(np.asarray, _jax_params(seed)), "cpu")


def _loss(params, b):
    return splade_loss(params, CFG, SpladeBatch(b["q_tokens"], b["q_mask"], b["d_tokens"], b["d_mask"]))


def _jax_loss(params, b):
    return jax_splade_loss(params, JCFG, JaxSpladeBatch(b["q_tokens"], b["q_mask"], b["d_tokens"], b["d_mask"]))


def _pipe():
    return CounterPipeline(PipelineConfig(global_batch=8), splade_synthetic_batch(CFG.vocab, 8, 8, 12))


def _trainer(tmp="", accum=1, async_=False, every=4):
    return Trainer(_loss, AdamW(**OPT),
                   TrainerConfig(ckpt_dir=tmp, ckpt_every=every, grad_accum=accum, compute_dtype=torch.float32,
                                 ckpt_async=async_),
                   _port_params)


def _flat_np(tree):
    """{path: numpy} of a port tree."""
    return {k: v.numpy() for k, v in flatten_with_paths(tree).items()}


def _jax_flat(tree):
    """{path: numpy} of a JAX pytree, through the JAX package's own flatten."""
    return {k: np.asarray(v) for k, v in jax_flatten_with_paths(tree).items()}


def _assert_trees_equal(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------------------ AdamW
def test_schedule_equals_jax():
    cfg = dict(lr=1e-3, warmup_steps=5, total_steps=40, min_lr_ratio=0.1)
    jopt, opt = JaxAdamW(**cfg), AdamW(**cfg)
    steps = np.arange(0, 50, dtype=np.int32)
    want = np.asarray(jax.vmap(jopt.schedule)(jnp.asarray(steps)))
    got = opt.schedule(torch.from_numpy(steps))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(float(opt.schedule(3)), float(jopt.schedule(jnp.int32(3))), rtol=1e-6)


def test_five_updates_equal_jax():
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((8, 4)).astype(np.float32),
              "n": {"b": rng.standard_normal(4).astype(np.float32), "g": np.ones(3, np.float32)}}
    grads = [tree_map(lambda p: (rng.standard_normal(p.shape) * s).astype(np.float32), params) for s in
             (0.1, 3.0, 0.5, 2.0, 0.01)]  # the 3.0 and 2.0 steps clip
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=20, weight_decay=0.1)
    jopt, opt = JaxAdamW(**cfg), AdamW(**cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = tree_map(torch.from_numpy, tree_map(np.copy, params))
    ts = opt.init(tp)
    for g in grads:
        jp, js, jm = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts, tm = opt.update(tree_map(torch.from_numpy, g), ts, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 5 and ts.step.dtype == torch.int32
    for got, want in [(tp, jp), (ts.m, js.m), (ts.v, js.v)]:
        want = _jax_flat(want)
        for k, v in _flat_np(got).items():
            np.testing.assert_allclose(v, want[k], rtol=1e-6, atol=1e-9, err_msg=k)


# ------------------------------------------------------------------ trainer
@pytest.mark.parametrize("accum", [1, 2])
def test_six_trainer_steps_equal_jax(accum):
    jt = JaxTrainer(_jax_loss, JaxAdamW(**OPT),
                    JaxTrainerConfig(grad_accum=accum, compute_dtype=jnp.float32), _jax_params)
    jpipe = JaxCounterPipeline(JaxPipelineConfig(global_batch=8), jax_splade_synthetic_batch(256, 8, 8, 12))
    want = jt.run(jt.init_or_restore(), jpipe, 6, log_every=0)
    t = _trainer(accum=accum)
    got = t.run(t.init_or_restore(), _pipe(), 6, log_every=0)
    assert int(got.step) == int(want.step) == 6
    want_flat = _jax_flat(want)
    for k, v in _flat_np(got).items():
        np.testing.assert_allclose(v, want_flat[k], **STEP_TOL, err_msg=k)


def test_grad_accum_matches_full_batch():
    """grad_accum=2 equals the full-batch step for a per-example loss (the
    in-batch contrastive loss is not linear over microbatches)."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((8, 4)).astype(np.float32)
    batch = {"x": torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)),
             "y": torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))}

    def loss(params, b):
        return torch.mean(torch.square(b["x"] @ params["w"] - b["y"])), {}

    opt = AdamW(lr=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.0)
    out = []
    for accum in (1, 2):
        step = make_train_step(loss, opt, TrainerConfig(grad_accum=accum, compute_dtype=torch.float32))
        p = {"w": torch.from_numpy(w0.copy())}
        state, metrics = step(TrainState(p, opt.init(p), torch.zeros((), dtype=torch.int32)), batch)
        out.append((state.params["w"].numpy(), float(metrics["loss"])))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-5)


def test_preemption_restart_is_bit_exact(tmp_path):
    """8 steps straight against 4 + a new Trainer restored from the step-4
    checkpoint + 4: equal to the bit (atomic checkpoints + counter-based
    pipeline)."""
    t_full = _trainer(str(tmp_path / "a"))
    s_full = t_full.run(t_full.init_or_restore(), _pipe(), 8, log_every=0)
    t_a = _trainer(str(tmp_path / "b"))
    t_a.run(t_a.init_or_restore(), _pipe(), 4, log_every=0)
    t_b = _trainer(str(tmp_path / "b"))
    state_b = t_b.init_or_restore()
    assert int(state_b.step) == 4
    s_resumed = t_b.run(state_b, _pipe(), 4, log_every=0)
    _assert_trees_equal(_flat_np(s_resumed), _flat_np(s_full))


def test_async_checkpoint_is_not_changed_by_the_steps_after_it(tmp_path):
    """The trainer updates its parameters in place; an async save taken at step
    4 must hold step 4's state while steps 5-8 run."""
    t = _trainer(str(tmp_path), async_=True)
    t.run(t.init_or_restore(), _pipe(), 8, log_every=0)
    straight = _trainer()
    s4 = straight.run(straight.init_or_restore(), _pipe(), 4, log_every=0)
    got, step = ckpt.restore_checkpoint(str(tmp_path), s4, step=4)
    assert step == 4
    _assert_trees_equal(_flat_np(got), _flat_np(s4))
    # and directly: the writer is held on the directory's lock until the leaves have changed
    tree = {"w": torch.arange(6, dtype=torch.float32)}
    with ckpt.dir_lock(str(tmp_path / "held")):
        thread = ckpt.save_checkpoint(str(tmp_path / "held"), 1, tree, async_write=True)
        tree["w"].add_(100.0)
    thread.join(timeout=60)
    assert not thread.is_alive()
    restored, _ = ckpt.restore_checkpoint(str(tmp_path / "held"), tree)
    np.testing.assert_array_equal(restored["w"].numpy(), np.arange(6, dtype=np.float32))


# ------------------------------------------------------------------ checkpoints across packages
def _jax_state(params):
    opt = JaxAdamW(**OPT)
    return JaxTrainState(params, opt.init(params), jnp.zeros((), jnp.int32))


def test_port_checkpoint_restores_in_jax(tmp_path):
    t = _trainer(str(tmp_path / "port"))
    state = t.run(t.init_or_restore(), _pipe(), 3, log_every=0)  # saved at step 3
    assert sorted(os.listdir(tmp_path / "port" / "step_3")) == [".complete", "arrays.npz.zz", "meta.msgpack"]
    restored, step = jax_ckpt.restore_checkpoint(str(tmp_path / "port"), _jax_state(_jax_params(seed=9)))
    assert step == 3
    _assert_trees_equal(_jax_flat(restored), _flat_np(state))
    # the meta is the JAX package's, byte for byte
    jax_dir = tmp_path / "jax"
    jax_ckpt.save_checkpoint(str(jax_dir), 3, restored)
    for name in ("meta.msgpack",):
        assert (jax_dir / "step_3" / name).read_bytes() == (tmp_path / "port" / "step_3" / name).read_bytes()


def test_jax_checkpoint_restores_in_the_port(tmp_path, monkeypatch):
    jt = JaxTrainer(_jax_loss, JaxAdamW(**OPT), JaxTrainerConfig(compute_dtype=jnp.float32), _jax_params)
    jpipe = JaxCounterPipeline(JaxPipelineConfig(global_batch=8), jax_splade_synthetic_batch(256, 8, 8, 12))
    jstate = jt.run(jt.init_or_restore(), jpipe, 2, log_every=0)
    monkeypatch.setattr(jax_ckpt, "zstandard", None)  # the port reads zlib only
    jax_ckpt.save_checkpoint(str(tmp_path), 2, jstate)
    target = _trainer().init_or_restore()
    restored, step = ckpt.restore_checkpoint(str(tmp_path), target)
    assert step == 2 and restored.step.dtype == torch.int32
    _assert_trees_equal(_flat_np(restored), _jax_flat(jstate))


def test_chunks_deflated_in_parallel_make_one_zlib_stream(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt, "_CHUNK", 1000)
    tree = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(5000).astype(np.float32)),
            "i": torch.arange(777, dtype=torch.int32)}
    ckpt.save_checkpoint(str(tmp_path), 1, tree)
    raw = (tmp_path / "step_1" / "arrays.npz.zz").read_bytes()
    d = zlib.decompressobj()
    d.decompress(raw)
    assert d.eof and not d.unused_data  # one stream, nothing after it
    restored, _ = jax_ckpt.restore_checkpoint(str(tmp_path), {"w": jnp.zeros(5000), "i": jnp.zeros(777, jnp.int32)})
    np.testing.assert_array_equal(np.asarray(restored["w"]), tree["w"].numpy())
    np.testing.assert_array_equal(np.asarray(restored["i"]), tree["i"].numpy())


def test_zstd_checkpoint_raises_the_jax_packages_error(tmp_path):
    if jax_ckpt.zstandard is None:
        pytest.skip("this host's JAX package writes zlib: no zstd checkpoint to refuse")
    jax_ckpt.save_checkpoint(str(tmp_path), 1, {"a": jnp.arange(4)})
    with pytest.raises(RuntimeError, match="needs the zstandard module, which is unavailable"):
        ckpt.restore_checkpoint(str(tmp_path), {"a": torch.zeros(4, dtype=torch.int32)})


# ------------------------------------------------------------------ the JAX package's checkpoint cases
def test_checkpoint_atomicity_and_gc(tmp_path):
    tmp = str(tmp_path)
    tree = {"a": torch.arange(10), "b": {"c": torch.ones((3, 3))}}
    for step in [1, 2, 3, 4]:
        ckpt.save_checkpoint(tmp, step, tree, keep=2)
    assert ckpt.latest_step(tmp) == 4
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp) if d.startswith("step_"))
    assert steps == [3, 4], "gc keeps last 2"
    os.makedirs(os.path.join(tmp, "step_9"))  # a partially-written dir (no .complete marker) is ignored
    assert ckpt.latest_step(tmp) == 4
    restored, step = ckpt.restore_checkpoint(tmp, tree)
    assert step == 4
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(10))


def test_restore_explicit_step_requires_commit_marker(tmp_path):
    tmp = str(tmp_path)
    tree = {"a": torch.arange(4)}
    ckpt.save_checkpoint(tmp, 1, tree, keep=2)
    assert ckpt.restore_checkpoint(tmp, tree, step=1)[1] == 1
    os.remove(os.path.join(tmp, "step_1", ".complete"))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tmp, tree, step=1)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tmp, tree)  # no complete step left at all


def test_restore_pairs_each_leaf_by_its_own_path_key(tmp_path):
    tree = {"b": {"y": torch.full((3,), 7.0), "x": torch.full((2,), 5.0)},
            "a": [torch.full((4,), 1.0), torch.full((4, 2), 2.0)]}
    ckpt.save_checkpoint(str(tmp_path), 1, tree, keep=1)
    restored, _ = ckpt.restore_checkpoint(str(tmp_path), tree)
    for path, want in [(("b", "x"), 5.0), (("b", "y"), 7.0)]:
        np.testing.assert_array_equal(restored[path[0]][path[1]].numpy(), tree[path[0]][path[1]].numpy())
    np.testing.assert_array_equal(restored["a"][1].numpy(), np.full((4, 2), 2.0, np.float32))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(str(tmp_path), {**tree, "a": [torch.zeros(5), tree["a"][1]]})


def test_concurrent_async_saves_do_not_race(tmp_path):
    tmp = str(tmp_path)
    tree = {"w": torch.arange(128, dtype=torch.float32)}
    threads = [ckpt.save_checkpoint(tmp, s, tree, keep=2, async_write=True) for s in range(1, 7)]
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert ckpt.latest_step(tmp) == 6
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp))
    complete = [d for d in os.listdir(tmp) if d.startswith("step_") and ckpt.is_complete(os.path.join(tmp, d))]
    assert len(complete) <= 2 + 1  # keep=2; one extra may slip in between gc sweeps
    restored, step = ckpt.restore_checkpoint(tmp, tree, step=6)
    assert step == 6
    np.testing.assert_array_equal(restored["w"].numpy(), np.arange(128, dtype=np.float32))


# ------------------------------------------------------------------ the launcher
def test_launcher_trains_the_reduced_encoder_on_the_cpu(tmp_path, capsys):
    launch_train.main(["--splade", "--reduced", "--device", "cpu", "--steps", "3",
                       "--ckpt-dir", str(tmp_path)])
    assert "[train] finished at step 3" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_launcher_trains_checkpoints_and_resumes_a_reduced_lm_on_the_cpu(tmp_path, capsys):
    """``--arch qwen3-4b --reduced``: 2 steps checkpointed, a second start
    restores them and runs 2 more, equal to the bit to 4 straight steps of
    the same job."""
    argv = ["--arch", "qwen3-4b", "--reduced", "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    launch_train.main(argv)
    launch_train.main(argv)
    out = capsys.readouterr().out
    assert "[trainer] restored checkpoint at step 2" in out and "[train] finished at step 4" in out
    cfg, trainer, pipe = launch_train.lm_job("qwen3-4b", 4, 16, reduced=True, device="cpu")
    straight = trainer.run(trainer.init_or_restore(), pipe, 4, log_every=0)
    assert isinstance(straight.opt_state, AdafactorState)
    resumed, step = ckpt.restore_checkpoint(str(tmp_path), straight)
    assert step == 4
    _assert_trees_equal(_flat_np(resumed), _flat_np(straight))
    with pytest.raises(SystemExit):
        launch_train.main(["--device", "cpu"])  # neither --arch nor --splade
    with pytest.raises(ValueError, match="--arch schnet is a gnn arch"):
        launch_train.main(["--arch", "schnet", "--reduced", "--device", "cpu"])


# ------------------------------------------------------------------ Adafactor
def test_adafactor_updates_equal_jax():
    """Five updates on 0-, 1-, 2- and 3-D float leaves (the stacked
    ``[n_groups, in, out]`` shape factors over its last two axes) and an int
    leaf, which has no gradient and passes through; moments and the step too."""
    rng = np.random.default_rng(0)
    params = {"s": np.asarray(rng.standard_normal(), np.float32), "b": rng.standard_normal(5).astype(np.float32),
              "w": rng.standard_normal((6, 4)).astype(np.float32),
              "stacked": rng.standard_normal((3, 4, 5)).astype(np.float32), "i": np.arange(4, dtype=np.int32)}
    jopt, opt = JaxAdafactor(lr=1e-2), Adafactor(lr=1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in params.items()}
    ts = opt.init(tp)
    for scale in (0.1, 30.0, 1.0, 2.0, 1e-4):  # gradients over five orders of magnitude
        g = {k: np.asarray(rng.standard_normal(np.shape(v)) * scale, np.float32) for k, v in params.items() if k != "i"}
        jp, js, _ = jopt.update({**jax.tree_util.tree_map(jnp.asarray, g), "i": np.zeros(4, jax.dtypes.float0)}, js, jp)
        tp, ts, metrics = opt.update({**{k: torch.from_numpy(v) for k, v in g.items()}, "i": None}, ts, tp)
    assert metrics == {} and int(ts.step) == int(js.step) == 5 and ts.step.dtype == torch.int32
    want, got = _jax_flat((jp, js)), _flat_np((tp, ts))
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.shape == want[k].shape and v.dtype == want[k].dtype, k
        np.testing.assert_allclose(v, want[k], rtol=1e-6, atol=0, err_msg=k)
    assert got["1/moments/b/vc"].shape == (0,) and got["1/moments/stacked/vr"].shape == (3, 4)
    np.testing.assert_array_equal(got["0/i"], params["i"])


# ------------------------------------------------------------------ LM training
LM_ARCHS = ["qwen3-4b", "phi3.5-moe-42b-a6.6b"]
LM_B, LM_S = 4, 16


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


def _lm_port_params(arch):
    return init_lm_stacked(get_arch(arch).reduced().lm, torch.Generator().manual_seed(0), device="cpu")


def _lm_trainer(arch, accum=1, ckpt_dir=""):
    cfg = get_arch(arch).reduced().lm
    return Trainer(lambda p, b: lm_loss_stacked(p, cfg, b["tokens"], b["labels"], remat=True), Adafactor(lr=1e-3),
                   TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=2, grad_accum=accum, compute_dtype=torch.float32,
                                 ckpt_async=False),
                   lambda: _lm_port_params(arch))


def _lm_pipe(arch):
    return CounterPipeline(PipelineConfig(global_batch=LM_B), lm_synthetic_batch(get_arch(arch).reduced().lm.vocab,
                                                                                LM_B, LM_S))


def _jax_lm_trainer(arch, accum=1):
    jcfg = jax_get_arch(arch).reduced().lm
    jp = _to_jax(to_arrays(_lm_port_params(arch)))
    return JaxTrainer(lambda p, b: jstacked.lm_loss_stacked(p, jcfg, b["tokens"], b["labels"], remat=True),
                      JaxAdafactor(lr=1e-3), JaxTrainerConfig(grad_accum=accum, compute_dtype=jnp.float32),
                      lambda: jp)


def _jax_lm_pipe(arch):
    return JaxCounterPipeline(JaxPipelineConfig(global_batch=LM_B),
                              jax_lm_synthetic_batch(jax_get_arch(arch).reduced().lm.vocab, LM_B, LM_S))


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_six_lm_trainer_steps_equal_jax(arch, accum):
    """Stacked, remat, float32, Adafactor: the loss of every step and every
    leaf of the state after six."""
    jt = _jax_lm_trainer(arch, accum)
    jlosses, losses = [], []
    jstate = jt.init_or_restore()
    jit = _jax_lm_pipe(arch).iterate(0)
    for _ in range(6):
        jstate, jm = jt.step_fn(jstate, next(jit))
        jlosses.append(float(jm["loss"]))
    jit.close()
    t = _lm_trainer(arch, accum)
    got = t.run(t.init_or_restore(), _lm_pipe(arch), 6, log_every=0,
                on_step=lambda step, m: losses.append(float(m["loss"])))
    np.testing.assert_allclose(losses, jlosses, **STEP_TOL)
    want = _jax_flat(jstate)
    flat = _flat_np(got)
    assert list(flat) == list(want)
    for k, v in flat.items():
        np.testing.assert_allclose(v, want[k], **STEP_TOL, err_msg=k)


def test_adafactor_checkpoint_restores_across_packages(tmp_path, monkeypatch):
    """The port's checkpoint of an Adafactor state (empty ``vc`` leaves
    included) restores in JAX to the bit, and JAX's in the port."""
    arch = "qwen3-4b"
    t = _lm_trainer(arch, ckpt_dir=str(tmp_path / "port"))
    state = t.run(t.init_or_restore(), _lm_pipe(arch), 2, log_every=0)
    jt = _jax_lm_trainer(arch)
    target = jt.init_or_restore()
    restored, step = jax_ckpt.restore_checkpoint(str(tmp_path / "port"), target)
    assert step == 2
    _assert_trees_equal(_jax_flat(restored), _flat_np(state))
    assert any(v.shape == (0,) for k, v in _flat_np(state).items() if k.endswith("/vc"))

    jstate = jt.run(target, _jax_lm_pipe(arch), 2, log_every=0)
    monkeypatch.setattr(jax_ckpt, "zstandard", None)  # the port reads zlib only
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 2, jstate)
    got, step = ckpt.restore_checkpoint(str(tmp_path / "jax"), _lm_trainer(arch).init_or_restore())
    assert step == 2 and got.opt_state.step.dtype == torch.int32 and got.opt_state.step.ndim == 0
    _assert_trees_equal(_flat_np(got), _jax_flat(jstate))
