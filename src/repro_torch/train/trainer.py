"""Training loop: mixed precision, gradient accumulation, checkpoint/restart.

Fault-tolerance contract:
  * checkpoints are atomic and carry (params, opt_state, step), keyed as the JAX
    package keys them, so either package restores the other's;
  * the data pipeline is counter-based, so restore(step) resumes the exact stream.

Mixed precision is the JAX package's, not ``torch.autocast``: the floating
parameters are cast to ``compute_dtype`` as leaves of their own, the gradient is
taken with respect to those low-precision copies, and it is cast to float32
for the optimizer, which updates the float32 master weights in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.ckpt.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.common.tree_utils import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor  # int32 0-d


@dataclass(frozen=True)
class TrainerConfig:
    ckpt_dir: str = ""
    ckpt_every: int = 50
    ckpt_keep: int = 3
    ckpt_async: bool = True
    grad_accum: int = 1
    compute_dtype: torch.dtype = torch.bfloat16  # params stay float32 (master weights)


def make_train_step(loss_fn: Callable[[Any, dict], tuple[torch.Tensor, dict]], optimizer, cfg: TrainerConfig):
    """A step: (state, batch) -> (state, metrics).

    Gradient accumulation splits the batch's leading axis into ``grad_accum``
    microbatches; their float32 gradients are summed and divided by
    ``grad_accum``. The loss is the microbatches' mean, the other metrics the
    last microbatch's.
    """

    def value_and_grad(lowp, batch):
        leaves = [x for x in tree_leaves(lowp) if x.requires_grad]
        loss, metrics = loss_fn(lowp, batch)
        grads = list(torch.autograd.grad(loss, leaves))
        for i in range(len(grads)):  # each low-precision gradient is freed as its float32 copy is made
            grads[i] = grads[i].float()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def compute_grads(params, batch):
        lowp = tree_map(
            lambda x: x.detach().to(cfg.compute_dtype).requires_grad_() if torch.is_floating_point(x) else x, params
        )
        if cfg.grad_accum == 1:
            return value_and_grad(lowp, batch)
        n = cfg.grad_accum
        split = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in batch.items()}
        acc, loss_sum = None, 0.0
        for i in range(n):
            loss, metrics, g = value_and_grad(lowp, {k: v[i] for k, v in split.items()})
            acc = g if acc is None else [a + b for a, b in zip(acc, g)]
            loss_sum = loss_sum + loss
        return loss_sum / n, metrics, [a / n for a in acc]

    def step_fn(state: TrainState, batch: dict):
        loss, metrics, flat = compute_grads(state.params, batch)
        it = iter(flat)
        grads = tree_map(lambda x: next(it) if torch.is_floating_point(x) else None, state.params)
        new_params, new_opt, opt_metrics = optimizer.update(grads, state.opt_state, state.params)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return step_fn


class Trainer:
    def __init__(self, loss_fn, optimizer, cfg: TrainerConfig, init_params_fn: Callable[[], Any]):
        self.cfg = cfg
        self.optimizer = optimizer
        self.step_fn = make_train_step(loss_fn, optimizer, cfg)
        self.init_params_fn = init_params_fn
        self._ckpt_thread = None

    def init_or_restore(self) -> TrainState:
        """Fresh parameters, or the latest checkpoint under ``ckpt_dir``,
        on the device the parameters are made on."""
        params = self.init_params_fn()
        device = tree_leaves(params)[0].device
        state = TrainState(params, self.optimizer.init(params), torch.zeros((), dtype=torch.int32, device=device))
        if self.cfg.ckpt_dir and latest_step(self.cfg.ckpt_dir) is not None:
            state, step = restore_checkpoint(self.cfg.ckpt_dir, state)
            print(f"[trainer] restored checkpoint at step {step}")
        return state

    def maybe_checkpoint(self, state: TrainState, force: bool = False) -> None:
        if not self.cfg.ckpt_dir:
            return
        step = int(state.step)
        if force or (step > 0 and step % self.cfg.ckpt_every == 0):
            if self._ckpt_thread is not None:
                self._ckpt_thread.join()  # one in-flight async save at a time
            self._ckpt_thread = save_checkpoint(
                self.cfg.ckpt_dir, step, state, keep=self.cfg.ckpt_keep, async_write=self.cfg.ckpt_async
            )

    def finish(self) -> None:
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()

    def run(self, state: TrainState, pipeline, n_steps: int, log_every: int = 10,
            on_step: Optional[Callable[[int, dict], None]] = None) -> TrainState:
        """``n_steps`` steps from ``state.step`` on, batches moved to the
        parameters' device; ``on_step(step, metrics)`` after each."""
        device = tree_leaves(state.params)[0].device
        start = int(state.step)
        it = pipeline.iterate(start_step=start)
        try:
            for i in range(start, start + n_steps):
                batch = {k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
                state, metrics = self.step_fn(state, batch)
                if log_every and (i + 1) % log_every == 0:
                    m = {k: float(v) for k, v in metrics.items() if v.ndim == 0}
                    print(f"[trainer] step {i + 1}: " + " ".join(f"{k}={v:.4g}" for k, v in m.items()))
                if on_step is not None:
                    on_step(i + 1, metrics)
                self.maybe_checkpoint(state)
        finally:
            it.close()  # stops the prefetch thread
        self.maybe_checkpoint(state, force=True)
        self.finish()
        return state
