"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --steps 50              # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --reduced --device cpu  # CPU smoke
  PYTHONPATH=src python -m repro_torch.launch.train --splade --steps 300                    # sparse encoder

Trains a decoder-only arch (``--arch``: the stacked LM through remat, with
Adafactor) or the SPLADE-style sparse encoder (``--splade``: AdamW), with
atomic checkpoints: bf16 compute over float32 master weights at full width,
float32 with ``--reduced``. Re-running the same command resumes from
``--ckpt-dir``.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import LMCfg, all_arch_names, get_arch
from repro_torch.data.pipeline import CounterPipeline, PipelineConfig, lm_synthetic_batch, splade_synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.models.sparse_encoder import SpladeBatch, init_encoder, splade_100m_config, splade_loss
from repro_torch.models.stacked import init_lm_stacked, lm_loss_stacked
from repro_torch.optim import Adafactor, AdamW
from repro_torch.train.trainer import Trainer, TrainerConfig

SPLADE_Q_LEN, SPLADE_D_LEN = 12, 24


def splade_config(reduced: bool = False) -> LMCfg:
    if reduced:
        return LMCfg(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                     vocab=1024, head_dim=16, tie_embeddings=True)
    return splade_100m_config()


def splade_job(steps: int, batch: int = 8, reduced: bool = False, device=None, ckpt_dir: str = "",
               ckpt_every: int = 25, seed: int = 0) -> tuple[LMCfg, Trainer, CounterPipeline]:
    """What ``--splade`` trains: (config, trainer, pipeline). The parameters are
    drawn from ``seed`` on ``device`` (CUDA by default) when the trainer
    initialises."""
    device = resolve_device(device)
    cfg = splade_config(reduced)

    def loss_fn(params, b):
        return splade_loss(params, cfg, SpladeBatch(b["q_tokens"], b["q_mask"], b["d_tokens"], b["d_mask"]))

    trainer = Trainer(
        loss_fn,
        AdamW(lr=3e-4, warmup_steps=10, total_steps=steps),
        TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                      compute_dtype=torch.float32 if reduced else torch.bfloat16),
        lambda: init_encoder(cfg, torch.Generator().manual_seed(seed), device=device),
    )
    pipe = CounterPipeline(PipelineConfig(global_batch=batch),
                           splade_synthetic_batch(cfg.vocab, batch, SPLADE_Q_LEN, SPLADE_D_LEN))
    return cfg, trainer, pipe


def lm_job(arch: str, batch: int = 8, seq: int = 128, reduced: bool = False, device=None, ckpt_dir: str = "",
           ckpt_every: int = 25, seed: int = 0) -> tuple[LMCfg, Trainer, CounterPipeline]:
    """What ``--arch`` trains: (config, trainer, pipeline). The stacked LM's
    loss through remat, Adafactor at lr 1e-3, ``lm_synthetic_batch`` tokens.
    The parameters are drawn from ``seed`` on a generator of ``device`` (CUDA
    by default) when the trainer initialises."""
    device = resolve_device(device)
    spec = get_arch(arch)
    if spec.family != "lm":
        raise ValueError(f"--arch {arch} is a {spec.family} arch; this launcher trains the LM archs")
    cfg = (spec.reduced() if reduced else spec).lm

    def loss_fn(params, b):
        return lm_loss_stacked(params, cfg, b["tokens"], b["labels"], remat=True)

    trainer = Trainer(
        loss_fn,
        Adafactor(lr=1e-3),
        TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                      compute_dtype=torch.float32 if reduced else torch.bfloat16),
        lambda: init_lm_stacked(cfg, torch.Generator(device=device).manual_seed(seed), device=device),
    )
    pipe = CounterPipeline(PipelineConfig(global_batch=batch), lm_synthetic_batch(cfg.vocab, batch, seq))
    return cfg, trainer, pipe


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=all_arch_names(), default=None)
    p.add_argument("--splade", action="store_true", help="train the SPLADE-style sparse encoder")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128, help="tokens a sequence (--arch)")
    p.add_argument("--reduced", action="store_true", help="CPU-smoke dims (same code paths)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=25)
    args = p.parse_args(argv)

    if args.splade:
        _, trainer, pipe = splade_job(args.steps, args.batch, args.reduced, args.device, args.ckpt_dir,
                                      args.ckpt_every)
    elif args.arch:
        _, trainer, pipe = lm_job(args.arch, args.batch, args.seq, args.reduced, args.device, args.ckpt_dir,
                                  args.ckpt_every)
    else:
        p.error("--arch or --splade required")
    state = trainer.init_or_restore()
    state = trainer.run(state, pipe, args.steps, log_every=max(args.steps // 10, 1))
    print(f"[train] finished at step {int(state.step)}")


if __name__ == "__main__":
    main()
