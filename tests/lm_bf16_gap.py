"""JAX's own bf16-vs-float32 gap on qwen3-4b's decode logits, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/lm_bf16_gap.py

The protocol of ``chip_smoke.py``'s float32/bf16 comparison at the reduced
widths: 2 prompts of 512 tokens from ``lm_synthetic_batch``, 64 teacher-forced
decode steps through the stacked path, once with float32 weights and cache and
once with bf16 weights (``tree_cast``) and cache. Prints, for qwen3-4b's
reduced depth (2 layers) and its full depth (36) and three seeds, the relative
error norm of the 64 steps' bf16 logits against the float32 ones, their
largest error over the largest float32 logit, and the share of equal argmax
tokens. ``chip_smoke.py`` holds the port's full-width gap to twice the
full-depth mean (``LM_BF16_GAP``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.common.tree_utils import tree_cast
from repro.configs import get_arch
from repro.data.pipeline import lm_synthetic_batch
from repro.models import stacked, transformer

PROMPT, STEPS = 512, 64


def gap(cfg, seed):
    params = stacked.stack_params(transformer.init_lm(jax.random.PRNGKey(seed), cfg), cfg)
    toks = lm_synthetic_batch(cfg.vocab, 2, PROMPT + STEPS)(np.random.default_rng(seed), 0)["tokens"]
    out = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        p = params if dtype == jnp.float32 else tree_cast(params, dtype)
        _, st = jax.jit(functools.partial(stacked.lm_prefill_stacked, cfg=cfg, max_len=PROMPT + STEPS,
                                          cache_dtype=dtype))(p, tokens=jnp.asarray(toks[:, :PROMPT]))
        step = jax.jit(functools.partial(stacked.lm_decode_step_stacked, cfg=cfg))
        rows = []
        for i in range(PROMPT, PROMPT + STEPS):
            d, st = step(p, token=jnp.asarray(toks[:, i:i + 1]), state=st)
            rows.append(np.asarray(d.astype(jnp.float32))[:, 0, :cfg.vocab])
        out[dtype] = np.stack(rows)
    lo, hi = out[jnp.bfloat16], out[jnp.float32]
    return (float(np.linalg.norm(lo - hi) / np.linalg.norm(hi)), float(np.abs(lo - hi).max() / np.abs(hi).max()),
            float((lo.argmax(-1) == hi.argmax(-1)).mean()))


def main():
    reduced = get_arch("qwen3-4b").reduced().lm
    for n_layers in (reduced.n_layers, get_arch("qwen3-4b").lm.n_layers):
        cfg = dataclasses.replace(reduced, n_layers=n_layers)
        norms = []
        for seed in range(3):
            norm, maxrel, same = gap(cfg, seed)
            norms.append(norm)
            print(f"{n_layers} layers, seed {seed}: norm {norm:.6f}, max {maxrel:.6f}, argmax equal {same:.4f}")
        print(f"{n_layers} layers: mean norm {np.mean(norms):.6f}")


if __name__ == "__main__":
    main()
