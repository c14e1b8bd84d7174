"""Initialisers, the elementwise building blocks of the models, and JAX's
rule for a gather whose index is out of range (``take_rows``).

Conventions across ``repro_torch.models``: parameters are NamedTuples of tensors
(the JAX package's pytrees, field for field), weights keep its ``[in, out]``
orientation so a layer is ``x @ w``, and initialisers take an explicit
``torch.Generator`` (CPU, or CUDA to draw on the card), dtype and device, so
that the bf16-compute / float32-master policy lives in the trainer, not the
model. The JAX module's ``maybe_shard`` and ``ambient_axis_size`` are hints to
an ambient device mesh, which PyTorch has no counterpart of; they are left out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _trunc_normal(shape, std: float, generator, dtype, device) -> torch.Tensor:
    """A normal truncated at ±2 standard deviations, then scaled by ``std``
    (``trunc_normal_``'s bounds are absolute, so they are ±2·std). Drawn on the
    device of ``generator``: from a CPU generator (or none) on the host, so a
    seed gives the same weights on every device; from a CUDA generator on the
    card, which is what makes a model of billions of parameters quick to
    initialise there. On the ``meta`` device nothing is drawn: the tree's
    shapes alone, for placements and restore targets."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.empty(shape, dtype=torch.float32, device=generator.device if generator is not None else "cpu")
    torch.nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
    return w.to(device=device, dtype=dtype)


def dense_init(in_dim: int, out_dim: int, generator=None, dtype=torch.float32, device=None,
               scale: float | None = None) -> torch.Tensor:
    """Fan-in scaled truncated-normal weight ``[in_dim, out_dim]``."""
    std = scale if scale is not None else in_dim**-0.5
    return _trunc_normal((in_dim, out_dim), std, generator, dtype, device)


def embed_init(vocab: int, dim: int, generator=None, dtype=torch.float32, device=None,
               std: float = 0.02) -> torch.Tensor:
    return _trunc_normal((vocab, dim), std, generator, dtype, device)


def jax_rows(rows: torch.Tensor, n: int) -> torch.Tensor:
    """The rows that JAX's ``x[rows]`` reads from ``n`` rows, where no index
    raises: a negative row wraps once, then every row is clamped into
    ``[0, n-1]`` (int64)."""
    rows = rows.long()
    return torch.where(rows < 0, rows + n, rows).clamp(0, n - 1)


def take_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` by JAX's out-of-range rule (``jax_rows``)."""
    return table[jax_rows(rows, table.shape[0])]


def zeros(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS reduction in float32; the normalising multiply in the activation dtype."""
    ms = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + eps).to(x.dtype)
    return x * inv * gamma.to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def swiglu(x_gate: torch.Tensor, x_up: torch.Tensor) -> torch.Tensor:
    return F.silu(x_gate) * x_up


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")
