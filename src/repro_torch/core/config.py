"""Retrieval configuration: the static/dynamic split.

* ``StaticConfig``: the shape-bearing knobs (variant, γ/γ₀, budgets, k_max,
  document layout). They size every intermediate of the traversal.
* ``DynamicParams``: the per-request point (k ≤ k_max, μ, η, β). It rides the
  batch as per-row [Q] tensors (``DynamicArgs``), so rows of one batch may mix
  points, with the same results as a batch at one point.

A copy of the JAX package's ``core/config.py`` (the port imports nothing from
it). All dataclasses validate at construction and raise ``ConfigError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

VARIANTS = ("lsp0", "lsp1", "lsp2", "sp", "bmp", "exact")
DOC_LAYOUTS = ("fwd", "flat")


class ConfigError(ValueError):
    """A retrieval config field is out of its domain (raised at construction)."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ConfigError(msg)


@dataclass(frozen=True)
class DynamicParams:
    """Per-request query-time parameters, never shape-bearing."""

    k: int = 10  # results returned; must be <= StaticConfig.k_max
    mu: float = 0.5  # threshold overestimation for max bounds (LSP/1, LSP/2, SP)
    eta: float = 1.0  # block-level overestimation / SP avg-bound factor
    beta: float = 0.33  # query pruning: keep the top β fraction of query terms (bounds only)

    def __post_init__(self) -> None:
        _require(
            int(self.k) == self.k and self.k >= 1,
            f"k must be a positive integer, got {self.k!r} — it is the number of results returned",
        )
        _require(
            0.0 < self.beta <= 1.0,
            f"beta (query-pruning fraction) must be in (0, 1], got {self.beta!r}; "
            "beta=1.0 disables query pruning",
        )
        _require(self.mu > 0.0, f"mu (max-bound overestimation divisor) must be > 0, got {self.mu!r}")
        _require(self.eta > 0.0, f"eta (block-bound overestimation divisor) must be > 0, got {self.eta!r}")

    def key_bytes(self) -> bytes:
        """Canonical byte image for cache keys: distinct points never share an
        entry inside one (epoch, query) namespace."""
        return np.int32(self.k).tobytes() + np.asarray([self.mu, self.eta, self.beta], np.float32).tobytes()

    def validate_for(self, static: "StaticConfig") -> "DynamicParams":
        """Check that a traversal sized by ``static`` can serve this point."""
        _require(
            self.k <= static.k_max,
            f"k={self.k} exceeds the static k_max={static.k_max}; raise StaticConfig.k_max or lower k",
        )
        return self

    @classmethod
    def recommended(cls, k: int) -> "DynamicParams":
        """The paper's zero-shot preset, dynamic half: β = 0.33 up to k = 100, else 0.5."""
        return cls(k=k, beta=0.33 if k <= 100 else 0.5)


class DynamicArgs(NamedTuple):
    """``DynamicParams`` as per-row [Q] tensors on the batch's device."""

    k: torch.Tensor  # int32 [Q]
    mu: torch.Tensor  # float32 [Q]
    eta: torch.Tensor  # float32 [Q]
    beta: torch.Tensor  # float32 [Q]


Dynamic = Union[DynamicParams, DynamicArgs, Sequence[DynamicParams], None]


def dynamic_args(dyn: Dynamic, q: int, k_max: int, device) -> DynamicArgs:
    """Broadcast host params (or a list of per-row params) to [Q] tensors.

    ``None`` means the static point: k = k_max with default μ/η/β.
    """
    if isinstance(dyn, DynamicArgs):
        return dyn
    if dyn is None:
        dyn = DynamicParams(k=k_max)
    if isinstance(dyn, DynamicParams):
        dyn = [dyn] * q
    if len(dyn) != q:
        raise ValueError(f"per-row params: got {len(dyn)} for a batch of {q} rows")

    def col(field, dtype):
        return torch.tensor([getattr(d, field) for d in dyn], dtype=dtype, device=device)

    return DynamicArgs(
        col("k", torch.int32), col("mu", torch.float32), col("eta", torch.float32), col("beta", torch.float32)
    )


@dataclass(frozen=True)
class DegradationRung:
    """One point of a serving degradation ladder: a dynamic point plus an
    optional query-term cap. Smaller μ/η/β prune more and smaller k raises θ;
    ``nq_cap`` truncates the canonical query so it rides a smaller nq bucket."""

    params: DynamicParams
    nq_cap: int = 0  # keep only the top-nq_cap query terms by weight; 0 = no cap

    def __post_init__(self) -> None:
        _require(
            isinstance(self.params, DynamicParams),
            f"DegradationRung.params must be DynamicParams, got {type(self.params).__name__}",
        )
        _require(self.nq_cap >= 0, f"nq_cap must be >= 0 (0 = no cap), got {self.nq_cap!r}")


def validate_degradation_ladder(rungs, static: Optional["StaticConfig"] = None) -> tuple[DegradationRung, ...]:
    """Validate a degradation ladder and return it as ``DegradationRung``s.

    ``rungs`` may mix bare ``DynamicParams`` (no term cap) and
    ``DegradationRung``s. Rung 0 is the full-quality point; walking down must
    never get more expensive, so k and every set ``nq_cap`` are non-increasing
    (a rung after a capped rung is capped at or below that cap). With
    ``static`` given, every rung must be servable by it (k <= k_max)."""
    out = []
    for i, r in enumerate(rungs):
        if isinstance(r, DynamicParams):
            r = DegradationRung(r)
        _require(
            isinstance(r, DegradationRung),
            f"ladder rung {i} must be DynamicParams or DegradationRung, got {type(r).__name__}",
        )
        if static is not None:
            r.params.validate_for(static)
        out.append(r)
    _require(bool(out), "degradation ladder must have at least one rung (the full-quality point)")
    for i in range(1, len(out)):
        prev, cur = out[i - 1], out[i]
        _require(
            cur.params.k <= prev.params.k,
            f"ladder rung {i} raises k ({prev.params.k} -> {cur.params.k}); "
            "degradation must walk toward cheaper points, so k is non-increasing",
        )
        if prev.nq_cap:
            _require(
                0 < cur.nq_cap <= prev.nq_cap,
                f"ladder rung {i} relaxes nq_cap ({prev.nq_cap} -> {cur.nq_cap or 'uncapped'}); "
                "once a rung caps query terms, every later rung must cap at or below it",
            )
    return tuple(out)


@dataclass(frozen=True)
class StaticConfig:
    """Shape-bearing knobs: each value sizes an intermediate or picks a code path."""

    variant: str = "lsp0"  # lsp0 | lsp1 | lsp2 | sp | bmp | exact
    gamma: int = 250  # guaranteed top-γ superblocks — sizes the candidate list
    gamma0: int = 32  # round-0 superblocks scored to seed θ
    k_max: int = 10  # widest k; result tensors are [Q, k_max]
    sb_budget: int = 0  # cap on visited superblocks; 0 -> gamma (lsp0/bmp) / 2*gamma
    block_budget: int = 0  # cap on scored blocks; 0 -> visited_superblocks * c
    doc_layout: str = "fwd"  # fwd | flat: the operand documents are scored from

    def __post_init__(self) -> None:
        _require(self.variant in VARIANTS, f"unknown variant {self.variant!r}; expected one of {VARIANTS}")
        _require(
            self.doc_layout in DOC_LAYOUTS,
            f"unknown doc_layout {self.doc_layout!r}; expected one of {DOC_LAYOUTS}",
        )
        _require(self.gamma >= 1, f"gamma must be >= 1, got {self.gamma!r}")
        _require(self.k_max >= 1, f"k_max must be >= 1, got {self.k_max!r}")
        _require(self.sb_budget >= 0, f"sb_budget must be >= 0 (0 = variant default), got {self.sb_budget!r}")
        _require(self.block_budget >= 0, f"block_budget must be >= 0 (0 = no cap), got {self.block_budget!r}")
        budget = self.resolved_sb_budget()
        _require(
            1 <= self.gamma0 <= budget,
            f"gamma0={self.gamma0} must be in [1, resolved sb_budget={budget}] "
            f"(variant={self.variant!r}, gamma={self.gamma}, sb_budget={self.sb_budget}): "
            "round 0 cannot score more superblocks than the traversal may visit — "
            "lower gamma0 or raise gamma/sb_budget",
        )

    def resolved_sb_budget(self) -> int:
        if self.sb_budget:
            return self.sb_budget
        return self.gamma if self.variant in ("lsp0", "bmp") else 2 * self.gamma


@dataclass(frozen=True)
class RetrievalConfig:
    """The combined view of both halves (k == k_max); ``split()`` yields the
    (StaticConfig, DynamicParams) pair, and construction validates both."""

    variant: str = "lsp0"
    k: int = 10
    gamma: int = 250
    mu: float = 0.5
    eta: float = 1.0
    beta: float = 0.33
    gamma0: int = 32
    sb_budget: int = 0
    block_budget: int = 0
    doc_layout: str = "fwd"

    def __post_init__(self) -> None:
        self.split()

    def static(self) -> StaticConfig:
        return StaticConfig(variant=self.variant, gamma=self.gamma, gamma0=self.gamma0, k_max=self.k,
                            sb_budget=self.sb_budget, block_budget=self.block_budget, doc_layout=self.doc_layout)

    def dynamic(self) -> DynamicParams:
        return DynamicParams(k=self.k, mu=self.mu, eta=self.eta, beta=self.beta)

    def split(self) -> tuple[StaticConfig, DynamicParams]:
        return self.static(), self.dynamic()

    def resolved_sb_budget(self) -> int:
        return self.static().resolved_sb_budget()


def combine(static: StaticConfig, dyn: Optional[DynamicParams] = None) -> RetrievalConfig:
    """The combined config of serving ``dyn`` (default: k = k_max) through a
    traversal sized by ``static``."""
    dyn = (dyn or DynamicParams(k=static.k_max)).validate_for(static)
    return RetrievalConfig(
        variant=static.variant, k=dyn.k, gamma=static.gamma, mu=dyn.mu, eta=dyn.eta, beta=dyn.beta,
        gamma0=static.gamma0, sb_budget=static.sb_budget, block_budget=static.block_budget,
        doc_layout=static.doc_layout,
    )


# Paper-recommended zero-shot configurations (§Conclusion):
#   k=10   -> γ=250 (or 500), β=0.33, b=16, c=16, 4-bit SIMDBP-256*, Fwd docs
#   k=1000 -> γ=1000 (or 2000), β=0.5, b=4..8, c=16
def recommended(k: int, variant: str = "lsp0") -> RetrievalConfig:
    if k <= 10:
        return RetrievalConfig(variant=variant, k=k, gamma=250, beta=0.33)
    if k <= 100:
        return RetrievalConfig(variant=variant, k=k, gamma=500, beta=0.33)
    return RetrievalConfig(variant=variant, k=k, gamma=1000, beta=0.5)


def recommended_static(k: int, n_superblocks: int = 0, variant: str = "lsp0") -> StaticConfig:
    """Static half of the paper's zero-shot preset (γ = 250 / 500 / 1000 for
    k ≤ 10 / ≤ 100 / above, γ₀ = 32), with γ clamped to the corpus's superblocks."""
    gamma = recommended(k, variant).gamma
    if n_superblocks:
        gamma = max(1, min(gamma, n_superblocks))
    return StaticConfig(variant=variant, gamma=gamma, gamma0=min(32, gamma), k_max=k)
