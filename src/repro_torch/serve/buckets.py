"""Shape-bucket ladder of the serving engine.

The ladder fixes a small set of (batch, nq) shapes (geometric by default:
1/4/16/…/max_batch × 16/64/…/nq_max) and picks the smallest one covering each
collected batch, so a lone query runs a batch-1 traversal instead of paying
for ``max_batch`` padded rows. Padding within a bucket leaves results
unchanged: sentinel terms (id == vocab, weight 0) and empty query rows
contribute nothing anywhere in the traversal.

The port runs eagerly, so a bucket compiles nothing; it still sets the batch
shapes, which is what a CUDA graph per bucket would capture, and ``shapes()``
is what warm-up runs once each (building and loading the CUDA kernels).
"""

from __future__ import annotations

from dataclasses import dataclass

_LADDER_FACTOR = 4


@dataclass(frozen=True, order=True)
class Bucket:
    batch: int
    nq: int


def _ladder(max_val: int, explicit, base: int) -> list[int]:
    """Ascending sizes ending exactly at max_val. Explicit sizes are clipped to
    max_val; the default is geometric from ``base``, so the ladder stays short."""
    if max_val < 1:
        raise ValueError(f"the largest bucket size must be >= 1, got {max_val}")
    if explicit is not None:
        vals = sorted({min(int(v), max_val) for v in explicit if int(v) >= 1})
        if not vals:
            raise ValueError(f"no usable bucket sizes in {explicit!r}")
    else:
        vals, v = [], min(base, max_val)
        while v < max_val:
            vals.append(v)
            v *= _LADDER_FACTOR
    if not vals or vals[-1] != max_val:
        vals.append(max_val)
    return vals


class BucketLadder:
    """batch × nq shape grid. ``batch_sizes=[max_batch]`` (one rung) pads every
    batch to one shape."""

    def __init__(
        self,
        max_batch: int,
        nq_max: int,
        batch_sizes: list[int] | None = None,
        nq_sizes: list[int] | None = None,
    ):
        self.batch_sizes = _ladder(max_batch, batch_sizes, base=1)
        self.nq_sizes = _ladder(nq_max, nq_sizes, base=16)
        self.max_batch = self.batch_sizes[-1]
        self.nq_max = self.nq_sizes[-1]

    def select(self, n_queries: int, nq: int) -> Bucket:
        """Smallest bucket covering (n_queries, nq); inputs beyond the ladder's
        maxima clip (the engine never collects > max_batch, and truncates terms
        at nq_max)."""
        n_queries = min(max(n_queries, 1), self.max_batch)
        nq = min(max(nq, 1), self.nq_max)
        batch = next(v for v in self.batch_sizes if v >= n_queries)
        return Bucket(batch, next(v for v in self.nq_sizes if v >= nq))

    def shapes(self) -> list[Bucket]:
        """Every bucket, for warm-up."""
        return [Bucket(b, q) for b in self.batch_sizes for q in self.nq_sizes]

    def __repr__(self) -> str:
        return f"BucketLadder(batch={self.batch_sizes}, nq={self.nq_sizes})"
