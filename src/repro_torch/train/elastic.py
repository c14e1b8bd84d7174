"""Elastic scaling + straggler mitigation policies.

The port of the JAX package's ``train/elastic.py``.

Elastic scaling: checkpoints are mesh-agnostic (host numpy leaves), so a job can
restart on any mesh — ``ckpt.checkpoint.restore_checkpoint(..., shardings=)``
hands each rank its shard of every leaf under placements derived from the new
mesh, and ``reshard_state`` moves a live state's shards from one placement to
another over the same ranks (``distributed/sharding.py::reshard``). Combined
with the counter-based data pipeline the restart is bit-deterministic w.r.t.
the data stream.

Straggler mitigation (design + hooks):
  * synchronous-with-backup: `BackupStepPolicy` tracks a per-step deadline from an
    EWMA of step times; when a step overruns, the launcher re-dispatches the stalled
    host's microbatch to the spare slice and drops the late result (at-most-once
    apply, deterministic because the reassigned microbatch is identical — counter
    pipeline again).
  * bounded staleness: for cross-pod DP, `allow_stale_pods` lets a pod fall at most
    one step behind, applying its gradient with the next step's reduction (documented
    trade-off; off by default).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.common.tree_utils import flatten_with_paths, tree_map
from repro_torch.distributed.sharding import NamedSharding, reshard


def reshard_state(state: Any, shardings: Any, current: Any) -> Any:
    """Move every leaf of ``state`` (this rank's shards under the placements
    of the matching ``current`` tree) onto the matching placement of
    ``shardings`` (the new mesh). Collective over the world."""
    return tree_map(lambda x, new, old: reshard(x, old, new) if isinstance(x, torch.Tensor) else x,
                    state, shardings, current)


def shardings_for(tree: Any, mesh, pspec_fn) -> Any:
    """Build a shardings tree: pspec_fn(path, leaf) -> PartitionSpec, with the
    leaf's path as the port's trees write it (``params/layers/0/attn/wq``)."""
    flat = iter([NamedSharding(mesh, pspec_fn(path, leaf)) for path, leaf in flatten_with_paths(tree).items()])
    return tree_map(lambda _: next(flat), tree)


@dataclass
class BackupStepPolicy:
    """EWMA step-deadline tracker; the launcher consults `overrun()` per step."""

    slack: float = 2.0  # deadline = slack * ewma
    alpha: float = 0.1
    ewma: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._t0 = time.monotonic()

    def finish(self) -> float:
        dt = time.monotonic() - self._t0
        self.ewma = dt if self.ewma == 0 else (1 - self.alpha) * self.ewma + self.alpha * dt
        return dt

    def deadline(self) -> float:
        return self.slack * self.ewma if self.ewma else float("inf")

    def overrun(self) -> bool:
        return self.ewma > 0 and (time.monotonic() - self._t0) > self.deadline()
