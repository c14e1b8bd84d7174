"""The traced run's instruments: the device trace of the window and the
program's kernel calls inside it.

``Tracer`` runs the window under ``torch.profiler`` with CUDA activity only
(CUPTI: kernels, copies, sets, and the runtime calls that launch them; no
per-op host events, which would be millions). A ``torch.cuda._sleep`` marker
launched on an idle device at each edge of the window ties the window to the
device's clock. ``OpCalls`` wraps the ``core.ops`` attributes that launch the
program's own CUDA kernels and keeps the arguments of their first calls in
the window; after the window each kept call is matched, in launch order, to
its kernel in the trace (one stream, so the i-th call of a kernel is its
i-th execution).
"""

from __future__ import annotations

import time
from collections import Counter, defaultdict

import torch

from portbench import work

MARKER = "spin_kernel"  # what torch.cuda._sleep launches
MARKER_CYCLES = 1000
# Kineto keeps only device records inside the host-clock span from starting
# to stopping the profiler; a marker launched right at an edge can fall
# outside it once converted from the device's clock (one traced run of
# three lost a marker so). The profiler runs this long past each edge.
EDGE_S = 0.05


class OpCalls:
    """Counts every call of the program's kernel launchers and keeps the
    arguments of the first ``keep`` calls of each (dense query rows as their
    width only)."""

    def __init__(self, core_ops, keep: int = 256):
        self.core_ops = core_ops
        self.keep = keep
        self.n = Counter()
        self.kept = defaultdict(list)
        self._originals = {}

    def __enter__(self):
        for name, (attr, _, _, dense_arg) in work.KERNELS.items():
            fn = getattr(self.core_ops, attr)
            self._originals[attr] = fn
            setattr(self.core_ops, attr, self._wrap(name, fn, dense_arg))
        return self

    def __exit__(self, *exc):
        for attr, fn in self._originals.items():
            setattr(self.core_ops, attr, fn)

    def _wrap(self, name, fn, dense_arg):
        def wrapper(*args):
            if self.n[name] < self.keep:
                kept = list(args)
                if dense_arg is not None:
                    kept[dense_arg] = args[dense_arg].shape[1]
                self.kept[name].append(kept)
            self.n[name] += 1
            return fn(*args)

        return wrapper


class Tracer:
    """``with Tracer() as tr: ...`` traces the block; ``tr.open()`` and
    ``tr.close()`` mark the window's edges on the device."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.__enter__()
        time.sleep(EDGE_S)
        return self

    def __exit__(self, *exc):
        time.sleep(EDGE_S)
        self._prof.__exit__(*exc)

    @staticmethod
    def mark():
        torch.cuda.synchronize()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()

    def events(self):
        """(name, start_ns, end_ns) of every device operation."""
        from torch.autograd import DeviceType

        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns()
                out.append((e.name(), s, s + e.duration_ns()))
        return out


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def reduce(events, top: int = 10) -> dict | None:
    """The window between the two markers: its length, the time a device
    operation ran (the union of their intervals), the kernels launched, the
    device operations that took most time, and the idle gaps summed by the
    operations on either side of them. None without two markers."""
    marks = sorted(s for name, s, _ in events if MARKER in name)
    if len(marks) < 2:
        return None
    w0, w1 = marks[0], marks[-1]
    inside = sorted((s, e, name) for name, s, e in events if s >= w0 and s < w1 and MARKER not in name)
    busy = 0
    gaps = Counter()
    by_name = Counter()
    cur_s = cur_e = None
    prev_name = "window start"
    for s, e, name in inside:
        e = min(e, w1)
        by_name[name[:120]] += (e - s) / 1e9
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            gap_from = w0 if cur_e is None else cur_e
            if s > gap_from:
                gaps[f"after {prev_name[:60]} / before {name[:60]}"] += (s - gap_from) / 1e9
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        prev_name = name
    if cur_e is not None:
        busy += cur_e - cur_s
        if w1 > cur_e:
            gaps[f"after {prev_name[:60]} / before window end"] += (w1 - cur_e) / 1e9
    else:
        gaps["window with no device operation"] += (w1 - w0) / 1e9
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "kernels": sum(1 for _, _, name in inside if _is_kernel(name)),
        "device_ops": [[n, v] for n, v in by_name.most_common(top)],
        "idle_gaps": [[n, v] for n, v in gaps.most_common(top)],
        "events": inside,
    }


def op_rooflines(calls: OpCalls, inside) -> dict:
    """{kernel: (least seconds, device seconds)} summed over its kept calls,
    each matched in launch order to its kernel in the window. A kernel whose
    count in the trace differs from its calls is left out."""
    out = {}
    for name, (_, device_name, work_fn, _) in work.KERNELS.items():
        kernels = [e - s for s, e, n in inside if device_name in n]
        kept = calls.kept.get(name, [])
        if not kept or len(kernels) != calls.n[name]:
            continue
        least = sum(work.least_seconds(*work_fn(*args)) for args in kept)
        out[name] = (least, sum(kernels[: len(kept)]) / 1e9)
    return out
