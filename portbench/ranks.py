"""A run over P cards: one process a rank, rank r on device r.

Rank 0 is the run's own process. It starts ranks 1..P-1 (``portbench/rank.py``,
their standard output sent to its standard error), and every rank joins one
process group through a file store in a directory of the run's own: NCCL
over the cards (gloo on the CPU, in the tests) is the group the program is
handed (``Group.program``), and a gloo group over the same ranks carries
the host-side agreement (``Group.gloo``): the barrier after every rank's
build, the gathers of each rank's readings, the check's exchanges.

Failure is bounded. Rank 0 watches the other ranks (``Ranks``): a rank that
exits before the end, or a phase of rank 0 that waits on the others past its
limit, stops every rank and ends the run non-zero, printing no result; rank
0's collectives time out after ``WAIT_S``. Each other rank ends itself when
rank 0's process is gone (``die_with_parent``)."""

from __future__ import annotations

import ctypes
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

RANK_SCRIPT = Path(__file__).resolve().parent / "rank.py"
WAIT_S = 60.0  # the longest rank 0 waits on the other ranks in one step
FOLLOW_S = 1800.0  # the longest another rank waits on rank 0 (its build, window, check); it ends with rank 0
POLL_S = 0.2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Group:
    """What a build recipe and a reference get of the run's ranks: ``rank``,
    ``size``, ``device``, ``program`` (the process group handed to the
    program: NCCL on CUDA, gloo on the CPU), ``gloo`` (a gloo group over the
    same ranks), and ``built()``. A run on one card has a group of size 1
    with neither process group."""

    def __init__(self, rank: int, size: int, device, program=None, gloo=None, store=None, ranks=None):
        self.rank, self.size, self.device = rank, size, torch.device(device)
        self.program, self.gloo, self.store = program, gloo, store
        self.ranks = ranks  # rank 0's watch over the others (None elsewhere)
        self.stages = []  # (name, perf_counter at its end) of this rank's set-up
        self.is_built = False
        self.timeout = timedelta(seconds=WAIT_S if rank == 0 else FOLLOW_S)
        self.after_built = None  # the harness's hook, run on this rank once every rank is built

    def stage(self, name: str) -> None:
        self.stages.append((name, time.perf_counter()))

    def built(self) -> None:
        """A build recipe calls this once on every rank, when the rank's part
        of the build is done and before anything serves: the set-up's
        barrier after every rank's build."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stage("the build (this rank's part)")
        if self.size > 1:
            with self.waiting("the barrier after every rank's build"):
                dist.monitored_barrier(self.gloo, timeout=self.timeout, wait_all_ranks=True)
            self.stage("the barrier after every rank's build")
            if self.ranks is not None:  # the rest of the recipe's build waits on the others too
                self.ranks.begin("the build after every rank's barrier", WAIT_S)
        self.is_built = True
        if self.after_built is not None:
            self.after_built()

    @contextmanager
    def waiting(self, what: str, limit: float = WAIT_S):
        """On rank 0, a step that waits on the other ranks: past ``limit``
        seconds the run is stopped. Elsewhere nothing."""
        if self.ranks is None:
            yield
            return
        self.ranks.begin(what, limit)
        try:
            yield
        finally:
            self.ranks.end()

    def gather(self, obj):
        """Every rank's ``obj`` by rank on rank 0, None elsewhere."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.gloo)
        return out

    def finish(self) -> None:
        """The last step of every rank: a barrier, after which rank 0 expects
        the others to exit."""
        if self.size == 1:
            return
        if self.ranks is not None:
            self.ranks.expect_exit = True
        dist.monitored_barrier(self.gloo, timeout=self.timeout, wait_all_ranks=True)


def join(rank: int, size: int, device, store_path: str, ranks=None) -> Group:
    """Join the run's process group as ``rank`` of ``size``. Rank 0's waits
    on the others last at most ``WAIT_S``; theirs on rank 0 ``FOLLOW_S``."""
    device = torch.device(device)
    timeout = timedelta(seconds=WAIT_S if rank == 0 else FOLLOW_S)
    store = dist.FileStore(store_path, size)
    store.set_timeout(timeout)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank, world_size=size, timeout=timeout)
    gloo = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo", timeout=timeout)
    return Group(rank, size, device, program=dist.group.WORLD, gloo=gloo, store=store, ranks=ranks)


def leave() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


class Ranks:
    """Rank 0's handle on ranks 1..P-1: starts them, watches them from a
    thread, and stops them. ``hard`` (the command) ends rank 0's process at
    the first fault; otherwise (a test calling the harness in its own
    process) the other ranks are killed, so rank 0's next exchange with them
    fails and the run raises."""

    def __init__(self, size: int, argv, hard: bool):
        self.size, self.hard = size, hard
        self.dir = tempfile.mkdtemp(prefix="portbench-ranks-")
        self.store_path = os.path.join(self.dir, "store")
        self.expect_exit = False
        self.failed = None
        self._what = None
        self._deadline = None
        self._limit = 0.0
        self._done = threading.Event()
        self.procs = []
        for r in range(1, size):
            cmd = [sys.executable, str(RANK_SCRIPT), *argv, "--rank", str(r), "--world", str(size),
                   "--store", self.store_path, "--parent", str(os.getpid())]
            self.procs.append(subprocess.Popen(cmd, stdout=2, stdin=subprocess.DEVNULL))
        log(f"ranks: started {size - 1} more, pids {[p.pid for p in self.procs]}")
        self._thread = threading.Thread(target=self._watch, name="portbench-ranks", daemon=True)
        self._thread.start()

    def begin(self, what: str, limit: float) -> None:
        self._what, self._limit, self._deadline = what, limit, time.monotonic() + limit

    def end(self) -> None:
        self._deadline = None

    def _watch(self) -> None:
        while not self._done.wait(POLL_S):
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc is not None and (rc != 0 or not self.expect_exit):
                    self.fail(f"rank {r} exited with code {rc}")
                    return
            deadline = self._deadline
            if deadline is not None and time.monotonic() > deadline:
                self.fail(f"{self._what}: not done within {self._limit:.0f} s")
                return

    def fail(self, why: str) -> None:
        if self.failed is not None:
            return
        self.failed = why
        log(f"run failed: {why}; every rank is stopped")
        self.kill()
        if self.hard:
            shutil.rmtree(self.dir, ignore_errors=True)
            os._exit(1)

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass

    def stop(self) -> None:
        """Wait for the other ranks to exit (after ``Group.finish``), kill
        any left, and remove the run's directory."""
        self._done.set()
        t_end = time.monotonic() + (WAIT_S if self.expect_exit and self.failed is None else 0)
        for p in self.procs:
            try:
                p.wait(timeout=max(0.0, t_end - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        self.kill()
        shutil.rmtree(self.dir, ignore_errors=True)


def die_with_parent(parent: int) -> None:
    """End this process when ``parent`` is gone: the kernel's parent-death
    signal where there is one, and a thread that looks for a new parent."""
    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass

    def watch():
        while True:
            if os.getppid() != parent:
                os._exit(1)
            time.sleep(1.0)

    if os.getppid() != parent:
        os._exit(1)
    threading.Thread(target=watch, name="portbench-parent", daemon=True).start()
