"""Fault tolerance: step watchdog / straggler detection, preemption-safe
checkpointing and restart, after the reference package's runtime/fault.py.

Single-process simulation discipline: every mechanism is driven through the
same interfaces a multi-host deployment would use (per-host step timings fed
to the watchdog, SIGTERM -> checkpoint, restore), so the logic is testable
on one process. On a mesh the manager saves and restores each rank's
shards through the checkpoint's gather and slice.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, List, Optional

import numpy as np

import torch

from repro_torch.checkpoint import ckpt as CK
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class StragglerReport:
    step: int
    median_s: float
    slow_hosts: Dict[int, float]    # host_id -> step seconds


class Watchdog:
    """Flags hosts whose step time exceeds `threshold` x median over a
    sliding window — the exclusion candidates for elastic restart."""

    def __init__(self, threshold: float = 2.0, window: int = 16):
        self.threshold = threshold
        self.window = window
        self._times: Dict[int, List[float]] = {}
        self.reports: List[StragglerReport] = []

    def record(self, step: int, host_times: Dict[int, float]
               ) -> Optional[StragglerReport]:
        for h, t in host_times.items():
            self._times.setdefault(h, []).append(t)
            self._times[h] = self._times[h][-self.window:]
        med = float(np.median([np.median(v) for v in self._times.values()]))
        slow = {h: float(np.median(v)) for h, v in self._times.items()
                if np.median(v) > self.threshold * med}
        if slow:
            rep = StragglerReport(step, med, slow)
            self.reports.append(rep)
            return rep
        return None


class CheckpointManager:
    """Periodic + on-demand checkpointing with async writes and auto-resume."""

    def __init__(self, ckpt_dir: str, interval: int = 100,
                 async_: bool = True, mesh=None, spec_tree=None):
        self.dir = ckpt_dir
        self.interval = interval
        self.async_ = async_
        self.mesh, self.spec_tree = mesh, spec_tree
        self._pending = None

    def maybe_save(self, step: int, tree, extra=None, force: bool = False):
        if not force and (self.interval <= 0 or step % self.interval):
            return
        self.wait()
        self._pending = CK.save(self.dir, step, tree, extra=extra,
                                async_=self.async_, mesh=self.mesh,
                                spec_tree=self.spec_tree)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def latest_step(self):
        return CK.latest_step(self.dir)

    def restore(self, target_tree, step=None, device="cuda"):
        """The checkpoint restored onto this manager's mesh: each rank's
        slices under its spec_tree (the whole tree without a mesh)."""
        return CK.restore(self.dir, target_tree, step=step, device=device,
                          mesh=self.mesh, spec_tree=self.spec_tree)


class PreemptionGuard:
    """SIGTERM/SIGINT -> set a flag the train loop polls; the loop saves a
    final checkpoint and exits cleanly (TPU preemption semantics)."""

    def __init__(self, install: bool = False):
        self.preempted = False
        if install:
            signal.signal(signal.SIGTERM, self._handler)

    def _handler(self, signum, frame):   # pragma: no cover (signal path)
        self.preempted = True

    def trigger(self):                   # tests call this directly
        self.preempted = True


def run_train_loop(*, train_step: Callable, params, opt_state, pipeline,
                   n_steps: int, ckpt_mgr: Optional[CheckpointManager] = None,
                   watchdog: Optional[Watchdog] = None,
                   guard: Optional[PreemptionGuard] = None,
                   start_step: int = 0,
                   host_time_fn: Optional[Callable[[int], Dict[int, float]]]
                   = None,
                   on_metrics: Optional[Callable] = None,
                   fail_at: Optional[int] = None):
    """Generic fault-tolerant loop. `fail_at` injects a crash (tests). Each
    step's numpy batch is moved to the parameters' device; a step's time
    (fed to the watchdog) ends when its metrics are read back.

    Returns (params, opt_state, last_step_completed, metrics_history).
    """
    history = []
    step = start_step
    dev = tree_leaves(params)[0].device
    while step < n_steps:
        if guard is not None and guard.preempted:
            if ckpt_mgr:
                ckpt_mgr.maybe_save(step, {"params": params,
                                           "opt": opt_state},
                                    extra={"step": step}, force=True)
                ckpt_mgr.wait()
            return params, opt_state, step, history
        if fail_at is not None and step == fail_at:
            raise RuntimeError(f"injected failure at step {step}")
        batch = pipeline.batch_at(step)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        t0 = time.monotonic()
        params, opt_state, metrics = train_step(params, opt_state, batch,
                                                step)
        history.append({k: float(v) for k, v in metrics.items()})
        dt = time.monotonic() - t0
        if watchdog is not None:
            times = (host_time_fn(step) if host_time_fn
                     else {0: dt})
            watchdog.record(step, times)
        if on_metrics:
            on_metrics(step, history[-1])
        step += 1
        if ckpt_mgr:
            ckpt_mgr.maybe_save(step, {"params": params, "opt": opt_state},
                                extra={"step": step})
    if ckpt_mgr:
        ckpt_mgr.maybe_save(n_steps, {"params": params, "opt": opt_state},
                            extra={"step": n_steps}, force=True)
        ckpt_mgr.wait()
    return params, opt_state, step, history
