"""Fault tolerance: the supervisor loop, straggler detection, restarts.

The supervisor wraps a train loop with the JAX package's logic (its
``train.fault``):

 * **checkpoint/restart** — on any step failure, restore the latest
   committed checkpoint into the state (or, with ``shardings``, onto a
   mesh: elastic restore) and replay from the step after it (the data
   source is step-addressable, so replay is deterministic);
   with no checkpoint yet, replay the failed step from the state in
   memory, which a failed step leaves as it was
   (``train.train_state``);
 * **retry budget** — failures retry; after ``max_restarts`` the last
   one is re-raised;
 * **straggler detection** — a step slower than ``straggler_factor ×``
   the moving median of the last ``straggler_window`` is recorded as
   skipped-and-repaired.

A step's time is taken on the host clock up to a synchronize of the
card, so it is the step's real time, not its launch time.  On CPU tests
failures are injected through ``fault_injector``.
"""

from __future__ import annotations

import logging
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from .checkpoint import (cleanup_old, flatten_tree, latest_step,
                         restore_checkpoint, save_checkpoint)

log = logging.getLogger("repro_torch.fault")


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class FaultConfig:
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 5
    straggler_factor: float = 3.0
    straggler_window: int = 20
    async_ckpt: bool = True


@dataclass
class StragglerMonitor:
    """Deadline-based straggler detection over a moving median."""

    factor: float = 3.0
    window: int = 20
    times: list[float] = field(default_factory=list)
    skipped_steps: list[int] = field(default_factory=list)

    def deadline(self) -> float | None:
        if len(self.times) < 5:
            return None
        return float(np.median(self.times[-self.window:])) * self.factor

    def record(self, dt: float) -> None:
        self.times.append(dt)

    def is_straggler(self, dt: float) -> bool:
        d = self.deadline()
        return d is not None and dt > d

    def skip_and_repair(self, step: int) -> None:
        """Mark the step's slow shard skipped; repair = re-enqueue."""
        self.skipped_steps.append(step)


def _synchronize(tree: Any) -> None:
    """Wait for the card that holds ``tree``'s first tensor, if any."""
    for leaf in flatten_tree(tree).values():
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type == "cuda":
                torch.cuda.synchronize(leaf.device)
            return


class Supervisor:
    """Run a train loop under fault tolerance.

    ``step_fn(state, batch) → (state, metrics)``; ``data_fn(step) →
    batch`` must be step-addressable (deterministic replay after a
    restore).  ``restarts`` counts the failures recovered from.
    """

    def __init__(self, cfg: FaultConfig, step_fn: Callable,
                 data_fn: Callable[[int], Any],
                 fault_injector: Callable[[int], None] | None = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.data_fn = data_fn
        self.fault_injector = fault_injector
        self.monitor = StragglerMonitor(cfg.straggler_factor,
                                        cfg.straggler_window)
        self.restarts = 0
        self.pending_ckpt = None

    def _save(self, step: int, state: Any) -> None:
        if self.pending_ckpt is not None:
            self.pending_ckpt.join()
        self.pending_ckpt = save_checkpoint(
            self.cfg.ckpt_dir, step, state,
            blocking=not self.cfg.async_ckpt)
        cleanup_old(self.cfg.ckpt_dir, self.cfg.keep)

    def _restore(self, state: Any, shardings: Any | None
                 ) -> tuple[int | None, Any]:
        """(the step to resume from, or None where there is no
        checkpoint; the state restored into ``state``, placed by
        ``shardings`` where given)."""
        if self.pending_ckpt is not None:
            self.pending_ckpt.join()
        if dist.is_available() and dist.is_initialized():
            dist.barrier()      # every rank's last save is committed
        step = latest_step(self.cfg.ckpt_dir)
        if step is None:
            return None, state
        return step + 1, restore_checkpoint(self.cfg.ckpt_dir, step, state,
                                            shardings)

    def run(self, state: Any, n_steps: int, shardings: Any | None = None,
            on_metrics: Callable[[int, dict], None] | None = None) -> Any:
        """Run ``n_steps`` from step 0.  ``shardings`` (a tree of
        ``sharding.named`` placements matching ``state``) places a
        restored state on its mesh, which may differ from the one that
        saved; without it a restore writes into ``state`` in place."""
        step = 0
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                if self.fault_injector is not None:
                    self.fault_injector(step)
                batch = self.data_fn(step)
                state, metrics = self.step_fn(state, batch)
                _synchronize(metrics or state)
                dt = time.perf_counter() - t0
                if self.monitor.is_straggler(dt):
                    log.warning("step %d straggled (%.3fs) — shard "
                                "skip-and-repair", step, dt)
                    self.monitor.skip_and_repair(step)
                self.monitor.record(dt)
                if on_metrics:
                    on_metrics(step, metrics)
                if (step + 1) % self.cfg.ckpt_every == 0:
                    self._save(step, state)
                step += 1
            except Exception as e:  # noqa: BLE001 — supervisor boundary
                self.restarts += 1
                log.error("step %d failed (%s); restart %d/%d", step,
                          type(e).__name__, self.restarts,
                          self.cfg.max_restarts)
                if self.restarts > self.cfg.max_restarts:
                    raise
                resumed, restored = self._restore(state, shardings)
                if resumed is not None:
                    step, state = resumed, restored
                # else: replay from the state in memory
        if self.pending_ckpt is not None:
            self.pending_ckpt.join()
        return state
