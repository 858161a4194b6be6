"""Straggler mitigation.

The port's own copy of ``repro.runtime.straggler`` (plain Python, held to
the original by tests/test_torch_ckpt_data.py).

Two standard mechanisms, both implemented:

1. Detection — per-worker step-time EWMA; a worker whose step time exceeds
   `threshold` x the fleet median is flagged.  On TPU pods stragglers are
   usually a host (input pipeline) or a chip (thermal), and the remedy is
   checkpoint-restart without that pod (plan_elastic_mesh) or input
   re-balancing.
2. Backup workers (speculative execution) for the INPUT pipeline — the
   slowest k hosts' shards are replicated on spare hosts; first result
   wins.  (Compute itself is SPMD-synchronous on TPU — backup execution
   applies to data loading, not the compiled step.)
"""
from __future__ import annotations

import dataclasses
import statistics
from collections import defaultdict
from typing import Dict, List, Optional


@dataclasses.dataclass
class StragglerReport:
    worker_id: int
    ewma_s: float
    fleet_median_s: float

    @property
    def slowdown(self) -> float:
        return self.ewma_s / max(self.fleet_median_s, 1e-9)


class StragglerDetector:
    def __init__(self, n_workers: int, alpha: float = 0.2,
                 threshold: float = 1.5, min_samples: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.min_samples = min_samples
        self.ewma: Dict[int, Optional[float]] = {i: None
                                                 for i in range(n_workers)}
        self.counts: Dict[int, int] = defaultdict(int)

    def record(self, worker_id: int, step_time_s: float):
        prev = self.ewma[worker_id]
        self.ewma[worker_id] = (step_time_s if prev is None
                                else (1 - self.alpha) * prev
                                + self.alpha * step_time_s)
        self.counts[worker_id] += 1

    def stragglers(self) -> List[StragglerReport]:
        vals = [v for v in self.ewma.values() if v is not None]
        if not vals:
            return []
        med = statistics.median(vals)
        out = []
        for wid, v in self.ewma.items():
            if v is None or self.counts[wid] < self.min_samples:
                continue
            if v > self.threshold * med:
                out.append(StragglerReport(wid, v, med))
        return out


class BackupInputRunner:
    """Speculative input fetch: start the shard read on the primary and, if
    it has straggled before, on a spare; take whichever returns first.
    Synchronous model (single-threaded container) — the policy logic is
    what's under test."""

    def __init__(self, detector: StragglerDetector, n_spares: int = 1):
        self.detector = detector
        self.n_spares = n_spares
        self.speculated = 0
        self.wins_by_backup = 0

    def fetch(self, worker_id: int, primary_fn, backup_fn=None,
              primary_time: float = 0.0, backup_time: float = 0.0):
        slow = {r.worker_id for r in self.detector.stragglers()}
        if worker_id in slow and backup_fn is not None and self.n_spares:
            self.speculated += 1
            if backup_time < primary_time:
                self.wins_by_backup += 1
                self.detector.record(worker_id, backup_time)
                return backup_fn()
        self.detector.record(worker_id, primary_time)
        return primary_fn()
