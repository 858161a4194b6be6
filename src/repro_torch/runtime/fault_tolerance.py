"""Fault tolerance: heartbeat failure detection, restart policy, elastic
remesh planning.

The port's own copy of ``repro.runtime.fault_tolerance`` (plain Python,
the same behaviour on the same call sequence; tests/test_torch_ckpt_data.py
holds it to the original).

On a real multi-pod deployment the coordinator runs next to the
distributed runtime's service; worker liveness comes from heartbeats, and recovery is
checkpoint-restart with a (possibly smaller) elastic mesh.  The full control
loop is implemented here and driven in-process by tests and by
``launch/train.py --simulate-failures`` (this container has one host, so
failures are injected rather than real — the state machine is the part that
must be correct).
"""
from __future__ import annotations

import dataclasses
import time
from enum import Enum
from typing import Callable, List, Optional, Tuple

__all__ = [
    "WorkerState", "Worker", "HeartbeatMonitor", "RestartPolicy",
    "plan_elastic_mesh", "TrainingSupervisor", "WorkerFailure",
]


class WorkerState(str, Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclasses.dataclass
class Worker:
    worker_id: int
    last_heartbeat: float
    state: WorkerState = WorkerState.HEALTHY
    incarnation: int = 0


class HeartbeatMonitor:
    """suspect after `suspect_s` without heartbeat, dead after `dead_s`.

    The clock is injected and mandatory: the same state machine runs on
    wall time in a real deployment and on the DES clock inside the fleet
    simulator, and a silent ``time.time`` fallback would let real time
    leak into simulations.
    """

    def __init__(self, n_workers: int, suspect_s: float = 10.0,
                 dead_s: float = 30.0, *, clock: Callable[[], float]):
        self.clock = clock
        now = clock()
        self.workers = {i: Worker(i, now) for i in range(n_workers)}
        self.suspect_s = suspect_s
        self.dead_s = dead_s

    def heartbeat(self, worker_id: int):
        w = self.workers[worker_id]
        w.last_heartbeat = self.clock()
        if w.state != WorkerState.DEAD:
            w.state = WorkerState.HEALTHY

    def sweep(self) -> List[int]:
        """Advance states; returns newly-dead worker ids."""
        now = self.clock()
        newly_dead = []
        for w in self.workers.values():
            dt = now - w.last_heartbeat
            if w.state == WorkerState.DEAD:
                continue
            if dt >= self.dead_s:
                w.state = WorkerState.DEAD
                newly_dead.append(w.worker_id)
            elif dt >= self.suspect_s:
                w.state = WorkerState.SUSPECT
        return newly_dead

    def revive(self, worker_id: int):
        w = self.workers[worker_id]
        w.state = WorkerState.HEALTHY
        w.incarnation += 1
        w.last_heartbeat = self.clock()

    def healthy_ids(self) -> List[int]:
        return [w.worker_id for w in self.workers.values()
                if w.state == WorkerState.HEALTHY]


@dataclasses.dataclass
class RestartPolicy:
    """Exponential backoff with a failure budget (fleet-standard)."""
    max_restarts: int = 100
    window_s: float = 3600.0
    base_backoff_s: float = 5.0
    max_backoff_s: float = 300.0

    def __post_init__(self):
        self.history: List[float] = []

    def should_restart(self, now: float) -> bool:
        self.history = [t for t in self.history if now - t < self.window_s]
        return len(self.history) < self.max_restarts

    def next_backoff(self, now: float) -> float:
        recent = [t for t in self.history if now - t < self.window_s]
        return min(self.base_backoff_s * (2 ** len(recent) if recent else 1),
                   self.max_backoff_s)

    def record_failure(self, now: float):
        self.history.append(now)


def plan_elastic_mesh(n_healthy_pods: int, chips_per_pod: int = 256,
                      model_axis: int = 16) -> Tuple[Tuple[int, ...],
                                                     Tuple[str, ...]]:
    """Elastic remesh: keep the model axis intact (weight shards must stay
    complete); shrink/grow the data(+pod) axes to the healthy pod count.
    Batch is re-sharded by the data pipeline; optimizer state re-shards via
    checkpoint restore with the new specs."""
    if n_healthy_pods < 1:
        raise ValueError("no healthy pods")
    data_axis = chips_per_pod // model_axis
    if n_healthy_pods == 1:
        return (data_axis, model_axis), ("data", "model")
    return (n_healthy_pods, data_axis, model_axis), ("pod", "data", "model")


class TrainingSupervisor:
    """The restart state machine: run -> (failure) -> restore -> resume.

    `run_step` raises WorkerFailure to simulate/surface a fault; the
    supervisor restores from the last complete checkpoint and replays.
    """

    def __init__(self, policy: RestartPolicy, save_every: int,
                 checkpointer, monitor: Optional[HeartbeatMonitor] = None,
                 clock: Callable[[], float] = time.time):
        self.policy = policy
        self.save_every = save_every
        self.ckpt = checkpointer
        self.monitor = monitor
        self.clock = clock
        self.restarts = 0

    def run(self, state, step: int, n_steps: int, run_step, make_batch,
            restore_fn):
        while step < n_steps:
            try:
                state, metrics = run_step(state, make_batch(step))
                step += 1
                if step % self.save_every == 0:
                    self.ckpt.save(step, state, {"step": step})
            except WorkerFailure as e:
                now = self.clock()
                self.policy.record_failure(now)
                if not self.policy.should_restart(now):
                    raise RuntimeError("failure budget exhausted") from e
                self.restarts += 1
                state, step = restore_fn()
        self.ckpt.wait() if hasattr(self.ckpt, "wait") else None
        return state, step


class WorkerFailure(RuntimeError):
    def __init__(self, worker_id: int, msg: str = ""):
        super().__init__(f"worker {worker_id} failed {msg}")
        self.worker_id = worker_id
