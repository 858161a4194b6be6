"""Runtime subsystems of the training driver: fault tolerance (restart
policy, heartbeats, elastic remesh plan) and straggler detection.  Own
copies of ``repro.runtime.fault_tolerance`` and ``repro.runtime.straggler``
(the reference's gradient compression and paged KV allocator are not
ported here)."""
from .fault_tolerance import (HeartbeatMonitor, RestartPolicy, TrainingSupervisor, Worker,
                              WorkerFailure, WorkerState, plan_elastic_mesh)
from .straggler import BackupInputRunner, StragglerDetector, StragglerReport

__all__ = ["BackupInputRunner", "HeartbeatMonitor", "RestartPolicy", "StragglerDetector",
           "StragglerReport", "TrainingSupervisor", "Worker", "WorkerFailure", "WorkerState",
           "plan_elastic_mesh"]
