"""Runtime subsystems of the training driver: fault tolerance (restart
policy, heartbeats, elastic remesh plan), straggler detection and the int8
error-feedback gradient compression of the data-parallel all-reduce.  Own
copies of ``repro.runtime.fault_tolerance``, ``repro.runtime.straggler``
and ``repro.runtime.compression`` (the reference's paged KV allocator
serves its simulator and is not ported here)."""
from .compression import (compress_with_feedback, compressed_allreduce, compressed_psum,
                          decompress, dequantize_int8, init_error_state, quantize_int8)
from .fault_tolerance import (HeartbeatMonitor, RestartPolicy, TrainingSupervisor, Worker,
                              WorkerFailure, WorkerState, plan_elastic_mesh)
from .straggler import BackupInputRunner, StragglerDetector, StragglerReport

__all__ = ["BackupInputRunner", "HeartbeatMonitor", "RestartPolicy", "StragglerDetector",
           "StragglerReport", "TrainingSupervisor", "Worker", "WorkerFailure", "WorkerState",
           "compress_with_feedback", "compressed_allreduce", "compressed_psum", "decompress",
           "dequantize_int8", "init_error_state", "plan_elastic_mesh", "quantize_int8"]
