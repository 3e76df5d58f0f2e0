"""repro_torch.api — the lazy Collection/Executor execution layer (DESIGN.md §3–§5).

The curated ``__all__`` below lists what this package has ported so far:

* :class:`Collection` — fluent, lazy plan builder over blocked arrays:
  ``Collection.from_array(...).split(policy).map_blocks(fn).reduce(c)``.
* :class:`ExecutionPolicy` and its concrete policies :class:`Baseline`,
  :class:`SplIter` (with its ``fusion="auto"|"scan"|"pallas"`` knob;
  ``"pallas"`` selects the hand-written CUDA kernel), :class:`Rechunk`.
* The two-stage execution split: a **lowering pass** (:func:`lower`)
  turns ``(plan, policy, backend Capabilities)`` into a frozen
  :class:`TaskGraph` of placed, keyed :class:`Task` descriptors;
  :class:`LocalExecutor` schedules it sequentially and reports costs via
  :class:`~repro_torch.core.engine.EngineReport`.
* The chunk tier's in-memory half: :class:`ChunkRef` handles resolved at
  dispatch time, behind an :class:`InMemoryStore`.
* :class:`PartitionKernel` / :func:`register_partition_kernel` — the
  registry through which a ``map_blocks`` fn declares a fused partition
  kernel (one kernel launch per partition run).
* The adaptive-granularity loop: a :class:`ProfileStore` per executor and
  an :class:`Autotuner` behind ``SplIter(partitions_per_location="auto")``.
"""

from repro_torch.api.autotune import Autotuner, CostModel, fit_cost_model
from repro_torch.api.chunkstore import ChunkRef, InMemoryStore, resolve_chunk
from repro_torch.api.collection import Collection
from repro_torch.api.executors import (
    ComputeResult,
    Executor,
    LocalExecutor,
    PartitionView,
    PrepareStats,
)
from repro_torch.api.futures import ComputeFuture, Deferred, PipelineBrokenError
from repro_torch.api.kernels import (
    PartitionKernel,
    pallas_interpret,
    partition_kernel_for,
    register_partition_kernel,
)
from repro_torch.api.lowering import (
    Capabilities,
    Task,
    TaskGraph,
    inputs_signature,
    lower,
    stable_task_key,
    stacked_fold,
)
from repro_torch.api.plan import ExecutionPlan, PlanError
from repro_torch.api.policy import Baseline, ExecutionPolicy, Rechunk, SplIter, as_policy
from repro_torch.api.profile import ProfileEvent, ProfileStore, TaskProfile

__all__ = [
    "Collection",
    "ComputeResult",
    "ComputeFuture",
    "Deferred",
    "PipelineBrokenError",
    "Executor",
    "LocalExecutor",
    "inputs_signature",
    "ChunkRef",
    "InMemoryStore",
    "resolve_chunk",
    "PartitionView",
    "PrepareStats",
    "Autotuner",
    "CostModel",
    "fit_cost_model",
    "ProfileEvent",
    "ProfileStore",
    "TaskProfile",
    "stacked_fold",
    "Capabilities",
    "Task",
    "TaskGraph",
    "lower",
    "stable_task_key",
    "PartitionKernel",
    "register_partition_kernel",
    "partition_kernel_for",
    "pallas_interpret",
    "ExecutionPlan",
    "PlanError",
    "Baseline",
    "ExecutionPolicy",
    "Rechunk",
    "SplIter",
    "as_policy",
]
