"""repro_torch.api — the lazy Collection/Executor execution layer (DESIGN.md §3–§5).

The curated ``__all__`` below holds every name of the JAX package's
``repro.api``:

* :func:`engine` / :class:`EngineConfig` / :data:`BACKENDS` — the one
  construction path for every backend (``with engine("mesh") as ex:``).
* :class:`Collection` — fluent, lazy plan builder over blocked arrays:
  ``Collection.from_array(...).split(policy).map_blocks(fn).reduce(c)``.
* :class:`ExecutionPolicy` and its concrete policies :class:`Baseline`,
  :class:`SplIter` (with its ``fusion="auto"|"scan"|"pallas"`` knob;
  ``"pallas"`` selects the hand-written CUDA kernel), :class:`Rechunk`.
* The two-stage execution split: a **lowering pass** (:func:`lower`)
  turns ``(plan, policy, backend Capabilities)`` into a frozen
  :class:`TaskGraph` of placed, keyed :class:`Task` descriptors;
  :class:`LocalExecutor` schedules it sequentially, :class:`ThreadedExecutor`
  on a persistent worker thread per location (its ``execute_async``
  overlaps consecutive submissions), :class:`StreamExecutor` in plan order
  with a prefetch thread that loads partition *k+1* while *k* computes
  (out-of-core, DESIGN.md §10), :class:`MeshExecutor` as one sharded
  dispatch per same-signature task run over a list of devices (DESIGN.md
  §5.4), :class:`ClusterExecutor` in spawned worker processes, each
  computing on the card in its own CUDA context, with operands and
  partials over POSIX shared memory (:class:`ShmStore`,
  :class:`ShmBlockRef`, :class:`ShmAttachments`, :func:`shm_available`),
  picklable :class:`TaskSpec` descriptors, deterministic replay of a dead
  worker's units (:class:`FaultPlan`, :class:`ClusterFailedError`), work
  stealing and autoscaling (:class:`ChaosSchedule`), and all report costs
  via :class:`~repro_torch.core.engine.EngineReport`.
* The job service: a :class:`JobServer` multiplexes many tenants' plans
  onto one executor at unit granularity (stride fairness, admission
  control, :class:`SharedAssets`), journals them in a :class:`JobJournal`
  and resumes them after a restart; a :class:`JobClient` is a tenant's
  Executor-shaped handle.
* The chunk tier: :class:`ChunkRef` handles resolved at dispatch time,
  behind the :class:`ChunkStore` contract — an :class:`InMemoryStore`, or
  a :class:`DiskStore` with a residency budget on the card that spills to
  ``.npy`` files (evicting a pinned chunk raises
  :class:`ChunkPinnedError`), its counters in :class:`StoreStats`; a
  worker process reads a store through its :class:`StoreManifest` as an
  :class:`AttachedStore`, chunk by :class:`ChunkHandle`.
* :class:`PartitionKernel` / :func:`register_partition_kernel` — the
  registry through which a ``map_blocks`` fn declares a fused partition
  kernel (one kernel launch per partition run).
* The adaptive-granularity loop: a :class:`ProfileStore` per executor and
  an :class:`Autotuner` behind ``SplIter(partitions_per_location="auto")``.
"""

from repro_torch.api.autotune import Autotuner, CostModel, fit_cost_model
from repro_torch.api.chunkstore import (
    AttachedStore,
    ChunkHandle,
    ChunkPinnedError,
    ChunkRef,
    ChunkStore,
    ChunkStoreError,
    DiskStore,
    InMemoryStore,
    StoreManifest,
    StoreStats,
    resolve_chunk,
)
from repro_torch.api.cluster_executor import (
    ChaosSchedule,
    ClusterExecutor,
    ClusterFailedError,
    FaultPlan,
)
from repro_torch.api.collection import Collection
from repro_torch.api.executors import (
    ComputeResult,
    Executor,
    LocalExecutor,
    PartitionView,
    PrepareStats,
    SharedAssets,
    ThreadedExecutor,
)
from repro_torch.api.factory import BACKENDS, EngineConfig, engine
from repro_torch.api.fnref import decode_fn, encode_fn
from repro_torch.api.futures import ComputeFuture, Deferred, PipelineBrokenError
from repro_torch.api.jobclient import JobClient
from repro_torch.api.jobserver import Job, JobEvent, JobFailedError, JobRejected, JobServer
from repro_torch.api.journal import JobJournal
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
    TaskSpec,
    inputs_signature,
    lower,
    plan_fingerprint,
    stable_task_key,
    stacked_fold,
)
from repro_torch.api.mesh_executor import MeshExecutor
from repro_torch.api.plan import ExecutionPlan, PlanError
from repro_torch.api.policy import Baseline, ExecutionPolicy, Rechunk, SplIter, as_policy
from repro_torch.api.profile import ProfileEvent, ProfileStore, TaskProfile
from repro_torch.api.shm import ShmAttachments, ShmBlockRef, ShmStore, shm_available
from repro_torch.api.stream_executor import StreamExecutor

__all__ = [
    # the blessed construction path (DESIGN.md §16)
    "engine",
    "EngineConfig",
    "BACKENDS",
    "Collection",
    "ComputeResult",
    "ComputeFuture",
    "Deferred",
    "PipelineBrokenError",
    "Executor",
    "LocalExecutor",
    "ThreadedExecutor",
    "MeshExecutor",
    "StreamExecutor",
    "ClusterExecutor",
    "ClusterFailedError",
    "FaultPlan",
    "ChaosSchedule",
    "JobServer",
    "JobClient",
    "Job",
    "JobEvent",
    "JobRejected",
    "JobFailedError",
    "JobJournal",
    "SharedAssets",
    "inputs_signature",
    "plan_fingerprint",
    "ChunkRef",
    "ChunkHandle",
    "StoreManifest",
    "AttachedStore",
    "ChunkStore",
    "ChunkStoreError",
    "ChunkPinnedError",
    "InMemoryStore",
    "DiskStore",
    "StoreStats",
    "resolve_chunk",
    "ShmStore",
    "ShmBlockRef",
    "ShmAttachments",
    "shm_available",
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
    "TaskSpec",
    "lower",
    "stable_task_key",
    "encode_fn",
    "decode_fn",
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
