"""Public entry points of the hand-written kernels, with the JAX signatures.

The port's counterpart of ``repro/kernels/ops.py``.  There each wrapper
binds Pallas's ``interpret`` flag; here each kernel's own wrapper already
launches the CUDA kernel for tensors on a card and runs its plain PyTorch
version for CPU tensors (``repro_torch.api.kernels.pallas_interpret``), and
accepts ``block_q``, ``block_k`` and ``chunk`` as the JAX package does, so
this module re-exports them.  Results do not depend on those tile sizes.

Neither ``flash_attention`` nor ``ssd_scan`` has a backward kernel: each
raises ``RuntimeError`` where autograd would record it
(``records_grad``, exported here with ``refuse_grad``, the wrappers' own
check), so a caller that differentiates takes the plain route, as the model
does.
"""

from __future__ import annotations

from repro_torch.kernels._build import records_grad, refuse_grad
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.partition_reduce import partition_histogram, partition_kmeans
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = ["flash_attention", "partition_histogram", "partition_kmeans", "records_grad",
           "refuse_grad", "ssd_scan"]
