"""repro_torch — the SplIter reproduction on PyTorch and CUDA.

The PyTorch port of the ``repro`` package, module for module
(``repro/api/lowering.py`` is ``repro_torch/api/lowering.py``).  It
imports ``torch`` and numpy only.  The card is the default device:
constructors take ``device=`` and raise when no GPU is present unless the
caller asks for ``device="cpu"``; everything after construction follows
the data's device.

The fused partition kernels (``repro_torch.kernels.partition_reduce``) are
CUDA C++ for Hopper (``csrc/*.cu``), compiled with ``nvcc`` at first use;
on a CPU tensor each wrapper runs its plain PyTorch version instead.
"""
