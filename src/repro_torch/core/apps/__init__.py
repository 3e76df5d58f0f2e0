"""The paper's memory-bound evaluation applications (§5), on the repro_torch.api layer.

Each app takes ``policy: ExecutionPolicy`` (Baseline / SplIter / Rechunk)
and an optional ``executor``; legacy mode strings are still coerced via
:func:`repro_torch.api.as_policy`.
"""

from repro_torch.core.apps.histogram import histogram
from repro_torch.core.apps.kmeans import kmeans

__all__ = ["histogram", "kmeans"]
