"""The paper's four evaluation applications (§5), on the repro_torch.api layer.

Each app takes ``policy: ExecutionPolicy`` (Baseline / SplIter / Rechunk)
and an optional ``executor`` (LocalExecutor / ThreadedExecutor); legacy
mode strings are still coerced via :func:`repro_torch.api.as_policy`.
"""

from repro_torch.core.apps.histogram import histogram
from repro_torch.core.apps.kmeans import kmeans
from repro_torch.core.apps.cascade_svm import cascade_svm
from repro_torch.core.apps.knn import knn

__all__ = ["histogram", "kmeans", "cascade_svm", "knn"]
