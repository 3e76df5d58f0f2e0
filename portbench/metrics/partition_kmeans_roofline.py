"""partition_kmeans_roofline: the least time an iteration's k-means work needs
on the card (``portbench/work/partition_kmeans.py``) over the device time of
the kernel's launches, in percent."""

from portbench.harness import roofline_pct


def read(w):
    return roofline_pct(w, "partition_kmeans")
