"""partition_histogramdd_roofline: the least time the pass's histogram work
needs on the card (``portbench/work/partition_histogramdd.py``) over the
device time of the kernel's launches, in percent."""

from portbench.harness import roofline_pct


def read(w):
    return roofline_pct(w, "partition_histogramdd")
