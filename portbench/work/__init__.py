"""The work of each kernel the benchmark reads a roofline share of.

One module per kernel, named as the kernel's wrapper is named in the
program.  Each gives ``KERNELS``, the device function names (prefixes) whose
time is the kernel's, ``PRECISION``, the precision it computes in, and
``work(cfg, traffic)``: the ``(flops, bytes)`` that one pass of the cell's
app needs of it, from the cell's shapes alone: each input byte read once,
each output byte written once, and the operations the algorithm needs.
"""
