"""Analysis: collective census + three-term roofline (the reference's DESIGN.md §6).

Port of ``repro/analysis``: ``hlo.py`` (copied; :class:`CollectiveStats` is
also the form of the port's collective census) and ``roofline.py`` (the
hardware figures are a named set, :data:`~repro_torch.analysis.roofline.H100_SXM`
by default).
"""
