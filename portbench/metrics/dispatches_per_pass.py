"""dispatches_per_pass: the ``EngineReport.dispatches`` of the window's
executes, summed, over its passes (the plan and lowering layer's task count)."""


def read(w):
    return sum(r.dispatches for r in w.reports) / w.passes if w.passes else None
