"""dispatch_ms_per_pass: the host time until the executor's dispatches
returned (``ProfileEvent.dispatch_s`` in its ``ProfileStore``) over the
window, per pass."""


def read(w):
    return 1e3 * w.dispatch_s / w.passes if w.passes else None
