"""pass_ms: the window's wall time over the passes it completed (a histogram
call is one pass, a k-means iteration one)."""


def read(w):
    return 1e3 * w.seconds / w.passes if w.passes else None
