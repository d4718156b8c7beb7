"""The device's idle share of the traced window of ``match_chunked``
requests, in %: 100 x (1 - the union of its kernels, copies and sets /
the window)."""


def read(run):
    if not run.card or run.trace is None or run.loop.kind != "chunked":
        return None
    return run.trace.idle_pct
