"""The plan-table build's fill (tables, prologue, banks and step specs),
seconds an invocation of the traced window: the program's span
``stage:tables.fill``, summed over the invocation's shards, over the
window's invocations."""


def window_spans(run):
    """The program's spans of the traced window, or None: the capture
    starts after the warm-up, and the program records only under a
    capture, so its totals are the window's.  Read only in a run on the
    card (a CPU rehearsal of the cell reports the build's two host
    clocks alone, as ``benchmark/tests/test_bench_wrapped.py`` holds it
    to), and only where the spans hold one ``stage:tables.fill`` a shard
    and invocation (a program without these spans reads nothing)."""
    loop = run.loop
    if not run.card or run.trace is None or loop.kind != "invoke" or \
            not loop.invocations:
        return None
    from phfpfac_tpu_torch.utils import profile

    if not hasattr(profile, "snapshot"):
        return None
    snap = profile.snapshot()
    n = len(loop.invocations)
    fill = snap["spans"].get("stage:tables.fill", (0.0, 0))[1]
    if fill != n * run.cell.config["num_shards"]:
        return None
    return snap, n


def read(run):
    got = window_spans(run)
    if got is None:
        return None
    snap, n = got
    return snap["spans"].get("stage:tables.fill", (0.0, 0))[0] / n
