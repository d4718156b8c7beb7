"""The scan kernels' share of their roofline, in %: the least time the
window's scans take at the HBM rate (``work.py``: each request's corpus
once, the dictionary's automaton once a request, 8 B a result row) over
the device time of the window's scan kernels in the trace.  Nothing is
read unless the trace holds one scan kernel for every shard of every
chunk of every request of the window (a capture that lost kernels would
read the share too high)."""

from benchmark import work


def read(run):
    t, loop = run.trace, run.loop
    if not run.card or t is None or loop.kind != "chunked" or \
            not loop.requests or not t.scan_s:
        return None
    launches = len(loop.requests) * loop.chunks * \
        run.cell.config["num_shards"]
    if t.scan_kernels != launches:
        return None
    nbytes = sum(work.scan_bytes(r.nbytes, run.states, len(r.rows))
                 for r in loop.requests)
    return 100.0 * work.least_seconds(nbytes) / t.scan_s
