"""The scan kernels' share of their roofline, in %: the least time the
window's scans take at the HBM rate (``work.py``: each request's corpus
once, the dictionary's automaton once a request, 8 B a result row) over
the device time of the window's scan kernels in the trace.  Nothing is
read unless the trace holds one scan kernel for every scan launch the
program itself counted over the window (``trace.scan_launches``, read
before and after it), so a capture that lost kernels, which would read
the share too high, reads nothing; however many launches a shard and
chunk takes (a compacted scan's two phases, a rescan, a split shard)."""

from benchmark import work


def read(run):
    t, loop = run.trace, run.loop
    if not run.card or t is None or loop.kind != "chunked" or \
            not loop.requests or not t.scan_s:
        return None
    if not run.launches or t.scan_kernels != run.launches:
        return None
    nbytes = sum(work.scan_bytes(r.nbytes, run.states, len(r.rows))
                 for r in loop.requests)
    return 100.0 * work.least_seconds(nbytes) / t.scan_s
