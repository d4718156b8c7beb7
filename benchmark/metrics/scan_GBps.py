"""Corpus bytes of every request completed in the window over the seconds
from the first request's start to the last one's end (a closed loop of
``Matcher.match_chunked`` requests)."""


def read(run):
    reqs = run.loop.requests if run.loop.kind == "chunked" else []
    if not reqs:
        return None
    return sum(r.nbytes for r in reqs) / (reqs[-1].t1 - reqs[0].t0) / 1e9
