"""Seconds an invocation: the span from the first invocation's start to
the last one's end over the invocations completed in it (the one in
flight at the close completes and counts)."""


def read(run):
    reqs = run.loop.requests if run.loop.kind == "invoke" else []
    if not reqs:
        return None
    return (reqs[-1].t1 - reqs[0].t0) / len(reqs)
