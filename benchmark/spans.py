"""The program's spans and counters over a traced window of
``match_chunked`` requests, as the result path's readers
(``metrics/result.*``) take them: only where they cover every request
and chunk of the window, on either of the program's two result paths.

A window of ``n`` requests of ``C`` chunks over ``S`` shards records:

* on the per-shard path (every shard's rows cut and joined): one
  ``stage:chunk.cut`` a shard, chunk and request, one
  ``stage:chunk.concat`` a request;
* on the ordered path (``Matcher._takes_ordered``: each chunk's rows
  decoded at once, in order): the counter ``merge.ordered`` once a
  request, one ``stage:result.decode`` a chunk and request, one
  ``stage:result.fetch`` a shard, chunk and request, and no cut.  The
  fetches and ``merge.ordered`` already show that every shard of every
  chunk was resolved.  The fetches are also held to the scan launches
  the program counted in the window (``Run.launches``), at least one a
  fetch, for one reason only: ``tests/test_torch_span_metrics.py``
  (``test_text_guard``, ``test_rehearsal_prints_what_it_reads``) holds
  the readers to read nothing on a CPU run of this path, whose plain
  scans launch nothing.  The condition adds no coverage; it goes with
  those tests' rewrite.

The capture starts after the warm-up and ends before the serial pass,
and the program records only under a capture, so its totals are the
window's.
"""

from __future__ import annotations


def result_window(run):
    """(the program's snapshot, chunks of the window), or None where the
    spans do not cover the window (or the program has none)."""
    loop = run.loop
    if run.trace is None or loop.kind != "chunked" or not loop.requests:
        return None
    from phfpfac_tpu_torch.utils import profile

    if not hasattr(profile, "snapshot"):
        return None
    snap = profile.snapshot()
    n = len(loop.requests)
    chunks = n * loop.chunks
    shards = run.cell.config["num_shards"]
    calls = {k: v[1] for k, v in snap["spans"].items()}
    per_shard = calls.get("stage:chunk.cut") == chunks * shards and \
        calls.get("stage:chunk.concat") == n
    ordered = "stage:chunk.cut" not in calls and \
        snap["counters"].get("merge.ordered") == n and \
        calls.get("stage:result.decode") == chunks and \
        calls.get("stage:result.fetch") == chunks * shards and \
        (run.launches or 0) >= chunks * shards
    if not (per_shard or ordered):
        return None
    return snap, chunks


def ms_a_chunk(run, *names):
    """Host ms a chunk of the window in the spans ``names`` together, or
    None where the window is not covered or none of them was opened."""
    got = result_window(run)
    if got is None:
        return None
    snap, chunks = got
    spans = [snap["spans"][k] for k in names if k in snap["spans"]]
    if not spans:
        return None
    return sum(s[0] for s in spans) / chunks * 1e3
