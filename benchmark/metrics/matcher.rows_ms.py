"""The chunk loop's own row work, ms a chunk of the traced window: the
program's spans ``stage:chunk.cut`` (a shard's rows of a chunk cut to its
body and moved to its base) and ``stage:chunk.concat`` (each shard's
parts joined before the merge), over the window's requests x chunks.

Not a metric of ``BENCHMARK.json`` any more: the cells take the ordered
result path, which opens no ``stage:chunk.cut``, and the per-shard path's
result stages are read by ``result.decode_ms``, ``result.join_ms`` and
``result.fetch_ms``.  Kept while ``tests/test_torch_span_metrics.py``
reads it by name: the change that rewrites that test deletes this file
with it, so that no second guard over the same spans stays beside
``benchmark/spans.py``."""


def window_spans(run):
    """The program's spans and counters of the traced window, or None:
    the capture starts after the warm-up and ends before the serial
    pass, and the program records only under a capture, so its totals
    are the window's.  None unless they hold one ``stage:chunk.cut`` a
    shard, chunk and request and one ``stage:chunk.concat`` a request (a
    program without these spans reads nothing)."""
    loop = run.loop
    if run.trace is None or loop.kind != "chunked" or not loop.requests:
        return None
    from phfpfac_tpu_torch.utils import profile

    if not hasattr(profile, "snapshot"):
        return None
    snap = profile.snapshot()
    n = len(loop.requests)
    calls = {k: v[1] for k, v in snap["spans"].items()}
    if calls.get("stage:chunk.concat") != n or calls.get(
            "stage:chunk.cut") != n * loop.chunks * \
            run.cell.config["num_shards"]:
        return None
    return snap, n * loop.chunks


def seconds(snap, *names):
    return sum(snap["spans"].get(f"stage:{k}", (0.0, 0))[0] for k in names)


def read(run):
    got = window_spans(run)
    if got is None:
        return None
    snap, chunks = got
    return seconds(snap, "chunk.cut", "chunk.concat") / chunks * 1e3
