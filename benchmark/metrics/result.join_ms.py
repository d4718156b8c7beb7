"""The result path's joins, ms a chunk of the traced window: the
program's spans ``stage:merge.concat`` (the merge's concatenations; on
the ordered path the chunks' blocks joined, once a request) and
``stage:chunk.concat`` (each shard's parts joined, on the per-shard
path), over the window's requests x chunks (``spans.result_window``)."""

from benchmark import spans


def read(run):
    return spans.ms_a_chunk(run, "stage:merge.concat", "stage:chunk.concat")
