"""The result path's decode, ms a chunk of the traced window: the
program's span ``stage:result.decode`` (``decode_hits``: a shard's hits,
or on the ordered path every shard's hits of a chunk at once, into
rows), over the window's requests x chunks (``spans.result_window``)."""

from benchmark import spans


def read(run):
    return spans.ms_a_chunk(run, "stage:result.decode")
