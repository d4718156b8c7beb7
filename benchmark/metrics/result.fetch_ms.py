"""The result download, ms a chunk of the traced window: the program's
span ``stage:result.fetch`` (``fetch_hit_bits``: the ``nonzero`` over a
shard's bitmap and the copy of its (position, bitmap) pairs to the
host), over the window's requests x chunks (``spans.result_window``)."""

from benchmark import spans


def read(run):
    return spans.ms_a_chunk(run, "stage:result.fetch")
