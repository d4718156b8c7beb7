"""The result download, MB a chunk of the traced window: the program's
counter ``fetch.bytes`` (each ``fetch_hit_bits`` call's (position,
bitmap) pairs, 16 B a hit), over the window's requests x chunks, where
the spans cover the window on either result path
(``spans.result_window``)."""

from benchmark import spans


def read(run):
    got = spans.result_window(run)
    if got is None:
        return None
    snap, chunks = got
    if "fetch.bytes" not in snap["counters"]:
        return None
    return snap["counters"]["fetch.bytes"] / chunks / 1e6
