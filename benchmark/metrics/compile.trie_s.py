"""Host seconds of ``compile_dictionary`` an invocation (read the pattern
file, sort, shard, build each shard's trie), median over the window."""

import numpy as np


def read(run):
    inv = run.loop.invocations
    if not inv:
        return None
    return float(np.median([i["compile_s"] for i in inv]))
