"""Host seconds of the scanner and plan-table build an invocation
(``Matcher._get_pallas_scanner``, timed where the traced run swaps it),
median over the window."""

import numpy as np


def read(run):
    inv = [i for i in run.loop.invocations if i.get("tables_s")]
    if not inv:
        return None
    return float(np.median([i["tables_s"] for i in inv]))
