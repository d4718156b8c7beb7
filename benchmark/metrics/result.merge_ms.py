"""The merge across shards, ms a chunk of the serial pass
(``merge_flat_matches``, once a request)."""


def read(run):
    s = run.loop.serial_stages
    if not s:
        return None
    return s["seconds"]["merge"] / s["chunks"] * 1e3
