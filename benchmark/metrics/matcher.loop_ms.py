"""The chunk loop's own time, ms a chunk of the serial pass: the wall less
every stage the timers see (its cut, shift and concatenation of rows)."""


def read(run):
    s = run.loop.serial_stages
    if not s:
        return None
    return (s["wall_s"] - sum(s["seconds"].values())) / s["chunks"] * 1e3
