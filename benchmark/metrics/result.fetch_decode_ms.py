"""The result path's fetch and decode, ms a chunk of the serial pass
(``fetch_hit_bits`` + ``decode_hits``)."""


def read(run):
    s = run.loop.serial_stages
    if not s:
        return None
    return (s["seconds"]["fetch"] + s["seconds"]["decode"]) / s["chunks"] \
        * 1e3
