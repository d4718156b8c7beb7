"""The matcher's input stages, ms a chunk of the serial pass: the window
copy, the pad and upload, and the staging (``window`` + ``upload`` +
``stage``)."""


def read(run):
    s = run.loop.serial_stages
    if not s:
        return None
    sec = s["seconds"]
    return (sec["window"] + sec["upload"] + sec["stage"]) / s["chunks"] * 1e3
