"""Set-up: seconds from the process's start to the first timed request
(import, inputs, compile, tables, kernel libraries, the warm-up)."""


def read(run):
    return run.setup_s
