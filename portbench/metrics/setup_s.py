"""Seconds from the start of the harness (the first line of ``run.py``; the
interpreter's own start, some tens of milliseconds, comes before it) to the
first timed query: imports, loading (on a checkout's first run, building)
the kernels, making the graph on the device and the warm-up query."""


def read(run):
    return run.setup_s
