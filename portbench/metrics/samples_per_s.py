"""Σ τ of the window's completed queries over the time from the window's
start to the last completion, by the host's clock: checked samples a
second, the paper's throughput."""


def read(run):
    if not run.queries:
        return None
    span = run.queries[-1]["t_end"] - run.window_start
    return sum(q["tau"] for q in run.queries) / span if span > 0 else None
