"""Mean wall of the window's completed queries, by the host's clock: from
the call of ``preprocess`` to b̃ on the host.  What a user of KADABRA waits
for."""


def read(run):
    walls = [q["wall_s"] for q in run.queries]
    return sum(walls) / len(walls) if walls else None
