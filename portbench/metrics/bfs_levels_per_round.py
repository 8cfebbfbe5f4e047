"""Launches of ``bfs_frontier`` (``repro_torch.kernels.bfs_frontier.launches``,
one a BFS level of all lanes) during sampling, per sampling round: the
levels SAMPLE()'s batched BFS runs before every lane is done.  The
launches of preprocessing are left out."""


def read(run):
    calls = sum(q.get("bfs_launches_sampling", 0) for q in run.queries)
    rounds = sum(q.get("rounds", 0) for q in run.queries)
    return calls / rounds if rounds and calls else None
