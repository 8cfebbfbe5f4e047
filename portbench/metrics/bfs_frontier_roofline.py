"""Share of the roofline of ``bfs_frontier``'s calls during sampling.

Each call is one BFS level for all the round's lanes B on a graph of n
vertices and m arcs.  Its least time is the larger of the bytes it needs
over HBM bandwidth and its operations over the float32 peak: the CSR read
once (4(n+1) + 4m bytes), dist read once and agg written once (4·B·n each;
the frontier's σ, whose size depends on the data, is left out, so the bound
is low and the share never overstates), and one test a (lane, arc) (B·m).
The device time is that of the kernels that implement a call, from the
trace, for the kernels that start outside the queries' preprocessing.
"""

from portbench.peaks import least_seconds

KERNELS = ("bfs_pack_kernel", "bfs_pull_kernel")


def least_call_seconds(n: int, m: int, lanes: int) -> float:
    nbytes = 4 * (n + 1) + 4 * m + 8 * lanes * n
    return least_seconds(nbytes, lanes * m)


def read(run):
    if run.trace is None:
        return None
    busy = run.trace.device_seconds(KERNELS,
                                    outside=run.trace.ranges("portbench.preprocess"))
    g = run.graph
    least = sum(q["bfs_launches_sampling"] *
                least_call_seconds(g["n"], g["m_arcs"], q["lanes"])
                for q in run.queries if "bfs_launches_sampling" in q)
    return 100.0 * least / busy if busy > 0 and least > 0 else None
