"""Seeds of a run, all mixed from ``--seed``: the graph's, each query's,
the warm-up query's and the draw of the queries that are checked."""

from __future__ import annotations

from .reference.streams import mix

GRAPH, QUERY, WARMUP, CHECK = 0x6A11, 0x9E27, 0x3A4D, 0xC4EC


def graph_seed(seed: int) -> int:
    return mix(GRAPH, seed)


def query_seed(seed: int, k: int) -> int:
    """The seed of query k of a run."""
    return mix(QUERY, seed, k)


def warmup_seed(seed: int) -> int:
    return mix(WARMUP, seed)


def check_seed(seed: int) -> int:
    return mix(CHECK, seed)
