"""The paper's own workload: KADABRA betweenness-centrality approximation.

Not an LM architecture — this config parameterizes the case-study benchmarks
and examples (graph size classes from App. E, matched synthetically)."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class KadabraBCConfig:
    graph_kind: str = "er"        # er | ba | grid
    n_vertices: int = 1_000
    n_edges: int = 5_000
    eps: float = 0.03
    delta: float = 0.1
    batch: int = 32
    rounds_per_epoch: int = 4     # N (App. C.2) in rounds
    xi: float = 1.33              # App. C.3
    world: int = 8                # virtual workers


PRESETS = {
    "moderate": KadabraBCConfig(n_vertices=2_000, n_edges=10_000),
    "road": KadabraBCConfig(graph_kind="grid", n_vertices=2_500,
                            n_edges=0, eps=0.05),
    "social": KadabraBCConfig(graph_kind="ba", n_vertices=3_000,
                              n_edges=9_000, eps=0.03),
}
