"""Graph workloads of the port: CSR graphs as tensors, synthetic
generators, batched BFS with shortest-path counting, uniform shortest-path
sampling, the exact Brandes oracle and KADABRA, plus triangle counting,
s–t reachability under percolation and double-sweep diameter estimation."""
from .bfs import bfs_sssp, connected_components, eccentricity, sample_path
from .brandes import brandes_exact
from .csr import Graph, from_edges
from .diameter import (diameter_estimate, diameter_exact, double_sweep,
                       make_sweep_sample_fn)
from .gens import barabasi_albert, erdos_renyi, grid2d
from .kadabra import (KadabraParams, Preprocessed, frame_template,
                      make_sample_fn, preprocess, run_kadabra)
from .reachability import (arc_edge_ids, make_percolation_sample_fn,
                           reachability_exact, reached_masked)
from .triangles import (make_wedge_sample_fn, triangle_estimate,
                        triangles_exact, wedge_weights)

__all__ = [
    "Graph", "from_edges", "erdos_renyi", "barabasi_albert", "grid2d",
    "bfs_sssp", "connected_components", "eccentricity", "sample_path",
    "brandes_exact", "KadabraParams", "Preprocessed", "preprocess",
    "make_sample_fn", "run_kadabra", "frame_template",
    "wedge_weights", "triangles_exact", "make_wedge_sample_fn",
    "triangle_estimate",
    "arc_edge_ids", "reached_masked", "make_percolation_sample_fn",
    "reachability_exact",
    "diameter_exact", "double_sweep", "make_sweep_sample_fn",
    "diameter_estimate",
]
