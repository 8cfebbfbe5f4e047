"""Graph substrate for the KADABRA case study: CSR graphs as tensors,
synthetic generators, batched BFS with shortest-path counting, uniform
shortest-path sampling, the exact Brandes oracle, and KADABRA."""
from .bfs import bfs_sssp, connected_components, eccentricity, sample_path
from .brandes import brandes_exact
from .csr import Graph, from_edges
from .gens import barabasi_albert, erdos_renyi, grid2d
from .kadabra import (KadabraParams, Preprocessed, frame_template,
                      make_sample_fn, preprocess, run_kadabra)

__all__ = [
    "Graph", "from_edges", "erdos_renyi", "barabasi_albert", "grid2d",
    "bfs_sssp", "connected_components", "eccentricity", "sample_path",
    "brandes_exact", "KadabraParams", "Preprocessed", "preprocess",
    "make_sample_fn", "run_kadabra", "frame_template",
]
