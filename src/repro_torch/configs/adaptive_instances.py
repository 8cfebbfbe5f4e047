"""Presets for the port's instance layer (:mod:`repro_torch.core.instances`),
the same as :mod:`repro.configs.adaptive_instances`: ``CONFORMANCE`` holds
the registry defaults (tiny, exact oracles feasible), ``BENCH`` the
benchmark sizes (expensive oracles off)."""

from __future__ import annotations

from repro_torch.core.instances import (DiameterInstance, GradVarianceInstance,
                                        KadabraInstance, ReachabilityInstance,
                                        TrianglesInstance,
                                        WeightedSamplingInstance)

# Conformance-sized (the registry defaults — tiny, exact oracles feasible).
CONFORMANCE = {
    "kadabra": KadabraInstance(),
    "triangles": TrianglesInstance(),
    "reachability": ReachabilityInstance(),
    "wrs": WeightedSamplingInstance(),
    "diameter": DiameterInstance(),
    "gradvar": GradVarianceInstance(),
}

# Benchmark-sized: expensive exact oracles are not computed at this scale.
BENCH = {
    "kadabra-m": KadabraInstance(name="kadabra-m", n_vertices=512,
                                 n_edges=2048, eps=0.05, batch=64,
                                 compute_oracle=False),
    "triangles-m": TrianglesInstance(name="triangles-m", n_vertices=2048,
                                     m_per=4, eps_p=0.02, batch=256,
                                     compute_oracle=False),
    "reachability-m": ReachabilityInstance(name="reachability-m", rows=4,
                                           cols=4, t=15, eps=0.02,
                                           batch=256, compute_oracle=False),
    # max_samples keeps the int32 moment sums exact
    # (max_samples·(value_scale−1)² < 2³¹).
    "wrs-m": WeightedSamplingInstance(name="wrs-m", n_items=1 << 16,
                                      rtol=0.01, batch=4096,
                                      max_samples=1 << 19),
    "diameter-m": DiameterInstance(name="diameter-m", kind="er",
                                   n_vertices=512, n_edges=2048,
                                   graph_seed=7, gap=2, batch=32,
                                   max_samples=8192, compute_oracle=False),
    "gradvar-m": GradVarianceInstance(name="gradvar-m", n_examples=1 << 14,
                                      dim=32, rtol=0.01, batch=1024,
                                      max_samples=1 << 19),
}
