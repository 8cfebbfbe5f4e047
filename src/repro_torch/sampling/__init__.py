"""Weighted random sampling (Hübschle-Schneider & Sanders): alias tables
and the weighted-mean workload.  Port of :mod:`repro.sampling`."""
from .alias import (AliasTable, alias_draw_probabilities, build_alias_table,
                    make_weighted_sample_fn, weighted_frame_template,
                    weighted_mean_exact)

__all__ = [
    "AliasTable", "build_alias_table", "alias_draw_probabilities",
    "make_weighted_sample_fn", "weighted_frame_template",
    "weighted_mean_exact",
]
