"""KADABRA betweenness queries through the port, one at a time.

A query is what a user of the port calls::

    pre = repro_torch.graphs.kadabra.preprocess(g, eps, delta, seed=q)
    b, res, _ = repro_torch.graphs.kadabra.run_kadabra(
        g, params, strategy=S, world=W, seed=q, pre=pre)

and it ends when b̃ is on the host.  The traffic file gives ε, δ, the
frame strategy, W, the samples a worker draws a round, the rounds an epoch
and the epoch cap, and may name its source; the queries run back to back,
one in flight, and a file with any other key is refused.  Each query's record holds its walls and the port's own
counters around it (``repro_torch.device.host_syncs``, the launches of
``bfs_frontier``); the counters are read as they are, nothing is patched in.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# the port's kernels a query launches, loaded (or built) during set-up
KERNELS = ("bfs_frontier", "frame_accum")
# what a traffic file of this driver may hold: one query in flight at a time,
# so a file that asks for another loop is refused rather than run as this one
TRAFFIC_KEYS = {"query", "name", "source", "eps", "delta", "strategy", "world",
                "batch", "rounds_per_epoch", "max_epochs", "checked_queries"}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    def __init__(self, graph, traffic: dict, device):
        from repro_torch.core.frames import FrameStrategy
        from repro_torch.graphs import kadabra

        unknown = sorted(set(traffic) - TRAFFIC_KEYS)
        if unknown:
            raise ValueError(f"traffic {traffic.get('name')!r}: this driver "
                             f"runs a closed loop of one query and reads no "
                             f"{unknown}")
        self.kadabra = kadabra
        self.graph = graph
        self.device = torch.device(device)
        self.traffic = traffic
        self.strategy = FrameStrategy(traffic["strategy"])
        self.world = int(traffic["world"])
        self.params = kadabra.KadabraParams(
            eps=float(traffic["eps"]), delta=float(traffic["delta"]),
            batch=int(traffic["batch"]),
            rounds_per_epoch=int(traffic["rounds_per_epoch"]),
            max_epochs=int(traffic["max_epochs"]))

    def query(self, q: int):
        """Run query ``q``; returns its record (walls and counters) and its
        output (what the check compares), with nothing of the port's state
        kept beyond them."""
        from repro_torch import device as port_device
        from repro_torch.kernels import bfs_frontier

        p, g = self.params, self.graph
        syncs0 = port_device.host_syncs
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.preprocess"):
            pre = self.kadabra.preprocess(g, p.eps, p.delta, seed=q,
                                          device=self.device)
            _sync(self.device)
        t1 = time.perf_counter()
        launches1 = bfs_frontier.launches
        with torch.profiler.record_function("portbench.run_kadabra"):
            b, res, _ = self.kadabra.run_kadabra(
                g, p, strategy=self.strategy, world=self.world, seed=q,
                pre=pre, device=self.device)
        t2 = time.perf_counter()
        # Every epoch but a stopped run's last one sampled K rounds (the
        # engine samples nothing after the verdict fires).
        sampled = res.epochs - 1 if res.stopped else res.epochs
        record = {
            "seed": q, "t_end": t2, "wall_s": t2 - t0,
            "preprocess_s": t1 - t0, "tau": int(res.num),
            "epochs": int(res.epochs),
            "rounds": sampled * p.rounds_per_epoch,
            "lanes": self.world * p.batch,
            "host_syncs": port_device.host_syncs - syncs0,
            "bfs_launches_sampling": bfs_frontier.launches - launches1,
        }
        output = {
            "btilde": np.asarray(b, dtype=np.float64), "tau": int(res.num),
            "stopped": bool(res.stopped), "epochs": int(res.epochs),
            "stop_epoch": int(res.stop_epoch), "omega": float(pre.omega),
            "vd_upper": int(pre.vd_upper), "diam_levels": int(pre.diam_levels),
            "components": pre.components,
        }
        return record, output


def settle(output: dict) -> dict:
    """An output with its device tensors brought to the host, so that the
    port's state can be freed before the reference runs."""
    return {**output,
            "components": output["components"].cpu().numpy().astype(np.int64)}


def reference_output(ref_graph, traffic: dict, q: int, uniform: bool = False):
    """The reference's output of query ``q``: the same fields, worked out
    again from the edge tuples (:mod:`portbench.reference.kadabra`)."""
    from portbench.reference import kadabra as ref

    return ref.query(ref_graph, traffic, q, uniform=uniform)


def check_every(outputs: list, ref_graph) -> list:
    """The numbers read on every query of the window.

    ``vd_bound_short``: how far the query's vd_upper falls under a lower
    bound of the graph's vertex diameter (0 where it bounds it).  KADABRA's
    ω and SAMPLE()'s BFS level budget rest on vd_upper bounding the vertex
    diameter of the whole graph; a bound that falls short cuts the BFS of
    pairs farther apart and leaves their paths out of b̃.
    """
    from portbench.reference import kadabra as ref

    lower = ref.vd_lower(ref_graph)
    return [{"vd_bound_short": max(0, lower - int(o["vd_upper"]))}
            for o in outputs]


def compare(got: dict, ref: dict) -> dict:
    """The numbers a checked query is judged by (see ``limits/kadabra.json``).

    ``pre_mismatch``: vertices whose component label differs, plus one for
    each of vd_upper, the BFS level budget and ω that differs (ω by more than
    1e-9 of itself).  ``verdict_mismatch``: one for each of τ, the stop,
    the epochs and the stop epoch that differs.  ``count_gap_share``: the L1
    distance of the port's b̃ from the reference's over the reference's L1
    mass, Σ|b̃ − b̃_ref| / Σ b̃_ref: the share of the sampled paths' internal
    vertices that the port put elsewhere.
    """
    pre = int(np.count_nonzero(got["components"] != ref["components"]))
    pre += int(got["vd_upper"] != ref["vd_upper"])
    pre += int(got["diam_levels"] != ref["diam_levels"])
    pre += int(abs(got["omega"] - ref["omega"]) > 1e-9 * abs(ref["omega"]))
    verdict = sum(int(got[k] != ref[k]) for k in
                  ("tau", "stopped", "epochs", "stop_epoch"))
    b, rb = got["btilde"], ref["btilde"]
    mass = float(np.abs(rb).sum())
    if b.shape != rb.shape:
        gap = float("inf")
    else:
        gap = float(np.abs(b - rb).sum()) / max(mass, 1.0 / max(ref["tau"], 1))
    return {"pre_mismatch": pre, "verdict_mismatch": verdict,
            "count_gap_share": gap}
