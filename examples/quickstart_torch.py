"""Quickstart of the PyTorch port (the analogue of ``examples/quickstart.py``):
the paper's algorithm in ~30 lines of user code.

Approximates betweenness centrality on a synthetic social graph with the
epoch-based local-frame algorithm (4 parallel workers), compares against the
exact Brandes oracle, prints the top-10 vertices.

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
    PYTHONPATH=src python examples/quickstart_torch.py     # the card
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core.frames import FrameStrategy
from repro_torch.device import resolve_device
from repro_torch.graphs import (KadabraParams, brandes_exact, erdos_renyi,
                                run_kadabra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = erdos_renyi(n=200, m_edges=800, seed=7, device=dev)
    print(f"graph: n={g.n}, arcs={g.m_arcs}")

    params = KadabraParams(eps=0.05, delta=0.1, batch=32, rounds_per_epoch=4)
    btilde, res, pre = run_kadabra(
        g, params, strategy=FrameStrategy.LOCAL_FRAME, world=4, seed=0,
        device=dev)
    tau = float(res.num)
    print(f"adaptive sampling stopped after τ = {tau:.0f} samples "
          f"(ω cap was {pre.omega:.0f})")

    exact = brandes_exact(g)
    err = np.abs(btilde - exact).max()
    print(f"max |b̃ − b| = {err:.4f}  (ε = {params.eps}) "
          f"{'OK' if err <= params.eps else 'MISS'}")

    top = np.argsort(-btilde)[:10]
    print("\n top-10 vertices by approximate BC:")
    print(f" {'vertex':>7s} {'b̃(v)':>9s} {'exact':>9s}")
    for v in top:
        print(f" {v:7d} {btilde[v]:9.5f} {exact[v]:9.5f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
