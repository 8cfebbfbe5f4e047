"""Full KADABRA case study on the PyTorch port (the analogue of
``examples/kadabra_bc.py``): every parallelization strategy of the paper on
a chosen instance category, with accuracy versus the exact oracle and the
epoch/termination statistics that drive Figs. 2–3.

    PYTHONPATH=src python examples/kadabra_bc_torch.py --kind er --n 300 --eps 0.05 --device cpu
    PYTHONPATH=src python examples/kadabra_bc_torch.py --kind grid --world 8   # the card
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core.frames import FrameStrategy
from repro_torch.device import resolve_device
from repro_torch.graphs import (KadabraParams, barabasi_albert, brandes_exact,
                                erdos_renyi, grid2d, preprocess, run_kadabra)


def build(kind: str, n: int, seed: int, device):
    if kind == "er":
        return erdos_renyi(n, 5 * n, seed=seed, device=device)
    if kind == "ba":
        return barabasi_albert(n, 3, seed=seed, device=device)
    if kind == "grid":
        side = int(n ** 0.5)
        return grid2d(side, side, device=device)
    raise ValueError(f"unknown kind {kind}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", default="er", choices=["er", "ba", "grid"])
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--eps", type=float, default=0.05)
    ap.add_argument("--delta", type=float, default=0.1)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-exact", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = build(args.kind, args.n, args.seed, dev)
    print(f"instance: kind={args.kind} n={g.n} arcs={g.m_arcs}")
    t0 = time.time()
    pre = preprocess(g, args.eps, args.delta, device=dev)
    print(f"preprocessing: VD ≤ {pre.vd_upper}, ω = {pre.omega:.0f} "
          f"({time.time()-t0:.1f}s)")
    exact = None if args.skip_exact else brandes_exact(g)

    params = KadabraParams(eps=args.eps, delta=args.delta, batch=32,
                           rounds_per_epoch=4)
    print(f"\n{'strategy':>9s} {'W':>3s} {'τ':>8s} {'epochs':>7s} "
          f"{'max err':>8s} {'time':>7s}")
    for strat in (FrameStrategy.LOCK, FrameStrategy.BARRIER,
                  FrameStrategy.LOCAL_FRAME, FrameStrategy.SHARED_FRAME,
                  FrameStrategy.INDEXED_FRAME):
        worlds = [1] if strat == FrameStrategy.LOCK else [args.world]
        for w in worlds:
            t0 = time.time()
            btilde, res, _ = run_kadabra(g, params, strategy=strat, world=w,
                                         seed=args.seed, pre=pre, device=dev)
            dt = time.time() - t0
            err = "-" if exact is None else \
                f"{np.abs(btilde - exact).max():8.4f}"
            print(f"{strat.value:>9s} {w:3d} {float(res.num):8.0f} "
                  f"{res.epochs:7d} {err:>8s} {dt:6.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
