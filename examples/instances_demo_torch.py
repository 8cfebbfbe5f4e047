"""The ADS instance layer of the PyTorch port end-to-end (the analogue of
``examples/instances_demo.py``): run every registered workload under a
chosen strategy/world, or the full cross-strategy conformance sweep.

    PYTHONPATH=src python examples/instances_demo_torch.py --device cpu
    PYTHONPATH=src python examples/instances_demo_torch.py --strategy indexed --world 4   # the card
    PYTHONPATH=src python examples/instances_demo_torch.py --conformance --device cpu
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--strategy", default="local",
                    choices=["lock", "barrier", "local", "shared", "indexed"])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--instance", default=None,
                    help="run only this registered instance")
    ap.add_argument("--conformance", action="store_true",
                    help="full strategy × world invariant sweep instead")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from repro_torch.core.conformance import run_all, run_conformance
    from repro_torch.core.instances import available_instances, run_instance

    names = [args.instance] if args.instance else list(available_instances())

    if args.conformance:
        reports = {n: run_conformance(n, seed=args.seed, device=dev)
                   for n in names} \
            if args.instance else run_all(seed=args.seed, device=dev)
        bad = 0
        for rep in reports.values():
            print(rep.summary())
            bad += 0 if rep.ok else 1
        return 1 if bad else 0

    for name in names:
        t0 = time.time()
        est, res, built = run_instance(name, strategy=args.strategy,
                                       world=args.world, seed=args.seed,
                                       device=dev)
        err = float(np.max(np.abs(est - built.oracle))) \
            if np.all(np.isfinite(built.oracle)) else float("nan")
        print(f"{name:13s} [{args.strategy}/W={args.world}] "
              f"τ={res.num:6d} epochs={res.epochs:4d} "
              f"err={err:.4f} (ε={built.eps:.4f}) "
              f"wall={time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
