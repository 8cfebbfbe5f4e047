"""Serving example of the PyTorch port (the analogue of
``examples/serve_adaptive.py``): batched generation + the ADS engine
estimating a serving metric to (ε,δ) — "how good is this checkpoint?"
answered with adaptive sampling instead of a fixed eval sweep.  Stops at
the first flow that fails and returns its exit code.

    PYTHONPATH=src python examples/serve_adaptive_torch.py --device cpu
    PYTHONPATH=src python examples/serve_adaptive_torch.py     # the card
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.device import resolve_device
from repro_torch.launch import serve as serve_mod

FLOWS = (
    ("[example] adaptive-query pool (epoch-granular scheduler):",
     ["--pool", "--queries", "wrs:local:2,reachability:shared:2:1",
      "--max-in-flight", "2"]),
    ("\n[example] placement-aware pool: disjoint leases + pressure "
     "(worker-slot accounting works even on one device):",
     ["--pool", "--queries", "reachability:shared:2,wrs:local:2:1",
      "--max-in-flight", "4", "--topology", "2",
      "--pressure-policy", "shrink:min=1"]),
    ("\n[example] batched greedy generation:",
     ["--arch", "smollm-360m-reduced", "--batch", "4", "--prompt-len", "16",
      "--gen", "16"]),
    ("\n[example] adaptive (ε,δ) metric estimation:",
     ["--arch", "smollm-360m-reduced", "--adaptive-eval", "--eps", "0.25",
      "--delta", "0.1", "--seq", "32", "--batch", "4"]),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for title, flow in FLOWS:
        print(title)
        rc = serve_mod.main([*flow, "--device", str(dev)])
        if rc:
            print(f"[example] failed: exit code {rc}")
            return rc
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
