"""Fault-tolerance demo of the PyTorch port (the analogue of
``examples/elastic_restart.py``): save a train state, then restore it
through ``elastic_restore`` onto a mesh with explicit layouts (the new
"fleet": one rank), verifying bit-identical parameters and moments and an
identical data cursor.

    PYTHONPATH=src python examples/elastic_restart_torch.py --device cpu
    PYTHONPATH=src python examples/elastic_restart_torch.py     # the card
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.distributed import destroy_worker_group, init_worker_group
from repro_torch.data import DataCursor, TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import device_mesh, make_mesh
from repro_torch.launch.sharding import build_rules
from repro_torch.models import Model
from repro_torch.models.layers import placements
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.runtime import elastic_restore
import repro_torch.configs.smollm_360m as sm


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = sm.reduced()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = Model(cfg, device=dev).init(gen)
    params = {k: p.detach() for k, p in model.named_parameters()}
    opt = adamw_init(params)

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2, async_write=False)
        cursor = DataCursor(step=17, seed=0)
        mgr.save({"params": params, "opt": opt}, 17, meta=cursor.as_meta())
        print("[elastic] saved at step 17 (simulated 'mesh A', dp=1)")

        # "new fleet": a mesh of one rank with explicit layouts, exercising
        # the global-slice restore path
        init_worker_group(0, 1, backend="gloo", device=dev,
                          init_method=f"file://{d}/rendezvous")
        try:
            mesh = device_mesh(make_mesh((1, 1), ("data", "model")), device=dev)
            rules = build_rules(cfg, mesh)
            defs = model.param_defs()
            layout = {k: placements(rules.spec_for(defs[k]), mesh)
                      for k in params}
            out = elastic_restore(
                mgr, {"params": params, "opt": opt}, mesh=mesh,
                placements={"params": layout,
                            "opt": AdamWState(step=None, mu=layout,
                                              nu=layout)})
            assert out is not None
            step, tree, meta = out
            cur2 = DataCursor.from_meta(meta)
            print(f"[elastic] restored step={step}, data cursor={cur2.step}, "
                  f"onto a mesh of {mesh.size()} rank(s)")
            for k, p in params.items():
                got = tree["params"][k].to_local()
                assert torch.equal(got, p), f"params differ after reshard: {k}"
                assert torch.equal(tree["opt"].mu[k].to_local(), opt.mu[k])
                assert torch.equal(tree["opt"].nu[k].to_local(), opt.nu[k])
            assert cur2 == DataCursor(step=17, seed=0)
        finally:
            destroy_worker_group()

    # data replay across a shard-count change stays globally identical
    stream = TokenStream(vocab=cfg.vocab, seq_len=16, batch=8, seed=0)
    full = stream.batch_at(17, 0, 1, device="cpu")["tokens"]
    parts = [stream.batch_at(17, i, 4, device="cpu")["tokens"] for i in range(4)]
    assert torch.equal(full, torch.cat(parts, 0))
    print("[elastic] data stream invariant across shard counts ✓")
    print("[elastic] bit-identical restore onto a new layout ✓")


if __name__ == "__main__":
    main()
