"""The generators and the CSR the port is handed, at small scale."""

import numpy as np
import pytest
import torch

from portbench import graph as graph_mod
from portbench.gens import kron, urand
from portbench.reference.graph import RefGraph

URAND = {"generator": "urand", "scale": 10, "edge_factor": 16}
KRON = {"generator": "kron", "scale": 10, "edge_factor": 16,
        "A": 0.57, "B": 0.19, "C": 0.19}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("module,cfg", [(urand, URAND), (kron, KRON)])
def test_generators_follow_the_seed(module, cfg):
    n, a = module.edge_tuples(cfg, _gen(3), torch.device("cpu"))
    _, b = module.edge_tuples(cfg, _gen(3), torch.device("cpu"))
    _, c = module.edge_tuples(cfg, _gen(4), torch.device("cpu"))
    assert n == 1 << cfg["scale"] and a.shape == (16 * n, 2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < n


def test_kron_quadrant_shares_at_every_level():
    tuples = kron.bit_tuples(KRON, _gen(0), torch.device("cpu"))
    for bit in range(KRON["scale"]):
        row = (tuples[:, 0] >> bit) & 1
        col = (tuples[:, 1] >> bit) & 1
        shares = [float(((row == r) & (col == c)).float().mean())
                  for r, c in ((0, 0), (0, 1), (1, 0), (1, 1))]
        assert np.allclose(shares, [0.57, 0.19, 0.19, 0.05], atol=0.01), shares


def test_kron_is_skewed_and_urand_is_not():
    degs = {}
    for name, module, cfg in (("u", urand, URAND), ("k", kron, KRON)):
        n, t = module.edge_tuples(cfg, _gen(1), torch.device("cpu"))
        csr = graph_mod.csr_from_tuples(n, t)
        degs[name] = (csr["indptr"][1:] - csr["indptr"][:-1]).numpy()
    assert degs["k"].max() > 5 * degs["u"].max()
    assert (degs["k"] == 0).mean() > 0.1 > (degs["u"] == 0).mean()


@pytest.mark.parametrize("module,cfg", [(urand, URAND), (kron, KRON)])
def test_csr_is_simple_symmetric_sorted_and_the_reference_agrees(module, cfg):
    n, t = module.edge_tuples(cfg, _gen(5), torch.device("cpu"))
    csr = graph_mod.csr_from_tuples(n, t)
    src, dst = csr["src"].long().numpy(), csr["dst"].long().numpy()
    assert (src != dst).all()
    keys = src * n + dst
    assert (np.diff(keys) > 0).all()            # sorted, no repeated arc
    assert set(keys) == set(dst * n + src)      # each pair both ways
    pairs = {tuple(sorted(p)) for p in t.tolist() if p[0] != p[1]}
    assert len(pairs) * 2 == csr["m_arcs"] == src.size
    indptr = csr["indptr"].long().numpy()
    assert indptr[-1] == src.size and (np.diff(indptr) >= 0).all()
    ind = csr["indices_padded"].numpy()
    assert ind.size == src.size + csr["max_degree"] and (ind[src.size:] == n).all()
    g = graph_mod.port_graph(csr)
    assert g.max_degree == int(np.diff(indptr).max())
    ref = RefGraph(n, t, "cpu")
    assert np.array_equal(ref.t_indptr.numpy(), indptr)
    assert np.array_equal(ref.dst.numpy(), dst)
    assert ref.max_degree == g.max_degree
