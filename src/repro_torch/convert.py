"""The state carried across from the reference: turn arrays that a test
read out of :mod:`repro` as numpy into the port's objects, so that both
packages compute on the same graph, frames, preprocessing, alias tables
and workload inputs."""

from __future__ import annotations

import numpy as np
import torch

from .core.frames import StateFrame, tree_map
from .device import resolve_device
from .graphs.csr import Graph, graph_from_arrays
from .graphs.kadabra import Preprocessed
from .sampling.alias import AliasTable


def graph_from_numpy(n: int, indptr, indices_padded, src, dst,
                     device=None) -> Graph:
    return graph_from_arrays(n, indptr, indices_padded, src, dst,
                             device=resolve_device(device))


def frame_from_numpy(num, data, device=None) -> StateFrame:
    device = resolve_device(device)
    return StateFrame(
        num=torch.from_numpy(np.array(num)).to(device),
        data=tree_map(lambda x: torch.from_numpy(np.array(x)).to(device), data))


def preprocessed_from_numpy(omega: float, vd_upper: int, components,
                            diam_levels: int, device=None) -> Preprocessed:
    comps = torch.from_numpy(np.array(components, dtype=np.int32))
    return Preprocessed(omega=float(omega), vd_upper=int(vd_upper),
                        components=comps.to(resolve_device(device)),
                        diam_levels=int(diam_levels))


def alias_table_from_numpy(prob, alias, device=None) -> AliasTable:
    prob = np.asarray(prob, dtype=np.float32)
    device = resolve_device(device)
    return AliasTable(
        n=int(prob.shape[0]), prob=torch.from_numpy(prob.copy()).to(device),
        alias=torch.from_numpy(np.array(alias, dtype=np.int32)).to(device))


def instance_inputs_from_numpy(device=None, **arrays) -> dict:
    """A workload's inputs by name (weights, quantized values, ``gq``,
    ``arc_ids``, edge masks, uniforms …) as tensors on ``device``, keeping
    bool arrays bool, integers int32 and floats float32."""
    device = resolve_device(device)

    def tensor(a):
        a = np.asarray(a)
        kind = a.dtype.kind
        a = a if kind == "b" else a.astype(np.int32 if kind in "iu"
                                            else np.float32)
        return torch.from_numpy(a.copy()).to(device)

    return {name: tensor(a) for name, a in arrays.items()}
