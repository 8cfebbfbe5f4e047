"""The state carried across from the reference: turn arrays that a test
read out of :mod:`repro` as numpy into the port's objects, so that both
packages compute on the same graph, frames and preprocessing."""

from __future__ import annotations

import numpy as np
import torch

from .core.frames import StateFrame, tree_map
from .device import resolve_device
from .graphs.csr import Graph, graph_from_arrays
from .graphs.kadabra import Preprocessed


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
