"""The state carried across from the reference: turn arrays that a test
read out of :mod:`repro` as numpy into the port's objects, so that both
packages compute on the same graph, frames, preprocessing, alias tables,
workload inputs and model weights."""

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


def _tensor_keep_dtype(a) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype; bfloat16 (numpy's
    ``ml_dtypes`` extension type) goes through its 16-bit pattern, bit for
    bit."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


_STACKS = ("units", "layers", "enc_layers", "dec_layers")


def model_params_from_numpy(cfg, tree, device=None) -> dict:
    """The reference model's parameter tree (``Model(cfg).init(key)``, its
    leaves as numpy arrays) as a state dict of the port's ``Model``, for
    every family: nested keys joined by dots, the stacked leading layer
    dimension of ``units`` (hybrid), ``layers`` (dense, moe, vlm, ssm) or
    ``enc_layers`` and ``dec_layers`` (encdec) split into ``<stack>.<i>``
    (the moe experts' (E, d, ff) leaves stay stacked by expert), every
    dtype kept; a stack whose depth is not ``cfg``'s raises.  Load it with
    ``model.load_state_dict(state, assign=True)``."""
    device = resolve_device(device)
    state = {}
    depth = {"units": cfg.n_layers // 3, "layers": cfg.n_layers,
             "enc_layers": cfg.enc_layers, "dec_layers": cfg.n_layers}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
            return
        t = _tensor_keep_dtype(node).to(device)
        stack, _, rest = prefix.partition(".")
        if stack in _STACKS and rest:
            if t.shape[0] != depth[stack]:
                raise ValueError(f"{prefix}: {t.shape[0]} stacked layers, "
                                 f"{cfg.name} has {depth[stack]}")
            for i in range(t.shape[0]):
                state[f"{stack}.{i}.{rest}"] = t[i].clone()
        else:
            state[prefix] = t

    walk("", tree)
    return state


def adamw_state_from_numpy(cfg, state, device=None):
    """The reference's ``AdamWState`` (``step`` and the ``mu``/``nu`` moment
    trees, leaves as numpy arrays) as the port's: the step an int32 0-d
    tensor, each moment tree named as ``model_params_from_numpy`` names
    the parameters, every dtype kept."""
    from .optim.adamw import AdamWState
    device = resolve_device(device)
    step, mu, nu = state.step, state.mu, state.nu
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=device),
        mu=model_params_from_numpy(cfg, mu, device),
        nu=model_params_from_numpy(cfg, nu, device))
