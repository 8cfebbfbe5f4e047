"""The collectives of a sharded call, by kind, with their bytes.  The
port's counterpart of :mod:`repro.analysis.hlo`, which reads them from
XLA's HLO text (there is none here).

DTensor issues ``_c10d_functional`` ops, not ``torch.distributed``'s
functions, so ``core.distributed.record_collectives`` cannot see them;
``torch.distributed.tensor.debug.CommDebugMode`` does.  The bytes of a
collective are those of its input on this rank (an all-gather's shard, a
reduce-scatter's whole input, an all-reduce's tensor), as the reference
counts an all-gather by its ``-start`` operand.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

# op name (``_c10d_functional``, ``_dtensor`` and ``c10d``) → the
# reference's HLO kind
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
# c10d's in-place forms that take the output before the input
_OUTPUT_FIRST = ("_allgather_base_", "allgather_into_tensor_coalesced_",
                 "_reduce_scatter_base_", "reduce_scatter_tensor_coalesced_",
                 "allgather_", "reduce_scatter_", "alltoall_", "alltoall_base_")


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    if isinstance(a, (list, tuple)):
        return sum(_nbytes(x) for x in a)
    return 0


def collective_bytes(run: Callable[[], Any]) -> Tuple[Any, Dict[str, int]]:
    """Run ``run()`` and count the collectives it issues on this rank →
    (its result, {"total": bytes, "count": n, kind: bytes, …}), the kinds
    named as the reference's (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``, ``broadcast``)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    out: Dict[str, int] = {"total": 0, "count": 0}

    class _Bytes(CommDebugMode):
        # CommDebugMode lets DTensor desugar first (it returns
        # NotImplemented on DTensor arguments), then sees the collectives
        # on local tensors: count their bytes there too
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = getattr(getattr(func, "_overloadpacket", None),
                           "__name__", "")
            if name in _KINDS and not any(t == DTensor for t in types):
                tensors = [a for a in args
                           if isinstance(a, (torch.Tensor, list, tuple))]
                i = 1 if name in _OUTPUT_FIRST and len(tensors) > 1 else 0
                n = _nbytes(tensors[i]) if tensors else 0
                out[_KINDS[name]] = out.get(_KINDS[name], 0) + n
                out["total"] += n
                out["count"] += 1
            return super().__torch_dispatch__(func, types, args, kwargs)

    with _Bytes() as comm:
        result = run()
    counted = comm.get_total_counts()
    if counted != out["count"]:
        raise AssertionError(f"collective_bytes: CommDebugMode counted "
                             f"{counted} collectives, the byte count "
                             f"{out['count']}")
    return result, out
