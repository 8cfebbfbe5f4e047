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

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

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


class Phases:
    """The part of a step that runs, for :func:`collective_bytes`: the
    step marks its parts with ``with phases("backward"): …``.  A plain
    attribute, so that the autograd engine's device thread sees it too."""

    def __init__(self, default: str = "other"):
        self.current = default

    @contextlib.contextmanager
    def __call__(self, name: str):
        prev, self.current = self.current, name
        try:
            yield
        finally:
            self.current = prev


def collective_bytes(run: Callable[[], Any], phases: Optional[Phases] = None
                     ) -> Tuple[Any, Dict[str, Any]]:
    """Run ``run()`` and count the collectives it issues on this rank →
    (its result, {"total": bytes, "count": n, kind: bytes, …}), the kinds
    named as the reference's (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``, ``broadcast``).  With ``phases``
    (which ``run`` switches), the same counts by phase under
    ``"by_phase"`` as well."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    out: Dict[str, Any] = {"total": 0, "count": 0}
    by_phase: Dict[str, Dict[str, int]] = {}

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
                counts = [out] if phases is None else [
                    out, by_phase.setdefault(phases.current,
                                             {"total": 0, "count": 0})]
                for c in counts:
                    c[_KINDS[name]] = c.get(_KINDS[name], 0) + n
                    c["total"] += n
                    c["count"] += 1
            return super().__torch_dispatch__(func, types, args, kwargs)

    with _Bytes() as comm:
        result = run()
    counted = comm.get_total_counts()
    if counted != out["count"]:
        raise AssertionError(f"collective_bytes: CommDebugMode counted "
                             f"{counted} collectives, the byte count "
                             f"{out['count']}")
    if phases is not None:
        out["by_phase"] = by_phase
    return result, out
