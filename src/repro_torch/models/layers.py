"""Parameter definitions, initialisation, logical-axis sharding and the
shared numerics.  Port of :mod:`repro.models.layers`.

A :class:`ParamDef` gives a parameter's shape, dtype, init kind and
*logical* axis names (``"embed"``, ``"vocab"``, ``"heads"``, ``"ffn"``,
``"experts"``, …); :class:`Params` holds one block's parameters as an
``nn.Module`` whose names are the reference tree's keys, and reads like
the reference's dict (``p["w_in"]``).

A :class:`ShardingRules` table maps logical axes to mesh axes with the
reference's **divisibility fallback** (an axis that does not divide a dim
evenly is not used for it, e.g. smollm's 15 heads on a 16-way model axis)
and its rule that a mesh axis shards at most one dim of a tensor.  A spec
is a tuple with one entry per dim: ``None``, one mesh-axis name, or a
tuple of names, as a ``jax.sharding.PartitionSpec`` reads.
:func:`placements` turns a spec into DTensor placements over a mesh, and
:func:`constrain` redistributes a DTensor activation to its logical
layout (the counterpart of ``with_sharding_constraint``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                   # normal | zeros | ones | scaled
    scale: float = 1.0
    fan_in: int = 0                        # contraction size for "scaled"
                                           # (0 → shape[-2], or shape[-1]
                                           # for a vector)
    logical: Optional[Tuple[Optional[str], ...]] = None  # one logical name
                                           # (or None) per dim; None → all None

    def __post_init__(self):
        if self.logical is None:
            object.__setattr__(self, "logical", (None,) * len(self.shape))
        if len(self.logical) != len(self.shape):
            raise ValueError(f"ParamDef: {len(self.shape)} dims {self.shape} "
                             f"but logical names {self.logical}")

    def stacked(self, n: int) -> "ParamDef":
        """The def of ``n`` such parameters stacked along a new leading
        ``layers`` dim (the reference's scan weights); ``fan_in`` stays
        that of one layer."""
        fan_in = self.fan_in or (self.shape[-2] if len(self.shape) >= 2
                                 else self.shape[-1])
        return dataclasses.replace(self, shape=(n,) + tuple(self.shape),
                                   logical=("layers",) + tuple(self.logical),
                                   fan_in=fan_in)


def _trunc_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [−2, 2], f32, by the inverse CDF."""
    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, device=generator.device)
    # in place: one f32 buffer at a time (a leaf of 10⁹ values is 4 GB)
    return (u.mul_(hi - lo).add_(lo).mul_(2.0).sub_(1.0).erfinv_()
            .mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0))


def init_leaf(d: ParamDef, generator: torch.Generator) -> torch.Tensor:
    """One parameter's initial value on the generator's device, with the
    reference's init kinds: truncated normal (±2)·scale/√fan_in for
    ``scaled``, normal·scale·0.02 for ``normal``, zeros and ones."""
    dev = generator.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=dev)
    if d.init == "scaled":
        fan_in = d.fan_in or (d.shape[-2] if len(d.shape) >= 2 else d.shape[-1])
        std = d.scale / math.sqrt(max(fan_in, 1))
        return _trunc_normal(d.shape, generator).mul_(std).to(d.dtype)
    return torch.randn(d.shape, generator=generator, device=dev).mul_(
        d.scale * 0.02).to(d.dtype)


def register_params(module: nn.Module, defs: Dict[str, ParamDef],
                    device: torch.device) -> None:
    """Give ``module`` one uninitialised parameter per def, under the def's
    name, and keep the defs as ``module.defs``."""
    module.defs = defs
    for name, d in defs.items():
        module.register_parameter(name, nn.Parameter(
            torch.empty(d.shape, dtype=d.dtype, device=device),
            requires_grad=False))


class Params(nn.Module):
    """The parameters of one block, named as in the reference's tree and
    allocated uninitialised; ``Model.init`` or ``load_state_dict`` fills
    them.  Serving needs no gradients, so none are tracked: a trainer opts
    in with ``model.requires_grad_(True)`` (``launch/steps.py``,
    ``launch/train.py``)."""

    def __init__(self, defs: Dict[str, ParamDef], device: torch.device):
        super().__init__()
        register_params(self, defs, device)

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


# ---------------------------------------------------------------------------
# Logical-axis sharding
# ---------------------------------------------------------------------------

Spec = Tuple[object, ...]   # per dim: None, a mesh-axis name, or a tuple of names


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis → tuple of mesh axes (applied with divisibility check)."""
    rules: Dict[str, Tuple[str, ...]]
    mesh_shape: Dict[str, int]

    def spec_for(self, d: ParamDef) -> Spec:
        return self.spec_for_shape(d.shape, d.logical)

    def spec_for_shape(self, shape: Sequence[int],
                       logical: Sequence[Optional[str]]) -> Spec:
        """Each dim takes, in order, the rule's mesh axes that are larger
        than 1, not used by an earlier dim, and whose product with the axes
        it already took divides its size."""
        used: set = set()
        out = []
        for size, name in zip(shape, logical):
            axes = self.rules.get(name, ()) if name else ()
            chosen = []
            prod = 1
            for ax in axes:
                if ax in used:
                    continue
                a = self.mesh_shape.get(ax, 1)
                if a > 1 and size % (prod * a) == 0:
                    chosen.append(ax)
                    prod *= a
            used.update(chosen)
            out.append(tuple(chosen) if len(chosen) > 1
                       else (chosen[0] if chosen else None))
        return tuple(out)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axis names, shape) of a ``DeviceMesh`` or of a mesh description
    (anything with ``axis_names`` and ``shape``)."""
    names = getattr(mesh, "mesh_dim_names", None) or getattr(mesh, "axis_names")
    return tuple(names), tuple(int(n) for n in mesh.shape)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``: mesh dim i is
    ``Shard(d)`` where tensor dim d names axis i, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names, _ = mesh_axes(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for ax in spec_axes(entry):
            out[names.index(ax)] = Shard(d)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` tensor laid out by
    ``spec`` (every sharded dim divides, by the fallback)."""
    names, sizes = mesh_axes(mesh)
    size = dict(zip(names, sizes))
    out = []
    for n, entry in zip(shape, spec):
        for ax in spec_axes(entry):
            n //= size[ax]
        out.append(n)
    return tuple(out)


def shard_range(mesh, pl: Sequence, dim: int, size: int,
                coord: Optional[Sequence[int]] = None) -> Tuple[int, int]:
    """(first index, length) of this rank's block (or the block of the
    rank at mesh coordinate ``coord``) of dim ``dim``, of ``size``, of a
    tensor laid out by placements ``pl`` on the ``DeviceMesh`` ``mesh``:
    the dim chunked by each mesh dim that shards it, outermost first, as
    DTensor lays shards out."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate() if coord is None else coord
    first, n = 0, size
    for i, p in enumerate(pl):
        if p == Shard(dim):
            if n % mesh.size(i):
                raise ValueError(f"dim {dim} of size {size} does not divide "
                                 f"into {mesh.size(i)} shards")
            n //= mesh.size(i)
            first += coord[i] * n
    return first, n


def local_chunk(full: torch.Tensor, mesh, pl: Sequence,
                coord: Optional[Sequence[int]] = None) -> torch.Tensor:
    """This rank's shard of ``full`` (or the shard of the rank at mesh
    coordinate ``coord``) under placements ``pl`` (:func:`shard_range` of
    every sharded dim).  A view of ``full``."""
    from torch.distributed.tensor import Shard
    for d in sorted({p.dim for p in pl if isinstance(p, Shard)}):
        first, n = shard_range(mesh, pl, d, full.shape[d], coord)
        full = full.narrow(d, first, n)
    return full


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]],
              rules: Optional[ShardingRules]) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to its logical layout under
    ``rules``.  ``x`` comes back unchanged when it is not a DTensor, when
    there are no rules, or when the fallback leaves every entry ``None``:
    an all-None spec would pin the tensor replicated, which the reference
    skips rather than force an all-gather of a whole activation."""
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = rules.spec_for_shape(x.shape, logical)
    if all(s is None for s in spec):
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """A (B, S, …) DTensor whose sequence is sharded (sequence parallelism
    between layers) gathered whole along S before a block's products, as
    Megatron's sequence parallelism does (the product flattens B and S,
    which DTensor will not do over a sharded S); anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor) or Shard(1) not in x.placements:
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p == Shard(1) else p for p in x.placements))


def residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y.  On a sequence-parallel stream x (a DTensor with its sequence
    sharded), a block's output y is first moved to x's layout: the
    reduce-scatter the add would make itself, made explicit so that its
    backward gathers the gradient before the block's last product; left
    to the add, the backward hands that product a sequence-sharded
    gradient to flatten over (B, S), which DTensor refuses on torch 2.11.
    Anywhere else the add as it is (its own layout choice, the same bits
    as before)."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(x, DTensor) and isinstance(y, DTensor) and \
            Shard(1) in x.placements and \
            tuple(y.placements) != tuple(x.placements):
        y = y.redistribute(x.device_mesh, x.placements)
    return x + y


def whole(x: torch.Tensor, dims: Sequence[int] = ()) -> torch.Tensor:
    """A DTensor with the dims ``dims`` whole on every rank and its partial
    sums reduced (a product that contracted a split dim: one all-reduce);
    anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    pl = tuple(Replicate() if p.is_partial() or any(p == Shard(d) for d in dims)
               else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


class _WholeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return whole(g)


def whole_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, whose gradient has its partial sums reduced before
    it flows on: for a DTensor produced by a redistribution whose backward
    cannot take partial sums (the vocab-masked partial of a sharded
    embedding lookup)."""
    from torch.distributed.tensor import DTensor
    return _WholeGrad.apply(x) if isinstance(x, DTensor) and \
        torch.is_grad_enabled() and x.requires_grad else x


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x · rsqrt(mean(x²) + eps), the factor cast to x's dtype, then · w."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w


def rotary(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
           theta: float = 10_000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE, half-split (not interleaved), on (..., S, H, hd) q/k given
    (..., S) positions."""
    hd = q.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=q.device) / half)
    ang = positions[..., None].float() * freqs                # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]

    def rot(x):
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)

    return rot(q), rot(k)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor, constrain=None) -> torch.Tensor:
    """(silu(x·w1) ⊙ x·w3)·w2; ``constrain`` lays out the hidden (the
    reference's ffn_act site)."""
    h = F.silu(x @ w1) * (x @ w3)
    return (h if constrain is None else constrain(h)) @ w2


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          vocab: int) -> torch.Tensor:
    """Token-mean CE on (…, V_padded) logits, in f32; the padded vocab tail
    is masked and labels outside [0, vocab) count for nothing.  Logits
    that are a vocab-sharded DTensor are gathered whole over the vocab
    first (one all-gather of each rank's rows; DTensor cannot take the
    label's logit from a vocab shard under autograd), and the loss comes
    back replicated."""
    lf = whole(logits, (logits.dim() - 1,)).float()
    if lf.shape[-1] > vocab:
        mask = torch.arange(lf.shape[-1], device=lf.device) < vocab
        lf = torch.where(mask, lf, -1e30)
    lse = torch.logsumexp(lf, dim=-1)
    labels = labels.long()
    picked = torch.gather(lf, -1, labels.clamp(0, lf.shape[-1] - 1)[..., None])[..., 0]
    valid = (labels >= 0) & (labels < vocab)
    ce = torch.where(valid, lse - picked, 0.0)
    # on a mesh the sums are partial over the batch's ranks: reduced before
    # the clamp and the quotient, so every rank holds the loss whole
    return whole(torch.sum(ce)) / torch.clamp(whole(torch.sum(valid)), min=1)
