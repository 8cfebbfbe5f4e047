"""Deterministic synthetic token stream, and the families' batch layouts.

Port of :mod:`repro.data.pipeline`'s ``TokenStream``: every batch is a pure
function of ``(seed, step, shard, n_shards)``, with zipf-ish tokens
(log-uniform ranks, exponent ≈ 1) in EOS-separated pseudo-documents and
next-token labels.  Row r of a step draws from a CPU ``torch.Generator``
seeded by a fixed mix of (seed, step, global row), so a row does not depend
on the shard count, and the same tokens come out on every device.  The bits
differ from the reference's threefry draws; the distribution is the same.

``micro_batches`` lays a step's batch out as (n_micro, mb, S) for
gradient accumulation, and ``DataCursor`` is the checkpointable position
(resume = replay from the recorded step).  ``family_batch`` makes a
serving or training batch in the layout the reference's
``launch/specs.py`` ``batch_struct`` gives each family.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from ..core.epoch import make_generator
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataCursor:
    """Checkpointable position (serialized into checkpoint meta)."""
    step: int = 0
    seed: int = 0

    def as_meta(self) -> Dict:
        return {"data_step": self.step, "data_seed": self.seed}

    @staticmethod
    def from_meta(meta: Dict) -> "DataCursor":
        return DataCursor(step=int(meta.get("data_step", 0)),
                          seed=int(meta.get("data_seed", 0)))


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab: int
    seq_len: int
    batch: int                 # global batch (over all shards)
    seed: int = 0
    mean_doc_len: int = 512
    eos: int = 0

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1,
                 device=None) -> Dict[str, torch.Tensor]:
        """→ {"tokens": (B/n_shards, S), "labels": same} int32 for this
        shard, on ``device`` (``None`` → the CUDA card)."""
        rows = self.batch // n_shards
        n = self.seq_len + 1
        toks = []
        for r in range(rows):
            gen = make_generator(torch.device("cpu"), self.seed, int(step),
                                 shard * rows + r)
            u = torch.rand(n, generator=gen) * (1.0 - 1e-6) + 1e-6
            # log-uniform ranks ≈ zipf(1); keep 0 reserved for EOS
            ranks = torch.exp(u * math.log(self.vocab - 1.0)).to(torch.int32)
            t = torch.clamp(ranks, 1, self.vocab - 1)
            de = torch.rand(n, generator=gen)
            toks.append(torch.where(de < 1.0 / self.mean_doc_len, self.eos, t))
        toks = torch.stack(toks).to(torch.int32).to(resolve_device(device))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def micro_batches(self, step: int, n_micro: int, *, shard: int = 0,
                      n_shards: int = 1, device=None) -> Dict[str, torch.Tensor]:
        """(n_micro, B/n_shards/n_micro, S) leading layout for gradient
        accumulation: the shard's rows in order, the remainder dropped."""
        b = self.batch_at(step, shard, n_shards, device=device)
        mb = (self.batch // n_shards) // n_micro
        return {k: x[: n_micro * mb].reshape((n_micro, mb) + tuple(x.shape[1:]))
                for k, x in b.items()}


def family_batch(cfg, batch: int, seq: int, generator: torch.Generator, *,
                 train: bool = False) -> Dict[str, torch.Tensor]:
    """A batch of B = ``batch`` sequences of ``seq`` positions in the
    family's layout (the reference's ``launch/specs.py`` ``batch_struct``),
    drawn from ``generator`` on its device:

    - ``tokens`` (B, S_text) int32, uniform over the vocab; S_text = seq,
      but seq − n_patches for vlm;
    - vlm: ``patches`` (B, n_patches, d) bf16, standard normal (the stubbed
      ViT's patch embeddings, prepended to the tokens');
    - encdec: ``frames`` (B, seq // frame_ratio, d) bf16, standard normal
      (the stubbed audio frontend's frame embeddings);
    - with ``train``: ``labels`` (B, S_text) int32, the next tokens.

    The reference's specs give shapes only; the values here are the
    caller's draws."""
    dev = generator.device
    text = seq - cfg.n_patches if cfg.family == "vlm" else seq
    if text <= 0:
        raise ValueError(f"{cfg.name}: seq {seq} leaves no text after "
                         f"{cfg.n_patches} patches")
    toks = torch.randint(0, cfg.vocab, (batch, text + 1), generator=generator,
                         device=dev, dtype=torch.int32)
    out = {}
    if cfg.family == "vlm":
        out["patches"] = torch.randn((batch, cfg.n_patches, cfg.d_model),
                                     generator=generator, device=dev
                                     ).to(torch.bfloat16)
    if cfg.family == "encdec":
        out["frames"] = torch.randn((batch, seq // cfg.frame_ratio, cfg.d_model),
                                    generator=generator, device=dev
                                    ).to(torch.bfloat16)
    out["tokens"] = toks[:, :-1]
    if train:
        out["labels"] = toks[:, 1:]
    return out
