"""Atomic, chunked, CRC-checked checkpoints.  Port of
:mod:`repro.checkpoint.manager`, in the same format, so that either
package reads the other's checkpoints:

    step_%010d/manifest.json — {"step", "meta", "leaves": {name: {shape,
                               dtype, chunks: [{start, stop, file,
                               crc32}]}}, "format": "repro-ckpt-v1",
                               "complete"} ("complete" written last)
    step_%010d/<leaf>.<i>.npy — axis-0 chunks of each leaf

written under ``.tmp_step_%010d`` and renamed into place.

A tree is walked as the reference's ``jax.tree_util`` walks it, with the
same leaf names: dicts in sorted key order, dataclasses and named tuples
by field name, lists and tuples by index, ``None`` holding no leaf; a
leaf is a ``torch.Tensor``, a numpy array or a scalar.  Leaves come back
as tensors.  A ``torch.bfloat16`` leaf is stored as its ``uint16`` view
with ``"bfloat16"`` in the manifest, as the reference stores an
``ml_dtypes.bfloat16`` array (the float8 types likewise as ``uint8``).

``CheckpointManager`` keeps the last k steps and can write on a worker
thread: ``save`` copies the tree to host memory first, so the caller may
go on changing its tensors while the disk is written.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any
_SEP = "/"

# logical dtype name → (numpy type stored on disk, the numpy and torch
# integer types of the same width that torch can view, the torch dtype)
_RAW = {"bfloat16": (np.uint16, np.int16, torch.int16, torch.bfloat16),
        "float8_e4m3fn": (np.uint8, np.uint8, torch.uint8, torch.float8_e4m3fn),
        "float8_e5m2": (np.uint8, np.uint8, torch.uint8, torch.float8_e5m2)}
_RAW_OF_TORCH = {v[3]: k for k, v in _RAW.items()}


def _encode(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the numpy array written to disk and its logical dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = _RAW_OF_TORCH.get(t.dtype)
        if name is not None:
            stored, _, t_int, _ = _RAW[name]
            return t.view(t_int).numpy().view(stored), name
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    name = str(arr.dtype)  # an ml_dtypes array names itself "bfloat16"
    if name in _RAW:
        return arr.view(_RAW[name][0]), name
    return arr, name


def _decode(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _RAW:
        _, np_int, _, t_dtype = _RAW[dtype_name]
        return torch.from_numpy(np.array(arr).view(np_int)).view(t_dtype)
    return torch.from_numpy(arr.astype(dtype_name))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(x) -> Optional[List[Tuple[str, Any]]]:
    """(name, child) pairs of an inner node, or None for a leaf."""
    if isinstance(x, dict):
        return [(str(k), x[k]) for k in sorted(x)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [(f.name, getattr(x, f.name)) for f in dataclasses.fields(x)]
    if _is_namedtuple(x):
        return [(f, getattr(x, f)) for f in x._fields]
    if isinstance(x, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(x)]
    return None


def _flatten_with_paths(tree: PyTree) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []

    def walk(x, path):
        if x is None:
            return
        kids = _children(x)
        if kids is None:
            out.append((_SEP.join(path) or "leaf", x))
            return
        for name, child in kids:
            walk(child, path + (name,))

    walk(tree, ())
    return out


def _rebuild(tree: PyTree, values: Dict[str, Any], path=()) -> PyTree:
    """``tree`` with each leaf replaced by ``values[its name]``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        name = _SEP.join(path) or "leaf"
        if name not in values:
            raise KeyError(f"checkpoint missing leaf {name}")
        return values[name]
    new = {name: _rebuild(child, values, path + (name,))
           for name, child in kids}
    if isinstance(tree, dict):
        return {k: new[str(k)] for k in tree}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **new)
    if _is_namedtuple(tree):
        return type(tree)(**new)
    return type(tree)(new[str(i)] for i in range(len(tree)))


def save_checkpoint(tree: PyTree, directory: "str | Path", step: int, *,
                    meta: Optional[Dict] = None, chunks: int = 4) -> Path:
    """Synchronous atomic save.  Returns the final step directory."""
    directory = Path(directory)
    final = directory / f"step_{step:010d}"
    tmp = directory / f".tmp_step_{step:010d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest: Dict[str, Any] = {"step": step, "meta": meta or {},
                                "leaves": {}, "format": "repro-ckpt-v1"}
    for name, leaf in _flatten_with_paths(tree):
        arr, dtype_name = _encode(leaf)
        safe = name.replace(_SEP, "__")
        n0 = max(arr.shape[0], 1) if arr.ndim else 1
        k = min(chunks, n0) if arr.ndim else 1
        bounds = np.linspace(0, n0, k + 1, dtype=np.int64)
        chunk_recs = []
        for i in range(k):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            part = arr[lo:hi] if arr.ndim else arr
            fn = f"{safe}.{i}.npy"
            with open(tmp / fn, "wb") as f:
                np.save(f, part)
            crc = zlib.crc32((tmp / fn).read_bytes())
            chunk_recs.append({"start": lo, "stop": hi, "file": fn,
                               "crc32": crc})
        manifest["leaves"][name] = {
            "shape": list(arr.shape), "dtype": dtype_name,
            "chunks": chunk_recs,
        }
    manifest["complete"] = True
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def load_checkpoint(tree_like: PyTree, directory: "str | Path", step: int, *,
                    device=None, verify_crc: bool = True
                    ) -> Tuple[PyTree, Dict]:
    """Restore into the structure of ``tree_like``; returns (tree, meta).

    Each leaf comes back as a tensor on ``device``, or, when ``device`` is
    None, on the device of the tree_like leaf it replaces (the CPU for a
    leaf that is not a tensor)."""
    d = Path(directory) / f"step_{step:010d}"
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest.get("complete"), f"incomplete checkpoint {d}"
    like = dict(_flatten_with_paths(tree_like))
    out: Dict[str, Any] = {}
    for name, rec in manifest["leaves"].items():
        parts = []
        for c in rec["chunks"]:
            raw = (d / c["file"]).read_bytes()
            if verify_crc and zlib.crc32(raw) != c["crc32"]:
                raise IOError(f"CRC mismatch in {d / c['file']}")
            parts.append(np.load(io.BytesIO(raw)))
        arr = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        t = _decode(arr.reshape(rec["shape"]), rec["dtype"])
        target = device if device is not None else (
            like[name].device if isinstance(like.get(name), torch.Tensor)
            else None)
        out[name] = t.to(target) if target is not None else t
    return _rebuild(tree_like, out), manifest["meta"]


def read_meta(directory: "str | Path", step: int) -> Dict:
    """The ``meta`` dict of one complete checkpoint, without loading any
    array data."""
    d = Path(directory) / f"step_{step:010d}"
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest.get("complete"), f"incomplete checkpoint {d}"
    return manifest["meta"]


def latest_step(directory: "str | Path") -> Optional[int]:
    d = Path(directory)
    if not d.exists():
        return None
    steps = []
    for p in d.iterdir():
        if p.name.startswith("step_") and (p / "manifest.json").exists():
            try:
                m = json.loads((p / "manifest.json").read_text())
                if m.get("complete"):
                    steps.append(int(p.name.split("_")[1]))
            except Exception:
                continue
    return max(steps) if steps else None


def _to_host(tree: PyTree) -> PyTree:
    """A copy of ``tree`` whose tensors live in host memory."""
    values = {name: leaf.detach().to("cpu", copy=True)
              if isinstance(leaf, torch.Tensor) else np.array(leaf)
              for name, leaf in _flatten_with_paths(tree)}
    return _rebuild(tree, values)


class CheckpointManager:
    """Async keep-last-k manager."""

    def __init__(self, directory: "str | Path", *, keep: int = 3,
                 async_write: bool = True, chunks: int = 4):
        self.directory = Path(directory)
        self.keep = keep
        self.async_write = async_write
        self.chunks = chunks
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, tree: PyTree, step: int, meta: Optional[Dict] = None
             ) -> None:
        self.wait()  # one in-flight save at a time
        snap = _to_host(tree)

        def work():
            try:
                save_checkpoint(snap, self.directory, step, meta=meta,
                                chunks=self.chunks)
                self._prune()
            except BaseException as e:  # noqa: BLE001
                self._error = e

        if self.async_write:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            if self._error:
                err, self._error = self._error, None
                raise err

    def restore_latest(self, tree_like: PyTree, device=None):
        step = latest_step(self.directory)
        if step is None:
            return None
        tree, meta = load_checkpoint(tree_like, self.directory, step,
                                     device=device)
        return step, tree, meta

    def _prune(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.directory.iterdir()
            if p.name.startswith("step_"))
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.directory / f"step_{s:010d}",
                          ignore_errors=True)
