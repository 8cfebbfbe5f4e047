"""The port's checkpoint format is the reference's: a checkpoint written by
either package loads in the other bit for bit, the two manifests are equal
(leaf names, shapes, dtype strings, chunk bounds, CRCs), and
``latest_step``, ``read_meta`` and ``CheckpointManager`` pruning agree.
The JAX side only writes and reads files (numpy), compiling nothing."""

import pytest

torch = pytest.importorskip("torch")

import dataclasses
import json
import typing

import ml_dtypes
import numpy as np

import repro.checkpoint.manager as jm
import repro_torch.checkpoint.manager as tm
from repro_torch.checkpoint import CheckpointManager


class Pair(typing.NamedTuple):
    left: object
    right: object


def numpy_tree(seed=0):
    """A nested tree of every leaf kind the format has to carry."""
    rng = np.random.default_rng(seed)
    return {
        "frames": {"num": rng.integers(-9, 9, (7, 3)).astype(np.int32),
                   "sum": rng.standard_normal(5).astype(np.float32)},
        "flags": [np.array(True), rng.integers(0, 2 ** 32, (4,),
                                               dtype=np.uint32)],
        "empty": np.zeros((0, 3), np.float32),
        "scalar": np.array(2.5, np.float32),
        "weights": rng.standard_normal((6, 2)).astype(ml_dtypes.bfloat16),
        "pair": Pair(np.arange(3, dtype=np.int32), np.array(-1, np.int32)),
        "none": None,
    }


def as_torch(x):
    """The same tree with torch leaves (bf16 through its int16 bits)."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: as_torch(v) for k, v in x.items()}
    if isinstance(x, Pair):
        return Pair(as_torch(x.left), as_torch(x.right))
    if isinstance(x, list):
        return [as_torch(v) for v in x]
    if str(x.dtype) == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def bits(t):
    """A leaf as numpy bits, whichever package returned it."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


def assert_trees_bit_equal(a, b):
    la, lb = tm._flatten_with_paths(a), tm._flatten_with_paths(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        x, y = bits(x), bits(y)
        assert x.shape == y.shape and x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def manifest(d, step):
    return json.loads((d / f"step_{step:010d}" / "manifest.json").read_text())


def test_leaf_names_walk_as_jax_tree_util():
    import jax
    tree = numpy_tree()
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    jax_names = ["/".join(jm._path_str(p) for p in path) for path, _ in flat]
    assert [n for n, _ in tm._flatten_with_paths(as_torch(tree))] == jax_names
    assert [n for n, _ in tm._flatten_with_paths(np.ones(3))] == ["leaf"]


@pytest.mark.parametrize("chunks", [1, 4])
def test_manifests_equal(tmp_path, chunks):
    tree = numpy_tree()
    meta = {"spec": {"instance": "wrs"}, "tau": 3}
    jm.save_checkpoint(tree, tmp_path / "jax", 5, meta=meta, chunks=chunks)
    tm.save_checkpoint(as_torch(tree), tmp_path / "torch", 5, meta=meta,
                       chunks=chunks)
    mj, mt = manifest(tmp_path / "jax", 5), manifest(tmp_path / "torch", 5)
    assert mj == mt
    assert mt["format"] == "repro-ckpt-v1" and mt["complete"] is True
    assert mt["leaves"]["weights"]["dtype"] == "bfloat16"
    # the npy chunks are the same bytes too
    for rec in mt["leaves"].values():
        for c in rec["chunks"]:
            assert (tmp_path / "jax" / "step_0000000005" / c["file"]).read_bytes() \
                == (tmp_path / "torch" / "step_0000000005" / c["file"]).read_bytes()


def test_reference_checkpoint_loads_in_port(tmp_path):
    tree = numpy_tree(1)
    jm.save_checkpoint(tree, tmp_path, 3, meta={"k": "v"})
    got, meta = tm.load_checkpoint(as_torch(tree), tmp_path, 3)
    assert meta == {"k": "v"}
    assert got["weights"].dtype == torch.bfloat16
    assert got["flags"][1].dtype == torch.uint32
    assert isinstance(got["pair"], Pair) and got["none"] is None
    assert_trees_bit_equal(got, as_torch(tree))


def test_port_checkpoint_loads_in_reference(tmp_path):
    tree = numpy_tree(2)
    tm.save_checkpoint(as_torch(tree), tmp_path, 3, meta={"k": "v"})
    got, meta = jm.load_checkpoint(tree, tmp_path, 3)
    assert meta == {"k": "v"}
    assert str(np.asarray(got["weights"]).dtype) == "bfloat16"
    assert_trees_bit_equal(got, tree)


def test_load_places_leaves_and_checks_crc(tmp_path):
    tree = as_torch(numpy_tree())
    tm.save_checkpoint(tree, tmp_path, 0)
    got, _ = tm.load_checkpoint(tree, tmp_path, 0, device="cpu")
    assert all(t.device.type == "cpu"
               for _, t in tm._flatten_with_paths(got))
    chunk = tmp_path / "step_0000000000" / "frames__num.0.npy"
    raw = bytearray(chunk.read_bytes())
    raw[-1] ^= 0xFF
    chunk.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="CRC"):
        tm.load_checkpoint(tree, tmp_path, 0)
    with pytest.raises(KeyError, match="missing leaf"):
        tm.load_checkpoint({**tree, "extra": torch.zeros(1)}, tmp_path, 0,
                           verify_crc=False)


def test_dataclass_trees_round_trip(tmp_path):
    @dataclasses.dataclass(frozen=True)
    class Frame:
        num: torch.Tensor
        data: dict

    f = Frame(num=torch.tensor(7, dtype=torch.int32),
              data={"s1": torch.arange(4, dtype=torch.int32)})
    tm.save_checkpoint(f, tmp_path, 1)
    assert set(manifest(tmp_path, 1)["leaves"]) == {"num", "data/s1"}
    got, _ = tm.load_checkpoint(f, tmp_path, 1)
    assert isinstance(got, Frame)
    assert torch.equal(got.num, f.num) and torch.equal(got.data["s1"],
                                                       f.data["s1"])


def test_latest_step_and_read_meta_agree(tmp_path):
    assert tm.latest_step(tmp_path / "absent") is None \
        and jm.latest_step(tmp_path / "absent") is None
    tree = numpy_tree()
    jm.save_checkpoint(tree, tmp_path, 2, meta={"by": "jax"})
    tm.save_checkpoint(as_torch(tree), tmp_path, 7, meta={"by": "torch"})
    # an incomplete write (no manifest) does not count
    (tmp_path / "step_0000000009").mkdir()
    assert tm.latest_step(tmp_path) == jm.latest_step(tmp_path) == 7
    for step in (2, 7):
        assert tm.read_meta(tmp_path, step) == jm.read_meta(tmp_path, step)


@pytest.mark.parametrize("async_write", [False, True])
def test_manager_keep_prunes_as_reference(tmp_path, async_write):
    tree = numpy_tree()
    mine = CheckpointManager(tmp_path / "torch", keep=2,
                             async_write=async_write)
    ref = jm.CheckpointManager(tmp_path / "jax", keep=2, async_write=False)
    for step in (1, 3, 4, 8):
        mine.save(as_torch(tree), step, meta={"step": step})
        ref.save(tree, step, meta={"step": step})
    mine.wait()
    names = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["step_0000000004", "step_0000000008"]
    step, got, meta = mine.restore_latest(as_torch(tree))
    assert step == 8 and meta == {"step": 8}
    assert_trees_bit_equal(got, as_torch(tree))
    assert CheckpointManager(tmp_path / "none").restore_latest(tree) is None


def test_manager_snapshot_is_taken_at_save(tmp_path):
    """The tree is copied to the host when save() returns: changing a
    tensor afterwards does not change what is written."""
    t = {"x": torch.zeros(1 << 16, dtype=torch.int32)}
    mgr = CheckpointManager(tmp_path, keep=1, async_write=True)
    mgr.save(t, 0)
    t["x"].add_(1)
    mgr.wait()
    got, _ = tm.load_checkpoint(t, tmp_path, 0)
    assert int(got["x"].sum()) == 0
