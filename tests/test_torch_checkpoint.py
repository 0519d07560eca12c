"""The port's checkpoint module (`repro_torch.checkpoint.ckpt`) against the
reference's format, on the CPU.

Round trips over every kind's worked heap state; the leaf names, shapes
and dtypes of a heap state equal the reference's, so a checkpoint written
by either package restores into the other; an int64 leaf keeps its width
(the reference's restore truncates 597721999265 to int32 without x64);
drifted dtypes are cast only where lossless; the COMMITTED marker; the
async saver copies its tree before returning and passes a worker's
exception through `wait`. The tolerance is exact equality.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import heap as jheap
from repro.core import system as jsys

from repro_torch.checkpoint import ckpt
from repro_torch.core import heap, system
from repro_torch.core.heap import OP_FREE, OP_MALLOC, OP_REALLOC, AllocRequest

T = 4
HEAP = 1 << 16
REF_KIND = {"fused": "pallas"}
BIG = 597721999265  # above 2^32: truncated by an int32 round trip


def _cfg(kind, mod=system):
    return mod.SystemConfig(kind=kind, heap_bytes=HEAP, num_threads=T)


def _churned_state(kind, seed=0, rounds=6):
    """A heap state that has worked: malloc / free / realloc churn on two
    cores."""
    h = heap.MultiCoreHeap(_cfg(kind), num_cores=2, device="cpu")
    rng = np.random.default_rng(seed)
    ptrs = np.full((2, T), -1, np.int64)
    for _ in range(rounds):
        op = rng.choice([OP_MALLOC, OP_FREE, OP_REALLOC], (2, T))
        op = np.where((op != OP_MALLOC) & (ptrs < 0), OP_MALLOC,
                      op).astype(np.int32)
        size = rng.choice([32, 128, 2048], (2, T)).astype(np.int32)
        resp = h.step(AllocRequest(*(torch.from_numpy(x) for x in (
            op, size, ptrs.astype(np.int32)))))
        rp = resp.ptr.numpy()
        ptrs = np.where(op == OP_FREE, -1, np.where(rp >= 0, rp, ptrs))
    return h.state


def _leaves(tree):
    return ckpt._flatten(tree)


def _assert_tree_equal(a, b):
    fa, fb = _leaves(a), _leaves(b)
    assert list(fa) == list(fb)
    for k in fa:
        x, y = ckpt._host(fa[k]), ckpt._host(fb[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("kind", heap.kinds())
def test_save_restore_round_trip_every_kind(kind, tmp_path):
    state = _churned_state(kind)
    path = ckpt.save(state, 3, str(tmp_path))
    assert os.path.exists(os.path.join(path, "COMMITTED"))
    assert ckpt.latest_step(str(tmp_path)) == 3
    template = heap.multicore_init(_cfg(kind), 2, device="cpu")
    back = ckpt.restore(template, 3, str(tmp_path))
    _assert_tree_equal(state, back)
    assert type(back) is type(state)
    assert all(isinstance(x, torch.Tensor) for x in _leaves(back).values())


@pytest.mark.parametrize("kind", ["hwsw", "fused"])
def test_heap_checkpoints_cross_between_the_packages(kind, tmp_path):
    """The fleet state's leaves carry the reference's names, shapes and
    dtypes (19 for these kinds); the reference restores the port's worked
    state and the port restores the reference's fresh one."""
    ref_kind = REF_KIND.get(kind, kind)
    ckpt.save(heap.sharded_init(_cfg(kind), 1, 2, device="cpu"), 0,
              str(tmp_path / "port"))
    jckpt.save(jheap.sharded_init(_cfg(ref_kind, jsys), 1, 2), 0,
               str(tmp_path / "ref"))
    manifests = [json.loads((tmp_path / d / "step_00000000" /
                             "manifest.json").read_text())
                 for d in ("port", "ref")]
    assert manifests[0] == manifests[1]
    assert len(manifests[0]["leaves"]) == 19
    assert ".alloc/.buddy/.longest" in manifests[0]["leaves"]

    state = _churned_state(kind, seed=4)
    ckpt.save(state, 1, str(tmp_path / "port"))
    want = jckpt.restore(jheap.multicore_init(_cfg(ref_kind, jsys), 2), 1,
                         str(tmp_path / "port"))
    fresh = heap.sharded_init(_cfg(kind), 1, 2, device="cpu")
    got = ckpt.restore(fresh, 0, str(tmp_path / "ref"))
    for k, x in _leaves(state).items():
        np.testing.assert_array_equal(np.asarray(jckpt._flatten(want)[k]),
                                      x.numpy(), err_msg=k)
    _assert_tree_equal(got, fresh)


def test_restore_places_leaves_by_template_or_device(tmp_path):
    """A numpy template leaf comes back as a host array, a tensor
    template's on its device; ``device=`` makes every leaf a tensor on
    it."""
    tree = {"a": np.arange(4, dtype=np.int32),
            "b": torch.arange(3, dtype=torch.float32),
            "c": [None, (torch.ones(2, dtype=torch.bool),)]}
    ckpt.save(tree, 0, str(tmp_path))
    back = ckpt.restore(tree, 0, str(tmp_path))
    assert isinstance(back["a"], np.ndarray)
    assert isinstance(back["b"], torch.Tensor)
    assert back["c"][0] is None and isinstance(back["c"][1], tuple)
    _assert_tree_equal(tree, back)
    on = ckpt.restore(tree, 0, str(tmp_path), device=torch.device("cpu"))
    assert all(isinstance(x, torch.Tensor) for x in _leaves(on).values())
    _assert_tree_equal(tree, on)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_irregular_trees_round_trip_int64_exactly(seed, tmp_path):
    """Nested dicts / lists, mixed dtypes, 0-d scalars and int64 leaves
    above 2^32 (the reference's restore truncates these) round-trip
    exactly, as numpy and as tensors."""
    rng = np.random.default_rng(seed)
    tree = {
        "a": rng.integers(-100, 100, int(rng.integers(1, 5)),
                          dtype=np.int32),
        "b": [rng.random(3).astype(np.float32),
              {"c": rng.integers(0, 2, (2, 2)).astype(bool)}],
        "d": np.int64(BIG if seed == 0 else rng.integers(1 << 40)),
        "e": torch.tensor([BIG, -BIG], dtype=torch.int64),
    }
    ckpt.save(tree, 0, str(tmp_path))
    back = ckpt.restore(tree, 0, str(tmp_path))
    _assert_tree_equal(tree, back)
    assert back["e"].dtype == torch.int64 and int(back["e"][0]) == BIG
    if seed == 0:
        assert int(back["d"]) == BIG


def test_restore_casts_drifted_dtype_losslessly(tmp_path):
    ckpt.save({"x": np.arange(8, dtype=np.int64)}, 0, str(tmp_path))
    for want, device in ((np.zeros(8, np.int32), None),
                         (torch.zeros(8, dtype=torch.int32), None),
                         (np.zeros(8, np.int32), "cpu")):
        back = ckpt.restore({"x": want}, 0, str(tmp_path), device=device)
        assert ckpt._host(back["x"]).dtype == np.int32
        np.testing.assert_array_equal(ckpt._host(back["x"]), np.arange(8))


def test_restore_refuses_a_lossy_cast_and_a_shape_mismatch(tmp_path):
    ckpt.save({"x": np.array([1 << 40], np.int64)}, 0, str(tmp_path))
    for want in (np.zeros(1, np.int32), torch.zeros(1, dtype=torch.int32)):
        for device in (None, "cpu"):
            with pytest.raises(ValueError, match="lossy"):
                ckpt.restore({"x": want}, 0, str(tmp_path), device=device)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore({"x": np.zeros(2, np.int64)}, 0, str(tmp_path))


def test_latest_step_needs_the_committed_marker(tmp_path):
    rng = np.random.default_rng(7)
    for step in range(5):
        tree = {"x": rng.integers(-5, 5, 4, dtype=np.int32)}
        ckpt.save(tree, step, str(tmp_path))
        _assert_tree_equal(tree, ckpt.restore(tree, step, str(tmp_path)))
    assert ckpt.latest_step(str(tmp_path)) == 4
    os.remove(os.path.join(str(tmp_path), "step_00000004", "COMMITTED"))
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert ckpt.latest_step(os.path.join(str(tmp_path), "nope")) is None


def test_async_checkpointer_saves_and_waits(tmp_path):
    acp = ckpt.AsyncCheckpointer(str(tmp_path))
    tree = {"x": torch.arange(10, dtype=torch.int32)}
    acp.save(tree, 1)
    acp.save(tree, 2)
    assert len(acp.wait()) == 2
    assert ckpt.latest_step(str(tmp_path)) == 2
    _assert_tree_equal(tree, ckpt.restore(tree, 2, str(tmp_path)))


def test_async_checkpointer_passes_a_failure_through_wait(tmp_path):
    with open(os.path.join(str(tmp_path), "step_00000005"), "w") as f:
        f.write("in the way")             # the step dir's path is a file
    acp = ckpt.AsyncCheckpointer(str(tmp_path))
    acp.save({"x": np.zeros(2)}, 5)
    with pytest.raises(OSError):
        acp.wait()
    assert ckpt.latest_step(str(tmp_path)) is None


@pytest.mark.parametrize("make", [
    lambda: np.arange(6, dtype=np.int32),
    lambda: torch.arange(6, dtype=torch.int32)])  # .numpy() shares memory
def test_async_checkpointer_copies_before_mutation(make, tmp_path,
                                                   monkeypatch):
    """Writing to the source after `save` returns must not reach the
    checkpoint, for a numpy array and for a CPU tensor."""
    gate = threading.Event()
    orig = ckpt.save

    def slow_save(tree, step, ckpt_dir):
        gate.wait(5)
        return orig(tree, step, ckpt_dir)

    x = make()
    acp = ckpt.AsyncCheckpointer(str(tmp_path))
    monkeypatch.setattr(ckpt, "save", slow_save)
    acp.save({"x": x}, 0)
    monkeypatch.setattr(ckpt, "save", orig)
    x[:] = -1
    gate.set()
    acp.wait()
    back = ckpt.restore({"x": np.zeros(6, np.int32)}, 0, str(tmp_path))
    np.testing.assert_array_equal(back["x"], np.arange(6))
