"""Checkpointing: named-leaf npz files + a JSON manifest, async save, and
restore onto a chosen device.

The port of `repro.checkpoint.ckpt`, over trees of tensors, numpy arrays,
NamedTuples, dicts, lists and tuples. The on-disk format is the
reference's: ``step_%08d/leaves.npz`` (one array per leaf), a
``manifest.json`` of shapes and dtypes, and a ``COMMITTED`` marker written
last. Leaves are named by their path as the reference names them (dict
key, sequence index, ``.field`` for a NamedTuple field, joined by ``/``,
e.g. ``heap/.alloc/.buddy/.longest``), so a checkpoint written by either
package restores into the other.

`restore` keeps each leaf's saved width: an int64 leaf comes back int64
(the reference's `jax.numpy.asarray` truncates it to int32 when JAX runs
without x64). A dtype that drifted between writer and restorer is cast
only where the cast is lossless.

A bfloat16 leaf is written as its raw 16-bit patterns, NumPy's ``|V2``,
with ``bfloat16`` in the manifest: the bytes and descriptor the reference
writes for one. Into a bfloat16 template a ``|V2`` (or int16) leaf comes
back by reinterpreting its bits, never by a cast, so a bfloat16
checkpoint written by either package restores bit for bit (the
reference's own restore fails on it: ``astype`` has no cast from
``|V2``). NumPy has no bfloat16 without ml_dtypes, which the port does not
use, so the bits travel as int16. Each restored leaf goes to the device of
its template leaf (a tensor's device; the host, as a numpy array, for a
numpy template), or to ``device`` where one is given. ``shardings``
(a tree matching the template whose leaves are ``slice`` objects, or
None) keeps only those rows of a saved leaf's first axis: a process of a
rank mesh restores its own slice of a whole-fleet checkpoint, the
counterpart of the reference's re-placement under new shardings.
"""
from __future__ import annotations

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def _children(tree):
    """[(path key, child)] of an inner node; None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _map(fn, tree, path=""):
    """`tree` with every leaf replaced by ``fn(name, leaf)``; None is an
    empty subtree, as in the reference."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    out = [_map(fn, v, f"{path}/{k}" if path else k) for k, v in kids]
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), out))
    if isinstance(tree, list):
        return out
    return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)


def _flatten(tree) -> dict:
    named = {}
    _map(lambda k, v: named.__setitem__(k, v), tree)
    return named


_BF16_BITS = np.dtype("V2")  # a bfloat16 leaf in the npz


def _host(x) -> np.ndarray:
    """A leaf as the array written to the npz: a bfloat16 tensor as its
    raw bits (``|V2``)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_BF16_BITS)
        return x.numpy()
    return np.asarray(x)


def _host_copy(x):
    """A host copy the caller's later writes cannot reach (``.numpy()`` of
    a CPU tensor and ``np.asarray`` of an array share its memory); a
    tensor stays a tensor, so that a bfloat16 leaf keeps its name."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


def _dtype_name(x, arr: np.ndarray) -> str:
    """The manifest's dtype of leaf `x`, written as `arr`."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.dtype(leaf.dtype)


def _torch_dtype(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.from_numpy(np.empty(0, leaf.dtype)).dtype


def _cast(key, t: torch.Tensor, want: torch.dtype) -> torch.Tensor:
    """`t` as `want`, refusing a lossy cast."""
    cast = t.to(want)
    if not torch.equal(cast.to(t.dtype), t):
        raise ValueError(f"lossy dtype cast restoring {key!r}: saved "
                         f"{t.dtype} -> wanted {want}")
    return cast


def _bf16_leaf(key, arr: np.ndarray, like) -> torch.Tensor:
    """A leaf where the saved array or the template is bfloat16: saved
    bits into a bfloat16 template are reinterpreted; any other pair is
    cast, losslessly."""
    want = _torch_dtype(like)
    if arr.dtype == _BF16_BITS or (want == torch.bfloat16
                                   and arr.dtype == np.int16):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t if t.dtype == want else _cast(key, t, want)


def save(tree, step: int, ckpt_dir: str) -> str:
    """Blocking save. Returns the checkpoint path."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    named = _flatten(tree)
    arrays = {k: _host(v) for k, v in named.items()}
    np.savez(os.path.join(path, "leaves.npz"), **arrays)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(a.shape),
                       "dtype": _dtype_name(named[k], a)}
                   for k, a in arrays.items()},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    # the completion marker, last: a save cut short is never restored
    with open(os.path.join(path, "COMMITTED"), "w") as f:
        f.write("ok")
    return path


class AsyncCheckpointer:
    """Saves on a background thread; `wait()` drains them and raises a
    failed save's exception.

    `save` copies the tree to host memory before it returns (a device
    tensor is read back; a CPU tensor or numpy array is copied, since the
    caller may write to it before the worker serializes it); only the
    serialization runs on the thread."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._futures = []
        self._lock = threading.Lock()

    def save(self, tree, step: int):
        host_tree = _map(lambda _, x: _host_copy(x), tree)
        with self._lock:
            self._futures.append(
                self._pool.submit(save, host_tree, step, self.ckpt_dir))

    def wait(self):
        with self._lock:
            futs, self._futures = self._futures, []
        return [f.result() for f in futs]


def latest_step(ckpt_dir: str):
    """The newest step under `ckpt_dir` with its COMMITTED marker, or
    None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, d, "COMMITTED")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore(tree_like, step: int, ckpt_dir: str, device=None,
            shardings=None):
    """Restore into the structure of `tree_like`, whose leaves (tensors or
    numpy arrays) give each leaf's shape, dtype and device. With
    ``device`` every leaf comes back as a tensor on it. With
    ``shardings`` (a matching tree of ``slice`` leaves; a missing or None
    leaf is whole) a leaf is the rows of the saved array its slice
    selects, and the template's shape is that of the slice."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    rows = _flatten(shardings) if shardings is not None else {}
    with np.load(os.path.join(path, "leaves.npz")) as data:
        def leaf(key, like):
            arr = data[key]
            if rows.get(key) is not None:
                arr = np.ascontiguousarray(arr[rows[key]])
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"shape mismatch restoring {key!r}: saved "
                                 f"{tuple(arr.shape)}, wanted "
                                 f"{tuple(like.shape)}")
            if arr.dtype == _BF16_BITS or (
                    isinstance(like, torch.Tensor)
                    and like.dtype == torch.bfloat16):
                t = _bf16_leaf(key, arr, like)
                if device is not None:
                    return t.to(device)
                if isinstance(like, torch.Tensor):
                    return t.to(like.device)
                return t.numpy()
            want = _np_dtype(like)
            if arr.dtype != want:
                # dtype drift between writer and restorer: cast, but
                # refuse a lossy cast (a truncated heap pointer is
                # corruption)
                cast = arr.astype(want)
                if not np.array_equal(cast.astype(arr.dtype), arr):
                    raise ValueError(
                        f"lossy dtype cast restoring {key!r}: saved "
                        f"{arr.dtype} -> wanted {want}")
                arr = cast
            if device is not None:
                return torch.from_numpy(arr).to(device)
            if isinstance(like, torch.Tensor):
                return torch.from_numpy(arr).to(like.device)
            return arr

        return _map(leaf, tree_like)
