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

A training state on a mesh has DTensor leaves. Saving one writes the whole
arrays in the same format: every process takes part in gathering each
leaf, process 0 alone writes, and the ``COMMITTED`` marker follows a
barrier (`AsyncCheckpointer` writes on its thread and commits at its next
save or `wait`, which every process makes at the same points). The
manifest also records the mesh's shape. ``shardings`` leaves that are
`repro_torch.parallel.sharding.NamedPlacement` (``named(mesh, specs)``)
restore a leaf as a DTensor on that mesh, each process cutting its own
shard of the saved array; a DTensor template leaf without one comes back on
its own placements. The mesh may differ from the one saved on (the data
axis may grow or shrink: the reference's elastic contract); its
``"model"`` axis may not, and a restore onto another ``"model"`` size
raises. Restoring without a mesh gives the whole arrays.
"""
from __future__ import annotations

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..parallel.sharding import is_dtensor


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


def _whole(tree):
    """`tree` with every DTensor leaf gathered whole on the host (a
    collective: every process of its mesh makes it, in the same order),
    and the first such leaf's mesh (None without one)."""
    meshes = []

    def whole(_, x):
        if not is_dtensor(x):
            return x
        meshes.append(x.device_mesh)
        return x.full_tensor().detach().to("cpu", copy=True)

    out = _map(whole, tree)
    return out, (meshes[0] if meshes else None)


def _mesh_shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))


def _writer(mesh) -> bool:
    """Whether this process writes a tree of `mesh`: its first process."""
    import torch.distributed as dist
    return dist.get_rank() == int(mesh.mesh.flatten()[0])


def _barrier(mesh) -> None:
    """Wait for every process of `mesh` (an all-reduce of one element over
    its dimensions; processes outside the mesh take no part)."""
    from torch.distributed.tensor import DTensor, Partial
    from ..parallel.sharding import mesh_device
    one = torch.zeros(1, device=mesh_device(mesh))
    DTensor.from_local(one, mesh, [Partial()] * mesh.ndim,
                       run_check=False).full_tensor()


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


def _write(tree, step: int, ckpt_dir: str, mesh_shape=None,
           commit: bool = True) -> str:
    """Write the leaves and the manifest of a host tree; the COMMITTED
    marker last, where `commit`."""
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
    if mesh_shape is not None:
        manifest["mesh"] = mesh_shape
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if commit:
        _commit(path)
    return path


def _commit(path: str) -> None:
    # the completion marker, last: a save cut short is never restored
    with open(os.path.join(path, "COMMITTED"), "w") as f:
        f.write("ok")


def save(tree, step: int, ckpt_dir: str) -> str:
    """Blocking save. Returns the checkpoint path. A tree with DTensor
    leaves is saved by every process of their mesh together."""
    tree, mesh = _whole(tree)
    if mesh is None:
        return _write(tree, step, ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _writer(mesh):
        _write(tree, step, ckpt_dir, _mesh_shape(mesh), commit=False)
    _barrier(mesh)
    if _writer(mesh):
        _commit(path)
    _barrier(mesh)
    return path


class AsyncCheckpointer:
    """Saves on a background thread; `wait()` drains them and raises a
    failed save's exception.

    `save` copies the tree to host memory before it returns (a device
    tensor is read back; a CPU tensor or numpy array is copied, since the
    caller may write to it before the worker serializes it); only the
    serialization runs on the thread. A tree with DTensor leaves is
    gathered whole by every process in `save`; process 0's thread writes
    it, and it is committed, after a barrier, at the next `save` or
    `wait`: every process makes these calls at the same points."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._futures = []
        self._uncommitted = []
        self._mesh = None
        self._lock = threading.Lock()

    def save(self, tree, step: int):
        whole, mesh = _whole(tree)
        if mesh is not None:
            self._commit_pending()
            self._mesh = mesh
            self._uncommitted.append(os.path.join(self.ckpt_dir,
                                                  f"step_{step:08d}"))
            if not _writer(mesh):
                return
            host_tree = _map(lambda _, x: _host_copy(x), whole)
            job = (_write, host_tree, step, self.ckpt_dir,
                   _mesh_shape(mesh), False)
        else:
            host_tree = _map(lambda _, x: _host_copy(x), tree)
            job = (_write, host_tree, step, self.ckpt_dir)
        with self._lock:
            self._futures.append(self._pool.submit(*job))

    def _drain(self):
        with self._lock:
            futs, self._futures = self._futures, []
        return [f.result() for f in futs]

    def _commit_pending(self):
        if not self._uncommitted:
            return
        self._drain()
        _barrier(self._mesh)
        if _writer(self._mesh):
            for path in self._uncommitted:
                _commit(path)
        self._uncommitted = []
        _barrier(self._mesh)

    def wait(self):
        pending = list(self._uncommitted)
        self._commit_pending()
        return self._drain() or pending


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


def placements_of(tree):
    """A tree of the `NamedPlacement` of each DTensor leaf of `tree` (None
    for a plain leaf): a state's own placements, to restore onto."""
    from ..parallel.sharding import NamedPlacement
    return _map(lambda _, x: NamedPlacement(x.device_mesh,
                                            tuple(x.placements))
                if is_dtensor(x) else None, tree)


def _check_model_axis(manifest, placed, key):
    saved = manifest.get("mesh")
    if saved is None:
        return
    names = placed.mesh.mesh_dim_names
    want = int(placed.mesh.mesh.shape[names.index("model")]) \
        if "model" in names else 1
    if want != saved.get("model", 1):
        raise ValueError(f"restoring {key!r} onto a mesh with model="
                         f"{want}: it was saved on {saved}, and the "
                         f"'model' axis is an invariant (only the data axis "
                         f"may grow or shrink)")


def restore(tree_like, step: int, ckpt_dir: str, device=None,
            shardings=None):
    """Restore into the structure of `tree_like`, whose leaves (tensors or
    numpy arrays) give each leaf's shape, dtype and device. With
    ``device`` every leaf comes back as a tensor on it. With
    ``shardings`` (a matching tree; a missing or None leaf is whole) a
    ``slice`` leaf keeps the rows of the saved array it selects (the
    template's shape is that of the slice), and a `NamedPlacement` leaf
    gives a DTensor on its mesh. A DTensor template leaf without a
    sharding comes back on its own placements."""
    from ..parallel.sharding import NamedPlacement, mesh_device
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    rows = _flatten(shardings) if shardings is not None else {}
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "leaves.npz")) as data:
        def leaf(key, like):
            arr = data[key]
            placed = rows.get(key)
            if placed is None and is_dtensor(like):
                placed = NamedPlacement(like.device_mesh,
                                        tuple(like.placements))
            if isinstance(placed, NamedPlacement):
                _check_model_axis(manifest, placed, key)
            elif placed is not None:
                arr = np.ascontiguousarray(arr[placed])
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"shape mismatch restoring {key!r}: saved "
                                 f"{tuple(arr.shape)}, wanted "
                                 f"{tuple(like.shape)}")
            if arr.dtype == _BF16_BITS or (
                    isinstance(like, torch.Tensor)
                    and like.dtype == torch.bfloat16):
                t = _bf16_leaf(key, arr, like)
            else:
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
                t = None
            if isinstance(placed, NamedPlacement):
                if t is None:
                    t = torch.from_numpy(arr)
                return placed.place(t, device=mesh_device(placed.mesh)
                                    if device is None else device)
            if t is not None:
                if device is not None:
                    return t.to(device)
                if isinstance(like, torch.Tensor):
                    return t.to(like.device)
                return t.numpy()
            if device is not None:
                return torch.from_numpy(arr).to(device)
            if isinstance(like, torch.Tensor):
                return torch.from_numpy(arr).to(like.device)
            return arr

        return _map(leaf, tree_like)
