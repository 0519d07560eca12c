"""Sharding rules as pure placement functions over a mesh shape.

The port of `repro.parallel.sharding`'s rules. A mesh shape is an ordered
mapping of axis names to sizes (``{"data": 16, "model": 16}``, or with a
leading ``"pod"``); a placement is a tuple with, for each dimension of a
leaf, the mesh axes it is split over (an axis name, a tuple of two or
more) or ``None``: what a ``PartitionSpec`` holds. The rules touch no
device. `named` (the reference's) turns a tree of placements into DTensor
placements on a live ``("data", "model")`` `DeviceMesh`
(``repro_torch.launch.mesh.make_host_mesh(live=True)``), and `place` /
`place_state` distribute a tree or a whole training state by them.

Conventions (divisibility-aware — falls back per dimension):
  * batch/sequence data shard over all non-'model' axes ('pod','data').
  * Megatron TP: qkv/up projections shard their output dim over 'model';
    out/down projections shard their input dim.
  * FSDP (>= ~8B params): every 2D+ weight additionally shards its largest
    remaining dim over 'data' — optimizer state inherits param specs.
  * MoE experts shard the expert dim over 'model' when divisible (olmoe:
    64 % 16 == 0), else the expert-FF dim (qwen2: 60 experts).
  * KV pools: batch dim over ('pod','data'); KV heads over 'model' when
    divisible, else the sequence / page dim; never head_dim.
"""
from __future__ import annotations

import dataclasses


def dp_axes(mesh: dict) -> tuple:
    return tuple(a for a in mesh if a != "model")


def _axsize(mesh: dict, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh[a]
    return n


def _maybe(mesh, dim: int, axes):
    """axes if dim divisible by their product else None."""
    return axes if dim % _axsize(mesh, axes) == 0 else None


# --------------------------------------------------------------------- params
_COL = ("wq", "wk", "wv", "w1", "w3", "m1", "m3", "ws1", "ws3", "in_proj",
        "wx", "wy", "wz", "wb", "wc", "wdt", "w_r", "w_i", "xwq", "xwk",
        "xwv")   # shard LAST dim (wxi matches "wx")
_ROW = ("wo", "w2", "m2", "ws2", "out_proj", "w_out", "xwo")  # shard dim -2
_REPL = ("ln", "scale", "norm", "a_param", "a_log", "dt_bias", "d_skip",
         "conv_w", "conv_b")


def _param_spec(mesh: dict, name: str, shape, fsdp: bool) -> tuple:
    nd = len(shape)
    spec = [None] * nd
    if name.startswith(_REPL) or nd <= 1:
        return tuple(spec)
    if name.startswith("embed"):
        if shape[0] % _axsize(mesh, "model") == 0:
            spec[0] = "model"
        elif shape[1] % _axsize(mesh, "model") == 0:
            spec[1] = "model"
        if fsdp:
            free = 1 if spec[0] == "model" else 0
            if spec[free] is None and shape[free] % _axsize(mesh, "data") == 0:
                spec[free] = "data"
        return tuple(spec)
    if name == "head":  # [D, V]
        spec[-1] = _maybe(mesh, shape[-1], "model")
        if fsdp and spec[-1] is not None:
            spec[0] = _maybe(mesh, shape[0], "data")
        return tuple(spec)
    if name in ("we1", "we3"):       # [L, E, D, Fe]
        if shape[1] % _axsize(mesh, "model") == 0:
            spec[1] = "model"
        else:
            spec[3] = _maybe(mesh, shape[3], "model")
        if fsdp:
            spec[2] = _maybe(mesh, shape[2], "data")
        return tuple(spec)
    if name == "we2":                # [L, E, Fe, D]
        if shape[1] % _axsize(mesh, "model") == 0:
            spec[1] = "model"
        else:
            spec[2] = _maybe(mesh, shape[2], "model")
        if fsdp:
            spec[3] = _maybe(mesh, shape[3], "data")
        return tuple(spec)
    if name == "wr":                 # [L, D, E] router
        spec[1] = _maybe(mesh, shape[1], "data") if fsdp else None
        spec[2] = _maybe(mesh, shape[2], "model")
        return tuple(spec)
    if name in ("wq", "wk", "wv", "xwq", "xwk", "xwv") and nd == 4:
        # attn_4d layout [L, D, H, hd]: the head dim over 'model' when
        # divisible, else replicated; never head_dim
        h_s = _maybe(mesh, shape[2], "model")
        if fsdp:
            spec[1] = _maybe(mesh, shape[1], "data")
        spec[2] = h_s
        return tuple(spec)
    if name in ("wo", "xwo") and nd == 4:     # [L, H, hd, D]
        h_s = _maybe(mesh, shape[1], "model")
        if fsdp:
            spec[3] = _maybe(mesh, shape[3], "data")
        spec[1] = h_s
        return tuple(spec)
    if name.startswith(_COL):
        spec[-1] = _maybe(mesh, shape[-1], "model")
        if fsdp:
            spec[-2] = _maybe(mesh, shape[-2], "data")
        return tuple(spec)
    if name.startswith(_ROW):
        spec[-2] = _maybe(mesh, shape[-2], "model")
        if fsdp:
            spec[-1] = _maybe(mesh, shape[-1], "data")
        return tuple(spec)
    # default: try model on last dim
    spec[-1] = _maybe(mesh, shape[-1], "model")
    return tuple(spec)


def _map(fn, tree, name=None):
    if isinstance(tree, dict):
        return {k: _map(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def param_specs(mesh: dict, shapes, fsdp: bool = False) -> dict:
    """A tree of tensors (meta or real) -> a tree of placements (by leaf
    name)."""
    return _map(lambda name, t: _param_spec(mesh, name, tuple(t.shape),
                                            fsdp), shapes)


# ------------------------------------------------------------- batch & cache
def _dp_if_div(mesh: dict, dim: int):
    """Largest suffix of the dp axes that divides `dim` (b=1 ->
    replicate); one axis as its name, as a PartitionSpec holds it."""
    dp = dp_axes(mesh)
    while dp and dim % _axsize(mesh, dp) != 0:
        dp = dp[1:]
    if not dp:
        return None
    return dp[0] if len(dp) == 1 else dp


def batch_specs(mesh: dict, batch) -> dict:
    return _map(lambda _, t: (_dp_if_div(mesh, t.shape[0]),)
                + (None,) * (t.dim() - 1), batch)


def _kv_tail_spec(mesh, kvh: int, seq: int):
    """(KVH, seq) preference: KV heads over 'model' when divisible, else
    the sequence / page dim; never head_dim."""
    if kvh % _axsize(mesh, "model") == 0:
        return "model", None
    if seq % _axsize(mesh, "model") == 0:
        return None, "model"
    return None, None


def cache_specs(mesh: dict, cache) -> dict:
    out = {}
    for name, s in cache.items():
        shape = tuple(s.shape)
        if name in ("k_pages", "v_pages"):   # [L, B, P, page, KVH, hd]
            dp = _dp_if_div(mesh, shape[1])
            kvh_s, seq_s = _kv_tail_spec(mesh, shape[4], shape[2])
            out[name] = (None, dp, seq_s, None, kvh_s, None)
        elif name in ("win_k", "win_v"):     # [G, B, win, KVH, hd]
            dp = _dp_if_div(mesh, shape[1])
            kvh_s, seq_s = _kv_tail_spec(mesh, shape[3], shape[2])
            out[name] = (None, dp, seq_s, kvh_s, None)
        elif name in ("enc_k", "enc_v"):     # [L, B, T, KVH, hd]
            dp = _dp_if_div(mesh, shape[1])
            kvh_s, seq_s = _kv_tail_spec(mesh, shape[3], shape[2])
            out[name] = (None, dp, seq_s, kvh_s, None)
        elif name == "ssm_state":            # [L, B, H, p, N]
            dp = _dp_if_div(mesh, shape[1])
            h_s = _maybe(mesh, shape[2], "model")
            out[name] = (None, dp, h_s, None, None)
        elif name == "conv_state":           # [L, B, W-1, C]
            dp = _dp_if_div(mesh, shape[1])
            out[name] = (None, dp, None, _maybe(mesh, shape[3], "model"))
        elif name == "rg_state":             # [n_rec, B, D]
            dp = _dp_if_div(mesh, shape[1])
            out[name] = (None, dp, _maybe(mesh, shape[2], "model"))
        elif name in ("page_table", "seq_lens"):
            dp = _dp_if_div(mesh, shape[0])
            out[name] = (dp,) + (None,) * (len(shape) - 1)
        else:
            out[name] = (None,) * len(shape)
    return out


def _sharded_bytes(tree, spec_tree, mesh: dict) -> int:
    """Per-device bytes of a tree of tensors under its placements
    (analytic: each leaf's bytes over the product of its axes' sizes)."""
    leaves, specs = [], []

    def walk(t, p):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], p[k])
        else:
            leaves.append(t)
            specs.append(p)

    walk(tree, spec_tree)
    total = 0
    for t, p in zip(leaves, specs):
        n = t.numel()
        div = 1
        for axes in p:
            if axes is None:
                continue
            for a in (axes if isinstance(axes, tuple) else (axes,)):
                div *= mesh[a]
        total += n * t.element_size() // max(div, 1)
    return total


# ------------------------------------------------------- live-mesh placement
def is_dtensor(x) -> bool:
    """Whether `x` is a DTensor (without importing DTensor for a plain
    tensor)."""
    import torch
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_shard(shape: tuple, mesh, placements) -> tuple:
    """(local shape, global offset) of this process's shard of a tensor of
    `shape` under `placements` (``Shard`` / ``Replicate``) on `mesh`:
    DTensor's split (``torch.chunk``'s, the mesh dimensions in order),
    from the mesh's sizes and this process's coordinate alone, so that it
    runs where DTensor's own helper would compute on tensors (a fake
    world under `FakeTensorMode`)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    size, offset = list(shape), [0] * len(shape)
    for i, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        d = p.dim % len(shape)
        full = -(-size[d] // mesh.size(i))
        lo = min(size[d], full * coord[i])
        hi = min(size[d], full * (coord[i] + 1))
        offset[d] += lo
        size[d] = hi - lo
    return tuple(size), tuple(offset)


@dataclasses.dataclass(frozen=True)
class NamedPlacement:
    """A placement tuple made concrete on a live `DeviceMesh`: the
    counterpart of a ``NamedSharding``. ``placements`` holds one DTensor
    placement per mesh dimension, in the mesh's order."""

    mesh: object
    placements: tuple

    def place(self, t, device=None):
        """`t` (the whole array, the same on every process) as a DTensor
        of these placements: each process cuts its own shard locally (no
        collective) into a storage of its own (a shard is never a view
        that keeps the whole array alive) and moves only that to `device`
        (`t`'s by default)."""
        import torch
        from torch.distributed.tensor import DTensor
        local, offset = local_shard(tuple(t.shape), self.mesh,
                                    self.placements)
        mine = t
        for d, (n, o) in enumerate(zip(local, offset)):
            if n != t.shape[d]:
                mine = mine.narrow(d, o, n)
        mine = (mine.contiguous() if mine is t else
                mine.clone(memory_format=torch.contiguous_format))
        mine = mine.to(t.device if device is None else device)
        return DTensor.from_local(mine, self.mesh, self.placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.contiguous().stride())


def _rebuild(like: tuple, items) -> tuple:
    items = list(items)
    return type(like)(*items) if hasattr(like, "_fields") else tuple(items)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def dtensor_placements(mesh, spec: tuple) -> tuple:
    """One DTensor placement per dimension of `mesh`: ``Shard(d)`` on each
    axis that dimension d of `spec` names, ``Replicate()`` elsewhere. An
    axis named twice, or one the mesh lacks, raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in (axes,) if isinstance(axes, str) else axes:
            if a not in names:
                raise ValueError(f"placement {spec} names axis {a!r}; the "
                                 f"mesh has {names}")
            i = names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"placement {spec} names axis {a!r} twice")
            out[i] = Shard(d)
    return tuple(out)


def named(mesh, spec_tree):
    """A tree of placement tuples (`param_specs`, `batch_specs`, ...) ->
    the same tree of `NamedPlacement` on the live `mesh`."""
    if _is_spec(spec_tree):
        return NamedPlacement(mesh, dtensor_placements(mesh, spec_tree))
    if isinstance(spec_tree, tuple):      # a NamedTuple of specs
        return _rebuild(spec_tree, (named(mesh, s) for s in spec_tree))
    return {k: named(mesh, v) for k, v in spec_tree.items()}


def place(tree, placed):
    """`tree` (tensors, whole and equal on every process) as DTensors by
    `placed`, a matching tree of `NamedPlacement` (from `named`)."""
    if isinstance(placed, NamedPlacement):
        return placed.place(tree)
    if isinstance(tree, tuple):
        return _rebuild(tree, (place(t, p) for t, p in zip(tree, placed)))
    return {k: place(tree[k], placed[k]) for k in tree}


def replicated_specs(tree):
    """Every leaf of a tree (dicts, NamedTuples) replicated."""
    if isinstance(tree, dict):
        return {k: replicated_specs(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return _rebuild(tree, (replicated_specs(t) for t in tree))
    return (None,) * tree.dim()


def mesh_device(mesh):
    """This process's device on a live `mesh`: its current card, or the
    CPU."""
    import torch
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_shape(mesh) -> dict:
    """A live `DeviceMesh`'s shape as the rules read it."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def place_state(mesh, params, opt_state, fsdp: bool = False):
    """(params, opt_state) as DTensors on the live `mesh`: the parameters
    by `param_specs`, the moments like them, the count replicated.
    Returns (params, opt_state, parameter specs)."""
    from ..optim.adamw import AdamWState
    p_spec = param_specs(mesh_shape(mesh), params, fsdp=fsdp)
    o_spec = AdamWState(count=(), m=p_spec, v=p_spec)
    return (place(params, named(mesh, p_spec)),
            place(opt_state, named(mesh, o_spec)), p_spec)
