"""Carry state, requests, model parameters and optimizer state between the
reference and the port.

The port's state is a tree of NamedTuples with the reference's field names
and nesting (`SystemState(alloc=PimMallocState(buddy=BuddyState(...), ...),
cache=BuddyCacheState(...), telem=HeapTelemetry(...))`), so flattening both
in field order pairs every leaf. The reference side is read by attribute
name and `numpy.asarray` alone: this module imports nothing of it.
"""
from __future__ import annotations

import numpy as np
import torch

from . import device as _device
from .core.buddy import BuddyState
from .core.buddy_cache import BuddyCacheState
from .core.heap import AllocRequest
from .core.pim_malloc import PimMallocState, Stats
from .core.system import HeapTelemetry, SystemState
from .optim.adamw import AdamWState


def _tensor(x, dev, core_axis: bool) -> torch.Tensor:
    a = np.array(x, dtype=np.int32)  # a writable copy
    return torch.from_numpy(a if core_axis else a[None]).to(dev)


def state_from_reference(st, device="cuda", core_axis: bool = True
                         ) -> SystemState:
    """A reference ``SystemState`` (``pim_malloc`` + buddy-cache layout)
    as the port's. ``core_axis=False`` marks a single-core state, whose
    leaves gain a leading ``[1]`` axis; otherwise they already carry
    ``[C]``."""
    dev = _device.resolve(device)

    def t(x):
        return _tensor(x, dev, core_axis)

    al, ca, te = st.alloc, st.cache, st.telem
    return SystemState(
        alloc=PimMallocState(
            buddy=BuddyState(longest=t(al.buddy.longest)),
            counts=t(al.counts), stacks=t(al.stacks),
            block_cls=t(al.block_cls), block_free=t(al.block_free),
            big_log2=t(al.big_log2),
            stats=Stats(*(t(getattr(al.stats, f)) for f in Stats._fields))),
        cache=BuddyCacheState(tags=t(ca.tags), last_used=t(ca.last_used),
                              clock=t(ca.clock)),
        telem=HeapTelemetry(live_bytes=t(te.live_bytes),
                            hwm_bytes=t(te.hwm_bytes)))


def request_from_reference(req, device="cuda", core_axis: bool = True
                           ) -> AllocRequest:
    """A reference ``AllocRequest`` ([C, T] leaves, or [T] with
    ``core_axis=False``) as the port's int32 ``[C, T]`` tensors."""
    dev = _device.resolve(device)
    return AllocRequest(*(_tensor(x, dev, core_axis)
                          for x in (req.op, req.size, req.ptr)))


def _leaf(x, dev, dtype=None) -> torch.Tensor:
    """One reference leaf as a tensor on `dev`, cast to `dtype` when given,
    else of NumPy's dtype: a bfloat16 leaf (ml_dtypes', a kind-'V' dtype
    to NumPy) goes through float32, which holds it exactly."""
    a = np.asarray(x)
    bf16 = a.dtype.name == "bfloat16"
    if a.dtype.kind not in "fiub":
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a)).to(dev)
    if dtype is None and bf16:
        dtype = torch.bfloat16
    return t if dtype is None else t.to(dtype)


def params_from_reference(np_tree, device="cuda", dtype=None) -> dict:
    """The reference's parameter tree (nested dicts of arrays, e.g. after
    ``jax.tree.map(numpy.asarray, params)``) as the port's: the same
    nesting and names, each leaf a tensor on `device`, cast to `dtype`
    when given (else of the leaf's own dtype, bfloat16 included)."""
    dev = _device.resolve(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _leaf(x, dev, dtype)

    return conv(np_tree)


def opt_state_from_reference(st, device="cuda") -> AdamWState:
    """The reference's ``AdamWState(count, m, v)`` as the port's: count an
    int32 scalar tensor, the moments with `params_from_reference`'s nesting
    in their own dtype (fp32 or bf16)."""
    dev = _device.resolve(device)
    return AdamWState(
        count=torch.tensor(int(np.asarray(st.count)), dtype=torch.int32,
                           device=dev),
        m=params_from_reference(st.m, dev), v=params_from_reference(st.v, dev))


def to_numpy(tree):
    """The same NamedTuple tree with every tensor copied to a NumPy array."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return type(tree)(*(to_numpy(x) for x in tree))


def leaves(tree) -> list:
    """Leaves in field order, the order of the reference's tree flatten."""
    if isinstance(tree, tuple):
        return [leaf for x in tree for leaf in leaves(x)]
    return [tree]
