"""Plain PyTorch oracles of the kernels reached through `ops`: the
counterparts of `repro.kernels.ref`, with its semantics where they differ
from the kernels' (see ROADMAP §C):

* `buddy_alloc_batch_ref` serves each core's batch through
  `core.buddy.alloc_batch`, which has no ``size > 0`` check: a size <= 0
  gets a ``min_block`` block, where the kernel fails it.
* `freelist_op_ref` reads with clamped indices and drops a write whose
  index lies outside the array, as JAX's gathers and scatters do: a class
  >= NC leaves ``counts`` (and on a push ``stacks``) unchanged, where the
  kernel updates class NC-1.
* `paged_attention_ref` is `paged_attention.paged_attention_plain`.
"""
from __future__ import annotations

import torch

from ..core import buddy
from .paged_attention import paged_attention_plain as paged_attention_ref

__all__ = ["buddy_alloc_batch_ref", "freelist_op_ref", "paged_attention_ref"]


def buddy_alloc_batch_ref(tree, sizes, *, heap_bytes: int, min_block: int):
    """Reference for the buddy kernel: `core.buddy.alloc_batch` per core.
    Returns (offsets [C, B], new tree [C, n_nodes])."""
    cfg = buddy.BuddyConfig(heap_bytes=heap_bytes, min_block=min_block)
    st, offs, _ = buddy.alloc_batch(cfg, buddy.BuddyState(tree), sizes)
    return offs, st.longest


def _wrap(i, n: int):
    """JAX's index normalization: a negative index counts from the end."""
    return torch.where(i < 0, i + n, i)


def freelist_op_ref(stacks, counts, op, cls, ptr_in):
    """Reference for the freelist kernel: one pop or push per thread.
    Returns (ptr_out [T], new counts, new stacks)."""
    T, NC, CAP = stacks.shape
    t = torch.arange(T, device=stacks.device)
    c = torch.clamp(cls, min=0)
    c_read = c.clamp(max=NC - 1).long()
    cnt = counts[t, c_read]
    is_pop = (op == 0) & (cnt > 0)
    is_push = (op == 1) & (cnt < CAP)

    pos_pop = _wrap(torch.clamp(cnt - 1, min=0), CAP).clamp(0, CAP - 1)
    ptr_out = torch.where(is_pop, stacks[t, c_read, pos_pop.long()],
                          -1).to(torch.int32)

    # a write lands only where every index lies inside the array
    pos_push = _wrap(torch.clamp(cnt, max=CAP - 1), CAP)
    in_cls = c < NC
    put = in_cls & (pos_push >= 0) & (pos_push < CAP)
    new_stacks = stacks.clone()
    tp, cp, pp = t[put], c[put].long(), pos_push[put].long()
    new_stacks[tp, cp, pp] = torch.where(is_push[put], ptr_in[put],
                                         stacks[tp, cp, pp])
    delta = torch.where(is_pop, -1, torch.where(is_push, 1, 0))
    new_counts = counts.clone()
    tc, cc = t[in_cls], c[in_cls].long()
    new_counts[tc, cc] = (counts[tc, cc] + delta[in_cls]).to(torch.int32)
    return ptr_out, new_counts, new_stacks
