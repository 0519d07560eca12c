"""Seeded-bug mini-backends: one deliberately broken step per pass.

The port of `repro.analysis.fixtures`. Each fixture serves the (state,
AllocRequest) -> (state, out) calling convention of a real backend step
on one core (``[1, T]`` requests), small enough to read in one screen,
and plants exactly the defect its pass exists to catch. `pimcheck
--fixtures` (and tests/test_torch_analysis.py) asserts every fixture is
flagged by its `expect_pass`: the checker passes are themselves under
test, in both directions: real kinds green, planted bugs red.

A round is recorded by running it, and torch checks every eager index, so
the request's values lie inside the tables: the passes flag where a value
comes from, not the value itself.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import device as _device
from ..core.heap import AllocRequest

T = 4  # fixture thread count


class FixState(NamedTuple):
    table: torch.Tensor   # int32[128] — a "size-class table"
    counts: torch.Tensor  # int32[64]  — a "freelist occupancy" row


def fix_init(device="cuda") -> FixState:
    dev = _device.resolve(device)
    return FixState(table=torch.arange(128, dtype=torch.int32, device=dev),
                    counts=torch.zeros((64,), dtype=torch.int32, device=dev))


def fix_request(device="cuda") -> AllocRequest:
    dev = _device.resolve(device)

    def row(xs):
        return torch.tensor([xs], dtype=torch.int32, device=dev)

    return AllocRequest(op=row([1] * T), size=row([16, 64, 96, 120]),
                        ptr=row([0, 32, 32, 48]))


# --- int-width: pointer computed through float -----------------------------
def step_float_leak(st: FixState, req: AllocRequest):
    """BUG: scales the request size in float32 and converts the result
    back to an int32 pointer — bits above 2^24 are silently lost."""
    ptr = (req.size.to(torch.float32) * 1.5).to(torch.int32)
    return st, ptr


# --- index-bounds: raw request value used as a table index -----------------
def step_unclamped_index(st: FixState, req: AllocRequest):
    """BUG: indexes the class table directly with the request size — no
    clamp or remainder, so a size of 8192 reads past the 128-entry table
    (a device-side assert on the card)."""
    csize = st.table[req.size.long()]
    return st, csize


# --- write-race: per-thread scatter keyed on the request pointer -----------
def step_aliased_scatter(st: FixState, req: AllocRequest):
    """BUG: every thread writes its size into `counts[ptr]`: two threads
    carrying the same pointer (threads 1 and 2 here) write the same cell
    in one round, and the survivor is write-order-defined."""
    st.counts[req.ptr.long()] = req.size
    return st, st.counts[:T]


# --- donation: state buffer re-made from a constant ------------------------
def step_dropped_donation(st: FixState, req: AllocRequest):
    """BUG: returns a freshly zeroed table instead of the (possibly
    updated) input buffer — the input is dropped and a new allocation is
    made every round."""
    counts = st.counts + req.size.sum(dtype=torch.int32)
    return (FixState(table=torch.zeros((128,), dtype=torch.int32,
                                       device=counts.device),
                     counts=counts), counts[:T])


# name -> (step_fn, expected pass that must flag it)
FIXTURES = {
    "float_leak": (step_float_leak, "int-width"),
    "unclamped_index": (step_unclamped_index, "index-bounds"),
    "aliased_scatter": (step_aliased_scatter, "write-race"),
    "dropped_donation": (step_dropped_donation, "donation"),
}
