"""The port's fused round against the reference's, output for output.

`repro_torch.kernels.heap_step.protocol_round` (plain PyTorch, batched over
an explicit core axis) is held against `repro.kernels.heap_step.
protocol_round` under `jax.jit(jax.vmap(...))` — the pure-jnp body the
Pallas kernel runs, as the reference's own CPU tests run it — with its
batched refill both off and on, each against the port's with its own off
and on. Both sides get the same inputs every round
(made from a seeded NumPy stream); all 31 outputs (9 state leaves, 22
per-thread records) must be equal. The tolerance is exact equality: every
output is int32.

At small widths: heap 2^18 with 4 KiB blocks (nb=64, depth 6), T=4,
CAP=256 (the minimum, so exactly-full freelists occur), C=3 cores.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import buddy as jbuddy
from repro.core import pim_malloc as jpm
from repro.kernels import heap_step as jhs

from repro_torch.core import buddy as tbuddy
from repro_torch.kernels import heap_step as ths

from test_torch_cuda import (C, CAP, GEOM, HEAP, INT32_MAX, T, drive,
                             initial_state, mixed_round)


def ref_round(batch_refill):
    return jax.jit(jax.vmap(functools.partial(
        jhs.protocol_round, batch_refill=batch_refill, **GEOM)))


def run_port(args, batch_refill=None):
    """The port's wrapper on copies of `args` (it updates its state
    arguments in place)."""
    return ths.fused_heap_step(*(torch.from_numpy(np.array(a)) for a in args),
                               batch_refill=batch_refill, **GEOM)


@pytest.mark.parametrize("batch_refill", [False, True])
def test_protocol_round_matches_reference(batch_refill):
    """The reference's round with its batched refill off or on, against
    the port's with its own off and on (the stream reaches the run-carve:
    test_torch_batch_refill.py)."""
    for port_refill in (False, True):
        tally = drive(ref_round(batch_refill),
                      functools.partial(run_port, batch_refill=port_refill),
                      rounds=40, seed=11)
        missing = [k for k, v in tally.items() if v == 0]
        assert not missing, f"stream never reached: {missing} ({tally})"


def test_initial_state_matches_reference():
    """The shared stream starts from the reference's prepopulated state."""
    pmc = jpm.PimMallocConfig(heap_bytes=HEAP, num_threads=T, cap=CAP)
    st = jpm.init(pmc, prepopulate=True)
    got = initial_state()
    for a, b in zip(got, [st.buddy.longest, st.counts, st.stacks,
                          st.block_cls, st.block_free, st.big_log2]):
        np.testing.assert_array_equal(a, np.broadcast_to(b, a.shape))


def test_wrapper_takes_plain_path_on_cpu():
    """On CPU tensors the wrapper is the plain version with the kernel's
    contract: same outputs, no kernel launch, the state arguments updated
    in place and returned, the requests left unchanged."""
    rng = np.random.default_rng(3)
    op, size, ptr = mixed_round(rng, [[] for _ in range(C)])
    args = [torch.from_numpy(a) for a in [op, size, ptr] + initial_state()]
    before = [a.clone() for a in args]
    want = ths.protocol_round(*args, **GEOM)
    for a, b in zip(args, before):
        assert torch.equal(a, b), "protocol_round itself stays pure"
    launches = ths.fused_heap_step.launches
    got = ths.fused_heap_step(*args, **GEOM)
    assert ths.fused_heap_step.launches == launches
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, a in zip(got[:ths.N_STATE], args[3:]):
        assert g is a
    assert not torch.equal(args[3 + 8], before[3 + 8]), "clock advanced"
    for a, b in zip(args[:3], before[:3]):
        assert torch.equal(a, b)


def test_bit_helpers_match_reference():
    """next_pow2 wraps above 2^30 and ilog2(INT32_MIN) is 31, as in JAX."""
    x = np.array([-5, 0, 1, 2, 3, 4095, 4096, 4097, 1 << 30, (1 << 30) + 1,
                  INT32_MAX], np.int32)
    np2 = tbuddy.next_pow2(torch.from_numpy(x))
    np.testing.assert_array_equal(np2.numpy(), np.asarray(jbuddy.next_pow2(x)))
    assert int(np2[-1]) == -2 ** 31
    np.testing.assert_array_equal(tbuddy.ilog2(np2).numpy(),
                                  np.asarray(jbuddy.ilog2(jnp.asarray(np2))))


def test_same_round_double_free_matches_reference():
    """Two threads free one bypass block in the same round: both reach the
    backend, and the second walk reads the -1 the first wrote to big_log2
    (a 1-byte free) — the port reproduces the reference exactly."""
    state = initial_state()
    op = np.zeros((C, T), np.int32)
    size = np.zeros((C, T), np.int32)
    ptr = np.full((C, T), -1, np.int32)
    op[:, 0], size[:, 0] = 1, 8192
    for run in (ref_round(False), ref_round(True)):
        out = run_port([op, size, ptr] + state)
        big = out.m_ptr[:, 0].numpy()
        assert (big >= 0).all()
        op2 = np.zeros((C, T), np.int32)
        op2[:, :2] = 2
        ptr2 = np.full((C, T), -1, np.int32)
        ptr2[:, 0] = ptr2[:, 1] = big
        nxt = [x.numpy() for x in out[:ths.N_STATE]]
        args = [op2, np.zeros((C, T), np.int32), ptr2] + nxt
        got, want = run_port(args), run(*args)
        for f, g, w in zip(ths.FusedRoundOut._fields, got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f)
        assert got.f_big[:, :2].numpy().all()
