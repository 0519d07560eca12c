"""`repro_torch.core.pim_malloc` function by function against the
reference's (vmapped over cores), on the CPU, exact equality.

`malloc` / `free` / `realloc` / `calloc` with their events (path, backend
order, levels, traces) and `gc`, over a scripted sequence that reaches
the drop-mode scatters' duplicate indices (two threads popping from one
block in a round, two frees into one block in a round), every malloc
case, misuse frees, reallocs in place and moved, calloc overflow, and
`gc` with more full blocks than ``max_gc`` (the reference's top_k tie
order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heap as jheap
from repro.core import pim_malloc as jpm

from repro_torch import convert
from repro_torch.core import heap as theap
from repro_torch.core import pim_malloc as tpm

from test_torch_cuda import C, HEAP, T
from test_torch_scan_pim import cfg_pair

INT32_MAX = 2 ** 31 - 1


_JIT = {}


def _ref(name, cfg):
    """The reference's `name`, vmapped over cores and jitted once."""
    if name not in _JIT:
        _JIT[name] = jax.jit(jax.vmap(functools.partial(getattr(jpm, name),
                                                        cfg)))
    return _JIT[name]


class Pair:
    """The reference's and the port's pim_malloc state side by side."""

    def __init__(self):
        jcfg, tcfg = cfg_pair("sw")
        self.jc, self.tc = jcfg.pm, tcfg.pm
        self.j = jheap.multicore_init(jcfg, C).alloc
        self.t = theap.multicore_init(tcfg, C, device="cpu").alloc

    def call(self, name, *args, active=None):
        jargs = [jnp.asarray(np.asarray(a, np.int32)) for a in args]
        targs = [torch.from_numpy(np.asarray(a, np.int32)) for a in args]
        act = np.ones((C, T), bool) if active is None else active
        jout = _ref(name, self.jc)(self.j, *jargs, jnp.asarray(act))
        tout = getattr(tpm, name)(self.tc, self.t, *targs,
                                  active=torch.from_numpy(act))
        self.j, self.t = jout[0], tout[0]
        self.check(name)
        for g, w in zip(tout[1:], jout[1:]):
            for a, b in zip(convert.leaves(g), jax.tree.leaves(w)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=name)
        return [np.asarray(x) for x in jax.tree.leaves(jout[1:])]

    def check(self, msg):
        for i, (a, b) in enumerate(zip(convert.leaves(self.t),
                                       jax.tree.leaves(self.j))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{msg} leaf={i}")


def full(*rows):
    return np.array(rows, np.int32).reshape(C, T)


def test_malloc_free_realloc_calloc_with_events():
    p = Pair()
    # thread 0 of core 0 takes two 16 B sub-blocks of its own block
    ptr1 = p.call("malloc", full([16, 0, 0, 0], [0] * 4, [0] * 4))[0]
    ptr2 = p.call("malloc", full([16, 0, 0, 0], [0] * 4, [0] * 4))[0]
    a, b = int(ptr1[0, 0]), int(ptr2[0, 0])
    assert a // 4096 == b // 4096
    # two frees into one block in one round (threads 0 and 1)
    p.call("free", full([a, b, -1, -1], [-1] * 4, [-1] * 4))
    # two threads popping from one block in one round
    p.call("malloc", full([16, 16, 0, 0], [0] * 4, [0] * 4))
    # every malloc case, idle threads, too big, above 2^30, exhaustion
    got = p.call("malloc", full([20, 3000, 2 ** 30 + 1, HEAP + 1],
                                [0, 4096, 70000, 2048],
                                [100, 100, 100, 100]),
                 active=np.array([[1, 1, 1, 1], [0, 1, 1, 1],
                                  [1, 1, 1, 1]], bool))
    live = got[0]
    for _ in range(3):  # exhaust core 1's buddy with bypasses
        p.call("malloc", full([0] * 4, [65536] * 4, [0] * 4))
    # misuse: NULL, garbage, out of heap, a double free, a mid-block ptr
    f = live.copy()
    f[0, 1] = -1
    f[0, 2] = -7
    f[0, 3] = HEAP + 8
    f[1, 1] = int(live[1, 1]) + 16
    p.call("free", f)
    p.call("free", f)  # every served free again: dropped
    # realloc: in place, moved into / out of / within bypass, to 0,
    # to INT32_MAX, NULL ptr
    q = p.call("malloc", full([100, 3000, 16, 2048], [16, 5000, 100, 0],
                              [64, 64, 64, 64]))[0]
    sizes = full([120, 9000, 3000, 0], [INT32_MAX, 6000, 10, 16],
                 [64, 0, 2048, 16])
    q = q.copy()
    q[1, 3] = -1
    p.call("realloc", q, sizes)
    # calloc with the overflow guard
    p.call("calloc", full([3, 65536, -1, 0], [3, 1, 1, 1], [46341, 2, 7, 1]),
           full([16, 65536, 8, 4], [100, 1, 1, 1], [46341, 2, 7, 1]))


def test_gc_takes_the_lowest_full_blocks_first():
    """A prepopulated heap holds T x NC fully free blocks per core, more
    than max_gc: gc merges the lowest max_gc of them per call."""
    p = Pair()
    assert T * p.tc.nc > p.tc.max_gc
    # make some blocks not full on some cores first
    p.call("malloc", full([16, 32, 0, 0], [0, 0, 64, 0], [0] * 4))
    for _ in range(3):
        p.j = _ref("gc", p.jc)(p.j)
        p.t = tpm.gc(p.tc, p.t)
        p.check("gc")
    assert int(p.t.stats.gc_blocks[2]) == 3 * p.tc.max_gc


@pytest.mark.parametrize("sizes", [[16, 17, 2048, 2049],
                                   [0, -5, INT32_MAX, 2 ** 30 + 1]])
def test_class_of_and_realloc_meta(sizes):
    s = np.array(sizes, np.int32)
    jcfg, tcfg = cfg_pair("sw")
    np.testing.assert_array_equal(
        tpm._class_of(tcfg.pm, torch.from_numpy(s)).numpy(),
        np.asarray(jpm._class_of(jcfg.pm, jnp.asarray(s))))
