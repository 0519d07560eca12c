"""The metadata-cache simulators against the reference's, on the CPU.

`sw_buffer_access` (PIM-malloc-SW's direct-mapped line buffer),
`buddy_cache_access` (the HW/SW design point's LRU CAM) and
`simulate_traces` over ``[C, B, L]`` traces, with -1 entries, empty
entries (last_used -1, all tied), tied timestamps and a word held twice
(the tie rules: a hit takes the first matching entry, a miss evicts the
first entry of least last_used). Exact equality: every value is int32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import buddy_cache as jbc

from repro_torch import convert
from repro_torch.core import buddy_cache as tbc

C, B, L = 4, 6, 9


def _stack(st, n):
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), st)


def _cfgs(kind):
    if kind == "sw":
        return (jbc.SWBufferConfig(buf_bytes=256, line_bytes=64),
                tbc.SWBufferConfig(buf_bytes=256, line_bytes=64))
    return jbc.BuddyCacheConfig(n_entries=4), tbc.BuddyCacheConfig(n_entries=4)


def _fns(kind):
    jcfg, tcfg = _cfgs(kind)
    if kind == "sw":
        return (functools.partial(jbc.sw_buffer_access, jcfg),
                functools.partial(tbc.sw_buffer_access, tcfg),
                _stack(jbc.sw_buffer_init(jcfg), C),
                tbc.SWBufferState(tags=torch.full((C, tcfg.n_lines), -1,
                                                  dtype=torch.int32)))
    tied = jbc.BuddyCacheState(
        tags=jnp.array([[-1, -1, -1, -1], [3, 5, 3, 7], [2, 9, 4, 6],
                        [-1, 8, -1, 1]], jnp.int32),
        last_used=jnp.array([[-1, -1, -1, -1], [4, 1, 1, 0],
                             [2, 2, 2, 2], [-1, 5, -1, 3]], jnp.int32),
        clock=jnp.array([0, 5, 3, 6], jnp.int32))
    return (functools.partial(jbc.buddy_cache_access, jcfg),
            functools.partial(tbc.buddy_cache_access, tcfg), tied,
            tbc.BuddyCacheState(*(torch.from_numpy(np.array(x))
                                  for x in tied)))


def _traces(seed):
    rng = np.random.default_rng(seed)
    tr = rng.integers(0, 200, size=(C, B, L)).astype(np.int32)
    tr[rng.random((C, B, L)) < 0.4] = -1
    tr[0] = -1           # a core with no access at all
    tr[1, 2] = -1        # an op with none
    tr[2, :, ::2] = 48   # word 3 again and again: hits
    return tr


@pytest.mark.parametrize("kind", ["sw", "hw"])
def test_access_matches_reference(kind):
    jacc, tacc, jst, tst = _fns(kind)
    jacc = jax.vmap(jacc)
    tr = _traces(1)
    for i in range(B * L):
        node = tr[:, i // L, i % L]
        jst, jh, jd = jacc(jst, jnp.asarray(node))
        tst, th, td = tacc(tst, torch.from_numpy(node))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        for a, b in zip(convert.leaves(tst), jax.tree.leaves(jst)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", ["sw", "hw"])
@pytest.mark.parametrize("seed", [2, 3])
def test_simulate_traces_matches_reference(kind, seed):
    jacc, tacc, jst, tst = _fns(kind)
    tr = _traces(seed)
    jst, js = jax.vmap(lambda s, t: jbc.simulate_traces(jacc, s, t))(
        jst, jnp.asarray(tr))
    tst, ts = tbc.simulate_traces(tacc, tst, torch.from_numpy(tr))
    for a, b in zip(convert.leaves((tst, ts)), jax.tree.leaves((jst, js))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(ts.hits.sum() + ts.misses.sum()) == int((tr >= 0).sum())


def test_inits_match_reference():
    for j, t in ((jbc.sw_buffer_init(jbc.SWBufferConfig()),
                  tbc.sw_buffer_init(tbc.SWBufferConfig(), device="cpu")),
                 (jbc.buddy_cache_init(jbc.BuddyCacheConfig()),
                  tbc.buddy_cache_init(tbc.BuddyCacheConfig(),
                                       device="cpu"))):
        for a, b in zip(convert.leaves(t), jax.tree.leaves(j)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
