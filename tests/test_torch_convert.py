"""State and requests carried between the reference and the port, and the
port's prepopulated `init` against the reference's (exact equality: every
leaf is int32)."""
import jax
import numpy as np
import pytest

from repro.core import heap as jheap
from repro.core import pim_malloc as jpm
from repro.core import system as jsys

from repro_torch import convert
from repro_torch.core import heap as theap
from repro_torch.core import pim_malloc as tpm
from repro_torch.core import system as tsys


def _cfg_pair(heap_bytes, threads, cap, classes):
    pj = jpm.PimMallocConfig(heap_bytes=heap_bytes, num_threads=threads,
                             cap=cap, size_classes=classes)
    pt = tpm.PimMallocConfig(heap_bytes=heap_bytes, num_threads=threads,
                             cap=cap, size_classes=classes)
    return (jsys.SystemConfig(kind="hwsw", heap_bytes=heap_bytes,
                              num_threads=threads, pm=pj),
            tsys.SystemConfig(kind="fused", heap_bytes=heap_bytes,
                              num_threads=threads, pm=pt))


@pytest.mark.parametrize("heap_bytes,threads,cap,classes", [
    (1 << 18, 4, 256, (16, 32, 64, 128, 256, 512, 1024, 2048)),
    (1 << 20, 16, 1024, (16, 32, 64, 128, 256, 512, 1024, 2048)),
    # fewer blocks than (thread, class) pairs: the carve runs out
    (1 << 16, 4, 8, (512, 1024, 2048)),
])
def test_init_prepopulate_matches_reference(heap_bytes, threads, cap,
                                            classes):
    jcfg, tcfg = _cfg_pair(heap_bytes, threads, cap, classes)
    want = jheap.multicore_init(jcfg, num_cores=2)
    got = theap.init(tcfg, num_cores=2, device="cpu")
    w, g = jax.tree.leaves(want), convert.leaves(got)
    assert len(w) == len(g)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_state_and_request_round_trip():
    """Reference state -> port -> NumPy keeps every leaf, for a stacked
    [C] state and for a single-core one."""
    jcfg, _ = _cfg_pair(1 << 18, 4, 256,
                        (16, 32, 64, 128, 256, 512, 1024, 2048))
    st = jheap.init(jcfg)
    stc = jheap.multicore_init(jcfg, num_cores=3)
    for src, core_axis in ((stc, True), (st, False)):
        back = convert.to_numpy(convert.state_from_reference(
            src, device="cpu", core_axis=core_axis))
        for a, b in zip(convert.leaves(back), jax.tree.leaves(src)):
            b = np.asarray(b)
            np.testing.assert_array_equal(a, b if core_axis else b[None])
            assert a.dtype == np.int32
    req = jheap.malloc_request(np.array([16, 0, 9000, 70], np.int32))
    got = convert.request_from_reference(req, device="cpu", core_axis=False)
    assert tuple(got.op.shape) == (1, 4)
    for a, b in zip(convert.to_numpy(got), req):
        np.testing.assert_array_equal(a[0], np.asarray(b))
