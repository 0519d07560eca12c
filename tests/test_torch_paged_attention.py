"""The port's paged attention against the reference's, on the CPU.

`repro_torch.kernels.paged_attention.paged_attention_plain` (the plain
version the CUDA kernel is held to on the card, and what the wrapper runs
on CPU tensors) against the reference's oracle `ref.paged_attention_ref`
and its Pallas kernel in interpret mode, on the same NumPy inputs: MHA,
GQA (G = 4) and MQA at head_dim 32 and 128; seq_len 0, 1, a page boundary,
one past it and full; permuted page tables with -1 entries.

Tolerances (atol = rtol), the reference's own (tests/test_kernels.py):
2e-5 in fp32 (the same products summed in another order), 2e-2 in bf16
(the inputs are the same bf16 values on both sides; the output is rounded
to bf16 once, from fp32 sums taken in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels import ref as jref
from repro.kvcache import paged as jpaged

from repro_torch.kernels import paged_attention as tpa
from repro_torch.kvcache import paged as tpaged

from test_torch_cuda import HEADS, TOL, paged_case, to_torch

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax(case, dtype):
    q, k, v, pt, sl = case
    return [jnp.asarray(x, JDT[dtype]) for x in (q, k, v)] + [
        jnp.asarray(pt), jnp.asarray(sl)]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,D", HEADS)
def test_plain_matches_reference_oracle_and_pallas(H, KVH, D, dtype):
    case = paged_case(11, H, KVH, D)
    got = tpa.paged_attention(*to_torch(case, dtype, "cpu"))
    assert got.dtype == dtype and got.shape == (len(case[4]), H, D)
    assert not got[0].any()  # seq_len 0 gives zeros, not NaN
    _close(got, jref.paged_attention_ref(*_jax(case, dtype)), TOL[dtype])
    _close(got, ops.paged_attention_op(*_jax(case, dtype), interpret=True),
           TOL[dtype])


def test_plain_respects_page_table():
    """Swapping page-table rows permutes the outputs (the reference's
    test_paged_attention_respects_page_table, on the port)."""
    q, k, v, _, _ = paged_case(13, 2, 2, 128, page=128, pages=2,
                               seq_lens=(256, 256))
    q2 = np.concatenate([q[:1], q[:1]])
    pt = np.array([[0, 1], [2, 3]], np.int32)
    sl = np.array([256, 256], np.int32)
    out = tpa.paged_attention(*to_torch((q2, k, v, pt, sl), torch.float32,
                                        "cpu"))
    out_sw = tpa.paged_attention(*to_torch((q2, k, v, pt[::-1].copy(), sl),
                                           torch.float32, "cpu"))
    torch.testing.assert_close(out[0], out_sw[1], atol=1e-6, rtol=0)
    assert not torch.allclose(out[0], out[1])


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_attend_matches_reference(impl):
    """`kvcache.paged.attend` over per-sequence pools: the port's kernel
    route (the flattened [B*P, ...] views and global page ids, reaching the
    wrapper's plain version here) and its batched gather, against the
    reference's `attend` with the same impl."""
    rng = np.random.default_rng(14)
    B, P, page, KVH, hd, H = 3, 3, 16, 2, 32, 8
    kp, vp = (rng.standard_normal((B, P, page, KVH, hd)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    pt = np.array([[2, 0, 1], [0, 1, -1], [1, 2, 0]], np.int32)
    sl = np.array([1, 17, 48], np.int32)
    n = tpa.paged_attention.launches
    got = tpaged.attend(*(torch.from_numpy(x) for x in (q, kp, vp, pt, sl)),
                        impl=impl)
    assert tpa.paged_attention.launches == n  # nothing launched on the CPU
    want = jpaged.attend(*(jnp.asarray(x) for x in (q, kp, vp, pt, sl)),
                         impl=impl)
    _close(got, want, 2e-5)


def test_wrapper_refuses_other_devices():
    q = torch.zeros((1, 2, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tpa.paged_attention(q, q, q, q, q)
