"""Public entry points of the port's kernels, with the reference's names
and arguments (`repro.kernels.ops`).

There is no ``interpret`` flag and no TPU test: routing follows the
tensors' device. CUDA tensors launch the hand-written kernels
(``csrc/buddy_traverse.cu``, ``csrc/freelist.cu``,
``csrc/paged_attention.cu``, ``csrc/flash_attention.cu``); CPU tensors run
their plain PyTorch versions; any other device raises. A build or launch
error raises: nothing falls back. Each entry point is its kernel's
wrapper, so its ``launches`` counter is the kernel's.

The oracles (`ref`) are re-exported for tests and benchmarks.
"""
from __future__ import annotations

from . import buddy_traverse, flash_attention, freelist, paged_attention, ref

# [C, B] buddy allocations over [C, n_nodes] trees:
#   buddy_alloc_batch(tree, sizes, *, heap_bytes, min_block)
buddy_alloc_batch = buddy_traverse.buddy_alloc_batch_kernel
# one pop / push per thread cache:
#   freelist_op(stacks, counts, op, cls, ptr_in)
freelist_op = freelist.freelist_op_kernel
# decode attention over paged KV:
#   paged_attention_op(q, k_pages, v_pages, page_table, seq_lens)
paged_attention_op = paged_attention.paged_attention
# flash attention forward:
#   flash_attention_op(q, k, v, *, causal, window, block_q, block_kv)
flash_attention_op = flash_attention.flash_attention_kernel

# re-exported oracles
buddy_alloc_batch_ref = ref.buddy_alloc_batch_ref
freelist_op_ref = ref.freelist_op_ref
paged_attention_ref = ref.paged_attention_ref
