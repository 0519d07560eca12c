"""PyTorch + CUDA port of the PIM-malloc allocator (the `repro` package is
the JAX reference it is held against).

Sub-packages mirror `repro`: `core/` (protocol, allocator state, pricing,
the `HeapClient` surface), `kernels/` (the hand-written Hopper kernels and
their plain PyTorch versions), `workloads/` (tape replay), `kvcache/` (the
paged KV cache and its allocator-backed `PagePool`), `models/` (the dense
transformer's serving path), `launch/` (the serving entry point), `configs/`.
Allocator state is a tree of NamedTuples of int32 tensors with an explicit
leading core axis ``[C, ...]``; model parameters are dicts of tensors
stacked over layers.

Entry points (`core.heap.init`, `core.heap.MultiCoreHeap`,
`workloads.replay.replay`, `launch.serve.serve`, `kvcache.PagePool`,
`core.api.HeapClient`, `models.registry.init`) run on the card: they take
``device="cuda"`` by default and raise when no GPU is present. Pass
``device="cpu"`` to run the plain PyTorch versions on the host, as the
tests do.
"""
