"""The five CUDA launchers as torch operators in the ``repro_torch``
namespace (``torch.ops.repro_torch.heap_step`` and the rest).

Each kernel module defines its operator here with a schema that names the
tensors the kernel writes in place (``Tensor(a!)``), registers its launcher
as the operator's CUDA implementation and a shape-only function as its
fake implementation. So a tracer that works at the dispatcher
(`repro_torch.analysis.trace_utils`, `torch._subclasses.FakeTensorMode`)
sees one node per launch, with the tensors it mutates, instead of a
``ctypes`` call it cannot see. The wrappers call the operator only for
CUDA tensors (CPU tensors take the plain versions, as before); there is no
CPU implementation, and a build or launch error raises from the CUDA one.

`torch.library.Library` is the registration: a Python CUDA kernel behind
the dispatcher, no autograd or tracing wrapper around it
(``torch.library.custom_op`` adds both; PERF.md §6 has the host cost per
call of each).
"""
from __future__ import annotations

import torch

NAMESPACE = "repro_torch"
LIB = torch.library.Library(NAMESPACE, "FRAGMENT")
# operator name -> (the wrapper module's plain version of the operator, in
# the operator's own calling convention and output order: the new values of
# the mutated arguments in schema order, then the returns)
PLAIN: dict = {}
# called as HOOK(operator name, args) just before a wrapper calls an
# operator, when set (`repro_torch.analysis.trace_utils.Recorder` records
# the operator's plain version there, at the dispatcher's top level)
HOOK = None


def define(name: str, schema: str, cuda, fake, plain):
    """Define ``repro_torch::<name><schema>`` with `cuda` as its CUDA
    implementation and `fake` as its fake one, keep `plain` in `PLAIN`,
    and return the function the wrapper calls: the operator, after `HOOK`
    when one is set."""
    qualname = f"{NAMESPACE}::{name}"
    LIB.define(name + schema)
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(qualname, fake, lib=LIB)
    PLAIN[qualname] = plain
    overload = getattr(getattr(torch.ops, NAMESPACE), name).default

    def call(*args):
        if HOOK is not None:
            HOOK(qualname, args)
        return overload(*args)

    return call
