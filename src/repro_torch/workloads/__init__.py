"""Allocation-trace workloads: record and replay real AllocRequest tapes.

See `repro_torch.workloads.trace` (schema, recorder, lint),
`repro_torch.workloads.replay` (closed-loop replay through every
registered kind, heap-health reports, cross-backend parity checks) and
`repro_torch.workloads.scenarios` (the four representative workloads).
CLIs: ``python -m repro_torch.workloads.record`` /
``python -m repro_torch.workloads.replay``.
"""
from .trace import (RecordingAllocator, Trace, TRACE_SCHEMA,  # noqa: F401
                    response_digest)

_LAZY = {
    "replay": "repro_torch.workloads.replay",
    "replay_all_kinds": "repro_torch.workloads.replay",
    "check_trace": "repro_torch.workloads.replay",
    "attach_expectations": "repro_torch.workloads.replay",
    "SCENARIOS": "repro_torch.workloads.scenarios",
}


def __getattr__(name):
    # lazy, so `python -m repro_torch.workloads.replay` does not import the
    # submodule through the package first (runpy's double-import warning)
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(name)
