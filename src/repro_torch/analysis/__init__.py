"""Static analysis for the allocator backends: `pimcheck` + tape lint.

The port of `repro.analysis`. Two pillars:

* `repro_torch.analysis.pimcheck` — record one round of every registered
  backend (single / vmap / sharded tiers) as its op sequence
  (`trace_utils.record`) and run the checker passes in
  `repro_torch.analysis.passes` over it: in-place state discipline,
  integer-width safety, index-bound provenance, and intra-round
  write-race detection. CLI:
  ``python -m repro_torch.analysis.pimcheck --all-kinds --tapes``.

* the ``sanitizer`` backend (`repro_torch.core.sanitizer`, registered in
  `heap.REGISTRY`) — an ASan-style shadow-heap design point that turns
  double-free / use-after-free / realloc-after-free into deterministic
  tagged reports; `sanitizer_report` re-exports its report renderer.

The same-round pointer-race tape rule lives in
`repro_torch.workloads.trace.trace_lint`; pimcheck's `--tapes` mode
applies it to committed tapes.
"""
from ..core.sanitizer import report as sanitizer_report  # noqa: F401
from .passes import (ALL_PASSES, Finding, PASS_NAMES,  # noqa: F401
                     SUPPRESSIONS, TracedStep, run_passes)

_PIMCHECK = ("check_fixtures", "check_kinds", "lint_tapes", "trace_fixture",
             "trace_kind")


def __getattr__(name):
    # lazy, so `python -m repro_torch.analysis.pimcheck` does not import
    # the module through the package first (runpy's double-import warning)
    if name in _PIMCHECK:
        from . import pimcheck
        return getattr(pimcheck, name)
    raise AttributeError(name)
