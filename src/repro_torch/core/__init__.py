"""repro_torch.core: the PIM-malloc allocator as composable PyTorch modules.

The port of `repro.core`. Layers (bottom-up):
  buddy        the array buddy allocator (backend / straw-man)
  thread cache + hierarchy: pim_malloc (PIM-malloc-SW semantics, incl.
               realloc/calloc)
  buddy_cache  metadata-cache simulators (SW buffer vs HW CAM+LRU)
  cost_model   DPU cycle model (UPMEM timing)
  system       composed design points: strawman / sw / hwsw / sanitizer /
               arena / tlregion / fused, each registered as a
               cost-instrumented `heap.step` backend (``fused`` is the
               reference's ``pallas``: the hand-written heap-step kernel)
  heap         the public allocator surface: the AllocRequest/AllocResponse
               protocol, `step`, `MultiCoreHeap` (C cores on an explicit
               core axis)
  design_space Table 1 / Fig 5 exploration
  api          Table 2 paper-facing facade over heap.step
"""
from . import (api, buddy, buddy_cache, cost_model, design_space, heap,
               oracle, pim_malloc, system)
from .api import Allocator, initAllocator
from .buddy import BuddyConfig, BuddyState
from .heap import (AllocRequest, AllocResponse, MultiCoreHeap, OP_CALLOC,
                   OP_FREE, OP_MALLOC, OP_NOOP, OP_REALLOC)
from .pim_malloc import PimMallocConfig, PimMallocState
from .system import (SystemConfig, SystemState, malloc_round, free_round,
                     system_init)

__all__ = [
    "api", "buddy", "buddy_cache", "cost_model", "design_space", "heap",
    "oracle", "pim_malloc", "system", "Allocator", "initAllocator",
    "AllocRequest", "AllocResponse", "MultiCoreHeap", "OP_NOOP", "OP_MALLOC",
    "OP_FREE", "OP_REALLOC", "OP_CALLOC", "BuddyConfig", "BuddyState",
    "PimMallocConfig", "PimMallocState", "SystemConfig", "SystemState",
    "malloc_round", "free_round", "system_init",
]
