"""The port stands alone: importing every module of `repro_torch`,
chip_smoke.py, the tools (dryrun_grid, flash_mutants, heap_mutants,
kernel_ab, op_cost, scan_ops, serve_phase, warp_latency) and the six port
examples (`examples/*_torch.py`) pulls in neither JAX nor any module of
the reference.

Among them the kernel entry point `kernels.ops` with its oracles
`kernels.ref`, the modules of the buddy, freelist and flash-attention
kernels, the scan-based design points and the design-space model (whose
constants the port keeps in its own copy), the region and sanitizer
frontends, the oracle module (the port's own copy of a pure-Python
module of the reference), the checkpoint module, the closed-loop and
elastic serving tiers, and the training path (the optimizer, compression,
token stream, train and serve steps, fault-tolerant loop and trainer), and
the moe, vlm and audio model families and the recurrent ones (ssm,
hybrid), and the analysis tooling (pimcheck with its recorder, passes and
fixtures, the op-level accounting, the dry-run, the mesh shapes and the
sharding rules; the five kernels as `repro_torch` operators), and the
tier across processes (the collectives, the rank mesh, the live world
and mesh with its spawn helper, the sharded heap on a mesh,
`write_attend_seqpar`; tools/seqpar_divergence.py and seqpar_mutants.py
and the mesh tests' per-process module), and training on a mesh
(`named`, `place_state`, `batch_pspec` / `shard_batch`,
`activation_constraint`, ``grad_pspec``, `compressed_psum`, the
host-staged gloo group, checkpoints of DTensors; tools/mesh_train_mutants.py
and the mesh training tests' per-process module); the registry lists all seven kinds and covers all
six model families; `repro_torch.core` re-exports the reference's
names."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, importlib.util, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}, {tools!r}, {root!r} + "/tests"]
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
import flash_mutants
import heap_mutants
import kernel_ab
import scan_ops
import serve_phase
import warp_latency
import op_cost
import dryrun_grid
import seqpar_divergence
import seqpar_mutants
import mesh_train_mutants
import torch_mesh_workers
import torch_mesh_train_workers
for name in ("quickstart", "graph_update", "serve_paged", "serve_decode",
             "serve_fleet", "train_lm"):
    spec = importlib.util.spec_from_file_location(
        name, {root!r} + f"/examples/{{name}}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main)
from repro_torch.core import initAllocator, Allocator, MultiCoreHeap
from repro_torch.core import system_init, malloc_round, system as _system
assert _system.KINDS and callable(_system.telemetry_init)
from repro_torch.kernels import ops
from repro_torch.core import arena, design_space, heap, oracle, sanitizer
from repro_torch.checkpoint import ckpt
from repro_torch.launch import elastic, serve, serve_fleet, steps, train
from repro_torch.optim import adamw, compression
from repro_torch.data import pipeline
from repro_torch.runtime import fault
from repro_torch.models import encdec, hybrid, layers, moe, registry, ssm
from repro_torch.models import transformer, vlm
assert all(callable(f) for f in (
    ckpt.save, ckpt.restore, ckpt.latest_step, ckpt.AsyncCheckpointer,
    serve_fleet.FleetServe, serve_fleet.serve_session,
    elastic.ElasticFleetServe, elastic.serve_elastic, serve.make_fleet_pool,
    serve.fleet_page_request, adamw.update, adamw.schedule,
    compression.quantize, compression.ef_compress, pipeline.TokenStream,
    pipeline.to_device, steps.make_train_step, steps.opt_state_specs,
    fault.run_with_recovery, train.main, train.build, layers.cross_entropy,
    transformer.loss, registry.loss_fn, registry.param_specs,
    registry.make_train_batch, registry.make_frontends, moe._moe_mlp,
    moe.prefill, moe.decode, vlm.prefill, vlm.loss, encdec.encode,
    encdec.prefill, encdec.decode, ssm.ssd_chunked, ssm.ssd_recurrent_step,
    ssm.loss, ssm.prefill, ssm.decode, hybrid.associative_scan,
    hybrid.loss, hybrid.prefill, hybrid.decode))
from repro_torch.analysis import (fixtures, passes, pimcheck,
                                  sanitizer_report, trace_utils)
from repro_torch.kernels import _library
from repro_torch.launch import dryrun, mesh, op_analysis
from repro_torch.parallel import comm, meshctx, sharding
from repro_torch.kvcache import paged
assert all(callable(f) for f in (
    pimcheck.main, pimcheck.trace_kind, pimcheck.trace_fixture,
    pimcheck.check_kinds, pimcheck.check_fixtures, pimcheck.lint_tapes,
    pimcheck._step_summary, pimcheck._mixed_request, passes.run_passes,
    trace_utils.record, trace_utils.iter_ops, trace_utils.producers,
    trace_utils.forward_taint, trace_utils.derives_from, trace_utils.sig,
    sanitizer_report, op_analysis.analyze, op_analysis.collective_schedule,
    dryrun.main, dryrun.dryrun_cell, dryrun.input_specs, dryrun.save_result,
    mesh.make_production_mesh, mesh.make_host_mesh, mesh.init_world,
    mesh.spawn, meshctx.make_rank_mesh, meshctx.rank_mesh_size,
    comm.all_gather, comm.gather, comm.all_reduce, comm.barrier,
    heap.RankShard, heap.sharded_inner, paged.write_attend_seqpar,
    paged.batch_rows, paged.local_pages, seqpar_divergence.main,
    seqpar_mutants.main, torch_mesh_workers.run_all, sharding.dp_axes,
    sharding.param_specs, sharding.batch_specs, sharding.cache_specs,
    sharding._sharded_bytes, sharding.named, sharding.place,
    sharding.place_state, sharding.dtensor_placements,
    sharding.replicated_specs, pipeline.batch_pspec, pipeline.shard_batch,
    layers.activation_constraint, layers.seq_shard_constraint,
    layers.on_mesh, compression.compressed_psum,
    compression.gather_quantized, comm.register_host_staged,
    comm.HostStagedGroup, ckpt.placements_of, mesh_train_mutants.main,
    torch_mesh_train_workers.run_all, chip_smoke.phase_mesh_train,
    chip_smoke.mesh_train_worker))
import inspect
assert "grad_pspec" in inspect.signature(steps.make_train_step).parameters
assert "mesh" in inspect.signature(compression.compressed_psum).parameters
assert pimcheck.TIERS == ("single", "vmap", "sharded")
assert passes.PASS_NAMES == ("donation", "int-width", "index-bounds",
                             "write-race") and passes.SUPPRESSIONS == ()
assert sorted(fixtures.FIXTURES) == ["aliased_scatter", "dropped_donation",
                                     "float_leak", "unclamped_index"]
assert sorted(_library.PLAIN) == [
    "repro_torch::buddy_alloc_batch", "repro_torch::flash_attention",
    "repro_torch::freelist_op", "repro_torch::heap_step",
    "repro_torch::paged_attention"]
assert sorted(registry.FAMILY_MODULES) == ["audio", "dense", "hybrid", "moe",
                                           "ssm", "vlm"]
assert heap.kinds() == ("strawman", "sw", "hwsw", "sanitizer", "arena",
                        "tlregion", "fused")
assert design_space.STRATEGIES[-1] == "pim_meta_pim_exec"
assert all(callable(getattr(ops, n)) for n in (
    "buddy_alloc_batch", "freelist_op", "paged_attention_op",
    "flash_attention_op", "buddy_alloc_batch_ref", "freelist_op_ref",
    "paged_attention_ref"))
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib"))
             or n == "repro" or n.startswith("repro."))
print("BAD", bad)
print("N", sum(n.startswith("repro_torch") for n in sys.modules))
"""


def test_port_imports_no_jax_and_no_reference():
    out = subprocess.run(
        [sys.executable, "-c",
         PROBE.format(src=str(ROOT / "src"), root=str(ROOT),
                      tools=str(ROOT / "tools"))],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n = int(out.stdout.split("N ")[1].split()[0])
    assert n >= 50, out.stdout  # every module of the package was imported
