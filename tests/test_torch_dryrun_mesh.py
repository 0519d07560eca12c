"""The dry-run's per-device SPMD program (`launch.dryrun.spmd_program`) on
fake worlds of CPU processes (`launch.mesh.fake_world`).

A cell's step runs as rank 0 of a world of 8, 256 or 512 ranks under
`FakeTensorMode` and is recorded as that one process runs it: its local
ops on its shards and its collectives. Held here:

  * argument bytes: the reference's `test_dryrun_small` cell (granite-3-8b
    reduced, bf16, 8 x 64, 2 microbatches, FSDP + TP on a (4, 2) mesh)
    holds exactly the rules' per-device state (parameters, m, v), AdamW's
    count and its rows of the batch;
  * FLOPs per device: the one-device program's over 8, to the FLOP, data
    parallel on (8, 1) and on the FSDP + TP cell, whose count is also held
    to the reference's own per-device count (`tests/test_dryrun_small.py`'s
    program, remat off, 8 fake XLA devices in a subprocess) through the
    one difference between the two programs (the test's docstring);
  * the production meshes: 16 x 16 (a train cell, widths cut to divide the
    16-wide axes, 1 layer) and 2 x 16 x 16 (a decode cell) give 256 / 512
    devices, their schedules and the collective term at `NVLINK_BW`;
  * a decode cell on (2, 2): the combine's all-reduces over ``"model"``,
    and the arguments the port's serving program holds (whole weights, its
    pages, its rows);
  * `fake_world` refuses a process that already holds a group, and leaves
    none behind; only a DTensor recording touches DTensor's internals, and
    it gives them back, also when the step raises.

The test file's whole time is ~40 s alone.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from repro_torch import configs
from repro_torch.analysis import trace_utils
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import fake_world
from repro_torch.models import registry
from repro_torch.models.config import ShapeConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import sharding

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite_3_8b"
SMALL = ShapeConfig("t", 64, 8, "train")     # test_dryrun_small's cell
# widths that divide the production meshes' 16-wide axes (8 KV heads on
# a 16-wide "model" axis, as granite's own)
WIDE = dict(d_model=256, n_heads=16, n_kv_heads=8, head_dim=16, d_ff=512)


def _reduced(**over):
    return dataclasses.replace(configs.get(ARCH).reduced(),
                               dtype="bfloat16", **over)


def _bytes(tree, mesh, specs) -> int:
    return sharding._sharded_bytes(tree, specs, mesh)


def _reference_flops() -> float:
    """The reference's per-device ``flops_scaled`` of test_dryrun_small's
    cell, from that test's own program (8 fake XLA devices)."""
    src = (ROOT / "tests/test_dryrun_small.py").read_text()
    script = re.search(r'SCRIPT = r"""(.*?)"""', src, re.S).group(1)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])["flops_scaled"]


def test_argument_bytes_are_the_rules_state_plus_count_and_rows():
    cfg = _reduced()
    mesh = {"data": 4, "model": 2}
    ana, sched, _ = dryrun.spmd_program(cfg, SMALL, mesh, 2, "cpu")
    p = registry.param_specs(cfg)
    o = steps.opt_state_specs(cfg, AdamWConfig(
        moment_dtype=cfg.opt_moment_dtype))
    spec = sharding.param_specs(mesh, p, fsdp=True)
    state = (_bytes(p, mesh, spec) + _bytes(o.m, mesh, spec)
             + _bytes(o.v, mesh, spec))
    rows = SMALL.global_batch // mesh["data"]
    batch = 2 * rows * SMALL.seq_len * 4          # tokens, labels: int32
    assert ana["argument_bytes"] == state + 4 + batch
    assert ana["peak_bytes"] > ana["argument_bytes"]
    assert {e["axis"] for e in sched} == {"data", "model"}
    assert ana["collective_bytes"] == sum(
        ana["collective_bytes_by_axis"].values()) == sum(
        ana["collective_bytes_by_op"].values())


def test_flops_per_device_are_the_one_device_flops_over_the_mesh():
    """Data parallel on (8, 1), the weights whole (FSDP off): every device
    runs its row of each microbatch, so 8 x its FLOPs == the one-device
    program's, exactly."""
    cfg = _reduced(fsdp=False)
    cell = ShapeConfig("t", 64, 16, "train")
    one, _ = dryrun.program(cfg, cell, 2, "cpu")
    ana, sched, _ = dryrun.spmd_program(cfg, cell, {"data": 8, "model": 1},
                                        2, "cpu")
    assert 8 * ana["flops"] == one["flops"]
    # the gradients' sums over "data", and no other traffic
    assert set(ana["collective_bytes_by_axis"]) == {"data"}
    assert "all_reduce" in {e["op"] for e in sched}


def test_fsdp_tp_flops_against_the_reference():
    """test_dryrun_small's cell (FSDP + TP on (4, 2), 2 microbatches of 4
    rows) with remat off, the reduced config's default. The one-device
    program counts 1,207,959,552 FLOPs, of which A = 100,663,296 are the
    materialized attention's six products (forward and backward; no other
    product is between two activations). The port's device runs its
    share, 150,994,944, exactly: each weight is gathered at its use
    (`layers.at_use`) and each product runs on the device's own rows and
    "model" slice. The reference's per-device program counts 188,743,680,
    1.25 x the port's, so the two are NOT within 2 %: XLA's partitioner
    splits every weight product 8 ways too (the same W / 8), but it keeps a
    microbatch's 4 rows whole on each "data" rank for the attention and
    splits only its heads over "model" (its HLO's score products are
    f32[4, 2, 64, 64]), so its attention costs A / 2 a device where the
    port's costs A / 8. Held exactly, with no tolerance: the port's count
    is the share, and the reference's is (one - A) / 8 + A / 2."""
    cfg = _reduced()
    assert not cfg.remat
    mesh = {"data": 4, "model": 2}
    one, _ = dryrun.program(cfg, SMALL, 2, "cpu")
    ana, _, _ = dryrun.spmd_program(cfg, SMALL, mesh, 2, "cpu")
    B, S = SMALL.global_batch, SMALL.seq_len
    attn = 3 * 2 * (2 * B * cfg.n_heads * S * S * cfg.head_dim) \
        * cfg.n_layers
    assert attn == 100_663_296
    assert 8 * ana["flops"] == one["flops"]
    assert _reference_flops() == (one["flops"] - attn) / 8 \
        + attn / mesh["model"]


def _wide_overrides():
    red = dataclasses.asdict(configs.get(ARCH).reduced())
    over = {k: red[k] for k in ("vocab", "remat", "page_size")}
    return dict(over, dtype="bfloat16", **WIDE)


def test_the_production_meshes():
    """16 x 16: a train cell (64 x 64, 2 microbatches, 1 layer), whose
    devices each run exactly their share of the FLOPs; 2 x 16 x 16: a
    decode cell. Under torch 2.13 on the CPU DTensor plans a 3-axis
    mesh's redistributions for minutes (~280 s for the smallest train cell);
    the card's torch 2.11 records granite's full-width train cells on both
    meshes in ~30 s (chip_smoke phase 15 (d))."""
    over = _wide_overrides()
    train = dryrun.dryrun_cell(ARCH, ShapeConfig("train_4k", 64, 64, "train"),
                               n_micro=2, overrides=over, layers=1,
                               device="cpu", verbose=False)
    dec = dryrun.dryrun_cell(ARCH, ShapeConfig("decode_32k", 512, 32,
                                               "decode"),
                             multi_pod=True, overrides=over, layers=1,
                             device="cpu", verbose=False)
    for res, devices, mesh in ((train, 256, "16x16"), (dec, 512, "2x16x16")):
        spmd, rf = res["spmd_program"], res["roofline"]
        assert res["status"] == "ok" and res["mesh"] == mesh
        assert res["devices"] == devices
        assert res["collective_schedule"] and spmd["collective_bytes"] > 0
        assert len(res["collective_schedule"]) <= dryrun.SCHEDULE_LEN
        assert rf["collective_s"] == spmd["collective_bytes"] / \
            dryrun.NVLINK_BW
        assert rf["bottleneck"] == max(
            ("compute_s", "memory_s", "collective_s"), key=rf.get)
        assert spmd["fits_per_device"] and res["fits_one_card"]
    # every product split 256 ways: granite's 8 KV heads on the 16-wide
    # "model" axis too (their replicated weights used split by columns)
    assert 256 * train["spmd_program"]["flops"] == \
        train["op_analysis"]["flops"]
    gathers = [e for e in train["collective_schedule"]
               if e["op"] == "all_gather_into_tensor"]
    assert any(e["axis"] == "data" for e in gathers)
    assert {e["axis"] for e in dec["collective_schedule"]} == {"model"}


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "qwen2_moe_a2_7b"])
def test_a_moe_train_cell_on_the_production_mesh(arch):
    """The MoE families' train cell on 16 x 16 (widths cut, 1 layer, the
    experts over "model", olmoe's 16 dividing it, qwen2-moe's 60 padded
    to 64): the per-device program runs (`moe._routed_on_mesh`), with the
    rules' state and its rows as arguments, and the one-device part is
    there beside it."""
    over = dict(vocab=512, d_model=256, n_heads=16, n_kv_heads=16,
                 head_dim=16, expert_d_ff=64, moe_group=64, remat=True,
                 dtype="bfloat16")
    over.update(n_experts=16, top_k=2, pad_experts_to=1) if arch.startswith(
        "olmoe") else over.update(n_shared_experts=1)
    cell = ShapeConfig("train_4k", 64, 64, "train")
    res = dryrun.dryrun_cell(arch, cell, n_micro=2, overrides=over,
                             layers=1, device="cpu", verbose=False)
    spmd, one = res["spmd_program"], res["op_analysis"]
    assert res["status"] == spmd["status"] == "ok", spmd.get("error")
    assert res["collective_schedule"] and res["roofline"]
    rows = cell.global_batch // 16
    assert spmd["argument_bytes"] == sum(
        res["state_bytes_per_device"].values()) + 4 + 2 * 4 * rows * 64
    assert one["flops"] / 256 <= spmd["flops"] < one["flops"] / 64


def test_a_decode_cell_on_a_two_by_two_world():
    """The port's serving program on the mesh: each process holds the
    weights whole, its rows' slice of the pages and its rows; the decode's
    combine (`paged.write_attend_seqpar`) all-reduces the row maxima and
    then the denominators with the outputs over "model", once each a
    layer."""
    cfg = dataclasses.replace(configs.get(ARCH).reduced(), n_layers=2,
                              attend_impl="kernel")
    cell = ShapeConfig("decode_32k", 256, 8, "decode")
    ana, sched, _ = dryrun.spmd_program(cfg, cell, {"data": 2, "model": 2},
                                        1, "cpu")
    assert {(e["op"], e["axis"]) for e in sched} == {("allreduce_",
                                                      "model")}
    assert sum(e["times"] for e in sched) == 2 * cfg.n_layers
    batch, cache = registry.decode_specs(cfg, cell)

    def nbytes(t, div=1):
        return t.numel() * t.element_size() // div
    local = (nbytes(cache["k_pages"], 4) + nbytes(cache["v_pages"], 4)
             + nbytes(cache["page_table"], 2) + nbytes(cache["seq_lens"], 2)
             + nbytes(batch["tokens"], 2))
    weights = sum(nbytes(t) for t in trace_utils.leaves(
        registry.param_specs(cfg)))
    assert ana["argument_bytes"] == weights + local
    assert ana["kernel_nodes"] == {}


def test_dtensor_all_to_all_counts_as_a_collective():
    """DTensor moves a shard from one dimension to another with its own
    operator, ``_dtensor::shard_dim_alltoall``, on a "cuda" mesh (a "cpu"
    one all-gathers instead): its result bytes count, over its axis."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import op_analysis
    from repro_torch.launch.mesh import mesh_axes
    with fake_world((2, 4), ("data", "model"), "cpu") as mesh, \
            FakeTensorMode():
        x = torch.empty(8, 16)
        name = mesh.get_group(1).group_name
        rec, y = trace_utils.record(
            lambda t: torch.ops._dtensor.shard_dim_alltoall(t, 0, 1, name),
            x)
        ana = op_analysis.analyze(rec, mesh_axes(mesh))
        assert tuple(y.shape) == (32, 4)
        assert ana["collective_bytes_by_op"] == {
            "shard_dim_alltoall": 32 * 4 * 4}
        assert ana["collective_bytes_by_axis"] == {"model": 32 * 4 * 4}


def test_only_a_dtensor_recording_patches_dtensor():
    """A plain recording leaves DTensor's internals alone; a DTensor
    recording patches them while it runs and gives them back on exit,
    also when the step raises."""
    import torch
    import torch.distributed.tensor  # noqa: F401 (the patched modules)
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    tracing = funcol._are_we_tracing
    prop = ShardingPropagator.__dict__["propagate_op_sharding_non_cached"]

    def seen(x):
        return (funcol._are_we_tracing is tracing,
                ShardingPropagator.__dict__[
                    "propagate_op_sharding_non_cached"] is prop), x + 1

    _, (plain, _) = trace_utils.record(seen, torch.ones(2))
    assert plain == (True, True)
    _, (live, _) = trace_utils.record(seen, torch.ones(2), dtensor=True)
    assert live == (False, False)

    def fails(x):
        raise ValueError("step")
    with pytest.raises(ValueError, match="step"):
        trace_utils.record(fails, torch.ones(2), dtensor=True)
    assert funcol._are_we_tracing is tracing
    assert ShardingPropagator.__dict__[
        "propagate_op_sharding_non_cached"] is prop


def test_fake_world_refuses_a_live_group_and_leaves_none(tmp_path):
    from torch.distributed import _functional_collectives as funcol
    tracing = funcol._are_we_tracing
    with fake_world((2, 2), ("data", "model"), "cpu") as mesh:
        assert dist.get_world_size() == 4 and mesh.mesh_dim_names == (
            "data", "model")
        assert tuple(mesh.get_coordinate()) == (0, 0)
    assert not dist.is_initialized()
    # the recorder gives DTensor's tracing test back on exit
    assert funcol._are_we_tracing is tracing
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already holds"):
            with fake_world((16, 16), ("data", "model"), "cpu"):
                pass
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="differ"):
        with fake_world((2, 2), ("data",), "cpu"):
            pass
    assert not dist.is_initialized()
