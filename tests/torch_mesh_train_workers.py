"""What each process of tests/test_torch_mesh_train.py's gloo group runs.

`repro_torch.launch.mesh.spawn` starts 4 processes on the CPU, each of
which calls `run_all` once with the same spec (NumPy parameters and
batches the parent made) and returns host objects. This module imports no
JAX and nothing of the reference, and `run_all` reports what the process
imported.
"""
import contextlib
import dataclasses
import io
import os
import shutil
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, convert
from repro_torch.analysis import trace_utils
from repro_torch.checkpoint import ckpt
from repro_torch.data import pipeline
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import op_analysis, steps, train
from repro_torch.models import registry
from repro_torch.optim import adamw, compression
from repro_torch.parallel import sharding
from repro_torch.runtime import fault

CPU = torch.device("cpu")


def host(tree):
    """A tree of (D)tensors as NumPy arrays, DTensors gathered whole (a
    collective)."""
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(host(x) for x in tree))
    if hasattr(tree, "placements"):
        tree = tree.full_tensor()
    return tree.detach().cpu().numpy()


def scalar(x) -> float:
    return float(x.full_tensor() if hasattr(x, "placements") else x)


def local_shapes(tree):
    if isinstance(tree, dict):
        return {k: local_shapes(v) for k, v in tree.items()}
    return tuple(tree.to_local().shape)


def reduced(arch, **over):
    return dataclasses.replace(configs.get(arch).reduced(), **over)


def mesh_state(spec, cfg, mesh, opt_cfg):
    """The spec's parameters (the reference's, converted) and a fresh
    AdamW state, placed on `mesh` by `param_specs(fsdp=True)`."""
    params = convert.params_from_reference(spec["params"], CPU)
    return sharding.place_state(mesh, params, adamw.init(opt_cfg, params),
                                fsdp=True)


def sharded_steps(spec, mesh, seq_shard):
    """The reference's sharded step on the (2, 2) mesh: 2 steps of
    n_micro microbatches with grad_pspec."""
    cfg = reduced(spec["arch"], seq_shard=seq_shard)
    opt_cfg = adamw.AdamWConfig()
    params, opt, p_spec = mesh_state(spec, cfg, mesh, opt_cfg)
    step = steps.make_train_step(cfg, opt_cfg, n_micro=spec["n_micro"],
                                 grad_pspec=p_spec)
    losses, gnorms, batch_shapes = [], [], None
    for b in spec["batches"]:
        feed = pipeline.shard_batch(mesh, b)
        batch_shapes = {k: tuple(v.to_local().shape) for k, v in feed.items()}
        params, opt, m = step(params, opt, feed)
        losses.append(scalar(m["loss"]))
        gnorms.append(scalar(m["grad_norm"]))
    return dict(losses=losses, gnorms=gnorms, local=local_shapes(params),
                batch_local=batch_shapes, m_local=local_shapes(opt.m),
                params=host(params))


def in_order(tree, like):
    """`tree` (nested dicts) with its keys in `like`'s order."""
    if not isinstance(tree, dict):
        return tree
    return {k: in_order(tree[k], like[k]) for k in like}


def live_schedule(spec, mesh):
    """One live step of the reduced cell on the (2, 2) mesh (the spec's
    parameters placed by `param_specs(fsdp=True)`, its first batch by
    `shard_batch`, n_micro microbatches, grad_pspec), recorded on this
    process: its whole collective schedule by mesh axis, its collective
    bytes by op and by axis, and its argument bytes."""
    cfg = reduced(spec["arch"])
    opt_cfg = adamw.AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
    # the tree in the port's own order (`registry.init`'s, the dry-run's):
    # the order of the leaves is the order of the backward's gradient sums,
    # whose placements DTensor takes from their first operand
    params = in_order(convert.params_from_reference(spec["params"], CPU),
                      registry.param_specs(cfg))
    params, opt, p_spec = sharding.place_state(
        mesh, params, adamw.init(opt_cfg, params), fsdp=True)
    step = steps.make_train_step(cfg, opt_cfg, n_micro=spec["n_micro"],
                                 grad_pspec=p_spec)
    feed = pipeline.shard_batch(mesh, spec["batches"][0])
    rec, _ = trace_utils.record(step, params, opt, feed, descend=False,
                                dtensor=True)
    axes = tmesh.mesh_axes(mesh)
    ana = op_analysis.analyze(rec, axes)
    return dict(schedule=op_analysis.collective_schedule(rec, 1 << 30, axes),
                by_op=ana["collective_bytes_by_op"],
                by_axis=ana["collective_bytes_by_axis"],
                argument_bytes=ana["argument_bytes"])


def one_step(cfg, batch, mesh):
    """One step (AdamW's defaults, fsdp placements) of `cfg` from seed 0's
    parameters on `batch`, on `mesh` (None: this process alone): the loss
    and the gradient norm."""
    opt_cfg = adamw.AdamWConfig()
    params = registry.init(cfg, seed=0, device=CPU)
    opt = adamw.init(opt_cfg, params)
    p_spec = None
    if mesh is not None:
        params, opt, p_spec = sharding.place_state(mesh, params, opt,
                                                   fsdp=True)
    step = steps.make_train_step(cfg, opt_cfg, grad_pspec=p_spec)
    feed = (pipeline.to_device(batch, CPU) if mesh is None
            else pipeline.shard_batch(mesh, batch))
    _, _, m = step(params, opt, feed)
    return scalar(m["loss"]), scalar(m["grad_norm"])


def whole_heads(spec):
    """Two steps whose heads meet the mesh: mamba2's SSD on local shards
    (`ssm._ssd_local`) on the (2, 2) mesh, and granite's 2 KV heads on a
    (1, 4) mesh, more "model" positions than heads (`layers.split_heads`
    gathers them); each step's (loss, gradient norm)."""
    from torch.distributed.device_mesh import init_device_mesh
    wide = init_device_mesh("cpu", (1, dist.get_world_size()),
                            mesh_dim_names=("data", "model"))
    square = tmesh.make_host_mesh(model=2, live=True)
    batch = spec["batches"][0]
    return {"mamba2_130m": one_step(reduced("mamba2_130m"), batch, square),
            "granite_3_8b": one_step(reduced(spec["arch"]), batch, wide)}


# (arch, config overrides, batch rows, sequence, mesh): the MoE's routed
# experts on the mesh, one case for each way `moe._routed_on_mesh` runs
MOE_CASES = {
    # a group of 64 tokens spans both data ranks' 32: the stream gathered
    "groups_across_rows": ("olmoe_1b_7b", {}, 4, 16, "square"),
    # more than moe_parallel_groups groups: the reference's group order
    # (gathered), with the shared expert
    "reordered_groups": ("qwen2_moe_a2_7b", {"moe_parallel_groups": 2}, 4,
                         64, "square"),
    # each process's rows are whole groups in place: nothing gathered
    "rows_in_place": ("olmoe_1b_7b", {}, 4, 64, "square"),
    # 6 experts over a 4-wide "model" axis: each expert's width split
    "expert_width": ("olmoe_1b_7b", {"n_experts": 6}, 4, 64, "wide"),
}


def moe_batch(arch, over, B, S):
    """The MoE case's batch, from seed 0."""
    t = np.random.default_rng(0).integers(
        0, reduced(arch, **over).vocab, (B, S)).astype(np.int32)
    return {"tokens": t, "labels": t.copy()}


def moe(spec):
    """One step of each MOE_CASES case on its mesh: (loss, gradient
    norm)."""
    from torch.distributed.device_mesh import init_device_mesh
    meshes = {"square": tmesh.make_host_mesh(model=2, live=True),
              "wide": init_device_mesh("cpu", (1, dist.get_world_size()),
                                       mesh_dim_names=("data", "model"))}
    return {name: one_step(reduced(arch, **over),
                           moe_batch(arch, over, B, S), meshes[mesh])
            for name, (arch, over, B, S, mesh) in MOE_CASES.items()}


def psum(spec):
    """compressed_psum over a ("data",) mesh of the 4 processes, each with
    its row of the inputs; the gathered payloads and scales too."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (dist.get_world_size(),),
                            mesh_dim_names=("data",))
    x = torch.from_numpy(spec["psum_inputs"][dist.get_rank()])
    qs, scales, n = compression.gather_quantized(x, "data", mesh)
    total = compression.compressed_psum(x, "data", mesh)
    return dict(q=qs.numpy(), scales=scales.numpy(), n=n,
                sum=total.numpy())


def trainer(spec):
    """`train.main` on the (world, 1) mesh with the spec's flags; process
    0's printed lines (the others print none)."""
    arch_get = configs.get
    configs.get = lambda name: dataclasses.replace(arch_get(name),
                                                   attn_4d=False)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            (params, opt), hist = train.main(
                spec["train_args"] + ["--device", "cpu", "--dist-backend",
                                      "gloo", "--ckpt-dir",
                                      spec["train_dir"]])
    finally:
        configs.get = arch_get
    return dict(lines=buf.getvalue().splitlines(), hist=hist,
                placements={str(p.placements) for p in
                            adamw.tree_leaves(params)})


def _loop(state, step_fn, ckpt_dir, total, every):
    """run_with_recovery of `step_fn(params, opt, step)`; each step's
    loss."""
    losses = {}

    def run(state, i, _):
        params, opt, m = step_fn(*state, i)
        losses[i] = scalar(m["loss"])
        return (params, opt), m

    state, hist = fault.run_with_recovery(
        fault.TrainLoopConfig(total_steps=total, ckpt_every=every,
                              ckpt_dir=ckpt_dir),
        init_state=state, step_fn=run, make_batch=lambda i: i)
    return state, losses, hist


def restore(spec, mesh):
    """(2, 2) -> (1, 2) and -> one device, one microbatch a step: the
    uninterrupted run on (2, 2) saves at steps 0 and EVERY; a copy holding
    only the step-EVERY
    checkpoint is restored by `run_with_recovery` onto a (1, 2) mesh of
    processes 0 and 1, and (process 0) onto one device, each continuing to
    the last step. Returns each run's losses, final parameters and the
    mesh of each restored leaf."""
    from torch.distributed.device_mesh import DeviceMesh
    cfg = reduced(spec["arch"])
    opt_cfg = adamw.AdamWConfig()
    total, every = spec["restore_steps"], spec["restore_every"]
    rank = dist.get_rank()
    base = spec["restore_dir"]
    batches = spec["restore_batches"]

    def step_on(m):
        inner = steps.make_train_step(cfg, opt_cfg)

        def fn(params, opt, i):
            feed = (pipeline.to_device(batches[i], CPU) if m is None
                    else pipeline.shard_batch(m, batches[i]))
            return inner(params, opt, feed)
        return fn

    params, opt, _ = mesh_state(spec, cfg, mesh, opt_cfg)
    (fp, _), whole_losses, _ = _loop((params, opt),
                                     step_on(mesh),
                                     f"{base}/whole", total, every)
    out = dict(whole=dict(losses=whole_losses, params=host(fp)))
    if rank == 0:
        for d in ("sub", "one"):
            os.makedirs(f"{base}/{d}")
            shutil.copytree(f"{base}/whole/step_{every:08d}",
                            f"{base}/{d}/step_{every:08d}")
    sub = DeviceMesh("cpu", torch.tensor([[0, 1]]),
                     mesh_dim_names=("data", "model"))
    tmesh_barrier()
    if rank < 2:
        params, opt, _ = mesh_state(spec, cfg, sub, opt_cfg)
        (sp, so), sub_losses, hist = _loop(
            (params, opt), step_on(sub), f"{base}/sub",
            total, every)
        out["sub"] = dict(losses=sub_losses, params=host(sp),
                          meshes={str(p.device_mesh.mesh.tolist()) for p in
                                  adamw.tree_leaves(sp)},
                          steps=hist["steps"])
    if rank == 0:
        params = convert.params_from_reference(spec["params"], CPU)
        (op, _), one_losses, hist = _loop(
            (params, adamw.init(opt_cfg, params)),
            step_on(None), f"{base}/one", total, every)
        out["one"] = dict(losses=one_losses, params=host(op),
                          steps=hist["steps"])
    tmesh_barrier()
    return out


def tmesh_barrier():
    from repro_torch.parallel import comm
    comm.barrier()


def model_axis_guard(spec, mesh):
    """Restoring the (2, 2) checkpoint onto a (4, 1) mesh (another
    "model" size) raises."""
    cfg = reduced(spec["arch"])
    wide = tmesh.make_host_mesh(model=1, live=True)
    params, opt, _ = mesh_state(spec, cfg, wide, adamw.AdamWConfig())
    every = spec["restore_every"]
    try:
        ckpt.restore((params, opt), every, f"{spec['restore_dir']}/whole")
    except ValueError as e:
        return str(e)
    return None


def staged():
    """The host-staged gloo group's collectives over the 4 processes (a
    group of its own): each against what gloo's own give."""
    from repro_torch.parallel import comm
    group = dist.new_group(backend=comm.register_host_staged())
    comm.HostStagedGroup.moved_bytes = {}
    r, n = dist.get_rank(), dist.get_world_size()
    x = torch.arange(8, dtype=torch.float32) + 10 * r
    out = {"type": type(group).__name__}
    ag = torch.empty(n * 8)
    dist.all_gather_into_tensor(ag, x, group=group)
    out["all_gather"] = ag.tolist()
    rs = torch.empty(8 // n)
    dist.reduce_scatter_tensor(rs, x.clone(), group=group)
    out["reduce_scatter"] = rs.tolist()
    a2a = torch.empty(8)
    dist.all_to_all_single(a2a, x.clone(), group=group)
    out["all_to_all"] = a2a.tolist()
    ar = x.clone()
    dist.all_reduce(ar, group=group)
    out["all_reduce"] = ar.tolist()
    bc = x.clone()
    dist.broadcast(bc, src=1, group=group)
    out["broadcast"] = bc.tolist()
    dist.barrier(group=group)
    out["moved_bytes"] = dict(comm.HostStagedGroup.moved_bytes)
    return out


def run_all(spec):
    torch.set_num_threads(1)   # 4 processes share the host's cores
    mesh = tmesh.make_host_mesh(model=2, live=True)
    out = dict(rank=dist.get_rank(),
               step={ss: sharded_steps(spec, mesh, ss) for ss in (False, True)},
               live=live_schedule(spec, mesh), heads=whole_heads(spec),
               moe=moe(spec),
               psum=psum(spec),
               restore=restore(spec, mesh))
    out["guard"] = model_axis_guard(spec, mesh)
    out["trainer"] = trainer(spec)
    out["staged"] = staged()
    out["jax"] = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "repro.")))
    return out
