"""Dry-run: drive every (arch x shape) cell's step on fake tensors and
account for its work, its memory and its sharded state, on one device and
on each device of the production meshes.

The port of `repro.launch.dryrun`, which lowers and compiles each cell
for the 256- and 512-chip meshes and reads the per-device program. A cell
here is

  * the per-device state bytes on the production mesh, from the sharding
    rules as pure placement functions (`repro_torch.parallel.sharding`);
  * the one-device program at the cell's full global shape: parameters,
    optimizer state, batch and cache made as fake tensors
    (`FakeTensorMode`: shapes and dtypes, no memory) on the card (or the
    CPU), the step of `repro_torch.launch.steps` run once under the
    recorder (`repro_torch.analysis.trace_utils.record`), and its FLOPs,
    memory bytes and argument / output / peak bytes from
    `repro_torch.launch.op_analysis`; whether it fits one card;
  * the per-device SPMD program (`spmd_program`): the same step run as
    rank 0 of a fake world of 256 (16 x 16) or 512 (2 x 16 x 16) ranks
    (`repro_torch.launch.mesh.fake_world`) under `FakeTensorMode`, and
    recorded as that one process runs it: its local ops and its
    collectives. A train cell places the parameters and AdamW state by
    the rules (`sharding.place_state`, FSDP as the config says) and the
    batch by `sharding.batch_specs` (the rows over ``("pod", "data")``,
    `pipeline.shard_batch`'s placement wherever they divide), and runs
    `steps.make_train_step` with ``grad_pspec``. A prefill or decode cell
    runs the port's serving program on the mesh (``mesh=``, as
    `launch.serve` runs it): the batch rows over ``"data"``
    (`paged.batch_rows`), the pages over ``"model"``, the decode through
    `paged.write_attend_seqpar`, the weights whole on every process (the
    rules place them tensor-parallel: both are reported); the recurrent
    families, whose caches have no pages, split their rows only. Its
    FLOPs, bytes, peak and collective schedule, and the roofline's three
    terms for the NVIDIA H100 SXM: compute, memory and the collective
    bytes over `NVLINK_BW`, the counterpart of the reference's `ICI_BW`.
    A per-device program that fails is reported in the cell (its error
    under ``spmd_program``) beside the one-device part, which stands.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_3_8b \\
        --shape train_4k [--multi-pod] [--out results/dryrun] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from .. import configs
from .. import device as _device
from ..analysis import trace_utils
from ..kvcache import paged
from ..models import registry
from ..models.config import SHAPES, ShapeConfig
from ..optim.adamw import AdamWConfig, AdamWState
from ..parallel import sharding
from . import op_analysis
from .mesh import fake_world, make_production_mesh, mesh_axes, mesh_name
from .steps import (make_decode_step, make_prefill_step, make_train_step,
                    opt_state_specs)

RESULTS_DIR = "results/dryrun"

# NVIDIA H100 SXM (the card `nvidia-smi` names "NVIDIA H100 80GB HBM3"),
# data-sheet figures at its 700 W limit
PEAK_FLOPS = 989.4e12        # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
CARD_BYTES = 80 * 10 ** 9    # device memory
NVLINK_BW = 450e9
"""Bytes/s one H100 SXM sends over NVLink 4: the data sheet's 900 GB/s
both ways, one way; a figure from the data sheet, not a measurement. It
prices every collective byte alike, as the reference's single ``ICI_BW``
figure does: a 16-wide axis spans two 8-card nodes, and the link between
nodes (slower than NVLink) is not priced."""
SCHEDULE_LEN = 25            # collective schedule entries, as the reference


def input_specs(arch: str, shape_name: str):
    """Meta-tensor stand-ins for every model input of this cell."""
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return {"batch": registry.train_specs(cfg, shape)}
    if shape.kind == "prefill":
        batch, cache = registry.prefill_specs(cfg, shape)
        return {"batch": batch, "cache": cache}
    batch, cache = registry.decode_specs(cfg, shape)
    return {"batch": batch, "cache": cache}


def _fake(tree, device):
    """Fake tensors on `device` shaped like a tree of meta tensors."""
    if isinstance(tree, dict):
        return {k: _fake(v, device) for k, v in tree.items()}
    if isinstance(tree, AdamWState):
        return AdamWState(*(_fake(x, device) for x in tree))
    return torch.empty(tree.shape, dtype=tree.dtype, device=device)


def _specs(cfg, shape: ShapeConfig):
    if shape.kind == "train":
        return registry.train_specs(cfg, shape), None
    if shape.kind == "prefill":
        return registry.prefill_specs(cfg, shape)
    return registry.decode_specs(cfg, shape)


def program(cfg, shape: ShapeConfig, n_micro: int = 1, device="cuda"):
    """Run the cell's step once on fake tensors under the recorder;
    returns (op_analysis.analyze of it, seconds it took)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.perf_counter()
    b_spec, c_spec = _specs(cfg, shape)
    with FakeTensorMode():
        params = _fake(registry.param_specs(cfg), device)
        batch = _fake(b_spec, device)
        if shape.kind == "train":
            opt_cfg = AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
            opt = _fake(opt_state_specs(cfg, opt_cfg), device)
            step, args = make_train_step(cfg, opt_cfg, n_micro), (
                params, opt, batch)
        elif shape.kind == "prefill":
            step, args = make_prefill_step(cfg), (
                params, batch, _fake(c_spec, device))
        else:
            step, args = make_decode_step(cfg), (
                params, _fake(c_spec, device), batch)
        with torch.no_grad() if shape.kind != "train" else \
                torch.enable_grad():
            rec, _ = trace_utils.record(step, *args, descend=False)
    return op_analysis.analyze(rec), time.perf_counter() - t0


def _fake_rows(tree, rows: slice, device):
    """`_fake` of this process's `rows` of a tree of batch-major meta
    tensors (a fake tensor of its own, not a view of the whole)."""
    if isinstance(tree, dict):
        return {k: _fake_rows(v, rows, device) for k, v in tree.items()}
    return torch.empty((rows.stop - rows.start, *tree.shape[1:]),
                       dtype=tree.dtype, device=device)


def _serving_rows_only(cfg) -> bool:
    """Families whose cache has no pages to split over ``"model"``: on a
    mesh they split their batch rows only (`launch.serve`)."""
    return cfg.family in ("hybrid", "ssm")


def spmd_program(cfg, shape: ShapeConfig, mesh_shape: dict, n_micro: int = 1,
                 device="cuda", schedule_len: int = SCHEDULE_LEN):
    """The cell's step as rank 0 of a fake world of `mesh_shape` (an
    ordered {axis: size}, `make_production_mesh`) runs it, on fake tensors
    on `device`'s type, recorded once (module docstring). Returns
    (op_analysis.analyze of it with its collectives named by mesh axis,
    the first `schedule_len` entries of its collective schedule, seconds
    it took)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = _device.resolve(device)
    t0 = time.perf_counter()
    b_spec, c_spec = _specs(cfg, shape)
    with fake_world(tuple(mesh_shape.values()), tuple(mesh_shape),
                    dev.type) as mesh, FakeTensorMode():
        params = _fake(registry.param_specs(cfg), dev)
        if shape.kind == "train":
            opt_cfg = AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
            opt = _fake(opt_state_specs(cfg, opt_cfg), dev)
            params, opt, p_spec = sharding.place_state(
                mesh, params, opt, fsdp=cfg.fsdp)
            batch = sharding.place(_fake(b_spec, dev), sharding.named(
                mesh, sharding.batch_specs(mesh_shape, b_spec)))
            step = make_train_step(cfg, opt_cfg, n_micro, grad_pspec=p_spec)
            args, grad = (params, opt, batch), torch.enable_grad()
        else:
            mod = registry.get_module(cfg)
            rows = paged.batch_rows(mesh, shape.global_batch)
            on_mesh = {} if _serving_rows_only(cfg) else {"mesh": mesh}
            cache = mod.init_cache(cfg, rows.stop - rows.start,
                                   shape.seq_len, device=dev, **on_mesh)
            batch = _fake_rows(b_spec, rows, dev)
            if shape.kind == "prefill":
                def step(p, b, c):
                    return mod.prefill(cfg, p, b, c, **on_mesh)
                args = (params, batch, cache)
            else:
                def step(p, c, b):
                    return mod.decode(cfg, p, c, b, **on_mesh)
                args = (params, cache, batch)
            grad = torch.no_grad()
        with grad:
            rec, _ = trace_utils.record(step, *args, descend=False,
                                        dtensor=True)
        axes = mesh_axes(mesh)
        ana = op_analysis.analyze(rec, axes)
        sched = op_analysis.collective_schedule(rec, schedule_len, axes)
    return ana, sched, time.perf_counter() - t0


def dryrun_cell(arch: str, shape_name, multi_pod: bool = False,
                n_micro: int | None = None, overrides: dict | None = None,
                layers: int | None = None, device="cuda",
                verbose: bool = True, _programs: dict | None = None) -> dict:
    """One cell: `shape_name` is a key of `SHAPES` or a `ShapeConfig`;
    `layers` cuts the depth, `overrides` replaces config fields (decode
    cells serve through the paged-attention kernel, ``attend_impl`` =
    ``kernel``, unless `overrides` says otherwise). A per-device program
    that fails leaves the one-device part as it is: its error stands in
    ``spmd_program`` (``status`` ``"error"``), with no schedule and no
    roofline."""
    dev = _device.resolve(device)
    cfg = configs.get(arch)
    shape = shape_name if isinstance(shape_name, ShapeConfig) else \
        SHAPES[shape_name]
    if shape.kind == "decode":
        cfg = dataclasses.replace(cfg, attend_impl="kernel")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    mesh = make_production_mesh(multi_pod=multi_pod)
    result = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name(mesh),
        "kind": shape.kind, "layers": cfg.n_layers,
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
        "device": str(dev), "status": "ok",
    }
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        result["status"] = "skipped"
        result["reason"] = ("pure full-attention arch: O(L^2) at 512K is out "
                            "of assigned scope")
        return result

    # ----- per-device state on the production mesh (analytic) --------------
    p_meta = registry.param_specs(cfg)
    fsdp = cfg.fsdp and shape.kind == "train"
    p_spec = sharding.param_specs(mesh, p_meta, fsdp=fsdp)
    dp = math.prod(mesh[a] for a in sharding.dp_axes(mesh))
    if shape.kind == "train":
        nm = (n_micro or cfg.train_microbatches
              or max(1, min(8, shape.global_batch // dp)))
        result["n_micro"] = nm
        o_meta = opt_state_specs(cfg, AdamWConfig(
            moment_dtype=cfg.opt_moment_dtype))
        state_parts = {"params": (p_meta, p_spec), "opt_m": (o_meta.m, p_spec),
                       "opt_v": (o_meta.v, p_spec)}
    else:
        nm = 1
        _, c_meta = _specs(cfg, shape)
        state_parts = {"params": (p_meta, p_spec),
                       "cache": (c_meta, sharding.cache_specs(mesh, c_meta))}
    result["state_bytes_per_device"] = {
        k: sharding._sharded_bytes(t, s, mesh)
        for k, (t, s) in state_parts.items()}
    result["devices"] = math.prod(mesh.values())

    # ----- the one-device program on fake tensors ---------------------------
    key = (arch, shape, nm, json.dumps(overrides, sort_keys=True), layers,
           str(dev))
    if _programs is not None and key in _programs:
        ana, secs = _programs[key]
    else:
        ana, secs = program(cfg, shape, nm, dev)
        if _programs is not None:
            _programs[key] = (ana, secs)
    result["record_s"] = round(secs, 2)
    result["op_analysis"] = ana
    result["fits_one_card"] = ana["peak_bytes"] <= CARD_BYTES
    # ----- the per-device program on a fake world ---------------------------
    try:
        dana, sched, dsecs = spmd_program(cfg, shape, mesh, nm, dev)
    except Exception as e:  # noqa: BLE001 (reported beside the one-device)
        result["spmd_program"] = {
            "status": "error", "error": str(e)[-2000:],
            "traceback": traceback.format_exc()[-4000:]}
    else:
        result["spmd_program"] = dict(
            dana, status="ok",
            fits_per_device=dana["peak_bytes"] <= CARD_BYTES,
            record_s=round(dsecs, 2))
        result["collective_schedule"] = sched
        terms = {"compute_s": dana["flops"] / PEAK_FLOPS,
                 "memory_s": dana["memory_bytes"] / HBM_BW,
                 "collective_s": dana["collective_bytes"] / NVLINK_BW}
        terms["bottleneck"] = max(terms, key=terms.get)
        terms["card"] = ("NVIDIA H100 80GB HBM3 at 700 W: "
                         f"{PEAK_FLOPS / 1e12} TFLOP/s bf16 dense, "
                         f"{HBM_BW / 1e12} TB/s, NVLink "
                         f"{NVLINK_BW / 1e9} GB/s a direction "
                         f"(data sheet)")
        result["roofline"] = terms

    if verbose:
        print(json.dumps({k: result.get(k) for k in
                          ("arch", "shape", "mesh", "status", "record_s")}))
    return result


def save_result(res: dict, out_dir: str = RESULTS_DIR):
    os.makedirs(out_dir, exist_ok=True)
    name = (f"{res['arch']}__{res['shape']}__"
            f"{res['mesh'].replace('x', '_')}.json")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(res, f, indent=1)
    return os.path.join(out_dir, name)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--overrides", default=None,
                    help="JSON dict of ArchConfig overrides")
    ap.add_argument("--device", default="cuda",
                    help="where the fake tensors live: cuda (default) or cpu")
    args = ap.parse_args(argv)
    overrides = json.loads(args.overrides) if args.overrides else None

    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    if args.all:
        cells = [(a, s, mp) for a in configs.ARCHS for s in SHAPES
                 for mp in meshes]
    else:
        cells = [(args.arch, args.shape, mp) for mp in meshes]

    failures = spmd_failures = 0
    programs = {}
    for arch, shape, mp in cells:
        key = f"{arch}/{shape}/{'2x16x16' if mp else '16x16'}"
        try:
            res = dryrun_cell(arch, shape, multi_pod=mp, overrides=overrides,
                              device=args.device, _programs=programs)
        except Exception as e:  # noqa: BLE001 (a failed cell is reported)
            failures += 1
            res = {"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if mp else "16x16",
                   "status": "error", "error": str(e)[-2000:],
                   "traceback": traceback.format_exc()[-4000:]}
            print(f"FAIL {key}: {e}")
        spmd = res.get("spmd_program", {}).get("status", "ok")
        if spmd != "ok":
            spmd_failures += 1
            print(f"FAIL {key} per device: {res['spmd_program']['error']}")
        path = save_result(res, args.out)
        print(f"{key}: {res['status']}, per device {spmd} -> {path}",
              flush=True)
    if failures or spmd_failures:
        raise SystemExit(f"{failures} dry-run cells and {spmd_failures} "
                         f"per-device programs failed")


if __name__ == "__main__":
    main()
