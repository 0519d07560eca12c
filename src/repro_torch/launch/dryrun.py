"""Dry-run: drive every (arch x shape) cell's step on fake tensors and
account for its work, its memory and its sharded state.

The port of `repro.launch.dryrun`. The reference lowers and compiles each
cell for the 256- and 512-chip production meshes; the port's SPMD
programs are processes on a live `DeviceMesh` (`repro_torch.launch.mesh`),
whose training step (DTensors, `repro_torch.launch.steps`) this dry-run
does not lower yet (ROADMAP A7c), so a cell here is

  * the per-device state bytes on the production mesh, from the sharding
    rules as pure placement functions (`repro_torch.parallel.sharding`);
  * the one-device program at the cell's full global shape: parameters,
    optimizer state, batch and cache made as fake tensors
    (`FakeTensorMode`: shapes and dtypes, no memory) on the card (or the
    CPU), the step of `repro_torch.launch.steps` run once under the
    recorder (`repro_torch.analysis.trace_utils.record`), and its FLOPs,
    memory bytes and argument / output / peak bytes from
    `repro_torch.launch.op_analysis`; whether it fits one card; the
    roofline terms for the NVIDIA H100 SXM.

The per-device SPMD program, its collective schedule and the collective
term of the roofline wait for ROADMAP A7c and are reported as absent
with that reason.

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
from ..models import registry
from ..models.config import SHAPES, ShapeConfig
from ..optim.adamw import AdamWConfig, AdamWState
from ..parallel import sharding
from . import op_analysis
from .mesh import make_production_mesh, mesh_name
from .steps import (make_decode_step, make_prefill_step, make_train_step,
                    opt_state_specs)

RESULTS_DIR = "results/dryrun"

# NVIDIA H100 SXM (the card `nvidia-smi` names "NVIDIA H100 80GB HBM3"),
# data-sheet figures at its 700 W limit
PEAK_FLOPS = 989.4e12        # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
CARD_BYTES = 80 * 10 ** 9    # device memory
NO_MESH = ("waits for ROADMAP A7c: the dry-run does not lower the "
           "step's per-device SPMD program or its collective schedule yet")


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


def dryrun_cell(arch: str, shape_name, multi_pod: bool = False,
                n_micro: int | None = None, overrides: dict | None = None,
                layers: int | None = None, device="cuda",
                verbose: bool = True, _programs: dict | None = None) -> dict:
    """One cell: `shape_name` is a key of `SHAPES` or a `ShapeConfig`;
    `layers` cuts the depth, `overrides` replaces config fields (decode
    cells serve through the paged-attention kernel, ``attend_impl`` =
    ``kernel``, unless `overrides` says otherwise)."""
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
    terms = {"compute_s": ana["flops"] / PEAK_FLOPS,
             "memory_s": ana["memory_bytes"] / HBM_BW}
    terms["bottleneck"] = max(terms, key=terms.get)
    terms["collective_s"] = None
    terms["collective_reason"] = NO_MESH
    terms["card"] = ("NVIDIA H100 80GB HBM3 at 700 W: "
                     f"{PEAK_FLOPS / 1e12} TFLOP/s bf16 dense, "
                     f"{HBM_BW / 1e12} TB/s")
    result["roofline"] = terms
    result["collective_schedule"] = None
    result["spmd_program"] = NO_MESH

    if verbose:
        print(json.dumps({k: result[k] for k in
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

    failures = 0
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
        path = save_result(res, args.out)
        print(f"{key}: {res['status']} -> {path}", flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
