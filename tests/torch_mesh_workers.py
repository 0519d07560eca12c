"""What each process of tests/test_torch_mesh.py's gloo group runs.

`repro_torch.launch.mesh.spawn` starts 4 processes on the CPU, each of
which calls `run_all` once with the same spec (NumPy inputs the parent
made) and returns host objects. This module imports no JAX and nothing
of the reference, and `run_all` reports what the process imported.
"""
import hashlib
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.core import heap
from repro_torch.core import system as tsys


def kind_cfg(kind, heap_bytes, threads):
    return tsys.SystemConfig(kind=kind, heap_bytes=heap_bytes,
                             num_threads=threads)


def response_arrays(resp):
    return {f: getattr(resp, f).cpu().numpy() for f in resp._fields}


def digest(arrays) -> str:
    """One hash of a list of response dicts: every process must hold the
    same gathered responses."""
    h = hashlib.sha256()
    for d in arrays:
        for f in sorted(d):
            h.update(np.ascontiguousarray(d[f]).tobytes())
    return h.hexdigest()


def sharded_session(h, sizes, masks=False):
    """malloc, realloc (rolled sizes), free the survivors; with `masks`
    the realloc selects ranks ([R]), a calloc cores ([R, C]) and the free
    takes a scalar mask. Returns the responses as host dicts."""
    R, C, T = h.shape
    ra = h.malloc(sizes)
    if masks:
        rank = np.arange(R) % 2 == 0
        rr = h.realloc(ra.ptr, np.roll(sizes, 1, axis=-1), active=rank)
        grid = (np.arange(R)[:, None] + np.arange(C)[None, :]) % 2 == 0
        rc = h.calloc(np.full((R, C, T), 4, np.int32),
                      np.full((R, C, T), 16, np.int32), active=grid)
        live = torch.where(rr.ptr >= 0, rr.ptr, ra.ptr)
        return [response_arrays(r) for r in
                (ra, rr, rc, h.free(live, active=True))]
    rr = h.realloc(ra.ptr, np.roll(sizes, 1, axis=-1))
    live = torch.where(rr.ptr >= 0, rr.ptr, ra.ptr)
    return [response_arrays(r) for r in (ra, rr, h.free(live))]


def held(engine_or_heap):
    """The ranks this process holds: [lo, hi), None on one device."""
    shard = engine_or_heap.shard
    return None if shard is None else (shard.lo, shard.hi)


def whole_state(engine_or_heap, state):
    """The fleet state gathered over the mesh, as host arrays."""
    shard = engine_or_heap.shard
    whole = state if shard is None else shard.gather(state)
    return [x.cpu().numpy() for x in convert.leaves(whole)]


def sharded_cases(spec):
    out = {}
    for kind in spec["kinds"]:
        cfg = kind_cfg(kind, spec["heap"], spec["threads"])
        for R in spec["ranks"]:
            C = spec["cores"] // R
            h = heap.ShardedHeap(cfg, R, C, device="cpu")
            sizes = spec["sizes"].reshape((-1, R, C, spec["threads"]))
            resps = []
            for rnd in range(sizes.shape[0]):
                resps += sharded_session(h, sizes[rnd])
            state = whole_state(h, h.state)  # a collective: all gather
            out[(kind, R)] = dict(
                held=held(h), digest=digest(resps),
                resps=resps if dist.get_rank() == 0 else None,
                state=state if dist.get_rank() == 0 else None,
                mesh_size=h.mesh.size())
    cfg = kind_cfg("sw", spec["heap"], spec["threads"])
    h = heap.ShardedHeap(cfg, 4, 2, device="cpu")
    resps = sharded_session(h, spec["sizes"][0].reshape(4, 2, -1),
                            masks=True)
    state = whole_state(h, h.state)
    out["masks"] = dict(digest=digest(resps),
                        resps=resps if dist.get_rank() == 0 else None,
                        state=state if dist.get_rank() == 0 else None)
    return out


def session_result(eng, plan, report, resps, state):
    from repro_torch.launch.serving import fleet_health
    R, C, _ = eng.shape
    health = fleet_health(eng.cfg, state, R, C, eng.shard)
    state = whole_state(eng, state)  # a collective: every process gathers
    return dict(report=report, health=health,
                digest=digest([response_arrays(resps)]),
                resps=response_arrays(resps) if dist.get_rank() == 0
                else None,
                state=state if dist.get_rank() == 0 else None,
                held=held(eng),
                op=plan.op if dist.get_rank() == 0 else None)


def fleet_case(spec):
    from repro_torch.launch import serve_fleet
    shape, traffic = spec["shape"], spec["traffic"]
    eng = serve_fleet.FleetServe(
        kind_cfg(spec["kind"], spec["heap"], shape[2]), shape[0], shape[1],
        traffic=serve_fleet.TrafficConfig(**traffic),
        placement=spec["placement"], mesh=None, device="cpu")
    from repro_torch.kernels import heap_step
    heap_step.fused_heap_step.launches = 0
    plan = eng.plan()
    state, resps = eng.run(plan)
    return session_result(eng, plan, eng.report(plan, resps, state), resps,
                          state)


def decode_case(spec):
    from repro_torch.launch import serve_decode
    shape, traffic = spec["shape"], spec["traffic"]
    eng = serve_decode.DecodeServe(
        kind_cfg(spec["kind"], spec["heap"], shape[2]), shape[0], shape[1],
        traffic=serve_decode.DecodeTraffic(**traffic), mesh=None,
        device="cpu")
    plan = eng.plan()
    state, resps = eng.run(plan)
    return session_result(eng, plan, eng.report(plan, resps, state), resps,
                          state)


def elastic_engine(spec, mesh):
    from repro_torch.launch import elastic
    from repro_torch.launch.serve_fleet import TrafficConfig
    shape = spec["shape"]
    return elastic.ElasticFleetServe(
        kind_cfg(spec["kind"], spec["heap"], shape[2]), shape[0], shape[1],
        traffic=TrafficConfig(**spec["traffic"]), placement="chunked",
        mesh=mesh, device="cpu",
        faults=elastic.FaultPlan.from_json(spec["faults"]),
        migration=elastic.MigrationConfig(**spec["migration"]))


def elastic_finish(eng):
    plan, report = eng.finish()
    return dict(report=report, resps=response_arrays(eng._stacked()),
                state=whole_state(eng, eng.state), held=held(eng))


def elastic_cases(spec):
    """(a) a session on the mesh, snapshotted at spec['snap'] into
    spec['dir_mesh'] (the parent restores it without a mesh) and run to
    its end; (b) the parent's snapshot in spec['dir_fold'], taken
    without a mesh, restored here on the mesh and finished."""
    eng = elastic_engine(spec, None)
    eng.start()
    eng.run_until(spec["snap"])
    eng.snapshot(spec["dir_mesh"])
    a = elastic_finish(eng)
    b = elastic_finish(elastic_engine(spec, None).restore(spec["dir_fold"]))
    keep = dist.get_rank() == 0
    return {k: (v if keep else dict(report=v["report"], held=v["held"]))
            for k, v in (("mesh_run", a), ("fold_to_mesh", b))}


def seqpar_case(spec):
    """`write_attend_seqpar` on a 2 x 2 (data, model) mesh: this
    process's rows and pages in, its output and pools out."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kvcache import paged
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    x = {k: torch.from_numpy(v) for k, v in spec.items()}
    rows = paged.batch_rows(mesh, x["q"].shape[0])
    base, n = paged.local_pages(mesh, x["pt"].shape[1])
    kp = x["kp"][rows, base:base + n].clone()
    vp = x["vp"][rows, base:base + n].clone()
    o, kp2, vp2 = paged.write_attend_seqpar(
        x["q"][rows], x["kn"][rows], x["vn"][rows], kp, vp, x["pt"][rows],
        x["pos"][rows], mesh=mesh)
    assert kp2 is kp and vp2 is vp  # written in place
    return dict(rows=(rows.start, rows.stop), pages=(base, base + n),
                o=o.numpy(), kp=kp.numpy(), vp=vp.numpy())


def granite_case(spec):
    """granite-3-8b reduced: prefill + spec['steps'] greedy decode steps
    on a 1 x 2 (data, model) mesh of processes 0 and 1 (processes 2 and
    3 lie outside it)."""
    import dataclasses

    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import configs
    from repro_torch.models import transformer
    mesh = DeviceMesh("cpu", [[0, 1]], mesh_dim_names=("data", "model"))
    if mesh.get_coordinate() is None:
        return None
    cfg = dataclasses.replace(configs.get("granite_3_8b").reduced(),
                              **spec["overrides"])
    params = convert.params_from_reference(spec["params"], device="cpu")
    toks = torch.from_numpy(spec["tokens"])
    B = toks.shape[0]
    cache = transformer.init_cache(cfg, B, spec["max_seq"], device="cpu",
                                   mesh=mesh)
    cache["page_table"] = torch.from_numpy(spec["pt"])
    cache, logits = transformer.prefill(cfg, params, {"tokens": toks},
                                        cache, mesh=mesh)
    out = dict(logits=[logits.numpy()], pages=cache["k_pages"].shape[2])
    for _ in range(spec["steps"]):
        tok = torch.argmax(logits, dim=-1)[:, None]
        cache, logits = transformer.decode(cfg, params, cache,
                                           {"tokens": tok}, mesh=mesh)
        out["logits"].append(logits.numpy())
    out["seq_lens"] = cache["seq_lens"].numpy()
    out["k_pages"] = cache["k_pages"].numpy()
    out["model_index"] = mesh.get_local_rank("model")
    return out


def serve_case(spec):
    """`launch.serve.serve(mesh=)` of granite-3-8b reduced on a 2 x 2
    (data, model) mesh of all 4 processes: the batch split over "data",
    the pages over "model", decode-time pages from a fleet of
    spec['fleet_ranks'] page heaps on the rank mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs
    from repro_torch.launch import serve
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res = serve.serve(configs.get("granite_3_8b").reduced(), mesh=mesh,
                      device="cpu", **spec)
    return dict(tokens=res.tokens.numpy(), logits=res.logits.numpy(),
                fleet=res.fleet_stats,
                page_allocs=res.page_allocs, finite=res.logits_finite,
                rows=res.cache["k_pages"].shape[1],
                pages=res.cache["k_pages"].shape[2])


def serve_main_case(argv):
    """`launch.serve.main` as under ``torchrun``, in this group (a 1 x 4
    mesh), which it keeps: it joined none."""
    from repro_torch.launch import serve
    res = serve.main(argv)
    return dict(tokens=res.tokens.numpy(), group_kept=dist.is_initialized())


def run_all(spec) -> dict:
    """Every case, in one process group; returns this process's part."""
    out = dict(rank=dist.get_rank(), world=dist.get_world_size())
    out["sharded"] = sharded_cases(spec["sharded"])
    out["fleet"] = fleet_case(spec["fleet"])
    out["decode"] = decode_case(spec["decode"])
    out["elastic"] = elastic_cases(spec["elastic"])
    out["seqpar"] = seqpar_case(spec["seqpar"])
    out["granite"] = granite_case(spec["granite"])
    out["serve"] = serve_case(spec["serve"])
    out["main"] = serve_main_case(spec["main"])
    out["imported"] = sorted(
        n for n in sys.modules if n == "jax" or n.startswith(
            ("jax.", "jaxlib")) or n == "repro" or n.startswith("repro."))
    return out
