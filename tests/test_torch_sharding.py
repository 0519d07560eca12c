"""The port's sharding rules, mesh shapes and dry-run against the
reference's.

`repro_torch.parallel.sharding` places every leaf by pure functions over a
mesh shape; the reference places it on a `jax.sharding.AbstractMesh` of
the same shape. For all 10 arches, the 4 shapes and both production
meshes the placements of the parameters, the batch and the cache are
equal leaf for leaf, and so are the per-device state bytes (the
reference's `launch.dryrun._sharded_bytes` rule, restated here because
importing that module forces 512 host devices on the process).
`launch.dryrun.dryrun_cell` runs a reduced train cell on CPU fake tensors:
the same op counts, FLOPs and live bytes as the same step on real
tensors, and the arguments the specs say. `long_500k` is skipped for the
archs that are not sub-quadratic, as the reference skips it.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import registry as rregistry  # noqa: E402
from repro.models.config import SHAPES as RSHAPES  # noqa: E402
from repro.parallel import sharding as rsharding  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.analysis import trace_utils  # noqa: E402
from repro_torch.launch import dryrun, mesh as tmesh, op_analysis  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}


def _abstract(mesh):
    return AbstractMesh(tuple(mesh.values()), tuple(mesh))


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}{k}/"))
        return out
    return {pre[:-1]: tree}


def _spec(p):
    return tuple(p) if isinstance(p, PartitionSpec) else p


def _ref_bytes(sds, spec, mesh):
    """The reference's `_sharded_bytes` rule over flat {name: leaf}."""
    total = 0
    for k, s in sds.items():
        n = int(np.prod(s.shape)) if s.shape else 1
        div = 1
        for axes in spec[k]:
            if axes is None:
                continue
            for a in (axes if isinstance(axes, tuple) else (axes,)):
                div *= mesh[a]
        total += n * np.dtype(s.dtype).itemsize // max(div, 1)
    return total


def _ref_specs(cfg, shape_name):
    shape = RSHAPES[shape_name]
    if shape.kind == "train":
        return rregistry.train_specs(cfg, shape), None
    if shape.kind == "prefill":
        return rregistry.prefill_specs(cfg, shape)
    return rregistry.decode_specs(cfg, shape)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_placements_and_state_bytes_match_reference(arch):
    cfg, rcfg = configs.get(arch), rconfigs.get(arch)
    p, rp = registry.param_specs(cfg), rregistry.param_sds(rcfg)
    fp, frp = _flat(p), _flat(rp)
    assert {k: tuple(t.shape) for k, t in fp.items()} == \
        {k: tuple(s.shape) for k, s in frp.items()}
    for multi_pod, mesh in MESHES.items():
        am = _abstract(mesh)
        assert sharding.dp_axes(mesh) == rsharding.dp_axes(am)
        for fsdp in (False, True):
            got = _flat(sharding.param_specs(mesh, p, fsdp=fsdp))
            want = {k: _spec(v) for k, v in _flat(
                rsharding.param_specs(am, rp, fsdp=fsdp)).items()}
            assert got == want, (arch, multi_pod, fsdp)
            assert sharding._sharded_bytes(p, sharding.param_specs(
                mesh, p, fsdp=fsdp), mesh) == _ref_bytes(frp, want, mesh)
        for name in SHAPES:
            batch, cache = dryrun._specs(cfg, SHAPES[name])
            rbatch, rcache = _ref_specs(rcfg, name)
            got = sharding.batch_specs(mesh, batch)
            want = {k: _spec(v) for k, v in
                    rsharding.batch_specs(am, rbatch).items()}
            assert got == want, (arch, name, multi_pod)
            if cache is None:
                continue
            got = sharding.cache_specs(mesh, cache)
            want = {k: _spec(v) for k, v in
                    rsharding.cache_specs(am, rcache).items()}
            assert got == want, (arch, name, multi_pod)
            assert sharding._sharded_bytes(cache, got, mesh) == \
                _ref_bytes(rcache, want, mesh)


def test_production_and_host_mesh_shapes():
    assert tmesh.make_production_mesh() == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True) == \
        {"pod": 2, "data": 16, "model": 16}
    assert list(tmesh.make_production_mesh(multi_pod=True)) == \
        ["pod", "data", "model"]
    assert tmesh.mesh_name(tmesh.make_production_mesh(multi_pod=True)) == \
        "2x16x16"
    n = max(torch.cuda.device_count(), 1)
    assert tmesh.make_host_mesh() == {"data": n, "model": 1}
    with pytest.raises(ValueError):
        tmesh.make_host_mesh(model=n + 1)


def _specs_bytes(tree):
    return sum(t.numel() * t.element_size()
               for t in trace_utils.leaves(tree))


def test_dryrun_cell_reduced_train_matches_a_real_run():
    """A reduced train cell through `dryrun_cell` on CPU fakes: status ok,
    per-device state bytes from the rules, argument bytes == parameters +
    m + v + count + batch; and its program == the same step recorded on
    real tensors: ops, FLOPs, memory bytes, argument / output / peak
    bytes."""
    cell = ShapeConfig("train_4k", 64, 4, "train")
    over = dict(dataclasses.asdict(configs.get("granite_3_8b").reduced()))
    over = {k: over[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                 "head_dim", "d_ff", "vocab", "dtype",
                                 "remat")}
    res = dryrun.dryrun_cell("granite_3_8b", cell, n_micro=2,
                             overrides=over, layers=2, device="cpu",
                             verbose=False)
    assert res["status"] == "ok" and res["n_micro"] == 2
    cfg = dataclasses.replace(configs.get("granite_3_8b"), n_layers=2,
                              **over)
    ospec = steps.opt_state_specs(cfg, AdamWConfig())
    p = registry.param_specs(cfg)
    want_args = (_specs_bytes(p) + _specs_bytes((ospec.m, ospec.v))
                 + 4 + _specs_bytes(registry.train_specs(cfg, cell)))
    ana = res["op_analysis"]
    assert ana["argument_bytes"] == want_args
    mesh = MESHES[False]
    spec = sharding.param_specs(mesh, p, fsdp=cfg.fsdp)
    assert res["state_bytes_per_device"]["params"] == \
        sharding._sharded_bytes(p, spec, mesh)
    # the per-device program on the fake 256-rank world: its collectives
    # priced at NVLink, the bottleneck over the three terms
    spmd, rf = res["spmd_program"], res["roofline"]
    assert spmd["collective_bytes"] > 0 and res["collective_schedule"]
    assert rf["collective_s"] == spmd["collective_bytes"] / dryrun.NVLINK_BW
    assert rf["bottleneck"] == max(
        ("compute_s", "memory_s", "collective_s"), key=rf.get)
    assert res["fits_one_card"] and spmd["fits_per_device"]

    # the same step on real tensors
    params = registry.init(cfg, seed=0, device="cpu")
    from repro_torch.optim import adamw
    opt = adamw.init(AdamWConfig(), params)
    batch = registry.make_train_batch(cfg, cell, seed=0, device="cpu")
    batch["labels"] = batch["labels"].clone()  # the specs' own buffer
    step = steps.make_train_step(cfg, AdamWConfig(), n_micro=2)
    rec, _ = trace_utils.record(step, params, opt, batch, descend=False)
    real = op_analysis.analyze(rec)
    for k in ("n_ops", "flops", "memory_bytes", "argument_bytes",
              "output_bytes", "peak_bytes"):
        assert ana[k] == real[k], k
    assert ana["peak_bytes"] > ana["argument_bytes"]


@pytest.mark.parametrize("arch", ["granite_3_8b", "mamba2_130m"])
def test_long_500k_skip(arch):
    res = dryrun.dryrun_cell(arch, "long_500k", device="cpu", verbose=False,
                             layers=1)
    cfg = configs.get(arch)
    assert res["status"] == ("ok" if cfg.sub_quadratic else "skipped")
    if cfg.sub_quadratic:
        assert res["op_analysis"]["flops"] > 0
    else:
        assert "O(L^2)" in res["reason"]
