"""Training on a live mesh of processes, against the reference's own
sharded step.

One group of 4 gloo processes on the CPU (`repro_torch.launch.mesh.spawn`,
once for the file) runs `torch_mesh_train_workers.run_all`; the processes
import no JAX. While it runs, the reference runs in a subprocess on 4 fake
CPU devices (``XLA_FLAGS`` set before JAX starts) on a (2, 2) mesh with
``Auto`` axes (tests/torch_mesh_train_reference.py), and the parent runs
the port's one-device trainer. Both packages start from the reference's
parameters (granite-3-8b reduced, fp32), carried across by
`convert.params_from_reference`, and see the same NumPy batches:

  * the sharded step (FSDP + TP by ``param_specs(fsdp=True)`` through
    `named`, the moments like the parameters, the batch by `shard_batch`,
    ``grad_pspec`` the parameters' specs, 2 microbatches, 2 steps, the
    default AdamW) against the reference's jitted one, with and without
    ``seq_shard``: each loss within 1e-5 relative, the gradient norm
    within 1e-4 relative, the parameters within 5e-5 absolute;
  * every parameter's, moment's and batch leaf's local shape == the
    reference's ``NamedSharding.shard_shape`` on the same mesh shape;
  * `compressed_psum` over 4 processes: the gathered int8 payloads and
    scales == the reference's quantization of each process's input bit for
    bit, the sum within 1e-6 relative of the reference's under
    ``shard_map``, and within tests/test_substrate.py's bound of the fp32
    sum;
  * `train.main` on the (4, 1) mesh with ``--fail-at``: its lines == the
    one-device trainer's (numbers to 1e-4, as tests/test_torch_train.py
    holds that trainer to the reference's), its history the same, the
    state replicated;
  * a run on (2, 2) (one microbatch: the gradients reach the update as
    partial sums) checkpointed at step 2, restored by `run_with_recovery`
    onto a (1, 2) mesh of two processes and onto one device: each
    continues equal to the uninterrupted run (loss 1e-5 relative,
    parameters 5e-5); a restore onto another "model" size raises.

Without a spawn: placement tuples to DTensor placements, the batch's
placement, the no-op constraints on plain tensors, and ``grad_pspec``
refusing parameters that are not on a mesh.
"""
import concurrent.futures
import contextlib
import dataclasses
import io
import os
import pickle
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_mesh_train_workers as W
from repro import configs as jconfigs
from repro.models import registry as jreg

from repro_torch import configs as tconfigs
from repro_torch.data import pipeline
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import layers, registry
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adamw
from repro_torch.parallel import sharding

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
ARCH = "granite_3_8b"
LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-4
PARAM_ATOL = 5e-5
TRAIN_ARGS = ["--arch", ARCH, "--reduced", "--steps", "12", "--batch", "4",
              "--seq", "32", "--ckpt-every", "1", "--fail-at", "7"]


def _batches(rng, vocab, n, B=4, S=16):
    out = []
    for _ in range(n):
        t = rng.integers(0, vocab, (B, S)).astype(np.int32)
        out.append({"tokens": t, "labels": t.copy()})
    return out


def _spec(tmp):
    cfg = jconfigs.get(ARCH).reduced()
    params = jax.tree.map(np.asarray, jreg.init(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    return dict(
        arch=ARCH, params=params, n_micro=2,
        batches=_batches(rng, cfg.vocab, 2),
        psum_inputs=rng.standard_normal((WORLD, 300)).astype(np.float32),
        train_args=TRAIN_ARGS, train_dir=str(tmp / "train"),
        restore_dir=str(tmp / "restore"), restore_steps=4, restore_every=2,
        restore_batches=_batches(rng, cfg.vocab, 4))


def _reference(spec, tmp):
    """The reference's side, in a subprocess on 4 fake CPU devices."""
    inp, out = tmp / "ref_in.pkl", tmp / "ref_out.pkl"
    with open(inp, "wb") as f:
        pickle.dump(spec, f)
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{flags} --xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen(
        [sys.executable, str(ROOT / "tests/torch_mesh_train_reference.py"),
         str(inp), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), out


def _one_device_trainer(tmp):
    """The port's trainer on one device with the spec's flags (flat
    attention weights, as tests/test_torch_train.py runs it): its lines
    and history."""
    get, threads = tconfigs.get, torch.get_num_threads()
    tconfigs.get = lambda name: dataclasses.replace(get(name), attn_4d=False)
    torch.set_num_threads(1)   # beside the 4 processes and the reference
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            _, hist = ttrain.main(TRAIN_ARGS + [
                "--device", "cpu", "--ckpt-dir", str(tmp / "one_train")])
    finally:
        tconfigs.get = get
        torch.set_num_threads(threads)
    return buf.getvalue().splitlines(), hist


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """(spec, results by process, the reference's results, the one-device
    trainer's (lines, history))."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    spec = _spec(tmp)
    proc, out = _reference(spec, tmp)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            spawned = ex.submit(tmesh.spawn, W.run_all, WORLD, spec,
                                backend="gloo", timeout=300)
            one = _one_device_trainer(tmp)
            results = spawned.result()
        log, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, log[-3000:]
    with open(out, "rb") as f:
        ref = pickle.load(f)
    return spec, results, ref, one


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{pre}{k}/"))
        return out
    return {pre[:-1]: tree}


@pytest.mark.parametrize("seq_shard", [False, True])
def test_sharded_step_matches_the_reference_sharded_step(group, seq_shard):
    _, results, ref, _ = group
    want = ref["step"][seq_shard]
    for r in results:
        got = r["step"][seq_shard]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(got["gnorms"], want["gnorms"],
                                   rtol=GNORM_RTOL, atol=0)
        gp, wp = _leaves(got["params"]), _leaves(want["params"])
        assert gp.keys() == wp.keys()
        for k in wp:
            np.testing.assert_allclose(gp[k], wp[k], rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"process {r['rank']} {k}")
    # SPMD: every process ends with the same parameters
    first = _leaves(results[0]["step"][seq_shard]["params"])
    for r in results[1:]:
        for k, v in _leaves(r["step"][seq_shard]["params"]).items():
            np.testing.assert_array_equal(v, first[k])


def test_local_shapes_are_the_reference_shard_shapes(group):
    """`named(param_specs(fsdp=True))` and `batch_pspec` on (2, 2): each
    process holds the shard the reference's NamedSharding gives a device,
    the moments like the parameters; at least one leaf is split over both
    axes (not a mesh replicated everywhere)."""
    _, results, ref, _ = group
    want = _leaves(ref["shapes"]["params"])
    whole = {k: tuple(v.shape) for k, v in _leaves(group[0]["params"]).items()}
    for r in results:
        got = r["step"][False]
        for what in ("local", "m_local"):
            g = _leaves(got[what])
            assert g.keys() == want.keys()
            assert {k: tuple(g[k]) for k in g} == {
                k: tuple(want[k]) for k in want}, what
        assert got["batch_local"] == {k: tuple(v) for k, v in
                                      ref["shapes"]["batch"].items()}
    split = [k for k in want
             if np.prod(whole[k]) == 4 * np.prod(want[k])]
    assert split, "no leaf is split over both axes"


def test_compressed_psum_matches_the_reference(group):
    spec, results, ref, _ = group
    xs = spec["psum_inputs"]
    for r in results:
        got = r["psum"]
        assert got["n"] == xs.shape[1]
        for p in range(WORLD):
            np.testing.assert_array_equal(got["q"][p], ref["psum"]["q"][p])
            np.testing.assert_array_equal(got["scales"][p],
                                          ref["psum"]["scales"][p])
        want = ref["psum"]["sum"][r["rank"]]
        np.testing.assert_allclose(got["sum"], want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
        # tests/test_substrate.py:73's bound against the fp32 sum
        np.testing.assert_allclose(got["sum"], xs.sum(0), atol=0.1,
                                   rtol=0.02)


def test_train_main_on_the_mesh_prints_the_one_device_lines(group):
    _, results, _, (want, want_hist) = group
    got = results[0]["trainer"]
    assert got["hist"] == {**want_hist, "stragglers": got["hist"][
        "stragglers"]}
    assert got["hist"]["recoveries"] == 1
    keep = ("arch=", "step ", "done:", "latest checkpoint")
    slow = re.compile(r"\d+ straggler events")   # read off the host clock
    a = [slow.sub("#", ln) for ln in got["lines"] if ln.startswith(keep)]
    b = [slow.sub("#", ln) for ln in want if ln.startswith(keep)]
    assert len(a) == len(b) == 6
    num = re.compile(r"[-+]?\d+\.\d+(?:e[-+]\d+)?")
    for x, y in zip(a, b):
        assert num.sub("#", x) == num.sub("#", y)
        np.testing.assert_allclose([float(v) for v in num.findall(x)],
                                   [float(v) for v in num.findall(y)],
                                   rtol=1e-4, atol=1e-4)
    assert got["placements"] == {"(Replicate(), Replicate())"}
    for r in results[1:]:
        assert r["trainer"]["lines"] == []      # process 0 alone prints


def test_restore_onto_a_new_mesh_continues_the_run(group):
    _, results, _, _ = group
    whole = results[0]["restore"]["whole"]
    tail = {k: v for k, v in whole["losses"].items() if k > 2}
    runs = [results[0]["restore"]["one"], results[0]["restore"]["sub"],
            results[1]["restore"]["sub"]]
    for run in runs:
        assert run["steps"] == [3]
        assert run["losses"].keys() == tail.keys()
        np.testing.assert_allclose(list(run["losses"].values()),
                                   list(tail.values()), rtol=LOSS_RTOL)
        gp, wp = _leaves(run["params"]), _leaves(whole["params"])
        for k in wp:
            np.testing.assert_allclose(gp[k], wp[k], rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)
    for r in results[:2]:
        assert r["restore"]["sub"]["meshes"] == {"[[0, 1]]"}
    assert all("sub" not in r["restore"] for r in results[2:])


def test_restore_onto_another_model_size_raises(group):
    for r in group[1]:
        assert r["guard"] and "'model' axis is an invariant" in r["guard"]


def test_host_staged_group_collectives(group):
    """`comm.HostStagedGroup` (the group of a gloo world whose processes
    hold cards; here a group of its own on the CPU): all-gather,
    reduce-scatter (gloo's all-to-all and a local sum), all-to-all,
    all-reduce and broadcast give the collectives' values."""
    xs = [np.arange(8, dtype=np.float32) + 10 * r for r in range(WORLD)]
    total = np.sum(xs, axis=0)
    for r in group[1]:
        got, k = r["staged"], r["rank"]
        assert got["type"] == "HostStagedGroup"
        assert got["all_gather"] == np.concatenate(xs).tolist()
        assert got["reduce_scatter"] == total[2 * k:2 * k + 2].tolist()
        assert got["all_to_all"] == np.concatenate(
            [x[2 * k:2 * k + 2] for x in xs]).tolist()
        assert got["all_reduce"] == total.tolist()
        assert got["broadcast"] == xs[1].tolist()
        # its byte count: the results' bytes by kind (fp32)
        assert got["moved_bytes"] == {
            "all_gather_into_tensor": 4 * WORLD * 8,
            "reduce_scatter_tensor": 4 * 8 // WORLD,
            "all_to_all_single": 4 * 8, "all_reduce": 4 * 8,
            "broadcast": 4 * 8}


@pytest.mark.parametrize("arch", ["mamba2_130m", "granite_3_8b"])
def test_heads_that_meet_the_mesh(group, arch):
    """One step on the mesh == the same step on one device (loss within
    LOSS_RTOL, gradient norm within GNORM_RTOL): mamba2's SSD runs on each
    process's rows and heads on the (2, 2) mesh; granite's 2 KV heads meet
    a (1, 4) mesh, whose "model" axis does not divide them, so their
    projections and the weights' gradients keep the heads whole."""
    spec, results, _, _ = group
    want = W.one_step(W.reduced(arch), spec["batches"][0], None)
    for r in results:
        got = r["heads"][arch]
        np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(got[1], want[1], rtol=GNORM_RTOL, atol=0)


@pytest.mark.parametrize("case", list(W.MOE_CASES))
def test_moe_on_the_mesh(group, case):
    """The MoE's routed experts on the mesh (`moe._routed_on_mesh`) keep
    the reference's groups of the whole token stream: one step == the
    same step on one device (loss within LOSS_RTOL, gradient norm within
    GNORM_RTOL), where a group spans processes, where the groups are
    reordered (more than moe_parallel_groups of them), where each
    process's rows are whole groups, and where "model" splits each
    expert's width instead of the experts."""
    spec, results, _, _ = group
    arch, over, B, S, _ = W.MOE_CASES[case]
    want = W.one_step(W.reduced(arch, **over), W.moe_batch(arch, over, B, S),
                      None)
    for r in results:
        got = r["moe"][case]
        np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(got[1], want[1], rtol=GNORM_RTOL, atol=0)


def test_live_schedule_equals_the_dry_run(group):
    """The collectives one live step of the reduced cell runs on each
    process of the (2, 2) gloo world (recorded by `trace_utils.record`)
    == the dry-run's per-device program of the same cell on a fake (2, 2)
    world (`dryrun.spmd_program`): every op, result shape, mesh axis,
    count and byte; and its argument bytes == the rules' per-device state
    (parameters, m, v) + count + the process's rows of the batch."""
    spec, results, _, _ = group
    cfg = tconfigs.get(ARCH).reduced()
    B, S = spec["batches"][0]["tokens"].shape
    ana, sched, _ = dryrun.spmd_program(
        cfg, ShapeConfig("t", S, B, "train"), {"data": 2, "model": 2},
        spec["n_micro"], "cpu", schedule_len=1 << 30)
    assert sched and {e["axis"] for e in sched} == {"data", "model"}
    for r in results:
        live = r["live"]
        assert live["schedule"] == sched, f"process {r['rank']}"
        assert live["by_op"] == ana["collective_bytes_by_op"]
        assert live["by_axis"] == ana["collective_bytes_by_axis"]
        assert live["argument_bytes"] == ana["argument_bytes"]
    mesh = {"data": 2, "model": 2}
    meta = registry.param_specs(cfg)
    state = 3 * sharding._sharded_bytes(
        meta, sharding.param_specs(mesh, meta, fsdp=True), mesh)
    assert ana["argument_bytes"] == state + 4 + 2 * 4 * (B // 2) * S


def test_the_mesh_processes_import_no_jax(group):
    for r in group[1]:
        assert r["jax"] == []


# ------------------------------------------------------------ no spawn --
MESH = types.SimpleNamespace(mesh_dim_names=("data", "model"))


def test_placement_tuples_become_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard
    assert sharding.dtensor_placements(MESH, ("data", "model")) == (
        Shard(0), Shard(1))
    assert sharding.dtensor_placements(MESH, (None, "model", None)) == (
        Replicate(), Shard(1))
    assert sharding.dtensor_placements(MESH, (("data", "model"), None)) == (
        Shard(0), Shard(0))
    assert sharding.dtensor_placements(MESH, ()) == (Replicate(),
                                                     Replicate())
    with pytest.raises(ValueError, match="pod"):
        sharding.dtensor_placements(MESH, (("pod", "data"), None))
    with pytest.raises(ValueError, match="twice"):
        sharding.dtensor_placements(MESH, ("data", "data"))


def test_batch_pspec_splits_the_leading_dim_over_the_data_axes():
    batch = {"tokens": np.zeros((8, 4), np.int32),
             "patch_embeds": np.zeros((8, 2, 3), np.float32)}
    assert pipeline.batch_pspec(MESH, batch) == {
        "tokens": (("data",), None), "patch_embeds": (("data",), None, None)}
    pod = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert pipeline.batch_pspec(pod, batch)["tokens"] == (("pod", "data"),
                                                          None)


def test_constraints_are_no_ops_without_a_mesh():
    x = torch.randn(2, 4, 8)
    assert layers.activation_constraint(x) is x
    assert layers.activation_constraint(x, seq_over_model=True) is x
    assert layers.seq_shard_constraint(x) is x
    with layers.on_mesh({"w": x}, {"tokens": torch.zeros(2, 4)}):
        pass


def test_grad_pspec_needs_parameters_on_a_mesh():
    cfg = tconfigs.get(ARCH).reduced()
    params = tsteps.registry.init(cfg, seed=0, device="cpu")
    opt_cfg = adamw.AdamWConfig()
    spec = sharding.param_specs({"data": 2, "model": 2}, params, fsdp=True)
    step = tsteps.make_train_step(cfg, opt_cfg, n_micro=2, grad_pspec=spec)
    batch = pipeline.to_device(_batches(np.random.default_rng(1), cfg.vocab,
                                        1)[0], "cpu")
    with pytest.raises(ValueError, match="grad_pspec"):
        step(params, adamw.init(opt_cfg, params), batch)
