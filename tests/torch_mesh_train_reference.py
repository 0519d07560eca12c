"""The reference's side of tests/test_torch_mesh_train.py, run as a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set
before JAX starts (4 fake CPU devices).

    python tests/torch_mesh_train_reference.py IN.pkl OUT.pkl

IN holds the spec the test's processes get (NumPy parameters, batches,
compression inputs). On a (2, 2) ("data", "model") mesh whose axes are
``Auto`` (the default ``Explicit`` axes make ``with_sharding_constraint``
an assertion and the microbatch reshape fail under JAX 0.9), the
reference's sharded step is jitted as its dry-run jits it: parameters by
``param_specs(fsdp=True)`` through ``named``, the moments like them, the
batch by ``batch_specs``, ``grad_pspec`` the parameters' specs. OUT holds
its losses, gradient norms and final parameters (with and without
``seq_shard``), each leaf's ``NamedSharding.shard_shape``, and
``compressed_psum`` under ``shard_map`` on a (4,) ``"data"`` mesh.
"""
import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

from repro import configs
from repro.launch.steps import make_train_step
from repro.models import registry
from repro.optim import adamw, compression
from repro.optim.adamw import AdamWConfig, AdamWState
from repro.parallel import sharding
from repro.parallel.meshctx import activate_mesh


def _mesh(shape, names):
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(names))


def sharded_steps(spec, seq_shard):
    cfg = dataclasses.replace(configs.get(spec["arch"]).reduced(),
                              seq_shard=seq_shard)
    mesh = _mesh((2, 2), ("data", "model"))
    params = jax.tree.map(jnp.asarray, spec["params"])
    p_spec = sharding.param_specs(mesh, params, fsdp=True)
    opt_cfg = AdamWConfig()
    opt = adamw.init(opt_cfg, params)
    o_spec = AdamWState(count=P(), m=p_spec, v=p_spec)
    b_spec = sharding.batch_specs(mesh, spec["batches"][0])

    def nm(s):
        return sharding.named(mesh, s)

    step = make_train_step(cfg, opt_cfg, n_micro=spec["n_micro"],
                           grad_pspec=p_spec)
    with activate_mesh(mesh):
        jitted = jax.jit(step, in_shardings=(nm(p_spec), nm(o_spec),
                                             nm(b_spec)),
                         out_shardings=(nm(p_spec), nm(o_spec), None))
        params = jax.device_put(params, nm(p_spec))
        opt = jax.device_put(opt, nm(o_spec))
        losses, gnorms = [], []
        for b in spec["batches"]:
            b = jax.device_put(jax.tree.map(jnp.asarray, b), nm(b_spec))
            params, opt, m = jitted(params, opt, b)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    return dict(losses=losses, gnorms=gnorms,
                params=jax.tree.map(np.asarray, params))


def shard_shapes(spec):
    mesh = _mesh((2, 2), ("data", "model"))
    params = spec["params"]
    p_spec = sharding.param_specs(mesh, params, fsdp=True)
    got = jax.tree.map(lambda s, x: NamedSharding(mesh, s).shard_shape(
        x.shape), p_spec, params, is_leaf=lambda x: isinstance(x, P))
    from repro.data.pipeline import batch_pspec
    b = spec["batches"][0]
    bs = batch_pspec(mesh, b)
    got_b = {k: NamedSharding(mesh, bs[k]).shard_shape(b[k].shape) for k in b}
    return dict(params=got, batch=got_b)


def compressed(spec):
    from jax.experimental.shard_map import shard_map
    mesh = _mesh((4,), ("data",))
    xs = jnp.asarray(spec["psum_inputs"])

    def f(x):
        return compression.compressed_psum(x[0], "data")[None]

    out = shard_map(f, mesh=mesh, in_specs=P("data"), out_specs=P("data"))(xs)
    parts = [compression.quantize(jnp.asarray(x)) for x in spec["psum_inputs"]]
    return dict(sum=np.asarray(out), q=[np.asarray(q) for q, _, _ in parts],
                scales=[np.asarray(s) for _, s, _ in parts])


def main(inp, out):
    with open(inp, "rb") as f:
        spec = pickle.load(f)
    assert jax.device_count() == 4, jax.devices()
    res = dict(step={ss: sharded_steps(spec, ss) for ss in (False, True)},
               shapes=shard_shapes(spec), psum=compressed(spec))
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
