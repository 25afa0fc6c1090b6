"""JAX reference runs for the PyTorch port's parity tests.

The JAX collectives and the DP train step need several JAX devices, and
--xla_force_host_platform_device_count must be set before JAX starts, so
the tests run this file in a subprocess:

    python tests/jax_reference.py collectives OUT.npz
    python tests/jax_reference.py train_step OUT.npz

Each command writes its inputs and the JAX results to OUT.npz. Importing
this module (as the tests do, for `flat_numpy`) sets nothing and imports
no JAX.
"""
import os
import sys

import numpy as np

P = 4                       # DP members
COLLECTIVE_N = 1001         # optcc length (not a multiple of p-1)
RING_N = 1000               # ring length (a multiple of p)
STRAGGLERS = (0, 1, 3)
TRAIN_STEPS = 3
TRAIN_LR = 1e-3
DEGRADED = (1, 1.5)         # straggler, ell


def flat_numpy(tree, prefix: str = "") -> dict:
    """A JAX pytree as {"/"-joined path: numpy array}, the paths that the
    JAX package's checkpoints use."""
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[prefix + key] = np.asarray(leaf)
    return out


def collective_input() -> np.ndarray:
    return np.random.default_rng(11).standard_normal(
        (P, COLLECTIVE_N)).astype(np.float32)


def _mesh():
    import jax
    from jax.sharding import Mesh
    assert jax.device_count() == P, jax.device_count()
    return Mesh(np.array(jax.devices()), ("dp",))


def collectives(out_path: str) -> None:
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as Ps

    from repro.comms import (optcc_allreduce, ring_allreduce,
                             ring_reduce_scatter)
    mesh = _mesh()
    x = collective_input()

    def run(fn, arr):
        return np.asarray(jax.jit(shard_map(
            fn, mesh=mesh, in_specs=Ps("dp"), out_specs=Ps("dp")))(arr))

    res = {"x": x,
           "ring_allreduce": run(
               lambda xs: ring_allreduce(xs[0], "dp")[None], x[:, :RING_N]),
           "ring_reduce_scatter": run(
               lambda xs: ring_reduce_scatter(xs[0], "dp")[None],
               x[:, :RING_N])}
    for s in STRAGGLERS:
        res[f"optcc_{s}"] = run(
            lambda xs, s=s: optcc_allreduce(xs[0], "dp", s, P)[None], x)
    np.savez(out_path, **res)


def train_config():
    from repro.configs import get_config
    return get_config("qwen3-1.7b", smoke=True)


def train_data():
    from repro.data import DataConfig, SyntheticLM
    cfg = train_config()
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=8))


def train_step(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.comms.fault import FaultState
    from repro.models import build_model
    from repro.optim import AdamWConfig
    from repro.optim.schedules import constant
    from repro.train import init_train_state, make_dp_failover_step
    assert jax.device_count() == P, jax.device_count()
    model = build_model(train_config())
    opt = AdamWConfig(weight_decay=0.01)
    mesh = Mesh(np.array(jax.devices()), ("data",))
    data = train_data()
    init = init_train_state(model, opt, seed=0)
    res = flat_numpy(init.params, "init/")
    for name, fault in (("healthy", FaultState(P)),
                        ("degraded", FaultState(P, *DEGRADED))):
        step = make_dp_failover_step(model, mesh, opt, constant(TRAIN_LR),
                                     fault)
        state = init
        losses, gnorms = [], []
        for i in range(TRAIN_STEPS):
            batch = jax.tree.map(jnp.asarray, data.batch(i))
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        res[f"{name}/loss"] = np.asarray(losses)
        res[f"{name}/grad_norm"] = np.asarray(gnorms)
        res.update(flat_numpy(state.params, f"{name}/params/"))
    np.savez(out_path, **res)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={P} "
        + os.environ.get("XLA_FLAGS", ""))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    {"collectives": collectives, "train_step": train_step}[sys.argv[1]](
        sys.argv[2])
