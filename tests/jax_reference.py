"""JAX reference runs for the PyTorch port's parity tests.

The JAX collectives and the DP train step need several JAX devices, and
--xla_force_host_platform_device_count must be set before JAX starts, so
the tests run this file in a subprocess:

    python tests/jax_reference.py collectives OUT.npz
    python tests/jax_reference.py train_step OUT.npz [--arch ARCH]
    python tests/jax_reference.py elastic DIR
    python tests/jax_reference.py gspmd_step OUT.npz

The first two write their inputs and the JAX results to OUT.npz
(`collectives`: ring, OptCC flat and tree, hierarchical_psum on a 2 x 2
('outer', 'inner') mesh and compressed_psum on seeded normal and dyadic
inputs; `train_step`: the initial parameters, each run's losses, grad norms and
final parameters, and its parameters after the first step)
(`train_step` on ARCH's smoke config, qwen3-1.7b by default; any dense,
vlm or MoE arch of the port, hymba-1.5b or rwkv6-7b: the tests run
gemma3-27b, internlm2-1.8b, hymba-1.5b, phi3.5-moe-42b-a6.6b, arctic-480b
and rwkv6-7b, and a qwen2-vl-2b batch carries text only, no patch prefix,
as the JAX launcher's does). `elastic`
saves JAX's initial train state as DIR/ckpt/step_0, runs the JAX launcher
from it with a node loss (ELASTIC_ARGV) and writes the launcher's printed
lines and final parameters to DIR/elastic.npz. `gspmd_step` runs one
`make_gspmd_train_step` step on a one-device mesh for each case of
GSPMD_CASES (all ten smoke configs at one microbatch, qwen3-smoke with 4
microbatches and remat="full") from JAX's init on `gspmd_batch`, and
writes the initial and final parameters, the AdamW first moments (0.1 x
the clipped gradients) and the metrics; and, as a JSON string under
"specs", `batch_spec` and `param_pspec` of every leaf of the ten FULL configs
(`jax.eval_shape` of their init) and `input_specs` / `cache_specs` of
every (arch, shape cell) pair that `cell_is_applicable` admits, on both
production meshes, fsdp on and off (512 forced host devices). Importing
this module (as the tests do, for `flat_numpy` and `gspmd_batch`) sets
nothing and imports no JAX.
"""
import contextlib
import io
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

P = 4                       # DP members
COLLECTIVE_N = 1001         # optcc length (not a multiple of p-1)
RING_N = 1000               # ring length (a multiple of p)
STRAGGLERS = (0, 1, 3)
# optcc_allreduce_tree lengths: both leave chunks that are not whole
# 16-byte fp32 vectors (334 and 1367 elements at p = 4)
TREE_NS = (1001, 4099)
INNER = 2                   # hierarchical_psum's ('outer', 'inner') = 2 x 2
TRAIN_STEPS = 3
TRAIN_LR = 1e-3
DEGRADED = (1, 1.5)         # straggler, ell
# the launcher flags of the elastic run (4 members, half lost at step 2)
ELASTIC_ARGV = ["--smoke", "--steps", "4", "--lose-node-at", "2",
                "--log-every", "1"]


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


def tree_leaves(row, n: int):
    """A member's leaves for the tree cases, cut from its (n,) row: (20,
    30) and (n - 604,) fp32, and the last 4 elements as bf16 (jnp or torch,
    whichever module `row` comes from)."""
    bf16 = getattr(type(row), "__module__", "").startswith("torch")
    tail = row[n - 4:n]
    if bf16:
        import torch
        tail = tail.to(torch.bfloat16)
    else:
        import jax.numpy as jnp
        tail = tail.astype(jnp.bfloat16)
    return [row[:600].reshape(20, 30), row[600:n - 4], tail]


def dyadic_input(seed: int = 12) -> np.ndarray:
    """(P, COLLECTIVE_N) multiples of 1/8 below 16 in magnitude: every sum
    of them is exact in fp32, whatever the order of addition."""
    return (np.random.default_rng(seed).integers(
        -128, 128, (P, COLLECTIVE_N)) / 8).astype(np.float32)


def error_input(seed: int = 13) -> np.ndarray:
    """An error-feedback input for compressed_psum (normal, 1e-2 scale)."""
    return (1e-2 * np.random.default_rng(seed).standard_normal(
        (P, COLLECTIVE_N))).astype(np.float32)


def _mesh():
    import jax
    from jax.sharding import Mesh
    assert jax.device_count() == P, jax.device_count()
    return Mesh(np.array(jax.devices()), ("dp",))


def collectives(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as Ps

    from repro.comms import (compressed_psum, hierarchical_psum,
                             optcc_allreduce, optcc_allreduce_tree,
                             ring_allreduce, ring_reduce_scatter)
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
    tree_x = np.random.default_rng(14).standard_normal(
        (P, max(TREE_NS))).astype(np.float32)
    res["tree_x"] = tree_x
    for n in TREE_NS:
        for s in STRAGGLERS:
            def tree(xs, n=n, s=s):
                leaves = optcc_allreduce_tree(tree_leaves(xs[0], n), "dp",
                                              s, P)
                return tuple(leaf.astype(jnp.float32)[None]
                             for leaf in leaves)
            outs = jax.jit(shard_map(
                tree, mesh=mesh, in_specs=Ps("dp"),
                out_specs=(Ps("dp"),) * 3))(tree_x[:, :n])
            for i, leaf in enumerate(outs):
                res[f"tree_{n}_{s}_{i}"] = np.asarray(leaf)
    mesh2 = Mesh(np.array(jax.devices()).reshape(P // INNER, INNER),
                 ("outer", "inner"))
    for outer in (True, False):
        res[f"hier_{outer}"] = np.asarray(jax.jit(shard_map(
            lambda xs, outer=outer: hierarchical_psum(
                xs[0], "inner", "outer" if outer else None)[None],
            mesh=mesh2, in_specs=Ps(("outer", "inner")),
            out_specs=Ps(("outer", "inner"))))(x))
    for name, (data, err) in {"normal": (x, error_input()),
                              "dyadic": (dyadic_input(), None)}.items():
        def comp(xs, es=None):
            out, new_err = compressed_psum(
                xs[0], "dp", None if es is None else es[0])
            return out[None], new_err[None]
        specs = (Ps("dp"),) if err is None else (Ps("dp"), Ps("dp"))
        out, new_err = jax.jit(shard_map(
            comp, mesh=mesh, in_specs=specs,
            out_specs=(Ps("dp"), Ps("dp"))))(
                *((data,) if err is None else (data, err)))
        res[f"compressed_{name}"] = np.asarray(out)
        res[f"compressed_{name}_error"] = np.asarray(new_err)
    np.savez(out_path, **res)


TRAIN_ARCH = "qwen3-1.7b"


def train_config(arch: str = TRAIN_ARCH):
    from repro.configs import get_config
    return get_config(arch, smoke=True)


def train_data(arch: str = TRAIN_ARCH):
    from repro.data import DataConfig, SyntheticLM
    cfg = train_config(arch)
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=8))


def train_step(out_path: str, arch: str = TRAIN_ARCH) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.comms.fault import FaultState
    from repro.models import build_model
    from repro.optim import AdamWConfig
    from repro.optim.schedules import constant
    from repro.train import init_train_state, make_dp_failover_step
    assert jax.device_count() == P, jax.device_count()
    model = build_model(train_config(arch))
    opt = AdamWConfig(weight_decay=0.01)
    mesh = Mesh(np.array(jax.devices()), ("data",))
    data = train_data(arch)
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
            if i == 0:
                res.update(flat_numpy(state.params, f"{name}/step1/params/"))
        res[f"{name}/loss"] = np.asarray(losses)
        res[f"{name}/grad_norm"] = np.asarray(gnorms)
        res.update(flat_numpy(state.params, f"{name}/params/"))
    np.savez(out_path, **res)


def elastic(out_dir: str) -> None:
    import jax

    from repro.checkpoint import save
    from repro.launch.train import main as train_main
    from repro.models import build_model
    from repro.optim import AdamWConfig
    from repro.train import init_train_state
    assert jax.device_count() == P, jax.device_count()
    ckpt = os.path.join(out_dir, "ckpt")
    model = build_model(train_config())
    save(ckpt, 0, init_train_state(model, AdamWConfig(weight_decay=0.01)))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        state = train_main(ELASTIC_ARGV + ["--ckpt-dir", ckpt])
    np.savez(os.path.join(out_dir, "elastic.npz"),
             lines=np.asarray(printed.getvalue().splitlines()),
             **flat_numpy(state.params, "params/"))


GSPMD_LR = 1e-3
GSPMD_ARCHS = ("qwen3-1.7b", "gemma3-27b", "minicpm-2b", "internlm2-1.8b",
               "rwkv6-7b", "arctic-480b", "phi3.5-moe-42b-a6.6b",
               "hymba-1.5b", "whisper-base", "qwen2-vl-2b")
# case name -> (arch, num_microbatches, remat override or None)
GSPMD_CASES = {arch: (arch, 1, None) for arch in GSPMD_ARCHS}
GSPMD_CASES["qwen3-1.7b/mb4_full"] = ("qwen3-1.7b", 4, "full")
MESH_DEVICES = 512          # the (2, 16, 16) production mesh


def gspmd_batch(cfg, B: int = 8, S: int = 24, seed: int = 0) -> dict:
    """A numpy batch for either package's `cfg` (the two are field-equal):
    next-token labels, the first 3 masked; whisper's standard-normal
    frames and qwen2-vl's patch prefix, as tests/test_arch_smoke.py
    draws them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    batch["labels"][:, :3] = -100
    if cfg.family == "whisper":
        batch["frames"] = rng.standard_normal(
            (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_patch_tokens, cfg.d_model)).astype(np.float32)
    return batch


def spec_json(spec) -> list:
    """A partition spec (JAX's or the port's) as JSON: one entry per dim,
    None, an axis name or a list of axis names."""
    if spec is None:
        return None
    return [list(p) if isinstance(p, tuple) else p for p in spec]


def _specs() -> dict:
    import dataclasses

    import jax

    from repro.configs import SHAPES, cell_is_applicable, get_config
    from repro.launch.mesh import (cache_specs, input_specs,
                                   make_production_mesh)
    from repro.models import build_model
    from repro.train.step import batch_spec, param_pspec

    def sds(tree):
        return {k: [list(v.shape), str(v.dtype),
                    spec_json(v.sharding.spec if v.sharding else None)]
                for k, v in tree.items()}

    out = {"shapes": [dataclasses.asdict(c) for c in SHAPES], "params": {},
           "leaf_shapes": {}, "inputs": {}, "caches": {},
           "batch_spec": {str(multi): spec_json(batch_spec(
               make_production_mesh(multi_pod=multi)))
               for multi in (False, True)}}
    for arch in GSPMD_ARCHS:
        cfg = get_config(arch)
        shapes = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
        leaves = _flat_shapes(shapes)
        out["leaf_shapes"][arch] = {k: [list(v.shape), str(v.dtype)]
                                    for k, v in leaves.items()}
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            for fsdp in (True, False):
                c = cfg.replace(fsdp=fsdp)
                out["params"][f"{arch}|{multi}|{fsdp}"] = {
                    k: spec_json(param_pspec(k, v, c, mesh))
                    for k, v in leaves.items()}
            for shape in SHAPES:
                if not cell_is_applicable(arch, shape)[0]:
                    continue
                key = f"{arch}|{shape.name}|{multi}"
                out["inputs"][key] = sds(input_specs(arch, shape, mesh))
                if shape.kind == "decode":
                    out["caches"][key] = sds(cache_specs(
                        cfg, mesh, shape.global_batch, shape.seq_len))
    return out


def _flat_shapes(tree) -> dict:
    import jax
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def gspmd_step(out_path: str) -> None:
    import json

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_config
    from repro.models import build_model
    from repro.optim import AdamWConfig
    from repro.optim.schedules import constant
    from repro.train import init_train_state, make_gspmd_train_step
    assert jax.device_count() == MESH_DEVICES, jax.device_count()
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    opt = AdamWConfig(weight_decay=0.01)

    def run(item):
        case, (arch, nmb, remat) = item
        cfg = get_config(arch, smoke=True)
        if remat:
            cfg = cfg.replace(remat=remat)
        model = build_model(cfg)
        state = init_train_state(model, opt, seed=0)
        out = flat_numpy(state.params, f"{case}/init/")
        step = jax.jit(make_gspmd_train_step(model, mesh, opt,
                                             constant(GSPMD_LR),
                                             num_microbatches=nmb))
        state, m = step(state, jax.tree.map(jnp.asarray, gspmd_batch(cfg)))
        out.update(flat_numpy(state.params, f"{case}/params/"))
        out.update(flat_numpy(state.opt_state["mu"], f"{case}/mu/"))
        for k in ("loss", "grad_norm", "lr"):
            out[f"{case}/{k}"] = np.asarray(m[k])
        return out

    res = {}
    # the cases' compiles overlap on threads (each is its own program)
    with ThreadPoolExecutor(4) as pool:
        for out in pool.map(run, GSPMD_CASES.items()):
            res.update(out)
    res["specs"] = np.asarray(json.dumps(_specs()))
    np.savez(out_path, **res)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["collectives", "train_step", "elastic",
                                     "gspmd_step"])
    ap.add_argument("out")
    ap.add_argument("--arch", default=TRAIN_ARCH,
                    choices=["qwen3-1.7b", "gemma3-27b", "internlm2-1.8b",
                             "minicpm-2b", "qwen2-vl-2b", "hymba-1.5b",
                             "phi3.5-moe-42b-a6.6b", "arctic-480b",
                             "rwkv6-7b"],
                    help="train_step's config (its smoke variant)")
    args = ap.parse_args()
    n_dev = MESH_DEVICES if args.what == "gspmd_step" else P
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={n_dev} "
        + os.environ.get("XLA_FLAGS", ""))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if args.what == "train_step":
        train_step(args.out, args.arch)
    else:
        {"collectives": collectives, "elastic": elastic,
         "gspmd_step": gspmd_step}[args.what](args.out)
