"""How far a smoke config's fp32 gradients sit from a float64 run: the
yardstick for the card-vs-CPU and port-vs-JAX gradient limits of the
tests and of chip_smoke.py.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/fp32_conditioning.py \
        --arch whisper-base                      # the tests' batch, --jax
    PYTHONPATH=src python tools/fp32_conditioning.py --arch whisper-base \
        --chip-batch                             # chip_smoke's loss run
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/fp32_conditioning.py \
        --arch whisper-base --gspmd-batch --jax  # the GSPMD step test's
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/fp32_conditioning.py \
        --arch hymba-1.5b --dp OUT.npz           # three DP steps' grad norms
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/fp32_conditioning.py \
        --arch arctic-480b --dp OUT.npz --perturb   # the run from a nudged init

Runs the port's loss and gradients on the CPU twice, in fp32 and in
float64 (the config's dtypes float64, and every `.float()` cast in the
port's code widened to `.double()` for that run only), and prints, worst
first, each leaf's norm-wise gap ||g - g64|| / ||g64|| of the fp32 run and,
with --jax, of JAX's fp32 gradients from the same parameters.

The tests' batch (default): JAX's init at seed 0, 2 x 24 tokens from numpy
seed 1 with next-token labels and row 0's first 3 masked, whisper's frames
from a generator of their own at seed 1
(tests/test_torch_{hymba,whisper}.py). --chip-batch: chip_smoke.py's
`_loss_run`, the port's init at seed 8 and numpy seed 8, labels equal to
the tokens. --gspmd-batch: JAX's init at seed 0 and
tests/jax_reference.py's `gspmd_batch` (8 x 24 tokens, every row's first 3
labels masked; tests/test_torch_gspmd.py). --dp OUT.npz: the port's DP step
(4 members, healthy) from the initial parameters of a
`tests/jax_reference.py train_step OUT.npz --arch ARCH` run, three steps in
fp32 and in float64 (chunk_reduce's plain version summing in float64 too),
the grad norms of both and of JAX's run, and each leaf's final parameters
of the port's and JAX's fp32 runs against float64; with --perturb instead,
the port's fp32 run against itself from an init nudged by about one fp32
rounding (x (1 + 1e-7 N(0,1))), and JAX's against it. CPU only.
"""
from __future__ import annotations

import argparse
import contextlib
import pathlib
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model


@contextlib.contextmanager
def float64_casts():
    """`.float()` returns float64, and chunk_reduce's plain version sums
    in float64, while open."""
    from repro_torch.kernels.chunk_reduce import ref
    orig_float, orig_reduce = torch.Tensor.float, ref.chunk_reduce_ref

    def reduce64(parts, out_dtype=None):
        acc = parts[0].double().clone()
        for row in parts[1:]:
            acc.add_(row)
        return acc.to(out_dtype or parts.dtype)

    torch.Tensor.float = lambda self: self.double()
    ref.chunk_reduce_ref = reduce64
    try:
        yield
    finally:
        torch.Tensor.float = orig_float
        ref.chunk_reduce_ref = orig_reduce


def _cfg(arch: str, dtype: torch.dtype):
    name = str(dtype).removeprefix("torch.")
    return get_config(arch, smoke=True).replace(param_dtype=name,
                                                compute_dtype=name)


def _batch(cfg, chip: bool, gspmd: bool = False) -> dict:
    if gspmd:
        sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                               / "tests"))
        from jax_reference import gspmd_batch
        return gspmd_batch(cfg)
    rng = np.random.default_rng(8 if chip else 1)
    if chip:
        toks = rng.integers(0, cfg.vocab_size, (2, 24))
        batch = {"tokens": toks, "labels": toks.copy()}
    else:
        toks = rng.integers(0, cfg.vocab_size, (2, 25))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        batch["labels"][0, :3] = -100
    if cfg.family == "whisper":
        # chip_smoke draws the frames after the tokens, the tests from a
        # generator of their own
        frng = rng if chip else np.random.default_rng(1)
        batch["frames"] = frng.standard_normal(
            (2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return batch


def _grads(arch: str, init: dict, batch: dict, dtype) -> dict:
    model = build_model(_cfg(arch, dtype))
    params = {k: v.detach().clone().to(dtype).requires_grad_(True)
              for k, v in init.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tb.update(tokens=tb["tokens"].long(), labels=tb["labels"].long())
    if "frames" in tb:
        tb["frames"] = tb["frames"].to(dtype)
    loss = model.loss(params, tb)
    return {k: g.double().numpy() for k, g in
            zip(params, torch.autograd.grad(loss, list(params.values())))}


def _jax_init_and_grads(arch: str, batch: dict):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model

    from repro_torch.convert import params_from_numpy
    jmodel = jax_build_model(jax_get_config(arch, smoke=True))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    grads = jax.jit(jax.grad(jmodel.loss))(
        jparams, jax.tree.map(jnp.asarray, batch))
    flat = {}
    for tree, out in ((jparams, "params"), (grads, "grads")):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(p, "key", p)) for p in path)
            flat.setdefault(out, {})[key] = np.asarray(leaf)
    return params_from_numpy(flat["params"], "cpu"), flat["grads"]


def gradients(arch: str, chip: bool, with_jax: bool,
              gspmd: bool = False) -> None:
    cfg = get_config(arch, smoke=True)
    batch = _batch(cfg, chip, gspmd)
    jgrads = None
    if chip:
        init = build_model(cfg).init(8, "cpu")
    elif with_jax:
        init, jgrads = _jax_init_and_grads(arch, batch)
    else:
        raise SystemExit("the tests' batch takes JAX's init: pass --jax")
    g32 = _grads(arch, init, batch, torch.float32)
    with float64_casts():
        g64 = _grads(arch, init, batch, torch.float64)
    rows = []
    for k, ref in g64.items():
        norm = np.linalg.norm(ref)
        rows.append((np.linalg.norm(g32[k] - ref) / norm,
                     np.linalg.norm(jgrads[k] - ref) / norm
                     if jgrads else float("nan"), k))
    which = "chip_smoke loss run" if chip else "GSPMD step test" if gspmd \
        else "tests"
    print(f"{cfg.name} ({which} batch): ||g - g64|| / ||g64|| per leaf, "
          "worst port first")
    print(f"{'port fp32':>12} {'JAX fp32':>12}  leaf")
    for port, jax_gap, k in sorted(rows, reverse=True):
        print(f"{port:12.3e} {jax_gap:12.3e}  {k}")


def dp_steps(arch: str, npz: str) -> None:
    import sys
    sys.path.insert(0, "tests")
    import jax_reference as drv
    from test_torch_train_step import port_run

    from repro_torch.comms.fault import FaultState
    import test_torch_train_step
    res = dict(np.load(npz))
    _, norms32, params32 = port_run(res, FaultState(drv.P), arch)
    res64 = {k: v.astype(np.float64) if k.startswith("init/") else v
             for k, v in res.items()}
    orig = test_torch_train_step.get_config
    test_torch_train_step.get_config = lambda a, smoke=False: _cfg(
        a, torch.float64)
    try:
        with float64_casts():
            _, ref, params64 = port_run(res64, FaultState(drv.P), arch)
    finally:
        test_torch_train_step.get_config = orig
    print(f"{arch} DP step, healthy: grad norm per step")
    print("float64 ", ref)
    for name, got in (("port fp32", norms32),
                      ("JAX fp32", res["healthy/grad_norm"])):
        print(f"{name:9s}", np.asarray(got), "rel to float64",
              np.asarray(got) / ref - 1)
    print("final parameters against float64, per leaf, worst port first: "
          "max |p - p64| and the share of elements past 1e-4")
    print(f"{'port max':>10} {'share':>9} {'JAX max':>10} {'share':>9}  leaf")
    rows = []
    for k, want in params64.items():
        gaps = [np.abs(np.asarray(p, np.float64) - want) for p in
                (params32[k], res[f"healthy/params/{k}"])]
        rows.append(tuple(x for g in gaps for x in (g.max(),
                                                     (g > 1e-4).mean()))
                    + (k,))
    for row in sorted(rows, key=lambda r: -r[1]):
        print("{:10.2e} {:9.2e} {:10.2e} {:9.2e}  {}".format(*row))


def perturbed(arch: str, npz: str) -> None:
    """The port's fp32 DP run (healthy, three steps) against itself from
    initial parameters times (1 + 1e-7 N(0, 1)), about one fp32 rounding:
    how far fp32 rounding alone can carry the run."""
    import sys
    sys.path.insert(0, "tests")
    import jax_reference as drv
    from test_torch_train_step import port_run

    from repro_torch.comms.fault import FaultState
    res = dict(np.load(npz))
    rng = np.random.default_rng(0)
    nudged = {k: (v * (1 + 1e-7 * rng.standard_normal(v.shape)))
              .astype(v.dtype) if k.startswith("init/") else v
              for k, v in res.items()}
    runs = [port_run(r, FaultState(drv.P), arch) for r in (res, nudged)]
    (l0, g0, p0), (l1, g1, p1) = runs
    print(f"{arch} DP step, healthy: fp32 run from init x (1 + 1e-7 "
          "N(0,1)) against the same run from init")
    print("loss rel per step     ", l1 / l0 - 1)
    print("grad norm rel per step", g1 / g0 - 1)
    for name, params in (("nudged port", p1), ("JAX", None)):
        gaps = {k: np.abs((params[k] if params else
                           res[f"healthy/params/{k}"]) - v)
                for k, v in p0.items()}
        k = max(gaps, key=lambda k: (gaps[k] > 1e-4).mean())
        print(f"final params, {name} vs port: max "
              f"{max(g.max() for g in gaps.values()):.3e}, worst share "
              f"past 1e-4 {(gaps[k] > 1e-4).mean():.3e} ({k})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--chip-batch", action="store_true")
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--gspmd-batch", action="store_true")
    ap.add_argument("--dp", default=None, metavar="OUT.npz")
    ap.add_argument("--perturb", action="store_true",
                    help="with --dp: the fp32 run against itself from a "
                         "nudged init")
    args = ap.parse_args(argv)
    if args.dp and args.perturb:
        perturbed(args.arch, args.dp)
    elif args.dp:
        dp_steps(args.arch, args.dp)
    else:
        gradients(args.arch, args.chip_batch, args.jax, args.gspmd_batch)


if __name__ == "__main__":
    main()
