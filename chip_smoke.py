#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (nvcc into
`build/`), then runs five phases, each printing one JSON line:

  1. kernels  - chunk_reduce's W-way and in-place pair forms against their
                plain PyTorch versions on the card;
  2. collectives - psum, ring_allreduce and optcc_allreduce at p=4 against
                x.sum(0), and the straggler's link count (Lemma 5);
  3. main path - `repro_torch.launch.train.main` on qwen3-1.7b at full width
                through healthy -> degraded -> repaired steps, with the
                kernels' launch counts read around that run;
  4. reference - the same DP step on the smoke config, on the card and on
                the CPU from the same parameters, healthy and degraded;
  5. timing   - each kernel at the main path's shapes (CUDA events) beside
                its memory-bound time, its plain version and one PyTorch
                library call that computes the same function.

Then it prints the card's name and power limit (nvidia-smi), a `kernels`
JSON line, and, as the last line, {"ok": true, "device": {...}}. Any failed
check raises: the script exits nonzero and prints no result. It needs a
CUDA card and the rest of the repository; it imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS = 67e12                 # H100 SXM fp32 outside the tensor cores
FP32_TOL = 1e-6                    # |kernel - plain| <= 1e-6 * (1 + |plain|)
# a p-term fp32 sum in another association differs by at most
# 2 (p-1) 2^-24 sum|x_i| (3.6e-7 sum|x_i| at p=4); the limit is 1e-6 sum|x_i|
COLLECTIVE_TOL = 1e-6
SOURCE = "src/repro_torch/kernels/chunk_reduce/csrc/chunk_reduce.cu"
REPLACES = "src/repro/kernels/chunk_reduce/kernel.py:34"
MAIN_ARGV = ["--arch", "qwen3-1.7b", "--dp", "4", "--seq-len", "128",
             "--global-batch", "8", "--steps", "6", "--fail-at", "2",
             "--repair-at", "4", "--straggler", "1", "--log-every", "1"]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t = time.perf_counter()
    logs = _build.build_all()
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "ptxas": ptxas})

    errs = {"chunk_reduce": 0.0, "chunk_reduce_pairs": 0.0}
    phase_kernels(torch, dev, errs)
    phase_collectives(torch, dev)
    n_grad, launches = phase_main_path(torch, dev)
    phase_reference(torch, dev)
    timings = phase_timing(torch, dev, n_grad, errs)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kernels = []
    for name in ("chunk_reduce", "chunk_reduce_pairs"):
        require(launches[name] > 0, f"{name} never launched on the main path")
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES, "launches": launches[name],
                        "max_abs_err": errs[name], **timings[name]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# ----------------------------------------------------------------------------
# checks
# ----------------------------------------------------------------------------

def _ulp_bf16(torch, x):
    """One bf16 unit in the last place of each |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _compare(torch, got, want, what: str) -> float:
    """Max |got - want|; raises past the limit of want's dtype: 1e-6 (times
    1 + |want|) for fp32, one bf16 ulp for bf16 (both sides accumulate in
    fp32, so only the final rounding may differ). Works in slices of 2^26
    elements to bound the temporaries at the main path's sizes."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    err = 0.0
    step = 1 << 26
    for g, w in zip(got.reshape(-1).split(step), want.reshape(-1).split(step)):
        g, w = g.float(), w.float()
        require(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
        diff = (g - w).abs()
        if want.dtype == torch.bfloat16:
            bad = diff > _ulp_bf16(torch, w)
        else:
            bad = diff > FP32_TOL * (1.0 + w.abs())
        err = max(err, float(diff.max()))
        require(not bool(bad.any()), f"{what}: max abs err {err} past the "
                "limit")
    return err


def phase_kernels(torch, dev, errs) -> None:
    from repro_torch.kernels.chunk_reduce import ops, ref
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for out_dtype in (torch.float32, torch.bfloat16):
            for W in (1, 2, 4, 7, 16):
                for N in (128, 1000, 5001, 2 ** 24 + 3):
                    parts = torch.randn((W, N), generator=gen, device=dev,
                                        dtype=torch.float32).to(dtype)
                    got = ops.chunk_reduce(parts, out_dtype)
                    want = ref.chunk_reduce_ref(parts, out_dtype)
                    torch.cuda.synchronize()
                    errs["chunk_reduce"] = max(errs["chunk_reduce"], _compare(
                        torch, got, want, f"W-way {dtype}->{out_dtype} "
                        f"W={W} N={N}"))
                    cases += 1
        # pair form: the three moves of one reduce-scatter hop at p=4
        # (rows member*3 + chunk), plus a fold of a whole member row
        for C in (128, 1000, 5001, 2 ** 22 + 1):
            for dst, src in (([5, 9, 1], [4, 8, 0]), ([3, 4, 5], [0, 1, 2])):
                buf = torch.randn((12, C), generator=gen, device=dev,
                                  dtype=torch.float32).to(dtype)
                want = buf.clone()
                ref.chunk_reduce_pairs_ref_(want, dst, src)
                ops.chunk_reduce_pairs_(buf, dst, src)
                torch.cuda.synchronize()
                errs["chunk_reduce_pairs"] = max(
                    errs["chunk_reduce_pairs"],
                    _compare(torch, buf, want, f"pairs {dtype} C={C}"))
                cases += 1
    emit({"phase": "kernels", "cases": cases, "max_abs_err": dict(errs)})


def phase_collectives(torch, dev) -> None:
    from repro_torch.comms import (LocalTransport, optcc_allreduce, psum,
                                   ring_allreduce)
    p = 4
    tr = LocalTransport(p)
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for n in (1000, 1001, 2 ** 20 + 1):
        x = torch.randn((p, n), generator=gen, device=dev)
        out[f"psum n={n}"] = _close(torch, psum(x), x)
        if n % p == 0:
            out[f"ring n={n}"] = _close(torch, ring_allreduce(x, tr), x)
        for s in (0, 1, 3):
            tr.reset_counts()
            got = optcc_allreduce(x, s, tr)
            out[f"optcc s={s} n={n}"] = _close(torch, got, x)
            npad = n + (-n) % (p - 1)
            require(tr.link_load(s) == 2 * npad,
                    f"straggler {s} link carried {tr.link_load(s)} elements, "
                    f"not 2 x {npad}")
    emit({"phase": "collectives", "p": p, "max_abs_err": out,
          "straggler_link": "2 x padded length"})


def _close(torch, got, x) -> float:
    """Max |got - x.sum(0)| over every member's row; raises past
    COLLECTIVE_TOL * sum|x_i| (+ the same absolute floor)."""
    diff = (got - x.sum(0)).abs()
    bad = diff > COLLECTIVE_TOL * (1.0 + x.abs().sum(0))
    err = float(diff.max())
    require(not bool(bad.any()), f"collective off by up to {err}")
    return err


def phase_main_path(torch, dev):
    from repro_torch.kernels.chunk_reduce import kernel as ck
    from repro_torch.launch.train import main as train_main
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    t = time.perf_counter()
    state, log = train_main(MAIN_ARGV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = dict(ck.launches)
    n_grad = sum(v.numel() for v in state.params.values())
    depth = state.params["blocks/wq"].shape[0]
    for rec in log:
        emit({"phase": "main_step", **rec})
        require(math.isfinite(rec["loss"]), f"step {rec['step']}: loss "
                f"{rec['loss']}")
        require(math.isfinite(rec["grad_norm"]), f"step {rec['step']}: "
                f"grad norm {rec['grad_norm']}")
    healthy = [r for r in log if r["sync"] == "psum"]
    degraded = [r for r in log if r["sync"] == "optcc"]
    require(healthy and degraded, "the run did not see both sync kinds")
    require(all(r["launches"]["chunk_reduce"] > 0 for r in healthy),
            "a healthy step did not launch chunk_reduce")
    require(all(r["launches"]["chunk_reduce_pairs"] > 0 for r in degraded),
            "a degraded step did not launch chunk_reduce_pairs")
    emit({"phase": "main_path", "argv": MAIN_ARGV, "n_layers": depth,
          "params": n_grad, "seconds": seconds, "launches": launches,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    del state
    torch.cuda.empty_cache()
    return n_grad, launches


def phase_reference(torch, dev) -> None:
    """Smoke config, same parameters on the card and on the CPU: the card's
    degraded (OptCC) run equals its healthy (psum) run, as on 8 JAX devices
    in tests/multidev_driver.py, and the CPU's plain-PyTorch run."""
    from repro_torch.comms import LocalTransport
    from repro_torch.comms.fault import FaultState
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.optim.schedules import constant
    from repro_torch.train import TrainState, make_dp_failover_step

    cfg = get_config("qwen3-1.7b", smoke=True)
    model = build_model(cfg)
    opt = AdamWConfig(weight_decay=0.0)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=8))
    init = model.init(7, "cpu")
    runs = {}
    for name, device, fault in (
            ("cuda_healthy", dev, FaultState(4)),
            ("cuda_degraded", dev, FaultState(4, straggler=1, ell=1.5)),
            ("cpu_degraded", torch.device("cpu"),
             FaultState(4, straggler=1, ell=1.5))):
        params = {k: v.detach().clone().to(device) for k, v in init.items()}
        state = TrainState(params, init_state(params, opt), 0)
        step = make_dp_failover_step(model, LocalTransport(4), opt,
                                     constant(1e-3), fault)
        losses = []
        for i in range(3):
            batch = {k: torch.as_tensor(v, dtype=torch.int64).to(device)
                     for k, v in data.batch(i).items()}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        runs[name] = (losses, {k: v.detach().cpu() for k, v in
                               state.params.items()})

    def gap(a, b):
        dl = max(abs(x - y) / abs(y) for x, y in zip(runs[a][0], runs[b][0]))
        dp = max(float((runs[a][1][k] - runs[b][1][k]).abs().max())
                 for k in runs[a][1])
        return dl, dp

    hd = gap("cuda_degraded", "cuda_healthy")
    cd = gap("cuda_degraded", "cpu_degraded")
    # healthy vs degraded on one card: the limits of the JAX multidev check;
    # card vs CPU: rel 1e-5 loss, abs 1e-4 params (AdamW divides by sqrt(nu)
    # per element, so a float-order difference in a near-zero gradient grows
    # into an update difference of up to lr)
    require(hd[0] < 1e-5 and hd[1] < 1e-5, f"healthy vs degraded: {hd}")
    require(cd[0] < 1e-5 and cd[1] < 1e-4, f"card vs CPU: {cd}")
    emit({"phase": "reference", "config": cfg.name,
          "losses": {k: v[0] for k, v in runs.items()},
          "healthy_vs_degraded": {"loss_rel": hd[0], "params_abs": hd[1]},
          "card_vs_cpu": {"loss_rel": cd[0], "params_abs": cd[1]}})


# ----------------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------------

def _cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(bytes_moved: int, flops: int) -> dict:
    """Least time for the work: the larger of its bytes (each input read
    once, each output written once) at the memory rate and its fp32 adds
    at the fp32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_timing(torch, dev, n_grad: int, errs) -> dict:
    """Both forms at the main path's shapes: the healthy step's W=4 psum of
    the bf16 gradient vector, and one degraded reduce-scatter hop (three
    fp32 chunk pairs of the padded vector, p=4, straggler 1)."""
    from repro_torch.kernels.chunk_reduce import ops, ref
    p, ph = 4, 3
    out = {}
    gen = torch.Generator(device=dev).manual_seed(2)

    parts = torch.randn((p, n_grad), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    got = ops.chunk_reduce(parts)
    errs["chunk_reduce"] = max(errs["chunk_reduce"], _compare(
        torch, got, ref.chunk_reduce_ref(parts), f"W-way at main shape"))
    del got
    out["chunk_reduce"] = {
        "ms": _cuda_ms(torch, lambda: ops.chunk_reduce(parts), 10),
        "plain_ms": _cuda_ms(torch, lambda: ref.chunk_reduce_ref(parts), 5),
        **_bound((p + 1) * n_grad * parts.element_size(), (p - 1) * n_grad),
        "library_ms": _cuda_ms(torch, lambda: parts.sum(0), 10),
        "shape": [p, n_grad], "dtype": "bfloat16"}
    del parts
    torch.cuda.empty_cache()

    npad = n_grad + (-n_grad) % ph
    c = npad // ph
    buf = torch.randn((p * ph, c), generator=gen, device=dev)
    ring = [0, 2, 3]          # healthy members with straggler 1
    dst = [ring[(i + 1) % ph] * ph + i for i in range(ph)]
    src = [ring[i] * ph + i for i in range(ph)]
    want = torch.stack([buf[d] + buf[s] for d, s in zip(dst, src)])
    ops.chunk_reduce_pairs_(buf, dst, src)
    errs["chunk_reduce_pairs"] = max(errs["chunk_reduce_pairs"], _compare(
        torch, buf[dst], want, "pairs at main shape"))
    del want
    torch.cuda.empty_cache()

    def library():
        for d, s in zip(dst, src):
            buf[d].add_(buf[s])

    out["chunk_reduce_pairs"] = {
        "ms": _cuda_ms(torch, lambda: ops.chunk_reduce_pairs_(buf, dst, src),
                       10),
        "plain_ms": _cuda_ms(
            torch, lambda: ref.chunk_reduce_pairs_ref_(buf, dst, src), 5),
        **_bound(3 * ph * c * buf.element_size(), ph * c),
        "library_ms": _cuda_ms(torch, library, 10),
        "shape": [p * ph, c], "pairs": ph, "dtype": "float32"}
    del buf
    torch.cuda.empty_cache()
    emit({"phase": "timing", **out})
    return {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")} for k, v in out.items()}


if __name__ == "__main__":
    sys.exit(main())
