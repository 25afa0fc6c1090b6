"""End-to-end training launcher with fault tolerance (the port of
`repro/launch/train.py`).

Runs data-parallel training with deterministic failure injection (NIC
degradation events): on each event the OptCC planner produces the new
collective plan and the train step is re-built, mirroring NCCL
communicator re-init, and the degraded mode syncs gradients with
optcc_allreduce instead of psum - the paper's straggler mitigation.

The DP members are `--dp` rows of one tensor on one device (the
single-process transport), standing in for JAX's forced device count.
Runs on CUDA unless `--device cpu` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --smoke --steps 200 --fail-at 60 --repair-at 120 --device cpu

Checkpointing (--ckpt-dir, --lose-node-at) comes with a later slice.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.comms import LocalTransport
from repro_torch.comms.fault import FailureInjector, FaultState
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels.chunk_reduce import kernel as chunk_reduce_kernel
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.optim.schedules import warmup_stable_decay
from repro_torch.train import init_train_state, make_dp_failover_step


def main(argv=None):
    """Returns (state, log): the final TrainState and one dict per step
    (loss, grad_norm, sync kind, the planner's algo, the step's wall
    seconds and those of its grad/sync/update phases, chunk_reduce kernel
    launches)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject NIC degradation at this step")
    ap.add_argument("--repair-at", type=int, default=None)
    ap.add_argument("--ell", type=float, default=1.5,
                    help="slowdown factor of the injected degradation")
    ap.add_argument("--straggler", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--lose-node-at", type=int, default=None,
                    help="elastic rescale (not yet ported)")
    ap.add_argument("--dp", type=int, default=4,
                    help="DP members of the single-process transport")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ckpt_dir is not None or args.lose_node_at is not None:
        raise NotImplementedError(
            "--ckpt-dir and --lose-node-at are not yet ported: "
            "checkpointing comes with a later slice")

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    dp = args.dp
    transport = LocalTransport(dp)
    opt = AdamWConfig(weight_decay=0.01)
    lr_fn = warmup_stable_decay(args.lr, warmup=20,
                                stable=max(args.steps - 60, 10), decay=40)

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq_len,
                                  global_batch=args.global_batch))
    injector = None
    if args.fail_at is not None:
        if dp < 3:
            print(f"NOTE: only {dp} DP member(s) - OptCC needs a DP ring "
                  "of >= 3; failure injection disabled. Run with --dp 4 "
                  "to see the failover path.")
        else:
            injector = FailureInjector.nic_loss(
                dp, args.fail_at, args.straggler % dp, args.ell,
                repair_step=args.repair_at)

    fault = FaultState(axis_size=dp)
    step_fn = make_dp_failover_step(model, transport, opt, lr_fn, fault)
    state = init_train_state(model, opt, device=device)
    n_grad = model.param_count(state.params)
    plan = fault.plan(n_grad)
    log = []

    t0 = time.time()
    for step in range(args.steps):
        if injector is not None:
            new_fault = injector.at_step(step, fault)
            if new_fault != fault:
                fault = new_fault
                plan = fault.plan(n_grad)
                if fault.degraded:
                    print(f"step {step}: DEGRADED (straggler="
                          f"{fault.straggler}, l={fault.ell}); planner "
                          f"chose {plan.algo}, predicted overhead "
                          f"{plan.predicted_overhead:.3f}x, plan built in "
                          f"{plan.gen_seconds * 1e3:.2f} ms")
                else:
                    print(f"step {step}: REPAIRED; back to native psum")
                step_fn = make_dp_failover_step(model, transport, opt,
                                                lr_fn, fault)
        batch = {k: torch.as_tensor(v, dtype=torch.int64).to(device)
                 for k, v in data.batch(step).items()}
        before = dict(chunk_reduce_kernel.launches)
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch)
        synchronize(device)
        step_seconds = time.perf_counter() - t_step
        rec = {"step": step, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "sync": "optcc" if fault.degraded else "psum",
               "algo": plan.algo, "step_seconds": step_seconds,
               **{k: metrics[k] for k in ("grad_seconds", "sync_seconds",
                                          "update_seconds")},
               "launches": {k: v - before[k] for k, v in
                            chunk_reduce_kernel.launches.items()}}
        log.append(rec)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {rec['loss']:.4f} "
                  f"gnorm {rec['grad_norm']:.3f} "
                  f"({(time.time() - t0):.1f}s) [{rec['sync']}, sync "
                  f"{rec['sync_seconds'] * 1e3:.1f} ms]", flush=True)
    print("done")
    return state, log


if __name__ == "__main__":
    main()
