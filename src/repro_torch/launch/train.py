"""End-to-end training launcher with fault tolerance (the port of
`repro/launch/train.py`).

Runs data-parallel training with:
  * checkpoint/restart in the JAX package's format (atomic, auto-resume
    from the latest step, a save every --ckpt-every steps),
  * deterministic failure injection (NIC degradation events): on each
    event the OptCC planner produces the new collective plan and the train
    step is re-built, mirroring NCCL communicator re-init, and the degraded
    mode syncs gradients with optcc_allreduce instead of psum - the paper's
    straggler mitigation,
  * elastic rescale (--lose-node-at): checkpoint, halve the DP members,
    rebuild the step, restore, continue.

As in the JAX launcher, the injector's fault state is not checkpointed: a
run resumed inside a degraded window syncs with psum until the next event.

The DP members are `--dp` rows of one tensor on one device (`--transport
local`, the default: the single-process transport), standing in for JAX's
forced device count, or `--dp` processes over torch.distributed (`--transport
gloo`: one member each, all on `--device`, gradients moved by gloo through
pinned host buffers on a card). Every rank follows the same injected
events, so all re-plan at the same step; rank 0 prints the log and writes
the checkpoints (the parameters are replicated; the format is unchanged).
Elastic rescale (`--lose-node-at`) needs the local transport.
Runs on CUDA unless `--device cpu` is given. qwen3-1.7b, internlm2-1.8b and
hymba-1.5b (bf16 leaves beside fp32 ones: the healthy sync sums each dtype
in its own buffer) train at full width on one card, and so does
phi3.5-moe at one layer (`--set n_layers=1`: its fp32 router beside bf16
experts, 1.56e9 params; at 2 layers the DP-4 train state does not fit);
qwen2-vl-2b trains on text batches (no patch prefix, as the JAX
launcher); rwkv6-7b and arctic-480b train at their smoke configs through
the same launcher (rwkv6's recurrence through JAX's training scan).
`--set key=value` overrides a config field as the JAX dry run's `--set`
does (repeatable; an unknown field raises). whisper-base does not
train here: its loss needs frames and the batches are tokens only, as in
the JAX launcher. gemma3-27b and minicpm-2b train only at
their smoke configs (`--smoke`): gemma3's full-width train state (bf16
params, fp32 moments, ~270 GB) does not fit one card, and neither does
minicpm-2b's at DP 4 (2.72e9 params, ~78 GiB by scaling qwen3-1.7b's
49.29 GiB peak with the parameter count).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --smoke --steps 200 --fail-at 60 --repair-at 120 --device cpu \
      --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-27b \
      --smoke --steps 6 --fail-at 2 --repair-at 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --smoke --steps 6 --fail-at 2 --repair-at 4 --device cpu
  (likewise --arch minicpm-2b, qwen2-vl-2b, hymba-1.5b, rwkv6-7b,
  arctic-480b or phi3.5-moe-42b-a6.6b; on the card --arch
  phi3.5-moe-42b-a6.6b --set n_layers=1)
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --transport gloo --dp 4 --steps 6 --fail-at 2 --repair-at 4
"""
from __future__ import annotations

import argparse
import os
import pathlib
import sys
import tempfile
import time

import torch

from repro_torch import _build
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.comms import LocalTransport, ProcessTransport, dist
from repro_torch.comms.fault import FailureInjector, FaultState
from repro_torch.configs import get_config, parse_overrides
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels.chunk_reduce import kernel as chunk_reduce_kernel
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.optim.schedules import warmup_stable_decay
from repro_torch.train import init_train_state, make_dp_failover_step
from repro_torch.train.state import TrainState


def _saved(ckpt_dir, step: int, state, device) -> dict:
    """Save `state` as checkpoint `step`; returns the save's record."""
    synchronize(device)
    t = time.perf_counter()
    save(ckpt_dir, step, state)
    seconds = time.perf_counter() - t
    return {"op": "save", "step": step, "seconds": seconds,
            "bytes": _npz_bytes(ckpt_dir, step)}


def _restored(ckpt_dir, state, device, step=None):
    """Restore checkpoint `step` (default: the latest) into `state`;
    returns (state, its step, the restore's record)."""
    t = time.perf_counter()
    state, meta = restore(ckpt_dir, state, step)
    synchronize(device)
    seconds = time.perf_counter() - t
    step = int(meta["step"])
    return state, step, {"op": "restore", "step": step, "seconds": seconds,
                         "bytes": _npz_bytes(ckpt_dir, step)}


def _npz_bytes(ckpt_dir, step: int) -> int:
    return (pathlib.Path(ckpt_dir) / f"step_{step}" / "arrays.npz") \
        .stat().st_size


def _parse(argv):
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
                    help="simulate losing half the DP members at this "
                         "step: checkpoint, rebuild the step on the "
                         "survivors, restore, continue (elastic rescale)")
    ap.add_argument("--dp", type=int, default=4, help="DP members")
    ap.add_argument("--transport", choices=("local", "gloo"),
                    default="local",
                    help="local: every member in this process; gloo: one "
                         "process per member over torch.distributed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="config override, as the JAX dry run's --set "
                         "(e.g. n_layers=2 to cut depth); repeatable")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns (state, log): the final TrainState and one dict per step
    (loss, grad_norm, sync kind, the planner's algo, DP members, the step's
    wall seconds and those of its grad/sync/update phases, chunk_reduce
    kernel launches, and `checkpoint`: the restores, saves and rescale made
    at this step, each with its checkpoint step, seconds and bytes). With
    `--transport gloo` the state is rank 0's final parameters (its
    optimizer state is not brought back: `opt_state` is None), the log rank
    0's, its launches summed over the ranks and each step's `peak_gib`
    the ranks' peak device memory (empty on the CPU)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    if args.transport == "local":
        return _train(args, LocalTransport(args.dp),
                      resolve_device(args.device))
    if args.lose_node_at is not None:
        raise ValueError("--lose-node-at needs --transport local: elastic "
                         "rescale across processes is not implemented")
    device = resolve_device(args.device)
    if device.type == "cuda":
        _build.build_all(["chunk_reduce"])     # once, before the ranks load it
    with tempfile.TemporaryDirectory(prefix="repro_train_") as out_dir:
        logs = dist.spawn(_rank_main, args.dp, (argv, out_dir))
        final = torch.load(os.path.join(out_dir, "final.pt"),
                           weights_only=False)
    log = logs[0]["log"]
    for rec, *others in zip(log, *(r["log"] for r in logs[1:])):
        rec["launches"] = {k: v + sum(o["launches"][k] for o in others)
                           for k, v in rec["launches"].items()}
    peak = [r["peak_gib"] for r in logs if r["peak_gib"] is not None]
    for rec in log:
        rec["peak_gib"] = peak
    params = {k: v.to(device) for k, v in final["params"].items()}
    return TrainState(params, None, final["step"]), log


def _rank_main(rank: int, argv, out_dir: str) -> dict:
    """One rank of a `--transport gloo` run (a `dist.spawn` target): the
    training loop on its ProcessTransport; rank 0 saves its final
    parameters into `out_dir`. Returns its log and peak device memory."""
    args = _parse(argv)
    device = dist.rank_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    transport = ProcessTransport()
    state, log = _train(args, transport, device, lead=rank == 0)
    if rank == 0:
        torch.save({"params": {k: v.detach().cpu() for k, v in
                               state.params.items()}, "step": state.step},
                   os.path.join(out_dir, "final.pt"))
    return {"log": log, "peak_gib": torch.cuda.max_memory_allocated(device)
            / 2 ** 30 if device.type == "cuda" else None}


def _train(args, transport, device, lead: bool = True):
    """The training loop on `transport`'s members; `lead` prints the log
    and writes the checkpoints."""
    say = print if lead else (lambda *a, **k: None)
    overrides = parse_overrides(args.set)
    cfg = get_config(args.arch, smoke=args.smoke).replace(**overrides)
    if overrides:
        say(f"config overrides: {overrides}", flush=True)
    model = build_model(cfg)
    dp = args.dp
    opt = AdamWConfig(weight_decay=0.01)
    lr_fn = warmup_stable_decay(args.lr, warmup=20,
                                stable=max(args.steps - 60, 10), decay=40)

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq_len,
                                  global_batch=args.global_batch))
    injector = None
    if args.fail_at is not None:
        if dp < 3:
            say(f"NOTE: only {dp} DP member(s) - OptCC needs a DP ring "
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
    events = []          # the checkpoint work done at the coming step
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, start, rec = _restored(args.ckpt_dir, state, device)
        events.append(rec)
        say(f"resumed from checkpoint at step {start} ({rec['bytes']} "
            f"bytes in {rec['seconds']:.2f} s)")

    t0 = time.time()
    for step in range(start, args.steps):
        if args.lose_node_at is not None and step == args.lose_node_at \
                and dp > 1:
            # Elastic rescale: half the DP members "fail". Checkpoint,
            # rebuild the transport and step on the survivors, restore,
            # continue. (Batches stay the same: the pipeline is keyed on
            # (seed, step), not on the members.)
            t_rescale = time.perf_counter()
            ckpt = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                                 "repro_elastic_ckpt")
            events.append(_saved(ckpt, step, state, device))
            dp = max(dp // 2, 1)
            transport = LocalTransport(dp)
            fault = FaultState(axis_size=dp)
            injector = None   # the old ring is gone
            step_fn = make_dp_failover_step(model, transport, opt, lr_fn,
                                            fault)
            state, _, rec = _restored(ckpt, state, device, step)
            events.append(rec)
            plan = fault.plan(n_grad)
            seconds = time.perf_counter() - t_rescale
            events.append({"op": "rescale", "step": step, "dp": dp,
                           "seconds": seconds})
            say(f"step {step}: NODE LOSS - resumed on {dp} DP members "
                f"(elastic reshard from checkpoint, {seconds:.2f} s)")
        if injector is not None:
            new_fault = injector.at_step(step, fault)
            if new_fault != fault:
                fault = new_fault
                plan = fault.plan(n_grad)
                if fault.degraded:
                    say(f"step {step}: DEGRADED (straggler="
                        f"{fault.straggler}, l={fault.ell}); planner "
                        f"chose {plan.algo}, predicted overhead "
                        f"{plan.predicted_overhead:.3f}x, plan built in "
                        f"{plan.gen_seconds * 1e3:.2f} ms")
                else:
                    say(f"step {step}: REPAIRED; back to native psum")
                step_fn = make_dp_failover_step(model, transport, opt,
                                                lr_fn, fault)
        batch = {k: torch.as_tensor(v, dtype=torch.int64).to(device)
                 for k, v in data.batch(step).items()}
        before = dict(chunk_reduce_kernel.launches)
        transport.reset_counts()    # link counts and hop records of a step
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch)
        synchronize(device)
        step_seconds = time.perf_counter() - t_step
        rec = {"step": step, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "sync": "optcc" if fault.degraded else "psum",
               "algo": plan.algo, "dp": dp, "step_seconds": step_seconds,
               **{k: metrics[k] for k in ("grad_seconds", "sync_seconds",
                                          "update_seconds")},
               "launches": {k: v - before[k] for k, v in
                            chunk_reduce_kernel.launches.items()},
               "checkpoint": events}
        events = []
        log.append(rec)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {rec['loss']:.4f} "
                f"gnorm {rec['grad_norm']:.3f} "
                f"({(time.time() - t0):.1f}s) [{rec['sync']}, sync "
                f"{rec['sync_seconds'] * 1e3:.1f} ms]", flush=True)
        if lead and args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            rec["checkpoint"].append(_saved(args.ckpt_dir, step + 1, state,
                                            device))
    say("done")
    return state, log


if __name__ == "__main__":
    main()
