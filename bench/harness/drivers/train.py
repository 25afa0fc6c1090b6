"""Training traffic: the program's data-parallel failover step, driven from
the seed.

Set-up builds one step object with its model, transport and optimizer
state, and drives it through the checked steps, which warm every shape
the window uses; the same object then runs the window. After the window
the program's state is freed and the plain reference follows the
checked steps from the same seeded weights and batches.

Compared (`checks.train_values`): each checked step's loss; the first
step's gradient as the optimizer got it, per leaf, worked out from its
first moment (mu / (1 - b1), undone from clipping by the reported
pre-clip norm), by its norm and along seeded directions
(`reference.probe`); and each leaf's change over the checked steps.
"""
from __future__ import annotations

import gc
import math
import time

import torch

from bench.harness import checks, inputs, yardstick
from bench.reference import decoder, probe
from bench.reference import train as ref_train

FAULTS = ("half_batch", "no_exchange", "altered")


def port_config(cfg: dict):
    """The program's configuration named in the file's `port`, checked
    against the file's sizes."""
    from repro_torch.configs import get_config
    port = get_config(cfg["port"]["arch"]).replace(**cfg["port"]["set"])
    w = decoder.widths(cfg)
    want = {"d_model": w["d"], "n_layers": w["L"], "n_heads": w["H"],
            "n_kv_heads": w["KV"], "hd": w["hd"], "d_ff": w["f"],
            "vocab_size": w["V"], "n_experts": w["E"],
            "rope_theta": cfg["rope_theta"], "norm_eps": cfg["rms_norm_eps"],
            "param_dtype": cfg["param_dtype"],
            "compute_dtype": cfg["compute_dtype"],
            "tie_embeddings": cfg["tie_word_embeddings"]}
    if w["E"]:
        want.update(top_k=w["k"], capacity_factor=cfg["capacity_factor"])
    got = {k: getattr(port, k) for k in want}
    if got != want:
        raise ValueError(f"the program's {cfg['port']} differs from the "
                         f"configuration file: {got} != {want}")
    return port


def _leaf_norms(tensors: dict, scale: float = 1.0) -> dict:
    return {k: torch.linalg.vector_norm(v, dtype=torch.float64).item()
            * scale for k, v in tensors.items()}


def _change_norms(after: dict, before: dict) -> dict:
    return {k: torch.linalg.vector_norm(after[k].float() - before[k].float(),
                                        dtype=torch.float64).item()
            for k in after}


def run(spec, seed: int, seconds: float, trace: bool, device, say,
        t_start: float) -> dict:
    from repro_torch.comms import LocalTransport
    from repro_torch.comms.fault import FaultState
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.optim.schedules import constant
    from repro_torch.train import make_dp_failover_step
    from repro_torch.train.state import TrainState

    cfg, tr = spec.config, spec.traffic
    dp, rows, seq = tr["dp"], tr["global_batch"], tr["seq_len"]
    layout = decoder.param_layout(cfg)
    adamw = tr["adamw"]
    opt = AdamWConfig(**adamw, moment_dtype=cfg["moment_dtype"])
    model = build_model(port_config(cfg))
    params = inputs.params(layout, seed, device)
    state = TrainState(params, init_state(params, opt), 0)
    fault = FaultState(dp, **tr["fault"]) if tr["fault"] else FaultState(dp)
    step = make_dp_failover_step(model, LocalTransport(dp), opt,
                                 constant(tr["lr"]), fault)
    pool = inputs.token_batches(seed, tr["batch_pool"], rows, seq,
                                decoder.widths(cfg)["V"], device)

    def batch(i):
        t = pool[i % len(pool)]
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    # set-up: the checked steps, which also warm up every shape
    prog = {"loss": []}
    n_checked = tr["checked_steps"]
    for i in range(n_checked):
        state, m = step(state, batch(i))
        prog["loss"].append(float(m["loss"]))
        if i == 0:
            unclip = max(1.0, float(m["grad_norm"]) / adamw["clip_norm"])
            mu, scale = state.opt_state["mu"], unclip / (1 - adamw["b1"])
            prog["first_grad"] = _leaf_norms(mu, scale)
            prog["first_proj"] = probe.project(mu, seed, scale)
            del mu
    prog["change"] = _change_norms(state.params,
                                   inputs.params(layout, seed, device))
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    # the window: steps back to back until `seconds` have passed
    records, failed, i = [], 0, n_checked
    t0 = time.perf_counter()
    while True:
        state, m = step(state, batch(i))
        i += 1
        failed += not math.isfinite(float(m["loss"]))
        records.append({k: float(m[k]) for k in
                        ("grad_seconds", "sync_seconds", "update_seconds")})
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    say({"step_s": [sum(r.values()) for r in records]})

    traced = None
    if trace:
        from bench.harness.trace import capture

        def units():
            nonlocal state, i
            for _ in range(tr["traced_steps"]):
                state, _ = step(state, batch(i))
                i += 1
        traced = capture(units, torch)

    # the reference, once the program's state is freed
    del state, step, params, model, m
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref, stats = reference(cfg, tr, seed, device)
    if stats:
        say({"moe_routing": stats})
    worst = {}
    values = checks.train_values(prog, ref, worst)
    say({"worst_leaf": worst})
    groups = {}
    for shape, dt, _ in layout.values():
        groups[dt] = groups.get(dt, 0) + torch.Size(shape).numel()
    groups["float32"] = groups.get("float32", 0) + 1      # the loss's psum
    return {"setup_s": setup_s, "window_s": window_s, "units": len(records),
            "failed": failed, "unit_tokens": rows * seq,
            "records": records, "peak": peak, "trace": traced,
            "traced_units": tr["traced_steps"], "values": values,
            "reference": ref,
            "least_bytes": yardstick.reduction_least_bytes(groups, dp),
            "flops_per_token": yardstick.train_flops_per_token(cfg, seq)}


def reference(cfg: dict, tr: dict, seed: int, device, control=None,
              fault=None) -> tuple[dict, dict]:
    """The plain reference's readings over the checked steps from the
    seed: the losses, the first gradient's norm and projections per leaf
    and each leaf's change; and, for an MoE configuration, the first
    step's routing counts. `control` and `fault` as in
    `reference.train.train_steps`."""
    layout = decoder.param_layout(cfg)
    pool = inputs.token_batches(seed, tr["batch_pool"], tr["global_batch"],
                                tr["seq_len"], decoder.widths(cfg)["V"],
                                device)
    batches = [(t[:, :-1], t[:, 1:]) for t in pool[:tr["checked_steps"]]]
    params = inputs.params(layout, seed, device)
    stats = {} if decoder.widths(cfg)["E"] else None
    out = ref_train.train_steps(cfg, params, batches, dp=tr["dp"],
                                lr=tr["lr"], adamw=tr["adamw"],
                                control=control, fault=fault, stats=stats,
                                probe=lambda g: probe.project(g, seed))
    out["change"] = _change_norms(params,
                                  inputs.params(layout, seed, device))
    return out, stats


def calibration(spec, seed: int, device, sides, ref=None):
    """(side, readings) of each control (`reference.train.CONTROLS`) and
    each planted fault of `FAULTS`, the plain reference put in the program's
    place, against the reference itself (`ref`, else worked out here)."""
    if ref is None:
        ref, _ = reference(spec.config, spec.traffic, seed, device)
    others = {}
    if "control" in sides:
        others.update(control={"control": "fp8"},
                      control_fp8_operands={"control": "fp8_operands"})
    if "faults" in sides:
        others.update({f: {"fault": f} for f in FAULTS})
    for side, kw in others.items():
        other, _ = reference(spec.config, spec.traffic, seed, device, **kw)
        yield side, checks.train_values(other, ref)
