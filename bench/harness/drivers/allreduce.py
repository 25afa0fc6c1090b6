"""AllReduce traffic: the program's gradient sync called back to back on
the members' seeded gradient leaf lists, each call ended on the device
before the next (the paper's completion time).

Each call is timed on the device's clock by a CUDA event before it and
one after its last operation; the window's host seconds over its calls
give the mean. A sample of the window's answers, drawn from the seed, and
its last answer are kept and compared, once the window has closed, with
the exact sum of the members' leaves (`reference.allreduce`).
"""
from __future__ import annotations

import random
import time

import torch

from bench.harness import inputs, yardstick
from bench.reference import allreduce as ref_allreduce
from bench.reference import decoder


def run(spec, seed: int, seconds: float, trace: bool, device, say,
        t_start: float) -> dict:
    from repro_torch.comms import LocalTransport, optcc_allreduce_tree
    from repro_torch.comms import psum_tree

    cfg, tr = spec.config, spec.traffic
    dp = tr["dp"]
    layout = decoder.param_layout(cfg)
    flat, members = inputs.member_grads(layout, seed, dp, tr["grad_dtype"],
                                        tr["grad_scale"], device)
    n = flat.shape[1]
    transport = LocalTransport(dp)
    if tr["fault"]:
        straggler = tr["fault"]["straggler"]

        def call():
            return optcc_allreduce_tree(iter(members), straggler, transport)
    else:
        def call():
            return psum_tree(iter(members), transport)

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    # set-up: two calls warm the kernel and the allocator; the second's
    # link counts are one call's
    out = call()
    transport.reset_counts()
    out = call()
    sync()
    links = transport.link_elems
    say({"link_elems_over_n": {
        "straggler": (tr["fault"] or {}).get("straggler"),
        "per_member": [(int(links[m].sum()) + int(links[:, m].sum())) / n
                       for m in range(dp)]}})
    del out
    setup_s = time.perf_counter() - t_start

    rng = random.Random(inputs.sub_seed(seed, "sample"))
    sample = set(rng.sample(range(tr["sample_among"]), tr["sample_calls"]))
    kept, marks = {}, []
    calls = 0
    t0 = time.perf_counter()
    while True:
        if cuda:
            begin, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            begin.record()
            out = call()
            end.record()
            end.synchronize()
            marks.append((begin, end))
        else:
            t = time.perf_counter()
            out = call()
            marks.append(time.perf_counter() - t)
        if calls in sample:
            kept[calls] = out
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    kept[calls - 1] = out
    del out
    call_ms = ([b.elapsed_time(e) for b, e in marks] if cuda
               else [s * 1e3 for s in marks])
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ranked = sorted(call_ms)
    say({"call_ms": {"calls": calls, "min": ranked[0],
                     "median": ranked[len(ranked) // 2], "max": ranked[-1],
                     "first": call_ms[:3], "last": call_ms[-3:]}})

    traced = None
    if trace:
        from bench.harness.trace import capture

        def units():
            for _ in range(tr["traced_calls"]):
                call()
                sync()
        traced = capture(units, torch)

    # the reference, once the window has closed
    worst = 0.0
    for answer in kept.values():
        for k, leaf in enumerate(answer):
            worst = max(worst, ref_allreduce.max_err_ulp(
                leaf.reshape(-1), [m[k].reshape(-1) for m in members]))
    groups = {tr["grad_dtype"]: n}
    return {"setup_s": setup_s, "window_s": window_s, "units": calls,
            "failed": 0, "unit_ms": call_ms, "peak": peak, "trace": traced,
            "traced_units": tr["traced_calls"],
            "values": {"max_err_ulp": worst},
            "least_bytes": yardstick.reduction_least_bytes(groups, dp)}


def calibration(spec, seed: int, device, sides, ref=None):
    """("control", readings): the members' sum accumulated in bf16
    (`reference.allreduce.sum_bf16`) in the program's place. The faults
    are planted in the program by the CPU tests."""
    if "control" not in sides:
        return
    tr = spec.traffic
    layout = decoder.param_layout(spec.config)
    _, members = inputs.member_grads(layout, seed, tr["dp"],
                                     tr["grad_dtype"], tr["grad_scale"],
                                     device)
    worst = 0.0
    for k in range(len(layout)):
        flat = [m[k].reshape(-1) for m in members]
        worst = max(worst, ref_allreduce.max_err_ulp(
            ref_allreduce.sum_bf16(flat), flat))
    yield "control", {"max_err_ulp": worst}
