"""The fault-tolerant data-parallel train step (the port of
`repro/train/step.py::make_dp_failover_step`).

The DP members live in one process on one device (`LocalTransport`):
member i takes rows [i b, (i+1) b) of the global batch, as P("data") gives
them in JAX, and its gradients come from `torch.autograd.grad` on its own
loss. They are synchronized by the collective the live `FaultState`
selects - psum when healthy, `optcc_allreduce_tree` when degraded, even
where the planner's plan says ring, as in the JAX step - then divided by
dp; the reported loss is the member mean. AdamW is applied once, in place,
to the replicated parameters.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.comms import (LocalTransport, optcc_allreduce_tree, psum,
                               psum_tree)
from repro_torch.comms.fault import FaultState
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.api import Model
from repro_torch.optim import AdamWConfig, init_state, update
from repro_torch.train.state import TrainState


def make_dp_failover_step(model: Model, transport: LocalTransport,
                          opt_cfg: AdamWConfig, lr_fn: Callable,
                          fault: FaultState):
    """Returns step(state, batch) -> (state, metrics) for dp =
    transport.p members. Re-call this factory whenever `fault` changes -
    the NCCL-reinit analogue.

    metrics: loss and grad_norm (0-dim tensors) and the wall time of the
    step's three phases, the device synchronized at each boundary:
    grad_seconds (every member's forward/backward and the packing of its
    gradients), sync_seconds (from the last member's packed gradients to
    the synced ones) and update_seconds (AdamW).
    """
    dp = transport.p

    def step(state: TrainState, batch: dict):
        params = state.params
        names = list(params)
        leaves = [params[k].requires_grad_(True) for k in names]
        rows = batch["tokens"].shape[0]
        if rows % dp:
            raise ValueError(f"global batch {rows} does not split over "
                             f"dp={dp} members")
        b = rows // dp
        device = leaves[0].device
        t_start = time.perf_counter()
        losses, sync_start = [], []

        def member_grads():
            # consumed one member at a time by the collective's packing, so
            # only one member's gradients are alive at once
            for i in range(dp):
                shard = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                loss = model.loss(params, shard)
                grads = torch.autograd.grad(loss, leaves)
                losses.append(loss.detach())
                yield grads
            synchronize(device)
            sync_start.append(time.perf_counter())

        if fault.degraded:
            synced = optcc_allreduce_tree(member_grads(), fault.straggler,
                                          transport)
        else:
            synced = psum_tree(member_grads(), transport)
        grads = {k: g.div_(dp) for k, g in zip(names, synced)}
        synchronize(device)
        t_update = time.perf_counter()
        loss = psum(torch.stack(losses)[:, None])[0] / dp
        lr = lr_fn(state.step)
        _, opt_state, gnorm = update(params, grads, state.opt_state, lr,
                                     opt_cfg)
        synchronize(device)
        return (TrainState(params, opt_state, state.step + 1),
                {"loss": loss, "grad_norm": gnorm,
                 "grad_seconds": sync_start[0] - t_start,
                 "sync_seconds": t_update - sync_start[0],
                 "update_seconds": time.perf_counter() - t_update})

    return step


def init_train_state(model: Model, opt_cfg: AdamWConfig, seed: int = 0,
                     device: str | torch.device = "cuda") -> TrainState:
    params = model.init(seed, resolve_device(device))
    return TrainState(params, init_state(params, opt_cfg), 0)
