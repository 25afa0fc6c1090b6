"""Train-step factories (the port of `repro/train/step.py`).

`make_gspmd_train_step` is the JAX package's plain training step: the
loss and its gradients on the whole batch, or summed over microbatches
into an fp32 accumulator, then AdamW. In JAX it runs under jit over a
(pod, data, model) mesh with the parameters placed by `param_pspec`; the
port runs it on one device and has the rules as data (`batch_spec`,
`param_pspec`, `shardings_for_params`, over a `repro_torch.sharding.Mesh`
description), held to JAX's leaf by leaf. A mesh of more than one device
raises: running the sharded program is not ported.

`make_dp_failover_step` is the fault-tolerant data-parallel step.

The DP members live on a transport: all of them in one process on one
device (`LocalTransport`), or one per process (`ProcessTransport`). Member
i takes rows [i b, (i+1) b) of the global batch, as P("data") gives them
in JAX, and its gradients come from `torch.autograd.grad` on its own loss;
a process computes the gradients of the members it holds. They are
synchronized by the collective the live `FaultState` selects - psum when
healthy, `optcc_allreduce_tree` when degraded, even where the planner's
plan says ring, as in the JAX step - then divided by dp; the reported loss
is the member mean, through psum on the transport. AdamW is applied once,
in place, to the replicated parameters (by every process to its replica).
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.comms import optcc_allreduce_tree, psum, psum_tree
from repro_torch.comms.fault import FaultState
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.api import Model
from repro_torch.optim import AdamWConfig, init_state, update
from repro_torch.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro_torch.train.state import TrainState


# ----------------------------------------------------------------------------
# the GSPMD path: sharding rules and the single-device step
# ----------------------------------------------------------------------------

def batch_spec(mesh: Mesh) -> P:
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return P(axes if len(axes) > 1 else axes[0])


def param_pspec(path: str, leaf, cfg, mesh: Mesh) -> P:
    """Sharding rule for one parameter leaf (reads only leaf.shape).

    TP: last (output-features) dim over 'model' for up-projections,
    first over 'model' for down-projections; embeddings/vocab over
    'model'. Experts over 'model' when the config has >= 64 of them,
    else their FFN hidden dim. FSDP: additionally shard the largest
    remaining dim (>= 1024) over 'data' when cfg.fsdp, embedding-like
    tables excepted.
    """
    shape = leaf.shape
    name = path.split("/")[-1]
    ndim = len(shape)
    spec: list = [None] * ndim
    model_dim = None
    if name in ("embed", "lm_head", "pos_embed"):
        # (V, d) / (d, V): shard vocab over model
        model_dim = 0 if name == "embed" else ndim - 1
    elif name in ("wq", "wk", "wv", "w_gate", "w_up", "xq", "xk", "xv",
                  "m_in", "m_xbc", "ck", "cr", "wr", "wg",
                  "e_gate", "e_up", "d_gate", "d_up"):
        model_dim = ndim - 1          # output features
    elif name in ("wo", "w_down", "xo", "m_out", "cv", "e_down", "d_down"):
        model_dim = ndim - 2 if ndim >= 2 else None  # input features
    if name in ("e_gate", "e_up", "e_down"):
        n_exp = getattr(cfg, "n_experts", 0) if cfg is not None else 0
        if n_exp >= 64:
            # expert parallelism: experts over model (arctic: 128)
            spec[1 if ndim == 4 else 0] = "model"
            model_dim = None
        else:
            # TP inside the experts: their FFN hidden dim over model, so
            # the dispatch stays device-local (phi3.5-moe: 16)
            model_dim = ndim - 1 if name in ("e_gate", "e_up") \
                else ndim - 2
    if model_dim is not None and shape[model_dim] % mesh.shape["model"] == 0:
        spec[model_dim] = "model"
    # FSDP (ZeRO-3 style): shard the largest remaining dim over data; not
    # the embedding-like tables, whose vocab dim is already over model
    if cfg is not None and getattr(cfg, "fsdp", False) \
            and name not in ("embed", "lm_head", "pos_embed"):
        free = [i for i in range(ndim) if spec[i] is None]
        if free:
            i = max(free, key=lambda i: shape[i])
            if shape[i] % mesh.shape["data"] == 0 and shape[i] >= 1024:
                spec[i] = "data"
    return P(*spec)


def shardings_for_params(params: dict, cfg, mesh: Mesh) -> dict:
    """{path: NamedSharding} for a parameter dict (or any {path: leaf with
    a shape}, such as `sharding.eval_shape(model.init, ...)`'s)."""
    return {k: NamedSharding(mesh, param_pspec(k, v, cfg, mesh))
            for k, v in params.items()}


def make_gspmd_train_step(model: Model, mesh: Mesh, opt_cfg: AdamWConfig,
                          lr_fn: Callable, num_microbatches: int = 1):
    """Returns step(state, batch) -> (state, metrics) on a one-device mesh.

    With num_microbatches > 1 the batch is cut into that many consecutive
    row blocks (JAX's reshape to (nmb, B / nmb, ...)); each block's
    gradients are added in order into fp32 zeros, and the sums and the
    loss are divided by nmb, as JAX's lax.scan does. Then AdamW, in place:
    the state passed in is updated, as JAX's donated buffers are.

    metrics: loss, grad_norm and lr (0-dim tensors), and the wall time of
    the gradient phase and of AdamW (grad_seconds, update_seconds), the
    device synchronized at each boundary.
    """
    if mesh.size > 1:
        raise NotImplementedError(
            f"a mesh of {mesh.size} devices {mesh.shape}: the port runs "
            "the GSPMD step on one device; running it sharded across "
            "ranks is queued in ROADMAP.md (the GSPMD path)")
    nmb = num_microbatches
    if nmb < 1:
        raise ValueError(f"num_microbatches={nmb}")

    def step(state: TrainState, batch: dict):
        params = state.params
        names = list(params)
        leaves = [params[k].requires_grad_(True) for k in names]
        device = leaves[0].device
        t_start = time.perf_counter()
        if nmb > 1:
            rows = batch["tokens"].shape[0]
            if rows % nmb:
                raise ValueError(f"batch of {rows} rows does not split "
                                 f"into {nmb} microbatches")
            b = rows // nmb
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=device)
                   for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(nmb):
                mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                mb_loss = model.loss(params, mb)
                for a, g in zip(acc, torch.autograd.grad(mb_loss, leaves)):
                    a.add_(g)
                loss = loss + mb_loss.detach()
            grads = {k: a.div_(nmb) for k, a in zip(names, acc)}
            loss = loss / nmb
        else:
            loss = model.loss(params, batch)
            grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
            loss = loss.detach()
        synchronize(device)
        t_update = time.perf_counter()
        lr = lr_fn(state.step)
        _, opt_state, gnorm = update(params, grads, state.opt_state, lr,
                                     opt_cfg)
        synchronize(device)
        return (TrainState(params, opt_state, state.step + 1),
                {"loss": loss, "grad_norm": gnorm, "lr": lr,
                 "grad_seconds": t_update - t_start,
                 "update_seconds": time.perf_counter() - t_update})

    return step


# ----------------------------------------------------------------------------
# the fault-tolerant pure-DP path (explicit sync on a transport)
# ----------------------------------------------------------------------------


def make_dp_failover_step(model: Model, transport, opt_cfg: AdamWConfig,
                          lr_fn: Callable, fault: FaultState,
                          compression: bool = False):
    """Returns step(state, batch) -> (state, metrics) for dp =
    transport.p members, of which this process computes
    `transport.members`. Re-call this factory whenever `fault` changes -
    the NCCL-reinit analogue. `compression` is accepted and not read, as
    in the JAX step.

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
            for i in transport.members:
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
        loss = psum(torch.stack(losses)[:, None], transport)[0] / dp
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
