"""Production meshes and input specs (the port of `repro/launch/mesh.py`).

`make_production_mesh` describes the JAX dry run's meshes, (16, 16)
("data", "model") and (2, 16, 16) ("pod", "data", "model"), as axis
names and sizes (`repro_torch.sharding.Mesh`, no devices). The spec
functions give, for a model's inputs and its decode cache, the shape,
the torch dtype and the partition spec of each, by JAX's rules: batch
over pod x data when it divides, else over data, else replicated; a cache
leaf's batch dim, else its sequence dim, over pod x data, and its KV
heads, else its sequence dim, over model.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs import ShapeCell, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import (Mesh, NamedSharding, PartitionSpec as P,
                                  ShapeDtypeStruct, eval_shape, make_mesh)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def batch_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _sds(shape, dtype, mesh, spec) -> ShapeDtypeStruct:
    return ShapeDtypeStruct(tuple(shape), dtype, NamedSharding(mesh, spec))


def _bspec(mesh: Mesh, B: int, extra_dims: int = 1) -> P:
    """Shard the leading batch dim over pod x data when divisible."""
    ba = batch_axes(mesh)
    n = math.prod(mesh.shape[a] for a in ba)
    if B % n == 0:
        return P(ba if len(ba) > 1 else ba[0], *([None] * extra_dims))
    if B % mesh.shape["data"] == 0:
        return P("data", *([None] * extra_dims))
    return P(*([None] * (extra_dims + 1)))


def token_positions_spec(cfg: ModelConfig, mesh: Mesh, B: int, S: int
                         ) -> dict:
    """Specs of the token inputs of one train batch."""
    bspec = _bspec(mesh, B, 1)
    batch = {
        "tokens": _sds((B, S), torch.int32, mesh, bspec),
        "labels": _sds((B, S), torch.int32, mesh, bspec),
    }
    if cfg.family == "whisper":
        batch["frames"] = _sds((B, cfg.n_audio_frames, cfg.d_model),
                               torch.bfloat16, mesh, _bspec(mesh, B, 2))
    if cfg.family == "vlm":
        batch["prefix_embeds"] = _sds(
            (B, cfg.n_patch_tokens, cfg.d_model), torch.bfloat16, mesh,
            _bspec(mesh, B, 2))
    return batch


def input_specs(arch: str, shape: ShapeCell, mesh: Mesh,
                cfg: ModelConfig | None = None) -> dict:
    """Specs of every model input of a cell.

    train:   {tokens, labels, extras}  (vlm text tokens shrink by the
             patch prefix so that the whole context is shape.seq_len)
    prefill: {tokens, extras}
    decode:  {tokens (B, 1), pos scalar}  (the cache's specs come from
             cache_specs)
    """
    cfg = cfg or get_config(arch)
    B, S = shape.global_batch, shape.seq_len
    S_text = S - cfg.n_patch_tokens if cfg.family == "vlm" else S
    if shape.kind == "train":
        return token_positions_spec(cfg, mesh, B, S_text)
    if shape.kind == "prefill":
        batch = token_positions_spec(cfg, mesh, B, S_text)
        batch.pop("labels")
        return batch
    return {
        "tokens": _sds((B, 1), torch.int32, mesh, _bspec(mesh, B, 1)),
        "pos": ShapeDtypeStruct((), torch.int32),
    }


def cache_specs(cfg: ModelConfig, mesh: Mesh, B: int, S: int) -> dict:
    """Specs of the decode cache of B rows of S positions, every family's
    leaves in their (L, B, S-or-window, ...) layout. The cache's shapes
    come from `init_cache` on fake tensors: a decode_32k cache is
    hundreds of GB."""
    from repro_torch.models import build_model
    model = build_model(cfg)
    template = eval_shape(lambda: model.init_cache(B, S, "cpu"))
    ba = batch_axes(mesh)
    nb = math.prod(mesh.shape[a] for a in ba)
    m = mesh.shape["model"]

    def spec_for(leaf):
        shp = tuple(leaf.shape)
        spec = [None] * len(shp)
        if len(shp) >= 3:
            if shp[1] % nb == 0 and shp[1] > 1:
                spec[1] = ba if len(ba) > 1 else ba[0]
            elif shp[2] % nb == 0 and shp[2] >= nb:
                spec[2] = ba if len(ba) > 1 else ba[0]
            # model axis: KV heads (dim 3) else seq (dim 2)
            if len(shp) >= 5 and shp[3] % m == 0 and shp[3] >= m:
                spec[3] = "model"
            elif spec[2] is None and shp[2] % m == 0 and shp[2] >= m:
                spec[2] = "model"
            elif len(shp) == 3 and shp[2] % m == 0:   # rwkv tshift (L,B,d)
                spec[2] = "model"
        return _sds(shp, leaf.dtype, mesh, P(*spec))

    return {k: spec_for(v) for k, v in template.items()}
