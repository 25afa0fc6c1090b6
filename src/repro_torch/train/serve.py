"""Serving: prefill + greedy decode (the port of `repro/train/serve.py`'s
`make_serve_step`, `pad_cache_to` and `generate`)."""
from __future__ import annotations

import time
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import synchronize
from repro_torch.models.api import Model

FULL_SEQ_CACHE_KEYS = ("k_glob", "v_glob")


def make_serve_step(model: Model):
    """Returns step(params, cache, token (B,1), pos) -> (next_token (B,1)
    int64, cache)."""
    def step(params, cache, token, pos):
        logits, cache = model.decode_step(params, cache, token, pos)
        return logits.argmax(-1)[:, None], cache
    return step


def pad_cache_to(cache: dict, target_len: int, keys=None) -> dict:
    """Grow the *full-sequence* caches (length S on axis 2 of a 5-D tensor)
    to a decode budget with zeros. Only the named keys are padded (default
    k_glob / v_glob): rings (hymba, gemma3's local layers), recurrent
    states (rwkv, mamba) and cross-attention caches must not grow.
    Whisper's self cache lives under "k" / "v": pass those."""
    out = dict(cache)
    for key in FULL_SEQ_CACHE_KEYS if keys is None else keys:
        x = out.get(key)
        if x is not None and x.dim() == 5 and x.shape[2] < target_len:
            out[key] = F.pad(x, (0, 0, 0, 0, 0, target_len - x.shape[2]))
    return out


@torch.no_grad()
def generate(model: Model, params: dict, prompt: torch.Tensor, max_new: int,
             batch_extras: Optional[dict] = None,
             log: Optional[dict] = None) -> torch.Tensor:
    """Greedy generation: prefill the prompt (with `batch_extras` in the
    prefill's batch: whisper's frames), then max_new - 1 decode steps.
    Returns (B, max_new) int64 tokens: the prefill's argmax first.

    If `log` is a dict, it gets the wall seconds of the prefill
    (`prefill_seconds`) and of the decode loop (`decode_seconds`), the
    device synchronized at each boundary, and whether every logit of the
    run was finite (`logits_finite`, read once at the end)."""
    B, S = prompt.shape
    dev = prompt.device
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompt,
                                           **(batch_extras or {})})
    finite = torch.isfinite(logits).all()
    pad_keys = ("k", "v") if model.cfg.family == "whisper" else None
    cache = pad_cache_to(cache, S + max_new, keys=pad_keys)
    tok = logits.argmax(-1)[:, None]
    if log is not None:
        synchronize(dev)
        log["prefill_seconds"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    out = [tok]
    for pos in range(S, S + max_new - 1):
        logits, cache = model.decode_step(params, cache, tok, pos)
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    tokens = torch.cat(out, dim=1)
    if log is not None:
        synchronize(dev)
        log["decode_seconds"] = time.perf_counter() - t1
        log["logits_finite"] = bool(finite)
    return tokens
