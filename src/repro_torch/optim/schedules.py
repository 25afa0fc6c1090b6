"""LR schedules (the port of `repro/optim/schedules.py`): step -> fp32
0-dim tensor, computed in fp32 as the JAX versions are."""
from __future__ import annotations

import torch


def warmup_stable_decay(peak_lr: float, warmup: int, stable: int,
                        decay: int, final_frac: float = 0.1):
    """MiniCPM's WSD: linear warmup, long stable plateau, short decay."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        w = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        in_decay = step > (warmup + stable)
        t = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
        decayed = peak_lr * (final_frac ** t)
        return torch.where(in_decay, decayed, w)
    return lr


def constant(lr_value: float):
    def lr(step):
        return torch.full((), lr_value, dtype=torch.float32)
    return lr
