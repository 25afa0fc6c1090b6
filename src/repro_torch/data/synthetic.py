"""Deterministic synthetic LM data pipeline.

A copy of `repro/data/synthetic.py` (numpy only): the same seed gives the
same batches, byte for byte, in both packages.

Generates a reproducible token stream with learnable structure (a mixture
of n-gram-ish patterns) so that short training runs show decreasing loss.
Host-sharded: each data-parallel host slice draws only its own shard of
the global batch (shard_id / num_shards), deterministically from
(seed, step), so restarts resume exactly and elastic reshards stay
deterministic.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    pattern_order: int = 3      # learnable markov-ish order


class SyntheticLM:
    def __init__(self, cfg: DataConfig, shard_id: int = 0,
                 num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError("global_batch must divide by num_shards")
        self.cfg = cfg
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        # A fixed random transition table gives the stream structure a
        # model can learn (deterministic in the seed).
        rng = np.random.default_rng(cfg.seed)
        self._table = rng.integers(
            0, cfg.vocab_size,
            size=(min(cfg.vocab_size, 4096), 8)).astype(np.int32)

    def batch(self, step: int) -> dict:
        """Returns {tokens (B_local, S), labels} for this shard at `step`."""
        cfg = self.cfg
        out = np.empty((self.local_batch, cfg.seq_len + 1), np.int32)
        for i in range(self.local_batch):
            gidx = self.shard_id * self.local_batch + i
            rng = np.random.default_rng(
                (cfg.seed * 1_000_003 + step) * 65_521 + gidx)
            seq = np.empty(cfg.seq_len + 1, np.int32)
            seq[0] = rng.integers(0, cfg.vocab_size)
            noise = rng.random(cfg.seq_len)
            jumps = rng.integers(0, cfg.vocab_size, cfg.seq_len)
            for t in range(1, cfg.seq_len + 1):
                prev = seq[t - 1] % self._table.shape[0]
                choice = self._table[prev, t % 8]
                seq[t] = choice if noise[t - 1] < 0.8 else jumps[t - 1]
            out[i] = seq
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}
