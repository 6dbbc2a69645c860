"""Deterministic, sharded, resumable synthetic-token data pipeline.

The port's own copy of ``repro.data.pipeline`` (numpy only, line for
line, so batches equal the reference's bit for bit).  Production shape
without external deps: an index-based sampler over a synthetic corpus
(seeded Zipf-ish token model), sharded by (host, data rank), with O(1)
checkpointable state (step counter + seed) so training resumes
bit-exactly after restart or elastic resharding.  Batches are numpy
``int32`` arrays; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    num_codebooks: int = 0      # audio archs
    zipf_a: float = 1.2


@dataclasses.dataclass
class DataState:
    """Checkpointable pipeline state."""
    step: int = 0

    def as_dict(self):
        return {"step": self.step}

    @staticmethod
    def from_dict(d):
        return DataState(step=int(d["step"]))


class TokenPipeline:
    """Per-host view of the global batch.

    ``batch_at(step)`` is a pure function of (config, step, shard), which
    makes resume and elastic re-sharding trivial: a host picks up any
    shard at any step and produces exactly the tokens every other host
    would have produced for that shard.
    """

    def __init__(self, cfg: DataConfig, *, shard: int = 0, num_shards: int = 1):
        if num_shards > cfg.global_batch:
            raise ValueError("more shards than global batch rows")
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.state = DataState()
        # Zipf-ish unigram distribution, fixed by seed.
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks ** cfg.zipf_a
        self._probs = probs / probs.sum()
        self._perm = rng.permutation(cfg.vocab_size)

    def _sample(self, rng, shape):
        flat = rng.choice(self.cfg.vocab_size, size=int(np.prod(shape)),
                          p=self._probs)
        return self._perm[flat].reshape(shape).astype(np.int32)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        # uneven layouts (elastic host loss): first `rem` shards carry one
        # extra row, so the global batch is preserved exactly
        base, rem = divmod(cfg.global_batch, self.num_shards)
        per_shard = base + (1 if self.shard < rem else 0)
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + self.shard)
        if cfg.num_codebooks > 1:
            toks = self._sample(rng, (per_shard, cfg.seq_len,
                                      cfg.num_codebooks))
        else:
            toks = self._sample(rng, (per_shard, cfg.seq_len))
        return {"tokens": toks}

    def __next__(self) -> dict:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b

    def __iter__(self):
        return self

    # -- checkpoint/resume -----------------------------------------------------
    def state_dict(self) -> dict:
        return self.state.as_dict()

    def load_state_dict(self, d: dict) -> None:
        self.state = DataState.from_dict(d)

    def reshard(self, shard: int, num_shards: int) -> "TokenPipeline":
        """Elastic re-sharding: same stream, new shard layout."""
        p = TokenPipeline(self.cfg, shard=shard, num_shards=num_shards)
        p.state = DataState(step=self.state.step)
        return p


def global_batch_at(cfg: DataConfig, step: int) -> dict:
    """The full global batch (all shards concatenated) — test oracle."""
    pipes = [TokenPipeline(cfg, shard=s, num_shards=1) for s in range(1)]
    return pipes[0].batch_at(step)
