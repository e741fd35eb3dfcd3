"""Deterministic synthetic LM data pipeline with per-host sharding.

Tokens are generated from a counter-based Philox stream keyed on
(seed, step, global example index) — any host can materialize exactly its
shard for any step with no coordination, which is what makes elastic
restart and straggler exclusion deterministic (runtime/fault.py): after a
re-mesh, host h' of H' regenerates the same global batch partitioned
differently.

Documents: geometric lengths packed into fixed-size sequences with EOS
separators; targets are next-token shifted within documents.

This package keeps its own copy of the reference package's pipeline (numpy
only, the same Philox stream), so its batches are byte-identical to the
reference's; the train loop moves them to the parameters' device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    eos_id: int = 1
    # Learnable structure: with prob `markov_p` the next token follows a fixed
    # affine map of the previous one — gives integration tests a decreasing
    # loss signal while staying fully deterministic.
    markov_p: float = 0.9


class TokenPipeline:
    """Iterator over per-host batches: {"tokens","targets"} int32 arrays."""

    def __init__(self, cfg: DataConfig, n_hosts: int = 1, host_id: int = 0,
                 start_step: int = 0):
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} not divisible "
                             f"by n_hosts {n_hosts}")
        self.cfg = cfg
        self.n_hosts = n_hosts
        self.host_id = host_id
        self.step = start_step

    def batch_at(self, step: int, n_hosts: Optional[int] = None,
                 host_id: Optional[int] = None) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        n_hosts = self.n_hosts if n_hosts is None else n_hosts
        host_id = self.host_id if host_id is None else host_id
        per_host = cfg.global_batch // n_hosts
        lo = host_id * per_host
        rows = [self._example(step, lo + i) for i in range(per_host)]
        tokens = np.stack([r[0] for r in rows])
        targets = np.stack([r[1] for r in rows])
        return {"tokens": tokens, "targets": targets}

    def _example(self, step: int, index: int):
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(
            key=np.array([np.uint64(cfg.seed) ^ np.uint64(0x5D17 << 32),
                          (np.uint64(step) << np.uint64(32))
                          | np.uint64(index)], dtype=np.uint64)))
        s = cfg.seq_len
        noise = rng.integers(2, cfg.vocab_size, size=s + 1, dtype=np.int64)
        follow = rng.random(s + 1) < cfg.markov_p
        toks = np.empty(s + 1, np.int64)
        toks[0] = noise[0]
        vspan = cfg.vocab_size - 2
        for i in range(1, s + 1):
            if follow[i]:
                toks[i] = 2 + (toks[i - 1] * 31 + 7) % vspan
            else:
                toks[i] = noise[i]
        # carve into documents with EOS boundaries (packing)
        pos = 0
        while pos < s + 1:
            dl = int(rng.geometric(1.0 / max(cfg.mean_doc_len, 2)))
            pos += dl
            if pos < s + 1:
                toks[pos] = cfg.eos_id
                pos += 1
        return toks[:s].astype(np.int32), toks[1:s + 1].astype(np.int32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self.batch_at(self.step)
        self.step += 1
        return batch
