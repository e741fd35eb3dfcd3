"""The PyTorch executor behind the serving engine: a paged KV block pool
with eager decode / chunk-prefill steps.

`PagedTorchExecutor` has the surface of the reference package's
`PagedJaxExecutor`: lane COMPACTION (decode at the smallest bucketed width
covering the active lanes) and CHUNKED prefill (append long prompts to the
live pool kv_block-aligned chunks at a time, interleaved with decode ticks).

The chunked step is STATELESS per call — each chunk carries its own
absolute `starts` and block tables, so the engine reuses it unchanged for
the overload machinery: a prefix SHARER prefills only its private suffix,
and an EVICTED request re-prefills `prompt + already-emitted tokens` from
scratch into freshly allocated blocks. No executor state survives an
eviction; everything is the block tables.

Whole-prompt prefill (`prefill_batch`) is not ported yet and raises: run the
engine with `chunk_prefill` > 0 and prompts longer than the chunk.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.runtime import serve_step as SS


def _pad_token(cfg: ModelConfig) -> int:
    """Dummy token id for padding rows — must be a REAL vocab entry (tiny
    test configs can have vocab_size <= 2, where a hardcoded id would
    index past the embedding table)."""
    pad = min(2, cfg.vocab_size - 1)
    assert 0 <= pad < cfg.vocab_size, cfg.vocab_size
    return pad


def _pow2_buckets(n: int) -> tuple:
    """Power-of-two widths up to n, always including n itself."""
    out = []
    w = 1
    while w < n:
        out.append(w)
        w *= 2
    out.append(int(n))
    return tuple(out)


def _cover(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (buckets sorted ascending; n <= max)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


class PagedTorchExecutor:
    """Engine lane operations over the paged KV block pool.

    Full-context attention layers store KV in `n_blocks` shared blocks of
    `kv_block` positions (physical id 0 is the scratch block for inactive
    lanes, so the pool is allocated one block larger); each active lane's
    logical layout reaches the pool through its block table.

    Decode runs either full width or, with `compact=True`, at the smallest
    bucketed width covering the active lanes: active lanes are packed to the
    front and their tables trimmed to the bucketed maximum of blocks
    actually allocated.

    `chunk > 0` enables chunked prefill (`prefill_chunks`): prompts are
    appended to the live pool `chunk` positions at a time, interleaved with
    decode ticks by the engine.

    The pool lives on `device` (default "cuda"; raises without a CUDA
    device) and is updated in place by every step. `params` must already be
    on that device.
    """

    def __init__(self, params, cfg: ModelConfig, *, n_lanes: int,
                 n_blocks: int, kv_block: int, context: int,
                 settings: Optional[M.ModelSettings] = None,
                 compact: bool = False,
                 lane_buckets: Optional[Sequence[int]] = None,
                 chunk: int = 0, kv_quant: str = "none",
                 kv_retain: int = 0, track_mass: bool = False,
                 device="cuda"):
        if kv_block < 1:
            raise ValueError(f"kv_block must be >= 1, got {kv_block}")
        if kv_retain < 0:
            raise ValueError(f"kv_retain must be >= 0, got {kv_retain}")
        self.device = M.require_device(device)
        self.params = params
        self.cfg = cfg
        self.kv_quant = str(kv_quant)
        self.kv_retain = int(kv_retain)
        if self.kv_retain or track_mass:
            # retention ranks blocks by attention mass — decode steps must
            # account it. `track_mass=True` alone pays the accounting
            # without a standing retention cap, for engines whose
            # degradation ladder may engage `bend_retain` mid-run.
            base = settings or M.ModelSettings()
            settings = dataclasses.replace(
                base, attn=dataclasses.replace(base.attn, track_mass=True))
        self.settings = settings
        self.n_lanes = int(n_lanes)
        self.kv_block = int(kv_block)
        # block-align the ring extent so logical blocks tile it exactly
        self.context = -(-int(context) // kv_block) * kv_block
        self.max_blocks = self.context // kv_block
        self.n_blocks = int(n_blocks)
        self.compact = bool(compact)
        if lane_buckets is None:
            self.lane_buckets = _pow2_buckets(self.n_lanes)
        else:
            bk = sorted({int(b) for b in lane_buckets})
            if not bk or bk[0] < 1:
                raise ValueError(f"bad lane_buckets {lane_buckets}")
            if bk[-1] < self.n_lanes:
                bk.append(self.n_lanes)   # must be able to cover every tick
            self.lane_buckets = tuple(bk)
        self.table_buckets = _pow2_buckets(self.max_blocks)
        self.chunk = int(chunk)
        if self.chunk and self.chunk % self.kv_block:
            raise ValueError(f"chunk={self.chunk} must be a multiple "
                             f"of kv_block={self.kv_block}")
        self.has_recurrent = any(not b.is_attn for b in cfg.blocks())
        self.pool = SS.init_paged_pool(cfg, self.n_lanes, self.n_blocks + 1,
                                       kv_block, self.context,
                                       kv_quant=self.kv_quant,
                                       device=self.device)
        self._decode_step = SS.make_paged_decode_step(cfg, settings)
        self._compact_step = SS.make_compact_decode_step(cfg, settings)
        self._chunk_step = SS.make_chunk_prefill_step(cfg, settings)
        self.prefills = 0
        self.decodes = 0
        self.chunk_calls = 0
        # distinct (lane-bucket, table-bucket) shapes each step was launched
        # at — what a jit would have compiled
        self._shapes: Dict[str, set] = {"decode": set(),
                                        "decode_compact": set(),
                                        "chunk": set()}
        # batch rows each bucketed step held a request in, and rows it
        # computed (the difference is the buckets' padding rows)
        self.rows_real = {"decode_compact": 0, "chunk": 0}
        self.rows_computed = {"decode_compact": 0, "chunk": 0}
        # lane -> per-logical-block attention mass from the LAST decode
        # tick (only populated when kv_retain or track_mass enables the
        # accounting)
        self._last_mass: Dict[int, np.ndarray] = {}

    def _dev(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    @staticmethod
    def _argmax(logits) -> np.ndarray:
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def _table_array(self, tables: Sequence[Sequence[int]], rows: int,
                     width: Optional[int] = None) -> np.ndarray:
        width = self.max_blocks if width is None else width
        out = np.full((rows, width), -1, np.int32)
        for i, tbl in enumerate(tables):
            if len(tbl) > width:
                raise ValueError(f"lane {i}: table of {len(tbl)} blocks "
                                 f"exceeds table width {width}")
            out[i, :len(tbl)] = tbl
        return out

    def prefill_batch(self, lanes: Sequence[int],
                      prompts: Sequence[Sequence[int]],
                      tables: Sequence[Sequence[int]]) -> List[int]:
        raise NotImplementedError(
            "whole-prompt prefill: needs the flash_attention_fwd slice")

    def fresh_blocks(self, ids: Sequence[int]) -> None:
        """Invalidate re-linked physical blocks (pos = -1) before decode
        reads them through a new owner's table."""
        ids = list(ids)
        if not ids:
            return
        self.pool = SS.reset_pool_blocks(self.pool, self._dev(ids))

    def reset(self) -> None:
        """Return this executor to as-fresh state WITHOUT rebuilding its
        device buffers: the whole pool's validity metadata is invalidated
        (`serve_step.clear_pool`) and the per-lane mass bookkeeping
        dropped. `Engine.resume` re-materializes every lane's KV via
        re-prefill, so a reset executor is exactly as good as a new one
        for restoring a snapshot — minus the allocation cost."""
        self.pool = SS.clear_pool(self.pool)
        self._last_mass = {}

    def decode_width(self, n_active: int) -> int:
        """The batch width a decode tick with `n_active` lanes computes at:
        the smallest covering bucket when compacting, else the full pool."""
        if not self.compact:
            return self.n_lanes
        return _cover(max(int(n_active), 1), self.lane_buckets)

    def decode(self, tokens: Sequence[int], positions: Sequence[int],
               tables: Sequence[Sequence[int]], lanes=None) -> List[int]:
        if self.compact and lanes is not None:
            return self._decode_compact(tokens, positions, tables, lanes)
        if lanes is not None:
            # Full-width decode still computes every lane row; rows NOT in
            # `lanes` (empty slots, lanes mid-chunk-prefill) are made INERT
            # (pos -1, empty table) so their write lands in the scratch
            # block instead of clobbering live KV through a mid-prefill
            # lane's real block table. The pool is written in place, so a
            # write through such a row's table would be immediate damage.
            act = set(int(i) for i in lanes)
            pad = _pad_token(self.cfg)
            tokens = [t if i in act else pad for i, t in enumerate(tokens)]
            positions = [p if i in act else -1
                         for i, p in enumerate(positions)]
            tables = [t if i in act else [] for i, t in enumerate(tables)]
        t = self._dev(list(tokens))[:, None]
        p = self._dev(list(positions))
        tbl = self._dev(self._table_array(tables, self.n_lanes))
        self._shapes["decode"].add((self.n_lanes, self.max_blocks))
        logits, self.pool, mass = self._decode_step(
            self.params, t, p, tbl, self.pool, context=self.context)
        self.decodes += 1
        if mass is not None:
            m = mass.float().cpu().numpy()
            act = lanes if lanes is not None else range(len(m))
            self._last_mass = {int(i): m[int(i)] for i in act}
        return self._argmax(logits).astype(int).tolist()

    def _decode_compact(self, tokens, positions, tables, lanes) -> List[int]:
        """Pack the active lanes into the smallest covering bucket and run
        the compacted step: padding rows carry lane id n_lanes, position -1
        and an all -1 table (they write only the scratch block, with an
        invalid position, and attend to nothing)."""
        w = self.decode_width(len(lanes))
        mb = _cover(max((len(tables[i]) for i in lanes), default=1),
                    self.table_buckets)
        t = np.full((w, 1), _pad_token(self.cfg), np.int32)
        p = np.full((w,), -1, np.int32)
        lane_arr = np.full((w,), self.n_lanes, np.int32)
        tbl = np.full((w, mb), -1, np.int32)
        for j, i in enumerate(lanes):
            t[j, 0] = tokens[i]
            p[j] = positions[i]
            lane_arr[j] = i
            if len(tables[i]) > mb:
                raise ValueError(f"lane {i}: table of {len(tables[i])} "
                                 f"blocks exceeds bucketed width {mb}")
            tbl[j, :len(tables[i])] = tables[i]
        self._shapes["decode_compact"].add((w, mb))
        self.rows_real["decode_compact"] += len(lanes)
        self.rows_computed["decode_compact"] += w
        logits, self.pool, mass = self._compact_step(
            self.params, self._dev(t), self._dev(p), self._dev(tbl),
            self._dev(lane_arr), self.pool, context=self.context)
        self.decodes += 1
        if mass is not None:
            m = mass.float().cpu().numpy()
            self._last_mass = {int(i): m[j] for j, i in enumerate(lanes)}
        out = self._argmax(logits)
        res = [0] * self.n_lanes
        for j, i in enumerate(lanes):
            res[i] = int(out[j])
        return res

    def prefill_chunks(self, lanes: Sequence[int],
                       chunks: Sequence[Sequence[int]],
                       starts: Sequence[int],
                       tables: Optional[Sequence[Sequence[int]]] = None,
                       final: Optional[Sequence[bool]] = None) -> List[int]:
        """One batched chunk-prefill call: lane `lanes[j]` appends prompt
        tokens `chunks[j]` at absolute positions starting at `starts[j]`
        through its block table. Short final chunks pad with position -1
        (masked everywhere); returned next-token ids are meaningful only
        where `final[j]`."""
        if not self.chunk:
            raise RuntimeError("executor built with chunk=0")
        w = _cover(len(lanes), self.lane_buckets)
        C = self.chunk
        tbls = [list(t) for t in (tables if tables is not None else
                                  [[]] * len(lanes))]
        mb = _cover(max((len(t) for t in tbls), default=1),
                    self.table_buckets)
        toks = np.full((w, C), _pad_token(self.cfg), np.int32)
        pos = np.full((w, C), -1, np.int32)
        lane_arr = np.full((w,), self.n_lanes, np.int32)
        tbl = self._table_array(tbls + [[]] * (w - len(tbls)), w, width=mb)
        for j, lane in enumerate(lanes):
            c = list(chunks[j])
            if not 0 < len(c) <= C:
                raise ValueError(f"lane {lane}: chunk of {len(c)} tokens "
                                 f"vs chunk size {C}")
            toks[j, :len(c)] = c
            pos[j, :len(c)] = starts[j] + np.arange(len(c))
            lane_arr[j] = lane
        self._shapes["chunk"].add((w, mb))
        self.rows_real["chunk"] += len(lanes)
        self.rows_computed["chunk"] += w
        logits, self.pool = self._chunk_step(
            self.params, self._dev(toks), self._dev(pos), self._dev(tbl),
            self._dev(lane_arr), self.pool, context=self.context)
        self.chunk_calls += 1
        if final is not None:
            self.prefills += sum(bool(f) for f in final)
        out = self._argmax(logits)
        return [int(out[j]) for j in range(len(lanes))]

    def block_masses(self) -> Dict[int, np.ndarray]:
        """Per-lane attention mass over the lane's logical blocks from the
        last decode tick ({} when mass tracking is off) — the retention
        policy's ranking signal."""
        return self._last_mass

    def compile_counts(self) -> dict:
        """Nothing is compiled per shape here; each entry is the number of
        distinct (lane-bucket, table-bucket) shapes that step was launched
        at, which is what the reference executor's jit would have compiled
        — so the engine's report keeps its meaning. `prefill` (whole-prompt
        prefill) is always 0: it is not ported; so is `reset`, which takes
        the block ids as they come, with no padded width."""
        return {"prefill": 0,
                "decode": len(self._shapes["decode"]),
                "decode_compact": len(self._shapes["decode_compact"]),
                "chunk": len(self._shapes["chunk"]),
                "reset": 0}
