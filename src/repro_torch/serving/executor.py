"""The PyTorch executors behind the serving engine: a slotted ring-cache
pool (`TorchExecutor`) and a paged KV block pool (`PagedTorchExecutor`),
with eager prefill / decode steps.

`TorchExecutor` has the surface of the reference package's `JaxExecutor`:
each slot of the pool is one lane's cache tree (a ring per attention layer,
a state per recurrent block); a prefill overwrites whole slots, and every
decode tick runs at the pool's width, the rings' slot = pos % L layout
taking each lane's own position.

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

Whole-prompt prefill (`prefill_batch`) runs a same-length admission group
at the smallest lane bucket covering it; each layer attends the prompts
over themselves (the flash-attention kernel on the card) and writes their
K/V into the pool through the block tables as it runs.

Both executors take a `mesh` (`launch.mesh.Mesh`, {data: 1, model: M}) to
serve tensor-parallel: `params` are then this rank's shards
(`parallel.sharding`), the pool holds this rank's n_kv_heads / M kv heads,
and every step runs inside `parallel.comm.model_axis`. Each rank runs the
same host engine: its decisions read only tokens, which the gathered
logits make equal on every rank, and the attention mass retention ranks
blocks by, which is summed over the model axis before the engine reads
it (each rank's covers its own heads only).

Both executors take a `log` (`TokenLog`) that keeps, for every token a
step emits, the top logits it came from, and can replay another run's
tokens in place of the argmax: two runs' served logits are then compared
token by token (the serve CLI's `--tokens-out` and `--replay`).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.parallel import comm
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


def _model_axis(cfg: ModelConfig, mesh):
    """(model group or None, model axis size) of a serving mesh; a mesh
    this slice does not serve on raises (runtime.schedule)."""
    if mesh is None:
        return None, 1
    from repro_torch.runtime import schedule as SCH
    SCH.check_serving_mesh(cfg, dict(mesh.shape))
    m = mesh.axis_size("model")
    return (mesh.groups["model"] if m > 1 else None), m


def history_key(tokens: Sequence[int]) -> str:
    """The key of a lane's tokens (prompt and tokens emitted so far): what
    `TokenLog` files the next token's logits under."""
    return hashlib.sha256(np.asarray(tokens, np.int32).tobytes()).hexdigest()


class TokenLog:
    """The served steps' own logits: for every token a step emits, the
    top `k` logits (ids and f32 values, largest first) and the standard
    deviation of the whole row, filed under the `history_key` of the tokens
    the lane held before it. The executor feeds it the tokens each step
    writes into a lane (`feed`) and lets it pick the emitted tokens
    (`pick`): the argmax, or where `force` ({history key: token}) has one,
    the given token — a replay of another run's tokens, so that the two
    runs' logits meet at every token they emitted. A lane whose first
    tokens the executor never saw (a prefix sharer's) files nothing."""

    def __init__(self, k: int = 8, force: Optional[Dict[str, int]] = None):
        self.k = int(k)
        self.force = dict(force or {})
        self.records: Dict[str, tuple] = {}
        self._held: Dict[int, Optional[List[int]]] = {}

    def feed(self, lane: int, start: int, tokens: Sequence[int]) -> None:
        """Lane `lane` now holds `tokens` at positions start.. (and drops
        what it held from there on)."""
        held = self._held.get(lane) if start else []
        if held is None or len(held) < start:
            self._held[lane] = None      # tokens before `start` unknown
            return
        self._held[lane] = held[:start] + [int(t) for t in tokens]

    def pick(self, logits: torch.Tensor, lanes: Sequence[int],
             tokens: Sequence[int]) -> List[int]:
        """Row j of `logits` [n, V] is lane lanes[j]'s next token, whose
        argmax is tokens[j]: files the row, returns the tokens emitted."""
        lg = logits.float()
        top = torch.topk(lg, min(self.k, lg.shape[-1]), dim=-1)
        ids, vals = top.indices.cpu().tolist(), top.values.cpu().tolist()
        std = lg.std(dim=-1).cpu().tolist()
        out = []
        for j, lane in enumerate(lanes):
            held = self._held.get(int(lane))
            tok = int(tokens[j])
            if held is not None:
                key = history_key(held)
                tok = int(self.force.get(key, tok))
                self.records[key] = (ids[j], vals[j], std[j])
            out.append(tok)
        return out


def _emit(ex, logits, rows: Sequence[int],
          lanes: Sequence[int]) -> List[int]:
    """Every row's argmax of `logits` [w, V] (`ex._argmax`); with a token
    log, row rows[j] (lane lanes[j]'s next token) takes the log's pick."""
    out = [int(t) for t in ex._argmax(logits)]
    if ex.log is not None and len(rows):
        rows = list(rows)
        picked = ex.log.pick(logits[rows], lanes, [out[r] for r in rows])
        for r, t in zip(rows, picked):
            out[r] = t
    return out


def _cover(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (buckets sorted ascending; n <= max)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


class TorchExecutor:
    """Engine slot operations over the slot pool (runtime.serve_step.
    init_slot_pool): prefill writes one slot, or a same-length group padded
    to the pool width (padding rows carry slot id n_slots and are dropped
    on the device); decode advances every slot in one batched
    heterogeneous-position step at the pool's width. Ring decode goes
    through the ring decode kernel on the card (settings.attn.backend
    "kernel"), whole-prompt prefill through the flash-attention kernel.

    The pool lives on `device` (default "cuda"; raises without a CUDA
    device) and is updated in place by every step. `params` must already be
    on that device (this rank's shards on a `mesh`)."""

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int,
                 context: int, settings: Optional[M.ModelSettings] = None,
                 device="cuda", mesh=None, log: Optional[TokenLog] = None):
        self.device = M.require_device(device)
        self.params = params
        self.cfg = cfg
        self.settings = settings
        self.log = log
        self.n_slots = int(n_slots)
        self.context = int(context)
        self.group, self.model_parallel = _model_axis(cfg, mesh)
        self.pool = SS.init_slot_pool(cfg, self.n_slots, self.context,
                                      device=self.device,
                                      model_parallel=self.model_parallel)
        self._prefill_step = SS.make_slot_prefill_step(cfg, settings)
        self._batch_step = SS.make_batch_prefill_step(cfg, settings)
        self._decode_step = SS.make_decode_step(cfg, settings)
        self.prefills = 0
        self.prefill_calls = 0             # prefill steps run (any width)
        self.decodes = 0

    def _dev(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    @staticmethod
    def _argmax(logits) -> np.ndarray:
        return torch.argmax(logits, dim=-1).cpu().numpy()

    @torch.no_grad()
    def prefill(self, slot: int, prompt: Sequence[int]) -> int:
        tokens = self._dev([list(prompt)])
        if self.log is not None:
            self.log.feed(slot, 0, prompt)
        with comm.model_axis(self.group):
            logits, self.pool = self._prefill_step(self.params, tokens, slot,
                                                   self.pool,
                                                   context=self.context)
        self.prefills += 1
        self.prefill_calls += 1
        return _emit(self, logits, [0], [slot])[0]

    @torch.no_grad()
    def prefill_batch(self, slots: Sequence[int],
                      prompts: Sequence[Sequence[int]],
                      tables=None) -> List[int]:
        """One prefill of a same-length admission group, padded to the pool
        width W: padding rows carry the config's pad token and slot id W,
        which the slot write drops."""
        p = len(prompts[0])
        if p < 1 or any(len(pr) != p for pr in prompts):
            raise ValueError("prefill_batch takes prompts of one length")
        toks = np.full((self.n_slots, p), _pad_token(self.cfg), np.int32)
        idx = np.full((self.n_slots,), self.n_slots, np.int32)
        for i, (s, pr) in enumerate(zip(slots, prompts)):
            toks[i] = pr
            idx[i] = s
            if self.log is not None:
                self.log.feed(s, 0, pr)
        with comm.model_axis(self.group):
            logits, self.pool = self._batch_step(
                self.params, self._dev(toks), self._dev(idx), self.pool,
                context=self.context)
        self.prefills += len(slots)        # per-request, like the engine
        self.prefill_calls += 1
        out = _emit(self, logits, range(len(slots)), slots)
        return out[:len(slots)]

    def decode_width(self, n_active: int) -> int:
        """The batch width a decode tick computes at: always the pool's."""
        return self.n_slots

    @torch.no_grad()
    def decode(self, tokens: Sequence[int], positions: Sequence[int],
               tables=None, lanes=None) -> List[int]:
        t = self._dev(list(tokens))[:, None]
        p = self._dev(list(positions))
        act = list(lanes if lanes is not None else range(self.n_slots))
        if self.log is not None:
            for i in act:
                self.log.feed(i, positions[i], [tokens[i]])
        with comm.model_axis(self.group):
            logits, self.pool = self._decode_step(self.params, t, p,
                                                  self.pool,
                                                  context=self.context)
        self.decodes += 1
        return _emit(self, logits, act, act)

    def compile_counts(self) -> dict:
        """Nothing is compiled here: the reference executor's jit counts
        have no counterpart, so every entry is None (unknown), as the
        reference reports for a jax without a cache-size probe."""
        return {"prefill": None, "decode": None}


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

    Recurrent blocks (xLSTM's mLSTM and sLSTM) keep each lane's state in
    per-lane pool leaves, gathered and written back by every step; a model
    with no attention layer pages nothing, and its block tables route
    nothing (`has_recurrent`: the engine then refuses prefix sharing).

    The pool lives on `device` (default "cuda"; raises without a CUDA
    device) and is updated in place by every step. `params` must already be
    on that device (this rank's shards on a `mesh`).
    """

    def __init__(self, params, cfg: ModelConfig, *, n_lanes: int,
                 n_blocks: int, kv_block: int, context: int,
                 settings: Optional[M.ModelSettings] = None,
                 compact: bool = False,
                 lane_buckets: Optional[Sequence[int]] = None,
                 chunk: int = 0, kv_quant: str = "none",
                 kv_retain: int = 0, track_mass: bool = False,
                 device="cuda", mesh=None, log: Optional[TokenLog] = None):
        if kv_block < 1:
            raise ValueError(f"kv_block must be >= 1, got {kv_block}")
        if kv_retain < 0:
            raise ValueError(f"kv_retain must be >= 0, got {kv_retain}")
        self.device = M.require_device(device)
        self.params = params
        self.cfg = cfg
        self.log = log
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
        self.group, self.model_parallel = _model_axis(cfg, mesh)
        self.pool = SS.init_paged_pool(cfg, self.n_lanes, self.n_blocks + 1,
                                       kv_block, self.context,
                                       kv_quant=self.kv_quant,
                                       device=self.device,
                                       model_parallel=self.model_parallel)
        self._decode_step = SS.make_paged_decode_step(cfg, settings)
        self._compact_step = SS.make_compact_decode_step(cfg, settings)
        self._chunk_step = SS.make_chunk_prefill_step(cfg, settings)
        self._prefill_step = SS.make_paged_prefill_step(cfg, settings)
        self.prefills = 0
        self.decodes = 0
        self.chunk_calls = 0
        # calls of each step at each shape: (lane bucket, table bucket) for
        # decode and chunk steps, (lane bucket, prompt length) for
        # whole-prompt prefill; a step's kernels launch once per paged layer
        # and call, at the call's shape
        self.shape_calls: Dict[str, Counter] = {
            k: Counter() for k in ("prefill", "decode", "decode_compact",
                                   "chunk")}
        # batch rows each bucketed step held a request in, and rows it
        # computed (the difference is the buckets' padding rows)
        self.rows_real = {"prefill": 0, "decode_compact": 0, "chunk": 0}
        self.rows_computed = {"prefill": 0, "decode_compact": 0, "chunk": 0}
        # lane -> per-logical-block attention mass from the LAST decode
        # tick (only populated when kv_retain or track_mass enables the
        # accounting)
        self._last_mass: Dict[int, np.ndarray] = {}
        # every block table the steps were given, in order: ranks of one
        # model axis run one schedule only if their digests agree
        self._schedule = hashlib.sha256()

    def _dev(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _tables(self, tbl: np.ndarray) -> torch.Tensor:
        """A step's block tables on the device, added to the schedule's
        digest."""
        self._schedule.update(np.ascontiguousarray(tbl, np.int32).tobytes())
        return self._dev(tbl)

    @property
    def schedule_digest(self) -> str:
        """sha256 of every block table the steps were given so far."""
        return self._schedule.hexdigest()

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

    @torch.no_grad()
    def prefill_batch(self, lanes: Sequence[int],
                      prompts: Sequence[Sequence[int]],
                      tables: Sequence[Sequence[int]]) -> List[int]:
        """One whole-prompt prefill of a same-length admission group: lane
        `lanes[j]` prefills `prompts[j]` from position 0 into the blocks of
        `tables[j]`. The group is padded to the smallest lane bucket that
        covers it (padding rows: the pad token, lane id n_lanes, an empty
        table, so they write nothing). Returns each lane's first token."""
        n = len(lanes)
        if not n or len(prompts) != n or len(tables) != n:
            raise ValueError("prefill_batch needs one prompt and one table "
                             "per lane")
        p = len(prompts[0])
        if p < 1 or any(len(pr) != p for pr in prompts):
            raise ValueError("prefill_batch takes prompts of one length")
        w = _cover(n, self.lane_buckets)
        toks = np.full((w, p), _pad_token(self.cfg), np.int32)
        toks[:n] = np.asarray([list(pr) for pr in prompts], np.int32)
        lane_arr = np.full((w,), self.n_lanes, np.int32)
        lane_arr[:n] = lanes
        tbl = self._table_array(list(tables) + [[]] * (w - n), w)
        if self.log is not None:
            for lane, pr in zip(lanes, prompts):
                self.log.feed(lane, 0, pr)
        self.shape_calls["prefill"][(w, p)] += 1
        self.rows_real["prefill"] += n
        self.rows_computed["prefill"] += w
        with comm.model_axis(self.group):
            logits, self.pool = self._prefill_step(
                self.params, self._dev(toks), self._dev(lane_arr),
                self._tables(tbl), self.pool, context=self.context)
        self.prefills += n                 # per-request, like the engine
        return _emit(self, logits, range(n), lanes)[:n]

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

    @torch.no_grad()
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
        tbl = self._tables(self._table_array(tables, self.n_lanes))
        act = [int(i) for i in (lanes if lanes is not None
                                else range(self.n_lanes))]
        if self.log is not None:
            for i in act:
                self.log.feed(i, positions[i], [tokens[i]])
        self.shape_calls["decode"][(self.n_lanes, self.max_blocks)] += 1
        with comm.model_axis(self.group):
            logits, self.pool, mass = self._decode_step(
                self.params, t, p, tbl, self.pool, context=self.context)
        self.decodes += 1
        if mass is not None:
            m = self._mass(mass)
            self._last_mass = {i: m[i] for i in act}
        return _emit(self, logits, act, act)

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
            if self.log is not None:
                self.log.feed(i, positions[i], [tokens[i]])
        self.shape_calls["decode_compact"][(w, mb)] += 1
        self.rows_real["decode_compact"] += len(lanes)
        self.rows_computed["decode_compact"] += w
        with comm.model_axis(self.group):
            logits, self.pool, mass = self._compact_step(
                self.params, self._dev(t), self._dev(p), self._tables(tbl),
                self._dev(lane_arr), self.pool, context=self.context)
        self.decodes += 1
        if mass is not None:
            m = self._mass(mass)
            self._last_mass = {int(i): m[j] for j, i in enumerate(lanes)}
        out = _emit(self, logits, range(len(lanes)), lanes)
        res = [0] * self.n_lanes
        for j, i in enumerate(lanes):
            res[i] = out[j]
        return res

    @torch.no_grad()
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
            if self.log is not None:
                self.log.feed(lane, starts[j], c)
        self.shape_calls["chunk"][(w, mb)] += 1
        self.rows_real["chunk"] += len(lanes)
        self.rows_computed["chunk"] += w
        with comm.model_axis(self.group):
            logits, self.pool = self._chunk_step(
                self.params, self._dev(toks), self._dev(pos),
                self._tables(tbl), self._dev(lane_arr), self.pool,
                context=self.context)
        self.chunk_calls += 1
        if final is not None:
            self.prefills += sum(bool(f) for f in final)
        done = [j for j in range(len(lanes)) if final is None or final[j]]
        out = _emit(self, logits, done, [lanes[j] for j in done])
        return out[:len(lanes)]

    def _mass(self, mass) -> np.ndarray:
        """A decode tick's per-block attention mass on the host. Under
        tensor parallelism each rank's is the mean over its own heads: the
        ranks' shares (mean / model ranks, exact for a power of two) are
        summed over the model axis, so every rank ranks blocks by the mean
        over all heads, as one rank does, and evicts the same blocks."""
        mass = mass.float()
        if self.group is not None:
            mass = comm.all_reduce(mass / self.model_parallel, self.group,
                                   kind="tp_mass")
        return mass.cpu().numpy()

    def block_masses(self) -> Dict[int, np.ndarray]:
        """Per-lane attention mass over the lane's logical blocks from the
        last decode tick ({} when mass tracking is off) — the retention
        policy's ranking signal."""
        return self._last_mass

    @property
    def _shapes(self) -> Dict[str, set]:
        """The distinct shapes each step was launched at: what a jit would
        have compiled."""
        return {k: set(c) for k, c in self.shape_calls.items()}

    def compile_counts(self) -> dict:
        """Nothing is compiled per shape here; each entry is the number of
        distinct shapes that step was launched at ((lane bucket, prompt
        length) for whole-prompt prefill, (lane bucket, table bucket) for
        the others), which is what the reference executor's jit would have
        compiled — so the engine's report keeps its meaning. `reset` is
        always 0: it takes the block ids as they come, with no padded
        width."""
        return {**{k: len(c) for k, c in self.shape_calls.items()},
                "reset": 0}
