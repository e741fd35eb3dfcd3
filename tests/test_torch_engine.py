"""The ported path as a whole: one seeded trace through the reference package's
engine with its paged executor (Pallas kernels in interpret mode) and
through the port's engine with PagedTorchExecutor on the CPU, converted
weights: same completions, token streams and report counters. Also pins the
port's copies of the engine, allocator and fault code against the reference
package's on a chaos trace (scripted executor, no model)."""
import dataclasses

import pytest

from repro.models import ModelSettings as JMS
from repro.models.attention import AttnSettings as JAS
from repro import serving as JS
from repro.serving.executor import PagedJaxExecutor
from repro_torch import serving as TS
from repro_torch.serving.executor import PagedTorchExecutor

from _torch_parity import model_pair

KV_BLOCK, N_BLOCKS, LANES = 4, 24, 2


def _report_dict(rep):
    d = dataclasses.asdict(rep)
    d.pop("completions")
    d.pop("cancellations")
    return d


def _streams(rep):
    return [(c.rid, tuple(c.tokens), c.arrival, c.admitted, c.finished,
             c.first_token) for c in rep.completions]


@pytest.mark.parametrize("kv_quant,interarrival",
                         [("none", 0.0), ("int8", 1.0)],
                         ids=["fp-burst", "int8-spaced"])
def test_engine_run_equals_reference(kv_quant, interarrival):
    cj, pj, ct, pt = model_pair()
    kw = dict(vocab_size=cj.vocab_size, seed=4, prompt_lens=(6, 10, 13),
              gen_lens=(3, 5), mean_interarrival=interarrival)
    trace_j, trace_t = JS.synthetic_trace(5, **kw), TS.synthetic_trace(5, **kw)
    assert [(r.rid, tuple(r.prompt), r.max_new, r.arrival) for r in trace_j] \
        == [(r.rid, tuple(r.prompt), r.max_new, r.arrival) for r in trace_t]
    assert min(len(r.prompt) for r in trace_t) > KV_BLOCK    # all chunked
    context = -(-JS.trace_context(trace_j) // KV_BLOCK) * KV_BLOCK
    assert TS.trace_context(trace_t) == JS.trace_context(trace_j)

    ex_j = PagedJaxExecutor(pj, cj, n_lanes=LANES, n_blocks=N_BLOCKS,
                            kv_block=KV_BLOCK, context=context,
                            settings=JMS(attn=JAS(backend="pallas")),
                            compact=True, chunk=KV_BLOCK, kv_quant=kv_quant)
    rep_j = JS.Engine(ex_j, LANES,
                      allocator=JS.BlockAllocator(N_BLOCKS, KV_BLOCK),
                      chunk_prefill=KV_BLOCK, audit="strict").run(trace_j)
    ex_t = PagedTorchExecutor(pt, ct, n_lanes=LANES, n_blocks=N_BLOCKS,
                              kv_block=KV_BLOCK, context=context,
                              compact=True, chunk=KV_BLOCK,
                              kv_quant=kv_quant, device="cpu")
    rep_t = TS.Engine(ex_t, LANES,
                      allocator=TS.BlockAllocator(N_BLOCKS, KV_BLOCK),
                      chunk_prefill=KV_BLOCK, audit="strict").run(trace_t)

    assert len(rep_t.completions) == len(trace_t)
    assert _streams(rep_t) == _streams(rep_j)
    assert _report_dict(rep_t) == _report_dict(rep_j)
    assert (ex_t.prefills, ex_t.decodes, ex_t.chunk_calls) \
        == (ex_j.prefills, ex_j.decodes, ex_j.chunk_calls)
    assert ex_t.chunk_calls > 0 and rep_t.prefill_calls == 0
    # one count per distinct (lane-bucket, table-bucket) shape, as the
    # reference executor's jit compiles one variant per such shape (its
    # jit cache is shared by every executor of the process, so its count
    # can only be larger)
    cc_t, cc_j = ex_t.compile_counts(), ex_j.compile_counts()
    assert cc_t["prefill"] == 0 and cc_t["decode"] == 0
    for step in ("decode_compact", "chunk"):
        assert cc_t[step] >= 1
        if cc_j[step] is not None:
            assert cc_t[step] <= cc_j[step], step


def test_full_width_decode_and_plain_backend_same_tokens():
    """compact=False (full-width ticks with inert rows) and the plain
    backend by name give the compacting kernel-backend run's tokens."""
    from repro_torch.models import ModelSettings
    from repro_torch.models.attention import AttnSettings
    _, _, ct, pt = model_pair()
    trace = TS.synthetic_trace(5, vocab_size=ct.vocab_size, seed=4,
                               prompt_lens=(6, 10, 13), gen_lens=(3, 5),
                               mean_interarrival=1.0)
    context = -(-TS.trace_context(trace) // KV_BLOCK) * KV_BLOCK

    def run(compact, backend, track_mass=False):
        ex = PagedTorchExecutor(
            pt, ct, n_lanes=LANES, n_blocks=N_BLOCKS, kv_block=KV_BLOCK,
            context=context, compact=compact, chunk=KV_BLOCK, device="cpu",
            settings=ModelSettings(attn=AttnSettings(backend=backend)),
            track_mass=track_mass)
        rep = TS.Engine(ex, LANES,
                        allocator=TS.BlockAllocator(N_BLOCKS, KV_BLOCK),
                        chunk_prefill=KV_BLOCK).run(trace)
        return ex, [c.tokens for c in rep.completions]

    _, base = run(True, "kernel")
    assert run(False, "kernel")[1] == base
    assert run(True, "naive")[1] == base
    ex, toks = run(True, "kernel", track_mass=True)
    assert toks == base and ex.block_masses()
    ex.reset()
    assert ex.block_masses() == {}
    assert int(ex.pool["units"][0]["pos"].max()) == -1


def test_prefill_batch_raises_and_device_rule():
    import torch
    _, _, ct, pt = model_pair()
    ex = PagedTorchExecutor(pt, ct, n_lanes=2, n_blocks=6, kv_block=4,
                            context=16, chunk=4, device="cpu")
    with pytest.raises(NotImplementedError, match="flash_attention_fwd"):
        ex.prefill_batch([0], [[2, 3, 4]], [[1]])
    with pytest.raises(ValueError):
        PagedTorchExecutor(pt, ct, n_lanes=2, n_blocks=6, kv_block=4,
                           context=16, chunk=6, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            PagedTorchExecutor(pt, ct, n_lanes=2, n_blocks=6, kv_block=4,
                               context=16, chunk=4)    # default: the card
    assert TS.PagedTorchExecutor is PagedTorchExecutor


def test_fresh_blocks_takes_ids_as_given_and_rows_are_accounted():
    _, _, ct, pt = model_pair()
    ex = PagedTorchExecutor(pt, ct, n_lanes=4, n_blocks=8, kv_block=4,
                            context=16, chunk=4, compact=True, device="cpu")
    pos = ex.pool["units"][0]["pos"]
    pos.fill_(7)
    ex.fresh_blocks([])
    assert int(pos.min()) == 7
    ex.fresh_blocks([3, 5])
    assert int(pos[:, [3, 5]].max()) == -1
    assert int(pos[:, [0, 1, 2, 4, 6, 7, 8]].min()) == 7   # scratch untouched
    ex.reset()
    # 3 lanes at the bucketed width 4: one padding row in each step
    ex.prefill_chunks([0, 1, 2], [[2, 3, 4, 5]] * 3, [0, 0, 0],
                      tables=[[1], [2], [3]], final=[True] * 3)
    ex.decode([2, 2, 2, 0], [4, 4, 4, 0], [[1, 4], [2, 5], [3, 6], []],
              lanes=[0, 1, 2])
    assert ex.rows_real == {"decode_compact": 3, "chunk": 3}
    assert ex.rows_computed == {"decode_compact": 4, "chunk": 4}
    assert ex.compile_counts()["reset"] == 0


# ---------------------------------------------------------------------------
# The copied scheduler: scripted executor, chaos plan, no model
# ---------------------------------------------------------------------------

def _chaos_run(S, seed):
    vocab, n_blocks, kv_block, n_slots = 97, 48, 4, 8
    trace = S.synthetic_trace(32, vocab_size=vocab, seed=3,
                              prompt_lens=(4, 8, 16), gen_lens=(4, 8, 16),
                              mean_interarrival=6.0, slo_classes=(0, 1, 2))
    plan = S.FaultPlan.generate(seed, ticks=256, n_requests=len(trace),
                                n_lanes=n_slots, exec_rate=0.05,
                                alloc_rate=0.05, n_shrinks=1,
                                shrink_frac=0.25, n_cancels=3, n_stalls=2)
    alloc = S.ChaosAllocator(n_blocks, kv_block, "expected", plan=plan)
    execu = S.ChaosExecutor(S.ScriptedExecutor(vocab), plan)
    eng = S.Engine(execu, n_slots=n_slots, allocator=alloc, chunk_prefill=4,
                   prefill_budget=8,
                   stats=S.OnlineLengthStats(base=S.length_stats(trace)),
                   faults=plan, deadline=800,
                   ladder=S.LadderConfig(patience=3, high=0.9),
                   audit="strict")
    rep = eng.run(trace, max_ticks=50_000)
    return plan, rep, S.leak_check(alloc)


@pytest.mark.parametrize("seed", [11, 5])
def test_scripted_chaos_run_equals_reference(seed):
    plan_j, rep_j, leaks_j = _chaos_run(JS, seed)
    plan_t, rep_t, leaks_t = _chaos_run(TS, seed)
    assert dataclasses.asdict(plan_t) == dataclasses.asdict(plan_j)
    assert leaks_t == leaks_j == []
    assert _streams(rep_t) == _streams(rep_j)
    assert [(c.rid, c.reason) for c in rep_t.cancellations] \
        == [(c.rid, c.reason) for c in rep_j.cancellations]
    assert _report_dict(rep_t) == _report_dict(rep_j)
    assert rep_t.exec_faults + rep_t.alloc_faults > 0
