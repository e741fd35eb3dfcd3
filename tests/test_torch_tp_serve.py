"""Serving tensor-parallel over a `model` axis, against the reference
package on one device: ranks over gloo on the CPU ({data: 1, model: 2},
spawned by launch.mesh.spawn_ranks; rank functions in
tests/_torch_tp_ranks.py). The GLU layout of `wi` shards and every rank's
shards reassembling the tree; reduced mistral-nemo-12b's prefill and decode
logits against the reference's single-device steps; its paged engine's
tokens (bf16, int8, int8 with retention) against the reference's
PagedJaxExecutor engine, with the retention's block masses summed over the
ranks equal to one rank's; reduced gemma3-12b's slot engine against the
reference's JaxExecutor engine; CudaMeasurer's max over ranks making every
rank's plan one; and the refusals that name ROADMAP queue A item 5."""
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as JS
from repro.configs import get_config as jax_get_config
from repro.configs.base import depth_variant as jax_depth
from repro.models import ModelSettings as JMS
from repro.models import init_params as jax_init_params
from repro.models.attention import AttnSettings as JAS
from repro.runtime import serve_step as JSS
from repro.serving.executor import JaxExecutor, PagedJaxExecutor
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import measure as TMM
from repro_torch.launch import mesh as LM
from repro_torch.launch import serve as SV
from repro_torch.models import init_params
from repro_torch.parallel import sharding as S
from repro_torch.parallel.axes import GluSpec, Spec
from repro_torch.runtime import schedule as SCH
from repro_torch.serving.executor import PagedTorchExecutor
from repro_torch.tree import tree_leaves

from _torch_parity import to_np, tree_np
import _torch_tp_ranks as R

JNAIVE = JMS(attn=JAS(backend="naive"))
ROOT = os.path.join(os.path.dirname(__file__), "..")
M = 2                   # ranks on the model axis
B, SEQ, S0 = 2, 12, 8   # step logits: prefill 8 positions, decode 4
# f32 weights: the two packages' f32 sums in other orders (the port's row-
# parallel wo sums two partial products); bf16 weights: the reference
# parity tests' tolerance for bf16 logits (tests/test_torch_serve.py)
ATOL = {"float32": 2e-5, "bfloat16": 5e-2}
GEMMA_TRACE = dict(seed=2, prompt_lens=(4, 6), gen_lens=(3, 6),
                   mean_interarrival=1.0)


def _jax_model(arch, depth, f32, seed=1):
    cj = jax_get_config(arch).reduced()
    if depth is not None:
        cj = jax_depth(cj, depth)
    if f32:
        cj = dataclasses.replace(cj, param_dtype="float32")
    pj = jax_init_params(jax.random.PRNGKey(seed), cj)
    return cj, pj


# per-rank (argument, transient, output, peak) bytes the stand-in measurer
# reads: alone, the ranks would classify the workload apart
READINGS = [(1.0e6, 2.0e3, 1.0e3, 1.0e6 + 3.0e3),
            (1.2e6, 9.0e6, 2.0e3, 1.2e6 + 9.0e6)]


@functools.lru_cache(maxsize=None)
def _world():
    """The JAX models and tokens, and every rank's results: one world of
    ranks runs all the model:2 checks (R.tp_all)."""
    cj16, pj16 = _jax_model(R.ARCH, R.DEPTH, False)
    cj32, pj32 = _jax_model(R.ARCH, R.DEPTH, True)
    gj, gp = _jax_model("gemma3-12b", None, False)
    toks = np.random.default_rng(7).integers(
        2, cj16.vocab_size, (B, SEQ)).astype(np.int32)
    ranks = R.spawn(R.tp_all, M, M,
                    (tree_np(pj32), tree_np(pj16), toks, S0),
                    (tree_np(gp), GEMMA_TRACE), READINGS)
    return {"bfloat16": (cj16, pj16), "float32": (cj32, pj32),
            "gemma": (gj, gp), "toks": toks, "ranks": ranks}


def _mistral():
    w = _world()
    return dict(w, ranks=[r["mistral"] for r in w["ranks"]])


def _jax_steps(cj, pj, toks):
    prefill = JSS.make_prefill_step(cj, JNAIVE)
    decode = JSS.make_decode_step(cj, JNAIVE)
    lg, cache = prefill(pj, jnp.asarray(toks[:, :S0]), context=SEQ)
    out = [to_np(lg)]
    for t in range(S0, SEQ):
        pos = jnp.full((B,), t, dtype=jnp.int32)
        lg, cache = decode(pj, jnp.asarray(toks[:, t:t + 1]), pos, cache,
                           context=SEQ)
        out.append(to_np(lg))
    return np.stack(out).astype(np.float32)


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------

def _specs(cfg, mesh):
    return S.param_specs(cfg, init_params(None, cfg, device="meta"),
                         S.default_strategy(cfg, mesh), mesh)


def _reassemble(shards_by_rank, specs):
    """The full leaves from every rank's shards: concatenated along the
    dimension the spec puts on "model"; a GLU wi's gate halves first, then
    its val halves."""
    out = []
    per_rank = [tree_leaves(t) for t in shards_by_rank]
    for i, spec in enumerate(tree_leaves(specs)):
        parts = [leaves[i] for leaves in per_rank]
        dims = [d for d, e in enumerate(spec) if "model" in S.entry_axes(e)]
        if not dims:
            for p in parts[1:]:
                assert torch.equal(p, parts[0])
            out.append(parts[0])
            continue
        d, = dims
        if isinstance(spec, GluSpec):
            halves = [p.chunk(2, dim=d) for p in parts]
            out.append(torch.cat([h[0] for h in halves]
                                 + [h[1] for h in halves], dim=d))
        else:
            out.append(torch.cat(parts, dim=d))
    return out


def test_glu_wi_shards_hold_matching_gate_and_val_halves():
    """On model:2 each rank's wi is [gate_r | val_r]: columns r of the gate
    and the same columns of the val, the element count the spec tree's
    shard; the shards reassemble the leaf exactly."""
    cfg = get_config(R.ARCH).reduced()
    F = cfg.d_ff
    full = torch.arange(cfg.d_model * 2 * F, dtype=torch.float32).reshape(
        1, cfg.d_model, 2 * F)                       # [repeats, d, 2F]
    mesh0 = R.shards_on_every_rank(M, lambda m: m)[0]
    spec = _specs(cfg, mesh0)["units"][0]["mlp"]["wi"]
    assert spec[-1] == "model"

    def cut(mesh):
        return S.local_slice(full, spec, mesh)

    shards = R.shards_on_every_rank(M, cut)
    w = F // M
    for r, sh in enumerate(shards):
        assert sh.shape == (1, cfg.d_model, 2 * w)
        gate, val = sh.chunk(2, dim=-1)
        assert torch.equal(gate, full[..., r * w:(r + 1) * w])
        assert torch.equal(val, full[..., F + r * w:F + (r + 1) * w])
    halves = [s.chunk(2, dim=-1) for s in shards]
    assert torch.equal(torch.cat([h[0] for h in halves]
                                 + [h[1] for h in halves], dim=-1), full)
    # the spec tree marks the leaf (axes.GluSpec), so its own cut is the
    # GLU one; under a plain spec the contiguous cut gives rank 0 the whole
    # gate: the trap it avoids
    assert isinstance(spec, GluSpec)
    assert torch.equal(S.local_slice(full, Spec(spec), mesh0),
                       full[..., :F])


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "gemma3-12b"])
@pytest.mark.parametrize("source", ["init_local_params", "params_from_jax"])
def test_rank_shards_reassemble_the_tree(arch, source):
    """Every rank's shards of the params (drawn by init_local_params from
    one generator seed, or carried from the reference's numpy weights by
    params_from_jax) reassemble each leaf exactly: the one-rank tree."""
    cfg = get_config(arch).reduced()
    if source == "init_local_params":
        whole = init_params(torch.Generator().manual_seed(5), cfg, "cpu")

        def shard(mesh):
            return S.init_local_params(torch.Generator().manual_seed(5),
                                       cfg, "cpu", _specs(cfg, mesh), mesh)
    else:
        _, pj = _jax_model(arch, None, False)
        whole = params_from_jax(tree_np(pj), cfg, "cpu")

        def shard(mesh):
            return params_from_jax(tree_np(pj), cfg, "cpu", mesh=mesh)
    shards = R.shards_on_every_rank(M, shard)
    mesh0 = R.shards_on_every_rank(M, lambda m: m)[0]
    specs = _specs(cfg, mesh0)
    for sh, r in zip(shards, range(M)):
        mesh = R.shards_on_every_rank(M, lambda m: m)[r]
        assert [tuple(t.shape) for t in tree_leaves(sh)] == [
            S.local_shape(t.shape, s, mesh) for t, s in
            zip(tree_leaves(whole), tree_leaves(specs))]
    got = _reassemble(shards, specs)
    for a, b in zip(got, tree_leaves(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# Logits and engines on model:2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tp_step_logits_match_reference(dtype):
    """The prefill step's last logits and four decode steps' logits of two
    ranks on model:2 against the reference's single-device steps (plain
    attention); every rank holds the same gathered logits."""
    mi = _mistral()
    cj, pj = mi[dtype]
    want = _jax_steps(cj, pj, mi["toks"])
    got = [r[dtype] for r in mi["ranks"]]
    assert got[0].shape == want.shape
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], want, atol=ATOL[dtype], rtol=0)
    assert (got[0].argmax(-1) == want.argmax(-1)).all()


def _jax_paged(kv_quant, kv_retain):
    cj, pj = _mistral()["bfloat16"]
    trace = JS.synthetic_trace(5, vocab_size=cj.vocab_size, **R.TRACE_KW)
    context = -(-JS.trace_context(trace) // R.KV_BLOCK) * R.KV_BLOCK
    ex = PagedJaxExecutor(pj, cj, n_lanes=R.LANES, n_blocks=R.N_BLOCKS,
                          kv_block=R.KV_BLOCK, context=context,
                          settings=JNAIVE, compact=True, chunk=R.KV_BLOCK,
                          kv_quant=kv_quant, kv_retain=kv_retain)
    rep = JS.Engine(ex, R.LANES,
                    allocator=JS.BlockAllocator(R.N_BLOCKS, R.KV_BLOCK),
                    chunk_prefill=R.KV_BLOCK, kv_retain=kv_retain,
                    audit="strict").run(trace)
    return R.streams(rep), rep


@pytest.mark.parametrize("case", R.ENGINE_CASES,
                         ids=["bf16", "int8", "int8-retain2"])
def test_tp_paged_engine_matches_reference(case):
    """The compacted chunked paged engine of two ranks on model:2 (each
    rank's pool at half the kv heads) emits the reference PagedJaxExecutor
    engine's streams, on every rank."""
    mi = _mistral()
    want, rep = _jax_paged(*case)
    if case[1]:
        assert rep.block_drops > 0           # retention dropped blocks
    cfg = R.cfg_of()
    for r in mi["ranks"]:
        assert r[case]["kv_heads"] == cfg.n_kv_heads // M
        assert r[case]["streams"] == want
    assert len(want) == 5


def test_tp_retention_masses_sum_to_one_ranks():
    """Under kv_retain the ranks' per-block attention mass (each over its
    own heads) summed over the model axis equals one rank's mass tick by
    tick, and every rank reads that sum: the ranks evict the same
    blocks."""
    mi = _mistral()
    cj, pj = mi["bfloat16"]
    cfg = R.cfg_of()
    one = params_from_jax(tree_np(pj), cfg, "cpu")
    _, ex = R.paged_engine(one, cfg, "int8", 2)
    ranks = [r[("int8", 2)] for r in mi["ranks"]]
    assert len(ex.masses) == len(ranks[0]["masses"]) > 0
    for t, want in enumerate(ex.masses):
        summed = sum(r["shares"][t] for r in ranks)
        np.testing.assert_allclose(summed, want, atol=1e-6, rtol=0)
        for r in ranks:
            np.testing.assert_array_equal(r["masses"][t], summed)


def test_tp_slot_engine_gemma3_matches_reference():
    """Reduced gemma3-12b (local windowed rings, a global ring, logit
    softcap, tied embeddings) through the slot engine on model:2 emits the
    reference JaxExecutor engine's streams on every rank."""
    cj, pj = _world()["gemma"]
    trace = JS.synthetic_trace(5, vocab_size=cj.vocab_size, **GEMMA_TRACE)
    want = R.streams(JS.Engine(JaxExecutor(
        pj, cj, n_slots=2, context=JS.trace_context(trace),
        settings=JNAIVE), 2).run(trace))
    for r in (r["gemma"] for r in _world()["ranks"]):
        assert r["kv_heads"] == cj.n_kv_heads // M
        assert r["streams"] == want


# ---------------------------------------------------------------------------
# CudaMeasurer over a model mesh
# ---------------------------------------------------------------------------

def test_measurer_max_over_ranks_gives_every_rank_one_plan():
    """With per-rank readings that differ (argument, transient, output,
    peak bytes), each rank planning on its own would reach another class;
    reduced with max over the ranks, as CudaMeasurer reduces them, every
    rank reaches one class and one plan."""
    out = [r["plans"] for r in _world()["ranks"]]
    assert out[0][True] == out[1][True]
    assert out[0][False] != out[1][False]
    assert out[0][False][0] != out[1][False][0]      # the class itself


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mesh,what", [
    ("mistral-nemo-12b", {"data": 2, "model": 1}, "'data' axis"),
    ("mistral-nemo-12b", {"pipe": 2, "model": 1}, "'pipe' axis"),
    ("xlstm-1.3b", {"data": 1, "model": 2}, "recurrent blocks"),
    ("recurrentgemma-9b", {"data": 1, "model": 2}, "recurrent blocks"),
    ("mixtral-8x7b", {"data": 1, "model": 2}, "MoE blocks"),
    ("mistral-nemo-12b", {"data": 1, "model": 16}, "kv_shard='seq'"),
    ("gemma3-12b", {"data": 1, "model": 16}, "kv_shard='seq'"),
])
def test_serving_refusals_name_queue_a_item_5(arch, mesh, what):
    """Each case is refused naming queue A item 5, but the MoE blocks:
    serving and training run them on a model axis (expert parallelism, or
    tensor parallelism inside the experts), so neither check refuses
    them."""
    cfg = get_config(arch)
    problems = SCH.serving_mesh_problems(cfg, mesh)
    if what == "MoE blocks":
        assert problems == []
        SCH.check_serving_mesh(cfg, mesh)
        SCH.check_training_mesh(cfg, mesh)
        return
    assert any(what in p for p in problems), problems
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        SCH.check_serving_mesh(cfg, mesh)


def test_tp_refusals_elsewhere_name_queue_a_item_5():
    """The serving mesh checks pass where they should; the executors, the
    measurer, the training mesh check and the CLI refuse what stays
    out."""
    cfg = get_config(R.ARCH).reduced()
    assert SCH.serving_mesh_problems(get_config(R.ARCH),
                                     {"data": 1, "model": 4}) == []
    assert SCH.serving_mesh_problems(cfg, {"data": 1, "model": 2}) == []
    assert any("query heads" in p for p in SCH.serving_mesh_problems(
        cfg, {"model": 8}))
    data2 = LM.Mesh(axis_names=("data", "model"),
                    shape={"data": 2, "model": 1},
                    coords={"data": 0, "model": 0}, groups={})
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        PagedTorchExecutor(init_params(torch.Generator(), cfg, "cpu"), cfg,
                           n_lanes=1, n_blocks=4, kv_block=4, context=8,
                           device="cpu", mesh=data2)
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        TMM.CudaMeasurer({"data": 1, "model": 2}, device="cpu")
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        TMM.CudaMeasurer({"data": 2, "model": 2}, device="cpu")
    model2 = LM.Mesh(axis_names=("data", "model"),
                     shape={"data": 1, "model": 2},
                     coords={"data": 0, "model": 0}, groups={}, rank=0)
    # a mesh checkpoint of a model axis is ported
    # (tests/test_torch_tp_train.py), and training MoE blocks on one
    # (tests/test_torch_tp_moe_train.py); training over recurrent blocks
    # on one is not
    assert model2.axis_size("model") == 2
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        SCH.check_training_mesh(get_config("xlstm-1.3b").reduced(),
                                model2.shape)
    SCH.check_training_mesh(get_config("mixtral-8x7b").reduced(),
                            model2.shape)
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        SV.main(["--arch", "xlstm-1.3b", "--reduced", "--device", "cpu",
                 "--kv", "paged", "--model-parallel", "2"])


# ---------------------------------------------------------------------------
# The serve CLI on model:2
# ---------------------------------------------------------------------------

CLI = ["--arch", "mistral-nemo-12b", "--reduced", "--device", "cpu", "--kv",
       "paged", "--compact", "--chunk-prefill", "8", "--kv-quant", "int8",
       "--kv-retain", "2", "--requests", "6", "--prompt-lens", "4,8,20",
       "--gen-lens", "2,4,9"]


def _cli(*extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *CLI, *extra], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=R.TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_serve_cli_on_two_ranks_emits_one_ranks_tokens(tmp_path):
    """`--model-parallel 2` spawns two gloo ranks: every rank's plan, tokens
    and block-table schedule (retention's drops included) are rank 0's, and
    each rank holds the spec tree's shard and the predictor's pool bytes.
    With `--replay` of the one-rank run's tokens (one of them changed) the
    ranks emit those tokens, and `--tokens-out` keeps the logits of the
    step that emitted each: wherever the ranks held the one-rank run's
    tokens, their argmax is its token and their top logits are its own."""
    one = _cli("--tokens-out", str(tmp_path / "one.json"))
    ref = json.loads((tmp_path / "one.json").read_text())
    assert re.search(r"^schedule digest \w+$", one, re.M)
    other = json.loads(json.dumps(ref))
    other["tokens"]["1"][1] = (other["tokens"]["1"][1] + 1) % 512
    (tmp_path / "other.json").write_text(json.dumps(other))
    two = _cli("--model-parallel", "2", "--replay",
               str(tmp_path / "other.json"), "--tokens-out",
               str(tmp_path / "two.json"))
    got = json.loads((tmp_path / "two.json").read_text())
    assert got["tokens"] == other["tokens"]
    digest = re.search(r"^tokens digest (\w+)$", two, re.M).group(1)
    rows = re.findall(r"^rank (\d) \{.*\}: param elements ([0-9,]+) \(spec "
                      r"tree ([0-9,]+);.*; pool (\d+) B \(predicted (\d+) "
                      r"B\);.*; schedule digest (\w+); tokens digest (\w+)$",
                      two, re.M)
    assert [r[0] for r in rows] == ["0", "1"]
    assert rows[0][5] == rows[1][5] != "none"
    for _, el, spec, pool, pred, _, dig in rows:
        assert el == spec and pool == pred and dig == digest
    plans = re.findall(r"^rank \d plan: (.*)$", two, re.M)
    assert len(plans) == 2 and plans[0] == plans[1] and "model:2" in plans[0]
    compared = 0
    for rid, toks in ref["tokens"].items():
        for k, tok in enumerate(toks):
            mine, theirs = got["logits"][rid][k], ref["logits"][rid][k]
            assert mine is not None and len(mine[0]) == 8
            if rid == "1" and k > 1:
                continue                 # after the changed token
            assert mine[0][0] == tok and theirs[0][0] == tok
            np.testing.assert_allclose(mine[1], theirs[1],
                                       atol=ATOL["bfloat16"], rtol=0)
            compared += 1
    assert compared == sum(len(t) for t in ref["tokens"].values()) - (
        len(ref["tokens"]["1"]) - 2)
    # the changed token was emitted in place of the argmax
    assert got["logits"]["1"][1][0][0] == ref["tokens"]["1"][1] != \
        got["tokens"]["1"][1]
