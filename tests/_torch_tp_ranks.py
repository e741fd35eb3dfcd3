"""Rank functions of the tensor-parallel serving tests
(tests/test_torch_tp_serve.py): each runs in a process that
launch.mesh.spawn_ranks starts (gloo over the CPU) on a {data: 1, model: M}
mesh, imports neither jax nor the reference package, and returns numpy
arrays and plain values for the parent test to hold against the
reference."""
import dataclasses

import torch

from repro_torch import serving as TS
from repro_torch.configs import get_config
from repro_torch.configs.base import DECODE, ShapeConfig, depth_variant
from repro_torch.convert import params_from_jax
from repro_torch.core import measure as MM
from repro_torch.launch import mesh as LM
from repro_torch.parallel import comm
from repro_torch.runtime import serve_step as SS
from repro_torch.search import execplan as XP
from repro_torch.search import space as SP
from repro_torch.serving.executor import PagedTorchExecutor, TorchExecutor

from _torch_mesh_ranks import TIMEOUT, spawn  # noqa: F401 — R.TIMEOUT, R.spawn

ARCH = "mistral-nemo-12b"
DEPTH = 2
KV_BLOCK, N_BLOCKS, LANES = 4, 24, 2
# (kv_quant, kv_retain) of the paged engine runs
ENGINE_CASES = (("none", 0), ("int8", 0), ("int8", 2))
TRACE_KW = dict(seed=4, prompt_lens=(6, 10, 13), gen_lens=(3, 8),
                mean_interarrival=1.0)


def cfg_of(arch=ARCH, depth=DEPTH, f32=False):
    cfg = get_config(arch).reduced()
    if depth is not None:
        cfg = depth_variant(cfg, depth)
    return dataclasses.replace(cfg, param_dtype="float32") if f32 else cfg


def model_mesh(m):
    return LM.build_mesh({"data": 1, "model": m})


def streams(rep):
    return [(c.rid, tuple(int(t) for t in c.tokens), c.arrival, c.admitted,
             c.finished, c.first_token) for c in rep.completions]


def trace_of(cfg):
    return TS.synthetic_trace(5, vocab_size=cfg.vocab_size, **TRACE_KW)


def trace_context(trace):
    return -(-TS.trace_context(trace) // KV_BLOCK) * KV_BLOCK


class MassRecorder(PagedTorchExecutor):
    """PagedTorchExecutor that keeps each decode tick's attention mass:
    this rank's share before the model-axis sum (`shares`) and the mass
    the engine reads (`masses`)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.shares, self.masses = [], []

    def _mass(self, mass):
        self.shares.append((mass.float() / self.model_parallel).numpy())
        out = super()._mass(mass)
        self.masses.append(out)
        return out


def paged_engine(params, cfg, kv_quant, kv_retain, mesh=None):
    """The compacted chunked paged engine on the seeded trace: (streams,
    executor)."""
    trace = trace_of(cfg)
    ex = MassRecorder(params, cfg, n_lanes=LANES, n_blocks=N_BLOCKS,
                      kv_block=KV_BLOCK, context=trace_context(trace),
                      compact=True, chunk=KV_BLOCK, kv_quant=kv_quant,
                      kv_retain=kv_retain, device="cpu", mesh=mesh)
    rep = TS.Engine(ex, LANES, allocator=TS.BlockAllocator(N_BLOCKS,
                                                           KV_BLOCK),
                    chunk_prefill=KV_BLOCK, kv_retain=kv_retain,
                    audit="strict").run(trace)
    return streams(rep), ex


def steps_logits(params, cfg, toks, s0, group=None):
    """The prefill step's last logits on toks[:, :s0], then the decode
    step's at each later position: [1 + S - s0, b, V] f32."""
    toks = torch.from_numpy(toks)
    b, s = toks.shape
    prefill, decode = SS.make_prefill_step(cfg), SS.make_decode_step(cfg)
    out = []
    with comm.model_axis(group):
        lg, cache = prefill(params, toks[:, :s0], context=s)
        out.append(lg)
        for t in range(s0, s):
            pos = torch.full((b,), t, dtype=torch.int32)
            lg, cache = decode(params, toks[:, t:t + 1], pos, cache,
                               context=s)
            out.append(lg)
    return torch.stack(out).float().numpy()


def tp_all(device, m, mistral_args, gemma_args, readings_by_rank):
    """Every model:m check of the tests in one world of ranks (one start-up
    for all): tp_mistral, tp_gemma_slots and measurer_plans."""
    mesh = model_mesh(m)
    return {"mistral": tp_mistral(mesh, *mistral_args),
            "gemma": tp_gemma_slots(mesh, *gemma_args),
            "plans": measurer_plans(mesh, readings_by_rank)}


def tp_mistral(mesh, np_f32, np_bf16, toks, s0):
    """Reduced mistral-nemo-12b on `mesh`: the step logits at f32 and bf16
    weights, and the paged engine's streams for every ENGINE_CASES entry
    with its tick masses (shares before the sum, and the summed mass)."""
    group = mesh.groups["model"]
    out = {"coords": dict(mesh.coords)}
    for name, tree, f32 in (("float32", np_f32, True),
                            ("bfloat16", np_bf16, False)):
        cfg = cfg_of(f32=f32)
        params = params_from_jax(tree, cfg, "cpu", mesh=mesh)
        out[name] = steps_logits(params, cfg, toks, s0, group)
    cfg = cfg_of()
    params = params_from_jax(np_bf16, cfg, "cpu", mesh=mesh)
    for q, r in ENGINE_CASES:
        st, ex = paged_engine(params, cfg, q, r, mesh)
        out[(q, r)] = {"streams": st, "shares": ex.shares,
                       "masses": ex.masses,
                       "kv_heads": ex.pool["units"][0]["kb"].shape[-2]}
    return out


def tp_gemma_slots(mesh, np_bf16, trace_kw):
    """Reduced gemma3-12b's slot engine (TorchExecutor) on `mesh`: the
    engine's streams and this rank's ring heads."""
    cfg = cfg_of("gemma3-12b", depth=None)
    params = params_from_jax(np_bf16, cfg, "cpu", mesh=mesh)
    trace = TS.synthetic_trace(5, vocab_size=cfg.vocab_size, **trace_kw)
    ex = TorchExecutor(params, cfg, n_slots=2,
                       context=TS.trace_context(trace), device="cpu",
                       mesh=mesh)
    rep = TS.Engine(ex, 2).run(trace)
    return {"streams": streams(rep),
            "kv_heads": ex.pool["units"][0]["k"].shape[-2]}


class StandInMeasurer(MM.CudaMeasurer):
    """CudaMeasurer's reduction with scripted per-rank readings: no card,
    no step; `reduce` False leaves each rank with its own readings (what
    the ranks would plan without the max)."""

    def __init__(self, mesh_shape, group, readings, reduce=True):
        MM.MemoryMeasurer.__init__(self, mesh_shape)
        self.device = torch.device("cpu")
        self.group = group if reduce else None
        self._params = None
        self.script = readings

    def _readings(self, cfg, shape, plan, settings):
        return list(self.script)


def measurer_plans(mesh, readings_by_rank):
    """Each rank plans the reduced mistral-nemo-12b's ring serving on the
    mesh's model axis as the serve CLI does, through the stand-in measurer
    with its own readings, reduced (max over ranks) and not: (class, plan)
    both ways."""
    m = mesh.axis_size("model")
    cfg = cfg_of(depth=None)
    shape = ShapeConfig("serve_trace", DECODE, 64, 4)
    space = SP.serving_space(cfg, shape, max_devices=m, data=(1,),
                             model=(m,), kv_blocks=(0,),
                             kv_quants=("none",), kv_retains=(0,))
    out = {}
    for reduce in (True, False):
        meas = StandInMeasurer({"data": 1, "model": m},
                               mesh.groups["model"],
                               readings_by_rank[mesh.rank], reduce)
        cls, splan = XP.plan_serving(cfg, shape, n_devices=m,
                                     hbm_budget=2e6, measurer=meas,
                                     space=space)
        out[reduce] = (cls.category.value, round(cls.alpha, 9),
                       splan.describe())
    return out


def shards_on_every_rank(m, fn):
    """fn(mesh) for each coordinate of a {data: 1, model: m} mesh, made
    without a process group (local cuts need coordinates only)."""
    return [fn(LM.Mesh(axis_names=("data", "model"),
                       shape={"data": 1, "model": m},
                       coords={"data": 0, "model": r}, rank=r))
            for r in range(m)]

