"""Rank functions of the MoE model-axis serving tests
(tests/test_torch_tp_moe.py): each runs in a process that
launch.mesh.spawn_ranks starts (gloo over the CPU) on a {data: 1, model: M}
mesh, imports neither jax nor the reference package, and returns numpy
arrays and plain values for the parent test to hold against the
reference."""
import dataclasses

import numpy as np
import torch

from repro_torch import serving as TS
from repro_torch.configs import get_config
from repro_torch.configs.base import depth_variant
from repro_torch.convert import params_from_jax
from repro_torch.launch import mesh as LM
from repro_torch.models import init_params
from repro_torch.models import moe as MOE
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as S
from repro_torch.serving.executor import PagedTorchExecutor, TorchExecutor

from _torch_mesh_ranks import TIMEOUT, spawn  # noqa: F401 — R.TIMEOUT, R.spawn

ARCHS = ("mixtral-8x7b", "llama4-scout-17b-a16e")
KV_BLOCK, N_BLOCKS, LANES, CHUNK = 4, 24, 3, 8
ENGINE_DEPTH = 2
TRACE_KW = dict(seed=6, prompt_lens=(3, 5, 8, 11), gen_lens=(3, 5),
                mean_interarrival=0.0)


def cfg_of(arch, dtype="bfloat16", depth=None):
    cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype=dtype)
    return depth_variant(cfg, depth) if depth else cfg


def specs_of(cfg, mesh, ep):
    return S.param_specs(cfg, init_params(None, cfg, device="meta"),
                         S.Strategy(ep=ep), mesh)


def layer_of(params):
    """The first MoE layer's leaves (repeat 0 of the stacked unit)."""
    return {k: v[0] for k, v in params["units"][0]["mlp"].items()}


def moe_blocks(mesh, cases, layouts):
    """For each (arch, dtype): {(ep, path): (y, aux, dispatch, wi shape)}
    of the first MoE layer on `mesh` under Strategy(ep=ep), its weights
    this rank's shards of the reference's (`cases[(arch, dtype)]` = (numpy
    params, {path: (x, group_size)})); the dispatch masks as `route` made
    them on this rank."""
    group = mesh.groups["model"]
    out = {}
    for (arch, dtype), (tree, inputs) in cases.items():
        cfg = cfg_of(arch, dtype)
        for ep in layouts:
            params = params_from_jax(tree, cfg, "cpu", mesh=mesh,
                                     spec_tree=specs_of(cfg, mesh, ep))
            layer = layer_of(params)
            for path, (x, g) in inputs.items():
                seen = []

                def catch(route, p, c, h):
                    r = route(p, c, h)
                    seen.append(r[0].float().numpy())
                    return r
                with comm.model_axis(group), MOE.routing(catch), \
                        torch.no_grad():
                    y, aux = MOE.moe_apply(
                        layer, cfg, torch.from_numpy(x).to(
                            layer["wi"].dtype), group_size=g)
                out[arch, dtype, ep, path] = (
                    y.float().numpy(), {k: float(v) for k, v in aux.items()},
                    seen[0], tuple(layer["wi"].shape))
    return out


def streams(rep):
    return [(c.rid, tuple(int(t) for t in c.tokens), c.arrival, c.admitted,
             c.finished, c.first_token) for c in rep.completions]


def trace_of(cfg):
    return TS.synthetic_trace(6, vocab_size=cfg.vocab_size, **TRACE_KW)


def context_of(trace):
    return -(-TS.trace_context(trace) // KV_BLOCK) * KV_BLOCK


RUNS = (("paged", True), ("paged", False), ("slot", True))


def run_engine(params, cfg, kind, mesh=None, forced=None):
    """The compacted chunked paged engine (`kind` "paged") or the slot
    engine on the seeded trace, every routing call through a RouteTape
    (forced to another run's routes when given): (streams, tape calls as
    numpy)."""
    trace = trace_of(cfg)
    if kind == "paged":
        ex = PagedTorchExecutor(params, cfg, n_lanes=LANES,
                                n_blocks=N_BLOCKS, kv_block=KV_BLOCK,
                                context=context_of(trace), compact=True,
                                chunk=CHUNK, device="cpu", mesh=mesh)
        eng = TS.Engine(ex, LANES,
                        allocator=TS.BlockAllocator(N_BLOCKS, KV_BLOCK),
                        chunk_prefill=CHUNK, audit="strict")
    else:
        ex = TorchExecutor(params, cfg, n_slots=2,
                           context=TS.trace_context(trace), device="cpu",
                           mesh=mesh)
        eng = TS.Engine(ex, 2)
    tape = MOE.RouteTape(None if forced is None else [
        (torch.from_numpy(e), torch.from_numpy(k)) for e, k in forced])
    with MOE.routing(tape):
        rep = eng.run(trace)
    return streams(rep), [(e.numpy(), k.numpy()) for e, k in tape.calls]


def engines(mesh, tree):
    """Reduced mixtral (bf16, ENGINE_DEPTH layers) on `mesh`, each run of
    RUNS (the paged engine under EP and under TP inside the experts, the
    slot engine under EP): its streams, route tape and wi shard shape."""
    cfg = cfg_of("mixtral-8x7b", depth=ENGINE_DEPTH)
    out = {}
    for kind, ep in RUNS:
        params = params_from_jax(tree, cfg, "cpu", mesh=mesh,
                                 spec_tree=specs_of(cfg, mesh, ep))
        st, routes = run_engine(params, cfg, kind, mesh)
        out[kind, ep] = {"streams": st, "routes": routes,
                         "wi": tuple(params["units"][0]["mlp"]["wi"].shape)}
    return out


def moe_all(device, m, cases, layouts, engine_tree):
    """Every model:m check of the tests in one world of ranks (one start-up
    for all): the MoE blocks and, given a tree, the engines."""
    mesh = LM.build_mesh({"data": 1, "model": m})
    out = {"coords": dict(mesh.coords),
           "blocks": moe_blocks(mesh, cases, layouts)}
    if engine_tree is not None:
        out["engines"] = engines(mesh, engine_tree)
    return out


def rng_inputs(seed, shape, copies=()):
    """f32 inputs exact in bf16; rows in `copies` ((dst, src) pairs of the
    leading dim) copied from another row (a decode step's inert lanes)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    for dst, src in copies:
        x[dst] = x[src]
    return x
