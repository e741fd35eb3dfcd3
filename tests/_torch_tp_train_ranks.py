"""Rank functions of the tensor-parallel training tests
(tests/test_torch_tp_train.py): each runs in a process that
launch.mesh.spawn_ranks starts (gloo over the CPU), imports neither jax
nor the reference package, and returns numpy arrays and plain values for
the parent test to hold against the reference."""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt as CK
from repro_torch.configs import get_config
from repro_torch.configs.base import depth_variant
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.launch import mesh as LM
from repro_torch.models import attention as A
from repro_torch.models import init_params, layers
from repro_torch.models import model as MD
from repro_torch.optim import optimizers as TO
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as S
from repro_torch.runtime import schedule as SCH
from repro_torch.runtime.train_step import TrainStepConfig
from repro_torch.tree import tree_leaves, tree_map, tree_paths

from _torch_mesh_ranks import TIMEOUT, spawn  # noqa: F401 — R.TIMEOUT, R.spawn

# the depth (unit repeats) of each arch's reduced config in these tests:
# two layers, and gemma3-12b's one unit of six (five windowed, one global)
DEPTH = {"h2o-danube-1.8b": 2, "mistral-nemo-12b": 2, "gemma3-12b": 1}
# the blocks whose gradients are held against one rank's: each runs one
# of the tensor-parallel autograd ops (comm.tp_enter, tp_sum,
# tp_gather_last, and the embedding's tp_sum)
BLOCKS = ("mlp", "attention", "head", "embed")


def cfg_of(arch, f32=True):
    cfg = depth_variant(get_config(arch).reduced(), DEPTH[arch])
    return dataclasses.replace(cfg, param_dtype="float32") if f32 else cfg


def specs_of(cfg, mesh):
    return S.param_specs(cfg, init_params(None, cfg, device="meta"),
                         S.default_strategy(cfg, mesh), mesh)


def _np(tree):
    return to_numpy(tree_map(lambda t: t.detach(), tree))


def whole_leaves(tree, specs):
    """The leaves of `tree` whose spec names no "model" axis (each rank of
    a model group holds them whole), as numpy."""
    return [t.detach().numpy().copy()
            for t, s in zip(tree_leaves(tree), tree_leaves(specs))
            if "model" not in s.axes()]


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

def train_case(mesh, arch, params_np, batches_np, schedule, kind, remat,
               lr):
    """make_train_step's steps on `mesh` from the same params: metrics,
    the full params after the steps (gathered, rank 0), the leaves the
    model axis leaves whole (every rank), the local state."""
    cfg = cfg_of(arch)
    specs = specs_of(cfg, mesh)
    local = params_from_jax(params_np, cfg, "cpu", mesh=mesh,
                            spec_tree=specs)
    micro = 2 if schedule == "scan" else 1
    tcfg = TrainStepConfig(remat=remat, microbatches=micro,
                           optimizer=TO.OptimizerConfig(kind=kind, lr=lr),
                           warmup_steps=2, total_steps=10)
    step = SCH.make_train_step(cfg, tcfg, mesh=mesh, spec_tree=specs,
                               schedule=schedule)
    state = TO.init_state(tcfg.optimizer, local)
    hist = []
    for i, b in enumerate(batches_np):
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        local, state, m = step(local, state, batch, i)
        hist.append({k: float(v) for k, v in m.items()})
    with torch.no_grad():
        full = _np(S.gather_tree(local, specs, mesh))
    return {"schedule": step.schedule, "metrics": hist,
            "params": full if mesh.rank == 0 else None,
            "whole": whole_leaves(local, specs),
            "coords": dict(mesh.coords)}


def train_world(device, mesh_shape, cases, setups, lr):
    """Every train case of one mesh in one world of ranks: {case: result}."""
    mesh = LM.build_mesh(mesh_shape)
    return {case: train_case(mesh, case[0], setups[case[0]][0],
                             setups[case[0]][1], *case[1:], lr)
            for case in cases}


# ---------------------------------------------------------------------------
# The autograd ops, block by block, against one rank
# ---------------------------------------------------------------------------

def _unit(tree, i=0):
    """Repeat 0 of unit position `i` of a params / specs tree."""
    u = tree["units"][i]
    if isinstance(tree_leaves(u)[0], torch.Tensor):
        return tree_map(lambda t: t[0], u)
    return tree_map(lambda s: type(s)(s[1:]), u)


def _block(name, cfg, p, x, tokens, pos, c):
    """The block's scalar loss (f32) on params p (whole or this rank's)."""
    if name == "mlp":
        y = MD.mlp_apply(p, cfg, x)
    elif name == "attention":
        y = A.attn_apply(p, cfg, cfg.unit[0], x, pos)[0]
    elif name == "head":
        logits = layers.lm_head(p, cfg, x)
        return layers.cross_entropy(logits, tokens)
    else:
        y = layers.embed_lookup(p, cfg, tokens)
    return (y.float() * c).sum()


def block_case(mesh, name):
    """The block's loss and gradients (input and weights) on the mesh's
    model axis against the same block on one rank: the loss, the input's
    gradient and each weight shard's gradient (against the slice of one
    rank's), as (max abs difference, max abs of one rank's) pairs (f32)."""
    arch = "gemma3-12b" if name == "head" else "mistral-nemo-12b"
    cfg = cfg_of(arch)
    gen = torch.Generator().manual_seed(21)
    full = init_params(gen, cfg, "cpu")
    specs = specs_of(cfg, mesh)
    local = S.local_shard(full, specs, mesh)
    if name in ("head", "embed"):
        key = ("embed" if cfg.tie_embeddings or name == "embed" else "head")
        wf, wl, ws = full[key], local[key], specs[key]
    else:
        key = "mlp" if name == "mlp" else "mixer"
        wf, wl, ws = (_unit(t)[key] for t in (full, local, specs))
    b, s, d = 2, 12, cfg.d_model
    x0 = torch.randn(b, s, d, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    c = torch.randn(b, s, d, generator=gen)

    def run(params, group):
        params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          params)
        x = x0.clone().requires_grad_(True)
        with comm.model_axis(group):
            loss = _block(name, cfg, params, x, tokens, pos, c)
            loss.backward()
        return loss.detach(), x.grad, tree_map(lambda t: t.grad, params)

    lf, gxf, gwf = run(wf, None)
    lt, gxt, gwt = run(wl, mesh.groups["model"])

    def diff(a, b):
        return (float((a - b).abs().max()), float(b.abs().max()))

    out = {"loss": diff(lt, lf)}
    if name != "embed":
        out["x"] = diff(gxt, gxf)
    for (path, g), spec, gf in zip(tree_paths(gwt), tree_leaves(ws),
                                   tree_leaves(gwf)):
        out["/".join(map(str, path))] = diff(
            g, S.local_slice(gf, spec, mesh))
    return out


def ops_forward(mesh):
    """Each tensor-parallel op's forward against the plain collective it
    wraps, bit for bit: tp_sum and all_reduce, tp_enter and its input,
    tp_gather_last and all_gather along the last dim."""
    group = mesh.groups["model"]
    gen = torch.Generator().manual_seed(31 + mesh.rank)
    t = torch.randn(3, 5, 6, generator=gen)
    with comm.model_axis(group):
        return {"tp_sum": bool(torch.equal(comm.tp_sum(t),
                                           comm.all_reduce(t, group))),
                "tp_enter": bool(torch.equal(comm.tp_enter(t), t)),
                "tp_gather_last": bool(torch.equal(
                    comm.tp_gather_last(t), comm.all_gather(t, group, 2)))}


# ---------------------------------------------------------------------------
# Checkpoints of a tensor-parallel layout
# ---------------------------------------------------------------------------

CK_ARCH = "mistral-nemo-12b"
CK_OPT = TO.OptimizerConfig(kind="adafactor")


def ckpt_target(cfg, mesh, gen_seed=9):
    """({"params", "opt"} of this rank's shapes, its spec tree)."""
    specs = specs_of(cfg, mesh)
    params = S.local_shard(init_params(torch.Generator().manual_seed(
        gen_seed), cfg, "cpu"), specs, mesh)
    return ({"params": params, "opt": TO.init_state(CK_OPT, params)},
            {"params": specs, "opt": TO.state_specs(CK_OPT, specs)})


def ckpt_world(mesh_m, mesh_d, params_np, batches_np, ckpt_m, ckpt_d):
    """On one world of two ranks: (1) two Adafactor steps on model:2 at
    bf16, then its checkpoint saved (the ranks' state returned); (2) that
    checkpoint restored onto data:2; (3) a data:2 checkpoint of the given
    params (the column moments set to 0.25) saved; (4) it restored onto
    model:2."""
    cfg = cfg_of(CK_ARCH, f32=False)
    specs = specs_of(cfg, mesh_m)
    local = params_from_jax(params_np, cfg, "cpu", mesh=mesh_m,
                            spec_tree=specs)
    tcfg = TrainStepConfig(optimizer=dataclasses.replace(CK_OPT, lr=1e-3),
                           warmup_steps=2, total_steps=10)
    step = SCH.make_train_step(cfg, tcfg, mesh=mesh_m, spec_tree=specs)
    state = TO.init_state(tcfg.optimizer, local)
    for i, b in enumerate(batches_np):
        local, state, _ = step(local, state, {k: torch.from_numpy(v)
                                              for k, v in b.items()}, i)
    tree = {"params": local, "opt": state}
    CK.save(ckpt_m, 2, tree, extra={"step": 2}, mesh=mesh_m,
            spec_tree={"params": specs,
                       "opt": TO.state_specs(CK_OPT, specs)})
    dist.barrier()                     # rank 0 has written it
    out = {"saved": _np(tree), "coords_m": dict(mesh_m.coords),
           "coords_d": dict(mesh_d.coords)}
    target, tspecs = ckpt_target(cfg, mesh_d)
    out["on_data"] = _np(CK.restore(ckpt_m, target, device="cpu",
                                    mesh=mesh_d, spec_tree=tspecs)[0])
    dspecs = specs_of(cfg, mesh_d)
    dparams = S.local_shard(params_from_jax(params_np, cfg, "cpu"), dspecs,
                            mesh_d)
    dstate = TO.init_state(CK_OPT, dparams)
    tree_map(lambda t: t.add_(0.25), dstate["f"])
    CK.save(ckpt_d, 5, {"params": dparams, "opt": dstate},
            extra={"step": 5}, mesh=mesh_d,
            spec_tree={"params": dspecs,
                       "opt": TO.state_specs(CK_OPT, dspecs)})
    dist.barrier()
    target, tspecs = ckpt_target(cfg, mesh_m, gen_seed=10)
    out["on_model"] = _np(CK.restore(ckpt_d, target, device="cpu",
                                     mesh=mesh_m, spec_tree=tspecs)[0])
    return out


# ---------------------------------------------------------------------------
# One world of model:2 for the blocks, the op forwards, the train cases and
# the checkpoints
# ---------------------------------------------------------------------------

def model2_world(device, cases, setups, lr, ck_params, ck_batches, ckpt_m,
                 ckpt_d):
    mesh = LM.build_mesh({"model": 2})
    out = {"train": {case: train_case(mesh, case[0], setups[case[0]][0],
                                      setups[case[0]][1], *case[1:], lr)
                     for case in cases},
           "blocks": {name: block_case(mesh, name) for name in BLOCKS},
           "ops": ops_forward(mesh)}
    mesh_d = LM.build_mesh({"data": 2})
    out["ckpt"] = ckpt_world(mesh, mesh_d, ck_params, ck_batches, ckpt_m,
                             ckpt_d)
    return out


def rank_slices(full, specs, mesh):
    """This rank's block of every leaf of a full numpy tree."""
    return tree_map(lambda a, s: np.asarray(S.local_slice(a, s, mesh)),
                    full, specs)
