"""Rank functions of the MoE model-axis training tests
(tests/test_torch_tp_moe_train.py): each runs in a process that
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
from repro_torch.models import init_params
from repro_torch.models import moe as MOE
from repro_torch.optim import optimizers as TO
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as S
from repro_torch.runtime import schedule as SCH
from repro_torch.runtime import train_step as TT
from repro_torch.runtime.train_step import TrainStepConfig
from repro_torch.tree import tree_leaves, tree_map

# seconds a world of these tests may take: each world trains several cases
# of two archs, and the tier-1 run shares the host's cores among its
# workers and their ranks
TIMEOUT = 300


def spawn(fn, world, *args):
    return LM.spawn_ranks(fn, world, "gloo", "cpu", args=args,
                          timeout=TIMEOUT)


# the depth (unit repeats) of each arch's reduced config: mixtral-8x7b's
# two MoE layers, llama4-scout-17b-a16e's one unit of four (three local,
# one global); 4 experts each, top-2 and top-1
DEPTH = {"mixtral-8x7b": 2, "llama4-scout-17b-a16e": 1}


def cfg_of(arch, f32=True):
    cfg = depth_variant(get_config(arch).reduced(), DEPTH[arch])
    return dataclasses.replace(cfg, param_dtype="float32") if f32 else cfg


def specs_of(cfg, mesh, ep):
    """The spec tree under Strategy(ep=ep): the experts over "model"
    (EP), or every expert's [gate_r | val_r] columns (TP)."""
    return S.param_specs(cfg, init_params(None, cfg, device="meta"),
                         S.Strategy(ep=ep), mesh)


def _np(tree):
    return to_numpy(tree_map(lambda t: t.detach(), tree))


def whole_leaves(tree, specs):
    """The leaves of `tree` whose spec names no "model" axis, as numpy."""
    return [t.detach().float().numpy().copy()
            for t, s in zip(tree_leaves(tree), tree_leaves(specs))
            if "model" not in s.axes()]


def _wi_shape(params):
    return tuple(params["units"][0]["mlp"]["wi"].shape)


# ---------------------------------------------------------------------------
# Train steps, one loss's gradients
# ---------------------------------------------------------------------------

def train_case(mesh, arch, ep, params_np, batches_np, schedule, kind, remat,
               lr):
    """make_train_step's steps on `mesh` from the same params: metrics,
    the full params after the steps (gathered, rank 0), the leaves the
    model axis leaves whole (every rank), the wi shard's shape."""
    cfg = cfg_of(arch)
    specs = specs_of(cfg, mesh, ep)
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
            "whole": whole_leaves(local, specs), "wi": _wi_shape(local),
            "coords": dict(mesh.coords)}


def grad_case(mesh, arch, ep, params_np, batch_np):
    """One loss and its gradients on the model axis (no update): the
    total and the metrics, the dispatch mask of every routing call, the
    routers' gradient norm, and this rank's gradients (its shards')."""
    cfg = cfg_of(arch)
    specs = specs_of(cfg, mesh, ep)
    local = params_from_jax(params_np, cfg, "cpu", mesh=mesh,
                            spec_tree=specs)
    seen = []

    def catch(route, p, c, h):
        out = route(p, c, h)
        seen.append(out[0].detach().float().numpy())
        return out

    grad_fn = TT.value_and_grad(TT.make_loss_fn(cfg, TrainStepConfig()))
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    with comm.model_axis(mesh.groups["model"]), MOE.routing(catch):
        (total, metrics), grads = grad_fn(local, batch)
    return {"total": float(total),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "dispatch": seen, "grads": _np(grads),
            "router_norm": float(SCH.router_grad_norm(grads, specs, mesh)),
            "wi": _wi_shape(local), "coords": dict(mesh.coords)}


def ops_case(mesh):
    """The MoE blocks' two new uses of the tensor-parallel ops, forward
    and backward: the router gather (kind "tp_router") against the plain
    all-gather, with this rank's slice of the gradient; the gates' entry
    (kind "tp_gate_grad") the identity, with the gradient summed over the
    group."""
    group = mesh.groups["model"]
    r = dist.get_rank(group)
    gen = torch.Generator().manual_seed(41 + mesh.rank)
    t = torch.randn(6, 4, generator=gen, requires_grad=True)
    g = torch.randn(6, 8, generator=torch.Generator().manual_seed(43))
    u = torch.randn(3, 5, 2, generator=gen, requires_grad=True)
    gu = torch.randn(3, 5, 2, generator=gen)
    with comm.model_axis(group):
        w = comm.tp_gather_last(t, kind="tp_router")
        (w * g).sum().backward()
        e = comm.tp_enter(u, kind="tp_gate_grad")
        (e * gu).sum().backward()
    return {"router_gather": bool(torch.equal(
                w, comm.all_gather(t.detach(), group, 1))),
            "router_grad_slice": bool(torch.equal(
                t.grad, g[:, 4 * r:4 * (r + 1)])),
            "gate_forward": bool(torch.equal(e, u)),
            "gate_grad_sum": bool(torch.equal(
                u.grad, comm.all_reduce(gu, group)))}


def remat_replay(mesh, params_np, batches_np, lr):
    """Reduced mixtral under EP, the scan schedule of two microbatches,
    two steps: a run without remat keeps its routes on a keyed tape; a
    run under remat "full" from the same params takes them (forced), its
    recompute in the backward routing again under its forward's key. The
    two runs' call keys, tapes and metrics."""
    cfg = cfg_of("mixtral-8x7b")
    specs = specs_of(cfg, mesh, True)

    def run(remat, forced):
        local = params_from_jax(params_np, cfg, "cpu", mesh=mesh,
                                spec_tree=specs)
        tcfg = TrainStepConfig(remat=remat, microbatches=2,
                               optimizer=TO.OptimizerConfig(lr=lr),
                               warmup_steps=2, total_steps=10)
        step = SCH.make_train_step(cfg, tcfg, mesh=mesh, spec_tree=specs)
        state = TO.init_state(tcfg.optimizer, local)
        tape = MOE.RouteTape(forced, keyed=True)
        hist = []
        with MOE.routing(tape):
            for i, b in enumerate(batches_np):
                local, state, m = step(local, state, {
                    k: torch.from_numpy(v) for k, v in b.items()}, i)
                hist.append({k: float(v) for k, v in m.items()})
        return tape, hist

    plain, h_plain = run("none", None)
    remat, h_remat = run("full", plain.calls)
    same = (sorted(plain.calls, key=repr) == sorted(remat.calls, key=repr)
            and all(torch.equal(a, b) for k in plain.calls
                    for a, b in zip(plain.calls[k], remat.calls[k])))
    return {"keys_plain": plain.keys, "keys_remat": remat.keys,
            "same_routes": same, "metrics_plain": h_plain,
            "metrics_remat": h_remat}


# ---------------------------------------------------------------------------
# Checkpoints of the two expert layouts
# ---------------------------------------------------------------------------

CK_ARCH = "mixtral-8x7b"
CK_OPT = TO.OptimizerConfig(kind="adafactor")


def ckpt_target(cfg, mesh, ep, gen_seed=9):
    """({"params", "opt"} of this rank's shapes under Strategy(ep=ep), its
    spec tree)."""
    specs = specs_of(cfg, mesh, ep)
    params = S.local_shard(init_params(torch.Generator().manual_seed(
        gen_seed), cfg, "cpu"), specs, mesh)
    return ({"params": params, "opt": TO.init_state(CK_OPT, params)},
            {"params": specs, "opt": TO.state_specs(CK_OPT, specs)})


def ckpt_world(mesh_m, mesh_d, params_np, batches_np, ckpt_dir):
    """Two Adafactor steps of reduced mixtral (bf16) on model:2 under EP,
    its checkpoint saved (the ranks' state returned); then restored onto
    data:2 and onto model:2 under TP inside the experts."""
    cfg = cfg_of(CK_ARCH, f32=False)
    specs = specs_of(cfg, mesh_m, True)
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
    CK.save(ckpt_dir, 2, tree, extra={"step": 2}, mesh=mesh_m,
            spec_tree={"params": specs,
                       "opt": TO.state_specs(CK_OPT, specs)})
    dist.barrier()                     # rank 0 has written it
    out = {"saved": _np(tree), "coords_m": dict(mesh_m.coords),
           "coords_d": dict(mesh_d.coords)}
    for name, mesh, ep in (("on_data", mesh_d, True),
                           ("on_tp", mesh_m, False)):
        target, tspecs = ckpt_target(cfg, mesh, ep)
        out[name] = _np(CK.restore(ckpt_dir, target, device="cpu",
                                   mesh=mesh, spec_tree=tspecs)[0])
    out["wi_tp"] = _wi_shape(out["on_tp"]["params"])
    return out


# ---------------------------------------------------------------------------
# The worlds
# ---------------------------------------------------------------------------

def model2_world(device, cases, grads, setups, lr, ck_params, ck_batches,
                 ckpt_dir):
    """Every model:2 check in one world of two ranks: the train cases, the
    gradient cases ((arch, ep) pairs), the ops, the remat replay and the
    checkpoints."""
    mesh = LM.build_mesh({"model": 2})
    out = {"train": {case: train_case(mesh, case[0], case[1],
                                      setups[case[0]][0],
                                      setups[case[0]][1], *case[2:], lr)
                     for case in cases},
           "grads": {(arch, ep): grad_case(mesh, arch, ep, setups[arch][0],
                                           setups[arch][1][0])
                     for arch, ep in grads},
           "ops": ops_case(mesh),
           "remat": remat_replay(mesh, setups["mixtral-8x7b"][0],
                                 setups["mixtral-8x7b"][1], lr)}
    out["ckpt"] = ckpt_world(mesh, LM.build_mesh({"data": 2}), ck_params,
                             ck_batches, ckpt_dir)
    return out


def train_world(device, mesh_shape, cases, setups, lr):
    """Every train case of one mesh in one world of ranks: {case: result}."""
    mesh = LM.build_mesh(mesh_shape)
    return {case: train_case(mesh, case[0], case[1], setups[case[0]][0],
                             setups[case[0]][1], *case[2:], lr)
            for case in cases}


def rank_slices(full, specs, mesh):
    """This rank's block of every leaf of a full numpy tree."""
    return tree_map(lambda a, s: np.asarray(S.local_slice(a, s, mesh)),
                    full, specs)
