"""Rank functions of the multi-rank port tests: each runs in a process that
launch.mesh.spawn_ranks starts (gloo over the CPU), imports neither jax
nor the reference package, and returns numpy arrays or numbers for the
parent test to hold against the reference."""
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import depth_variant
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.launch import mesh as LM
from repro_torch.models import init_params
from repro_torch.optim import optimizers as TO
from repro_torch.optim.compress import compressed_psum
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as S
from repro_torch.parallel.axes import Spec
from repro_torch.parallel.pipeline import pipeline_1f1b, split_stages
from repro_torch.runtime import schedule as SCH
from repro_torch.runtime.train_step import TrainStepConfig
from repro_torch.search import execplan as XP
from repro_torch.tree import tree_map

TIMEOUT = 120       # seconds a multi-rank test may take


def spawn(fn, world, *args):
    return LM.spawn_ranks(fn, world, "gloo", "cpu", args=args,
                          timeout=TIMEOUT)


def cfg_of(arch, depth, f32=True):
    import dataclasses
    cfg = depth_variant(get_config(arch).reduced(), depth)
    return dataclasses.replace(cfg, param_dtype="float32") if f32 else cfg


def strategy_for(mesh_shape):
    return S.Strategy(pipeline=mesh_shape.get("pipe", 1) > 1)


def sharded(cfg, params, mesh_shape):
    """(mesh, spec tree, this rank's shards) of a full params tree."""
    mesh = LM.build_mesh(mesh_shape)
    specs = S.param_specs(cfg, init_params(None, cfg, device="meta"),
                          strategy_for(mesh_shape), mesh)
    return mesh, specs, S.local_shard(params, specs, mesh)


def full_np(tree, specs, mesh):
    with torch.no_grad():
        return to_numpy(S.gather_tree(tree, specs, mesh))


# ---------------------------------------------------------------------------

GATHER_LEAVES = (((8, 6), (("pipe", "data"), None)),
                 ((4, 6, 10), ("pipe", "data", None)),
                 ((6, 4), (None, "data")),
                 ((5,), (None,)))


def gather_roundtrip(device):
    """local_shard then gather_tree on data:2,pipe:2: the leaves back, and
    each shard's gradient of sum(leaf * (rank + 1)) (the reduce-scatter
    sum over the ranks that gathered it); and the same through comm's
    nccl branch (NCCL's tensor all-gather and reduce-scatter, which gloo
    also runs), bit for bit."""
    mesh = LM.build_mesh({"pipe": 2, "data": 2})
    gen = torch.Generator().manual_seed(5)
    full = [torch.randn(shape, generator=gen) for shape, _ in GATHER_LEAVES]
    specs = [Spec(spec) for _, spec in GATHER_LEAVES]
    local = [t.requires_grad_(True)
             for t in S.local_shard(full, specs, mesh)]

    def roundtrip():
        for t in local:
            t.grad = None
        back = S.gather_tree(local, specs, mesh)
        sum(((b * (mesh.rank + 1)).sum() for b in back)).backward()
        return back, [t.grad.clone() for t in local]

    back, grads = roundtrip()
    gloo = comm._gloo
    comm._gloo = lambda group: False
    try:
        back_t, grads_t = roundtrip()
    finally:
        comm._gloo = gloo
    return {"rank": mesh.rank, "coords": dict(mesh.coords),
            "equal": [bool(torch.equal(b, f)) for b, f in zip(back, full)],
            "tensor_path": all(torch.equal(a, b) for a, b in
                               zip(back + grads, back_t + grads_t)),
            "shapes": [tuple(t.shape) for t in local],
            "grads": [g.numpy() for g in grads]}


def _stage_layers(ws, x):
    for w in ws:
        x = torch.tanh(x @ w)
    return x


def _run_1f1b(stage_fn, mine, x, mesh, dtype):
    """pipeline_1f1b over x's microbatches with the loss sum(y ** 2) of
    each; the last stage's outputs (None on other stages)."""
    outs = []

    def last(i, y):
        outs.append(y.detach())
        return [(y.to(torch.float32) ** 2).sum()], None

    pipeline_1f1b(stage_fn, mine, x.shape[0], mesh=mesh,
                  carry=(tuple(x.shape[1:]), dtype, x.device),
                  first=lambda i, grad: x[i], last=last)
    return torch.stack(outs) if outs else None


def pipeline_vs_sequence(device, n_stages):
    """pipeline_1f1b over pipe:n_stages against the stages run in
    sequence: the last stage's outputs and every stage's gradients (f32),
    and the mixed-dtype stage (bf16 weights and input, f32 output, so an
    f32 carry)."""
    mesh = LM.build_mesh({"pipe": n_stages})
    gen = torch.Generator().manual_seed(0)
    d, n_layers, n_micro, mb = 16, 8, 8, 4
    ws = torch.randn(n_layers, d, d, generator=gen) * 0.3
    x = torch.randn(n_micro, mb, d, generator=gen)
    s = mesh.coords["pipe"]
    mine = split_stages({"w": ws}, n_stages)["w"][s].clone().requires_grad_()
    xp = x.clone().requires_grad_()
    out = _run_1f1b(_stage_layers, mine, xp, mesh, torch.float32)
    wr, xr = ws.clone().requires_grad_(), x.clone().requires_grad_()
    ref = torch.stack([_stage_layers(wr, xr[i]) for i in range(n_micro)])
    (ref ** 2).sum().backward()
    per = n_layers // n_stages
    first, last = s == 0, s == n_stages - 1
    res = {"out": float((out - ref).detach().abs().max()) if last else 0.0,
           "gw": float((mine.grad - wr.grad[s * per:(s + 1) * per])
                       .abs().max()),
           "gx": float((xp.grad - xr.grad).abs().max()) if first else 0.0,
           "gx_elsewhere": xp.grad is None or first}

    wb = (torch.randn(n_stages, d, d, generator=gen) * 0.3).to(torch.bfloat16)
    xb = torch.randn(n_micro, mb, d, generator=gen).to(torch.bfloat16)

    def mixed(w, xx):
        return torch.tanh(xx.to(torch.bfloat16) @ w[0]).to(torch.float32)

    outb = _run_1f1b(mixed, wb[s:s + 1].clone().requires_grad_(), xb, mesh,
                     torch.float32)
    refb = xb
    for i in range(n_stages):
        refb = mixed(wb[i:i + 1], refb)
    res["mixed_dtype"] = str(outb.dtype) if last else "torch.float32"
    res["mixed"] = float((outb - refb).abs().max()) if last else 0.0
    return res


def pipeline_loss(device, arch, depth, params_np, batch_np, micro):
    """make_pipeline_loss_fn on data:2,pipe:2: total, loss and the full
    gradients (gathered), from rank 0."""
    cfg = cfg_of(arch, depth)
    params = params_from_jax(params_np, cfg, "cpu")
    mesh, specs, local = sharded(cfg, params, {"data": 2, "pipe": 2})
    tcfg = TrainStepConfig(microbatches=micro)
    fn = SCH.make_pipeline_loss_fn(cfg, tcfg, mesh, specs)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    (total, met), grads = fn(local, batch)
    g = full_np(grads, specs, mesh)
    return {"total": float(total), "loss": float(met["loss"]),
            "grads": g if mesh.rank == 0 else None}


def train_steps(device, arch, depth, params_np, batches_np, mesh_shape,
                micro, kinds, lr, remat="none"):
    """make_train_step steps from the same params under each optimizer
    kind on a mesh: metrics and the full updated params, from rank 0."""
    cfg = cfg_of(arch, depth)
    out = {}
    for kind in kinds:
        params = params_from_jax(params_np, cfg, "cpu")
        mesh, specs, local = sharded(cfg, params, mesh_shape)
        tcfg = TrainStepConfig(remat=remat, microbatches=micro,
                               optimizer=TO.OptimizerConfig(kind=kind, lr=lr),
                               warmup_steps=2, total_steps=10)
        step = SCH.make_train_step(cfg, tcfg, mesh=mesh, spec_tree=specs)
        state = TO.init_state(tcfg.optimizer, local)
        hist = []
        for i, b in enumerate(batches_np):
            batch = {k: torch.from_numpy(v) for k, v in b.items()}
            local, state, m = step(local, state, batch, i)
            hist.append({k: float(v) for k, v in m.items()})
        out[kind] = {"schedule": step.schedule, "metrics": hist,
                     "params": full_np(local, specs, mesh)}
    return out if dist.get_rank() == 0 else None


def psum_case(device, n_seeds):
    """compressed_psum over data:2: the error of one call against the exact
    mean, the shared scale, and the mean over `n_seeds` generators."""
    mesh = LM.build_mesh({"data": 2})
    r = mesh.coords["data"]
    xs = [torch.arange(64, dtype=torch.float32).reshape(8, 8) / 7.0 + k
          for k in range(2)]
    xs[1] = -xs[1] * 0.37
    x = xs[r]
    want = (xs[0] + xs[1]) / 2
    scale = max(float(t.abs().max()) for t in xs) / 127.0
    group = mesh.groups["data"]
    one = compressed_psum(x, group, torch.Generator().manual_seed(100 + r))
    acc = torch.zeros_like(x, dtype=torch.float64)
    for seed in range(n_seeds):
        acc += compressed_psum(
            x, group, torch.Generator().manual_seed(1000 * seed + r)).double()
    return {"err": float((one - want).abs().max()), "scale": scale,
            "bias": float((acc / n_seeds - want.double()).abs().max())}


def save_sharded(device, arch, depth, params_np, ckpt_dir, step):
    """Save {"params", "opt"} from data:2 shards (rank 0 writes)."""
    from repro_torch.checkpoint import ckpt as CK
    cfg = cfg_of(arch, depth, f32=False)
    params = params_from_jax(params_np, cfg, "cpu")
    mesh, specs, local = sharded(cfg, params, {"data": 2})
    ocfg = TO.OptimizerConfig(kind="adafactor")
    state = TO.init_state(ocfg, local)
    tree_map(lambda t: t.add_(0.25), state["f"])
    CK.save(ckpt_dir, step, {"params": local, "opt": state},
            extra={"step": step}, mesh=mesh,
            spec_tree={"params": specs, "opt": TO.state_specs(ocfg, specs)})
    return mesh.rank


def restore_sharded(device, arch, depth, ckpt_dir, mesh_shape):
    """Restore that checkpoint onto `mesh_shape`: this rank's leaves and
    its coordinates."""
    from repro_torch.checkpoint import ckpt as CK
    cfg = cfg_of(arch, depth, f32=False)
    mesh = LM.build_mesh(mesh_shape)
    specs = S.param_specs(cfg, init_params(None, cfg, device="meta"),
                          strategy_for(mesh_shape), mesh)
    ocfg = TO.OptimizerConfig(kind="adafactor")
    target = {"params": S.local_shard(init_params(
        torch.Generator().manual_seed(9), cfg, "cpu"), specs, mesh)}
    target["opt"] = TO.init_state(ocfg, target["params"])
    tree, manifest = CK.restore(
        ckpt_dir, target, device="cpu", mesh=mesh,
        spec_tree={"params": specs, "opt": TO.state_specs(ocfg, specs)})
    return {"coords": dict(mesh.coords), "tree": to_numpy(tree),
            "specs": {"params": specs, "opt": TO.state_specs(ocfg, specs)},
            "step": manifest["step"]}


def build_live(device):
    """ExecutionPlan.build over a live world of 2: the mesh of a 2-rank
    plan, and the refusal of a 4-rank one."""
    two = XP.ExecutionPlan(mesh_axes=(("data", 2),))
    mesh, strategy = two.build()
    four = XP.ExecutionPlan(mesh_axes=(("data", 2), ("pipe", 2)))
    try:
        four.build()
        refusal = None
    except ValueError as e:
        refusal = str(e)
    return {"axes": mesh.axis_names, "shape": mesh.shape,
            "coords": dict(mesh.coords), "groups": sorted(mesh.groups),
            "fsdp": strategy.fsdp, "refusal": refusal}



# ---------------------------------------------------------------------------
# nccl on cards of their own (tests/test_torch_nccl.py; needs the cards)
# ---------------------------------------------------------------------------

def nccl_vs_gloo(device):
    """comm's collectives over the nccl world and over a gloo group of the
    same ranks, on CUDA tensors of small integers (so every sum is exact
    in any order): whether each result is equal, whether nccl's lie on
    this rank's card, and the bytes each staged through the host."""
    from repro_torch.parallel import comm
    world, rank = dist.get_world_size(), dist.get_rank()
    gloo = dist.new_group(backend="gloo")
    gen = torch.Generator(device=device).manual_seed(rank)
    t = torch.randint(-8, 8, (world * 4, 2 * world), generator=gen,
                      device=device).to(torch.float32)
    partner = rank ^ 1
    res = {}
    for name, group in (("nccl", dist.group.WORLD), ("gloo", gloo)):
        staged = comm.staged_bytes
        out = [comm.all_reduce(t, group), comm.all_reduce(t, group, "max"),
               comm.all_gather(t, group, 0), comm.all_gather(t, group, 1),
               comm.reduce_scatter(t, group, 0),
               comm.reduce_scatter(t, group, 1),
               comm.broadcast(t, group, world - 1)]
        # even ranks send first, odd ranks receive first: nccl runs a
        # rank's sends and receives to one peer in order on one stream,
        # so two ranks that both sent first could wait on each other (the
        # pipeline's sends never cross so)
        if rank % 2 == 0:
            sent = comm.isend(t * (rank + 1), partner, group)
            out.append(comm.recv(t.shape, t.dtype, device, partner, group))
        else:
            out.append(comm.recv(t.shape, t.dtype, device, partner, group))
            sent = comm.isend(t * (rank + 1), partner, group)
        sent.wait()
        shard = t.clone().requires_grad_()
        (comm.AllGather.apply(shard, group, 1) * (rank + 1)).sum().backward()
        out.append(shard.grad)
        res[name] = (out, comm.staged_bytes - staged)
    return {"equal": [bool(torch.equal(a, b)) for a, b in
                      zip(res["nccl"][0], res["gloo"][0])],
            "on_card": all(x.device == device for x in res["nccl"][0]),
            "staged": {k: v[1] for k, v in res.items()},
            "device": str(device)}
