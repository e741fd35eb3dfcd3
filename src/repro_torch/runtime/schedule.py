"""Schedule-aware train-step factory: HOW a step executes its microbatches,
after the reference package's runtime/schedule.py.

  single        — one forward/backward over the whole batch.
  scan          — microbatch accumulation (the plan's transient-shrinking
                  knob): a Python loop over the microbatches with an f32
                  gradient accumulator, divided by their number.
  pipeline_1f1b — the pipe-axis runtime: the stacked unit layers are split
                  into mesh.shape["pipe"] contiguous stages, one a rank,
                  and driven through parallel.pipeline.pipeline_1f1b; the
                  embedding runs on the first stage, the tail, final norm,
                  head and loss on the last. Each stage keeps at most its
                  in-flight boundary carries (stage bodies run again in the
                  backward), the in-flight transient core.predictor
                  assumes for pipe > 1.

On a mesh of more than one rank (`launch.mesh.Mesh`) the params are this
rank's shards under `spec_tree`: weights split over "data" are gathered
where they are used (FSDP, parallel.sharding.Gatherer) and their
gradients reduce-scattered; every rank reads the same global batch and
keeps its rows of each microbatch; the gradient is the mean over the data
axes, and the leaves a stage shares with the others (embedding, final
norm, head) take the sum of the stages' gradients, so they stay equal.
A "model" axis runs the single and scan schedules tensor-parallel: the
forward and backward inside `comm.model_axis`, whose collectives carry
their gradients, so each rank's shards get their own gradients and the
leaves it replicates (norms) the same gradient on every model rank.

`make_train_step(cfg, tcfg, mesh=..., schedule="auto")` dispatches; the
`runtime.train_step.make_train_step(cfg, tcfg)` facade delegates here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import TRAIN, ModelConfig
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models.layers import cross_entropy
from repro_torch.optim import optimizers as opt
from repro_torch.optim.compress import compress_roundtrip
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.parallel import comm
from repro_torch.parallel import pipeline as PPL
from repro_torch.parallel import sharding as S
from repro_torch.runtime.schedule_kinds import (  # noqa: F401 — re-exported vocabulary
    SCHEDULE_PIPELINE, SCHEDULE_SCAN, SCHEDULE_SINGLE, SCHEDULES,
    pipeline_problems, schedule_kind)
from repro_torch.runtime.train_step import (TrainStepConfig, _trainable,
                                            grads_like, make_loss_fn,
                                            remat_wrapper, value_and_grad)
from repro_torch.tree import tree_leaves, tree_map, tree_paths

DATA_AXES = ("pod", "data")

_NOT_PORTED = "is not ported: ROADMAP queue A item 5"


def model_axis_problems(cfg: ModelConfig, m: int,
                        kv_shard: str = "heads") -> list:
    """Why `cfg` cannot run tensor-parallel on a model axis of `m` with
    the cache layout `kv_shard` (empty: it can): the archs without
    recurrent blocks (MoE blocks run under expert parallelism, or tensor
    parallelism inside the experts: models.moe), heads, kv heads, d_ff and
    the padded vocab split over the axis, the cache over kv heads. Serving
    and training share this list. Each reason names ROADMAP queue A item
    5."""
    out = []
    if m <= 1:
        return out
    if any(b.is_recurrent for b in cfg.blocks()):
        out.append(f"a model axis above 1 over recurrent blocks (the "
                   f"'inner' / 'lru' widths) {_NOT_PORTED}")
    if cfg.n_kv_heads % m:
        out.append(f"kv_shard='seq' ({cfg.n_kv_heads} kv heads do not "
                   f"split over model:{m}; the cache would shard its "
                   f"sequence) {_NOT_PORTED}")
    elif kv_shard == "seq":
        out.append(f"kv_shard='seq' (a plan that shards the cache's "
                   f"sequence over model:{m}) {_NOT_PORTED}")
    if cfg.n_heads % m:
        out.append(f"{cfg.n_heads} query heads that do not split over "
                   f"model:{m} {_NOT_PORTED}")
    for name, n in (("padded vocab", cfg.padded_vocab_size),
                    ("d_ff", cfg.d_ff)):
        if n % m:
            out.append(f"a {name} of {n} that does not split over "
                       f"model:{m} {_NOT_PORTED}")
    return out


def serving_mesh_problems(cfg: ModelConfig, mesh_shape,
                          kv_shard: str = "heads") -> list:
    """Why serving cannot run on `mesh_shape` ({axis: size}) with the
    cache layout `kv_shard`: serving is tensor-parallel over "model"
    (model_axis_problems), every other axis of size 1. Each reason names
    ROADMAP queue A item 5."""
    out = []
    for axis in ("pod", "data", "pipe"):
        if int(mesh_shape.get(axis, 1)) > 1:
            out.append(f"serving over a {axis!r} axis above 1 (the paged "
                       f"pool's blocks sharded over it) {_NOT_PORTED}")
    return out + model_axis_problems(cfg, int(mesh_shape.get("model", 1)),
                                     kv_shard)


def _check(problems, cfg, mesh_shape):
    if problems:
        raise NotImplementedError(f"{cfg.name} on {dict(mesh_shape)}: "
                                  f"{problems[0]}")


def check_serving_mesh(cfg: ModelConfig, mesh_shape,
                       kv_shard: str = "heads"):
    """Raise NotImplementedError with serving_mesh_problems' first reason."""
    _check(serving_mesh_problems(cfg, mesh_shape, kv_shard), cfg,
           mesh_shape)


def check_training_mesh(cfg: ModelConfig, mesh_shape,
                        kv_shard: str = "heads"):
    """Raise NotImplementedError with the first reason the single and scan
    schedules cannot train on `mesh_shape`: model_axis_problems of its
    model axis (MoE blocks train there, under expert parallelism or tensor
    parallelism inside the experts; recurrent blocks do not; a model axis
    inside the pipeline is validate_pipeline's refusal, the reference's)."""
    _check(model_axis_problems(cfg, int(mesh_shape.get("model", 1)),
                               kv_shard), cfg, mesh_shape)


def _shape_of(mesh):
    return dict(getattr(mesh, "shape", mesh))


def pipe_size_of(mesh) -> int:
    """Pipeline-stage count of a Mesh or {axis: size} dict (1 = none)."""
    if mesh is None:
        return 1
    return int(_shape_of(mesh).get("pipe", 1))


def validate_pipeline(cfg: ModelConfig, tcfg: TrainStepConfig, mesh) -> int:
    """Check (cfg, tcfg, mesh) is executable by the 1F1B schedule; returns
    the stage count. One predicate (schedule_kinds.pipeline_problems) is
    shared with the search space and the predictor, so a planned candidate
    is exactly a runnable one."""
    pipe = pipe_size_of(mesh)
    problems = []
    if pipe <= 1:
        problems.append("mesh has no pipe axis of size > 1")
    problems += pipeline_problems(cfg, tcfg.microbatches, _shape_of(mesh))
    if problems:
        raise ValueError("pipeline_1f1b schedule not executable: "
                         + "; ".join(problems))
    return pipe


def fallback_schedule(cfg: ModelConfig, tcfg: TrainStepConfig, mesh,
                      global_batch: Optional[int] = None) -> str:
    """Best-effort schedule for a measurement probe: the pipeline kind when
    (cfg, tcfg, mesh) is executable, else scan/single on the same mesh."""
    kind = schedule_kind(TRAIN, tcfg.microbatches, pipe_size_of(mesh))
    if kind == SCHEDULE_PIPELINE:
        if pipeline_problems(cfg, tcfg.microbatches, _shape_of(mesh),
                             global_batch):
            return (SCHEDULE_SCAN if tcfg.microbatches > 1
                    else SCHEDULE_SINGLE)
    return kind


# ---------------------------------------------------------------------------
# Meshes: rows, gradient and metric reductions
# ---------------------------------------------------------------------------

def _live_axes(mesh, names):
    return [a for a in names if mesh.axis_size(a) > 1]


def data_parallel(mesh) -> int:
    n = 1
    for a in _live_axes(mesh, DATA_AXES):
        n *= mesh.shape[a]
    return n


def data_rows(batch, mesh, n_micro: int):
    """This rank's rows of the global batch: of each of the n_micro
    microbatches (contiguous row ranges, in order) its data-axes share, in
    microbatch order, so a local split into n_micro equal parts gives its
    share of each global microbatch."""
    dp = data_parallel(mesh)
    b = batch["tokens"].shape[0]
    if b % n_micro:
        raise ValueError(f"global batch {b} not divisible by "
                         f"microbatches={n_micro}")
    mb = b // n_micro
    if mb % dp:
        raise ValueError(
            f"per-microbatch batch {mb} not divisible by the data axes "
            f"(dp={dp}): each microbatch's rows split over them; lower "
            "microbatches or the data axis")
    if dp == 1:
        return batch
    d = 0
    for a in _live_axes(mesh, DATA_AXES):
        d = d * mesh.shape[a] + mesh.coords[a]
    n = mb // dp
    rows = torch.cat([torch.arange(i * mb + d * n, i * mb + (d + 1) * n)
                      for i in range(n_micro)])
    return {k: v[rows.to(v.device)] for k, v in batch.items()}


def sync_grads(grads, spec_tree, mesh):
    """IN PLACE: each leaf's gradient summed over the data and pipe axes
    that do not shard it (a leaf split over "data" had its sum in the
    gather's reduce-scatter), then divided by the data-parallel degree:
    the mean over the data ranks' losses, and for a leaf every stage holds,
    the sum of the stages' parts. The "model" axis is left unreduced: a
    leaf split over it has its own gradient on each rank, and a leaf it
    replicates has the same gradient on every model rank already (the
    tensor-parallel collectives' backward, parallel.comm), so a sum would
    count it M times."""
    axes = _live_axes(mesh, DATA_AXES + ("pipe",))
    dp = data_parallel(mesh)

    def one(g, spec):
        for a in axes:
            if a not in spec.axes():
                g.copy_(comm.all_reduce(g, mesh.groups[a]))
        if dp > 1:
            g.div_(dp)
        return g

    return tree_map(one, grads, spec_tree)


def mean_metrics(metrics, mesh):
    """Each metric's mean over the data ranks."""
    axes = _live_axes(mesh, DATA_AXES)
    if not axes:
        return metrics
    keys = list(metrics)
    v = torch.stack([metrics[k].to(torch.float32) for k in keys])
    for a in axes:
        v = comm.all_reduce(v, mesh.groups[a])
    v = v / data_parallel(mesh)
    return {k: v[i] for i, k in enumerate(keys)}


def fsdp_axes(mesh):
    """The axes a rank gathers weights over: every mesh axis but "pipe"
    (a stage keeps its own layers) and "model" (tensor parallelism keeps
    its shards local)."""
    return [a for a in mesh.axis_names if a not in ("pipe", "model")]


def model_group_of(mesh):
    """The mesh's model group where its model axis is above 1, else
    None (what `comm.model_axis` takes)."""
    if mesh is None or mesh.axis_size("model") <= 1:
        return None
    return mesh.groups["model"]


# ---------------------------------------------------------------------------
# The 1F1B pipeline loss
# ---------------------------------------------------------------------------

def make_pipeline_loss_fn(cfg: ModelConfig, tcfg: TrainStepConfig, mesh,
                          spec_tree, axis: str = "pipe"):
    """fn(params, batch) -> ((total, metrics), grads) whose forward runs
    the unit stack as a 1F1B pipeline over mesh axis `axis`. `params` are
    this rank's shards under `spec_tree`, `batch` the global batch (the
    same on every rank). The embedding runs on the first stage; the tail,
    final norm, head and loss on the last. Because 1F1B runs a
    microbatch's backward before later microbatches' forwards, the
    function computes the gradients itself: `grads` are this rank's
    shards' gradients of the total, reduced over the mesh (sync_grads),
    and total and metrics are every rank's."""
    n_stages = validate_pipeline(cfg, tcfg, mesh)
    n_micro = tcfg.microbatches
    settings = tcfg.settings
    remat = remat_wrapper(tcfg.remat)
    gat = S.Gatherer(spec_tree, mesh, fsdp_axes(mesh))
    wrapper = gat.unit_wrapper(None if tcfg.remat == "none" else remat)
    head_keys = [k for k in spec_tree if k not in ("units", "embed")]
    if cfg.tie_embeddings:
        head_keys.append("embed")

    def fn(params, batch):
        local = data_rows(batch, mesh, n_micro)
        tokens, targets = local["tokens"], local["targets"]
        mb, s = tokens.shape[0] // n_micro, tokens.shape[1]
        tree, leaves = _trainable(params)
        pos = torch.arange(s, dtype=torch.int32,
                           device=tokens.device)[None].expand(mb, s)
        stage_dtype = layers.torch_dtype(cfg.param_dtype)
        sums = torch.zeros(4, dtype=torch.float32, device=tokens.device)

        def first(i, grad):
            with torch.set_grad_enabled(grad):
                table = gat.gather(tree["embed"], spec_tree["embed"])
                return layers.embed_lookup(table, cfg,
                                           tokens[i * mb:(i + 1) * mb])

        def stage(units, x):
            return M.unit_stack_forward(units, cfg, x, pos,
                                        settings=settings, context=s,
                                        unit_wrapper=wrapper)[0]

        def last(i, y):
            with gat.saving() as gather:
                rest = gather({k: tree[k] for k in head_keys},
                              {k: spec_tree[k] for k in head_keys})
                logits, aux = M.tail_head_forward(
                    dict(rest), cfg, y, pos, settings=settings, context=s)
            loss = cross_entropy(logits, targets[i * mb:(i + 1) * mb])
            total = (loss + tcfg.lb_coef * aux["lb_loss"]
                     + tcfg.z_coef * aux["z_loss"])
            sums.add_(torch.stack([total, loss, aux["lb_loss"],
                                   aux["z_loss"]]).detach())
            return [total / n_micro], None

        PPL.pipeline_1f1b(stage, tree["units"], n_micro, mesh=mesh,
                          axis=axis,
                          carry=((mb, s, cfg.d_model), stage_dtype,
                                 tokens.device),
                          first=first, last=last)
        grads = grads_like(params, leaves, [t.grad for t in leaves])
        sync_grads(grads, spec_tree, mesh)
        out = comm.broadcast(sums / n_micro, mesh.groups[axis],
                             mesh.rank_at(**{axis: n_stages - 1}))
        m = mean_metrics({"total": out[0], "loss": out[1],
                          "lb_loss": out[2], "z_loss": out[3]}, mesh)
        total = m.pop("total")
        return (total, m), grads

    return fn


# ---------------------------------------------------------------------------
# Gradient schedules
# ---------------------------------------------------------------------------

def _single_shot(grad_fn):
    def compute(params, batch):
        (_, metrics), grads = grad_fn(params, batch)
        return grads, metrics
    return compute


def _scan_accum(grad_fn, n_micro: int):
    def compute(params, batch):
        b = batch["tokens"].shape[0]
        if b % n_micro:
            raise ValueError(f"global batch {b} not divisible by "
                             f"microbatches={n_micro}")
        mb = b // n_micro
        gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        macc = None
        for i in range(n_micro):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            with MOE.site(micro=i):
                (_, met), g = grad_fn(params, micro)
            with torch.no_grad():
                tree_map(lambda a, g_: a.add_(g_.to(torch.float32)), gacc, g)
            del g
            macc = met if macc is None else {k: macc[k] + met[k]
                                             for k in macc}
        with torch.no_grad():
            tree_map(lambda a: a.div_(n_micro), gacc)
        return gacc, {k: v / n_micro for k, v in macc.items()}
    return compute


# ---------------------------------------------------------------------------
# The factory
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, tcfg: TrainStepConfig, *,
                    mesh=None, schedule: str = "auto", spec_tree=None):
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics): params and opt_state are updated IN PLACE and
    returned; metrics maps "loss", "lb_loss", "z_loss", "grad_norm" and
    "lr" to 0-d f32 tensors, and for a MoE arch "router_grad_norm" (the
    routers' part of the gradient norm before clipping, router_grad_norm).

    schedule: "auto" resolves from tcfg.microbatches and the mesh's pipe
    axis; or one of SCHEDULES explicitly. The chosen kind is exposed as
    `train_step.schedule`. The scan schedule's gradients are the f32
    accumulator (as the reference's), so the update reads f32 gradients
    there and the parameters' dtype under the single schedule.

    On a `launch.mesh.Mesh` of more than one rank, params and opt_state
    are this rank's shards under `spec_tree` (sharding.param_specs;
    required there), `batch` the global batch. The pipeline schedule
    needs such a mesh; a model axis runs the single and scan schedules
    (check_training_mesh) and not the pipeline (validate_pipeline)."""
    if schedule == "auto":
        schedule = schedule_kind(TRAIN, tcfg.microbatches, pipe_size_of(mesh))
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; known: {SCHEDULES}")
    sharded = mesh is not None and getattr(mesh, "size", 1) > 1
    if schedule == SCHEDULE_PIPELINE and not (sharded and mesh.groups):
        raise ValueError("pipeline_1f1b schedule needs a mesh of ranks "
                         "(launch.mesh.Mesh)")
    if sharded:
        if schedule != SCHEDULE_PIPELINE:
            check_training_mesh(cfg, mesh.shape)
        if spec_tree is None:
            raise ValueError("a mesh of more than one rank needs the "
                             "params' spec_tree")
    if schedule == SCHEDULE_PIPELINE:
        compute_grads = _single_shot(make_pipeline_loss_fn(cfg, tcfg, mesh,
                                                           spec_tree))
    else:
        gat = (S.Gatherer(spec_tree, mesh, fsdp_axes(mesh))
               if sharded and _live_axes(mesh, fsdp_axes(mesh)) else None)
        grad_fn = value_and_grad(make_loss_fn(cfg, tcfg, gat))
        if schedule == SCHEDULE_SCAN:
            if tcfg.microbatches <= 1:
                raise ValueError("scan schedule needs microbatches > 1")
            compute_grads = _scan_accum(grad_fn, tcfg.microbatches)
        else:
            compute_grads = _single_shot(grad_fn)
        if sharded:
            compute_grads = _on_mesh(compute_grads, mesh, spec_tree,
                                     tcfg.microbatches)
    if not sharded:
        spec_tree = None

    def train_step(params, opt_state, batch, step):
        with MOE.site(step=int(step)):
            grads, metrics = compute_grads(params, batch)
        metrics = dict(metrics)
        if cfg.is_moe:
            metrics["router_grad_norm"] = router_grad_norm(grads, spec_tree,
                                                           mesh)
        if tcfg.compress_grads:
            dev = tree_leaves(params)[0].device
            gen = torch.Generator(device=dev).manual_seed(
                (17 << 32) + int(step))
            grads = compress_roundtrip(grads, gen)
        grads, gnorm = opt.clip_by_global_norm(grads, tcfg.max_grad_norm,
                                               spec_tree, mesh)
        lr = warmup_cosine(int(step), tcfg.optimizer.lr, tcfg.warmup_steps,
                           tcfg.total_steps)
        params, opt_state = opt.apply_updates(tcfg.optimizer, params, grads,
                                              opt_state, lr, spec_tree, mesh)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return params, opt_state, metrics

    train_step.schedule = schedule
    return train_step


def router_grad_norm(grads, spec_tree=None, mesh=None):
    """The global norm of the MoE routers' gradients (every leaf named
    "router"; on a mesh, shards under `spec_tree`). The router sits behind
    the gates' gradient sum and the router gather's slice (models.moe), and
    is a small part of the whole gradient norm, so this norm is the
    sharper reading of both."""
    keep = [i for i, (path, _) in enumerate(tree_paths(grads))
            if path[-1] == "router"]
    leaves = tree_leaves(grads)
    specs = None if spec_tree is None else tree_leaves(spec_tree)
    return opt.global_norm([leaves[i] for i in keep],
                           None if specs is None else [specs[i]
                                                       for i in keep], mesh)


def _on_mesh(compute_grads, mesh, spec_tree, n_micro):
    """A single / scan schedule on a mesh: this rank's rows of the global
    batch in, its shards' gradients reduced over the mesh and the metrics'
    data mean out; forward and backward tensor-parallel over the model
    axis."""
    group = model_group_of(mesh)

    def compute(params, batch):
        with comm.model_axis(group):
            grads, metrics = compute_grads(params, data_rows(batch, mesh,
                                                              n_micro))
        return sync_grads(grads, spec_tree, mesh), mean_metrics(metrics,
                                                                mesh)
    return compute
