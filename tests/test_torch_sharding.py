"""The parallel layer's spec trees against the reference package's:
logical_to_spec on every logical name under every Strategy knob;
param_specs, cache_specs, input_specs_sharding and state_specs leaf for
leaf for all ten archs on the production meshes and on data:2,pipe:2 (the
reference's functions called on jax.eval_shape trees with a plain object
that has `axis_names` and `shape`, which is all they read); and, on four
gloo ranks over the CPU, local_shard then gather_tree giving back every
leaf with the reduce-scatter sum as each shard's gradient."""
import itertools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.launch.compile import abstract_params
from repro.models.model import init_cache as jax_init_cache
from repro.optim import optimizers as JO
from repro.parallel import axes as JAX_AXES
from repro.parallel import sharding as JS
from repro_torch.configs import get_config
from repro_torch.launch import mesh as LM
from repro_torch.models import init_params
from repro_torch.models.model import init_cache
from repro_torch.optim import optimizers as TO
from repro_torch.parallel import axes as TA
from repro_torch.parallel import sharding as TS
from repro_torch.tree import tree_paths

import _torch_mesh_ranks as R

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "data2_pipe2": {"pipe": 2, "data": 2}}


def _mesh(shape):
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


def _ref_flat(spec_tree):
    """[(path, spec)] sorted by path (jax walks dict keys sorted, the port
    in insertion order)."""
    out = []
    for path, spec in jax.tree_util.tree_flatten_with_path(
            spec_tree, is_leaf=lambda x: isinstance(x, P))[0]:
        key = "//".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out.append((key, tuple(spec)))
    return sorted(out)


def _port_flat(spec_tree):
    return sorted(("//".join(str(k) for k in path), spec)
                  for path, spec in tree_paths(spec_tree))


def test_production_meshes_are_the_references():
    for multi in (False, True):
        m = LM.make_production_mesh(multi_pod=multi)
        assert m.groups is None and not m.coords
        shape = MESHES["2x16x16" if multi else "16x16"]
        assert m.axis_names == tuple(shape) and m.shape == shape


def _strategies():
    for ep, kv, fsdp, pipe in itertools.product(
            (False, True), ("heads", "seq"), (True, False), (False, True)):
        yield (JS.Strategy(ep=ep, kv_shard=kv, fsdp=fsdp, pipeline=pipe),
               TS.Strategy(ep=ep, kv_shard=kv, fsdp=fsdp, pipeline=pipe))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_logical_to_spec_matches_reference(mesh_name):
    """Every logical name alone, in pairs and with dimension sizes that
    some axes do not divide, under each of the 16 strategy settings."""
    mesh = _mesh(MESHES[mesh_name])
    names = sorted(TA.DEFAULT_RULES) + [None]
    n = 0
    for js, ts in _strategies():
        assert ts.rules() == js.rules()
        for a, b in itertools.product(names, names):
            for shape in (None, (6, 32), (32, 2048)):
                want = JAX_AXES.logical_to_spec((a, b), rules=js.rules(),
                                                mesh=mesh, shape=shape)
                got = TA.logical_to_spec((a, b), rules=ts.rules(),
                                         mesh=mesh, shape=shape)
                assert isinstance(got, TA.Spec)
                assert got == tuple(want), (a, b, shape, js)
                n += 1
    assert n == 16 * len(names) ** 2 * 3


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_match_reference(arch):
    """param_specs, cache_specs, input_specs_sharding and state_specs (all
    three optimizers) on every mesh under its default strategy, leaf for
    leaf (same paths, same entries)."""
    cj, ct = jax_get_config(arch), get_config(arch)
    pj = abstract_params(cj)
    pt = init_params(None, ct, device="meta")
    cache_j = jax_init_cache(cj, 16, 2048, abstract=True)
    cache_t = init_cache(ct, 16, 2048, device="meta")
    inputs = {"tokens": np.zeros((16, 2048), np.int32),
              "targets": np.zeros((16, 2048), np.int32),
              "positions": np.zeros((16,), np.int32),
              "prefix_embeds": np.zeros((16, 8, 4), np.float32)}
    for shape in MESHES.values():
        mesh = _mesh(shape)
        js = JS.default_strategy(cj, mesh)
        ts = TS.default_strategy(ct, mesh)
        assert ts == TS.Strategy(**{f: getattr(js, f) for f in
                                    ("name", "ep", "kv_shard", "fsdp",
                                     "pipeline")})
        sj = JS.param_specs(cj, pj, js, mesh)
        st = TS.param_specs(ct, pt, ts, mesh)
        assert _port_flat(st) == _ref_flat(sj)
        assert (_port_flat(TS.cache_specs(ct, cache_t, ts, mesh))
                == _ref_flat(JS.cache_specs(cj, cache_j, js, mesh)))
        got = TS.input_specs_sharding(inputs, ts, mesh)
        want = JS.input_specs_sharding(inputs, js, mesh)
        assert {k: tuple(v) for k, v in want.items()} == got
        for kind in TO.KINDS:
            assert (_port_flat(TO.state_specs(TO.OptimizerConfig(kind=kind),
                                              st))
                    == _ref_flat(JO.state_specs(JO.OptimizerConfig(kind=kind),
                                                sj)))
    assert TS.scalar_spec() == tuple(P())


def test_per_repeat_lists_take_the_stacked_spec():
    """A unit leaf given as its list of per-repeat tensors (the trainer's
    autograd leaves) takes the stacked leaf's ("layers", ...) spec."""
    ct = get_config("h2o-danube-1.8b").reduced()
    pt = init_params(None, ct, device="meta")
    mesh = _mesh(MESHES["data2_pipe2"])
    ts = TS.Strategy(pipeline=True)
    listed = dict(pt, units=[{k: {n: list(t.unbind(0)) for n, t in v.items()}
                              for k, v in u.items()} for u in pt["units"]])
    assert TS.param_specs(ct, listed, ts, mesh) == TS.param_specs(ct, pt, ts,
                                                                  mesh)


def test_local_shard_then_gather_tree_round_trip():
    """On data:2,pipe:2 (four gloo ranks): every leaf comes back equal,
    each shard has its spec's local shape, and the gradient of
    sum(leaf * (rank + 1)) reaching a shard is the reduce-scatter sum over
    the ranks that gathered it; comm's nccl branch (NCCL's own tensor
    all-gather and reduce-scatter, run here on gloo) gives the same leaves
    and gradients bit for bit."""
    out = R.spawn(R.gather_roundtrip, 4)
    for res in out:
        assert res["equal"] == [True] * len(R.GATHER_LEAVES)
        assert res["tensor_path"]
        c = res["coords"]
        for (shape, spec), local, g in zip(R.GATHER_LEAVES, res["shapes"],
                                           res["grads"]):
            mesh = LM.Mesh(axis_names=("pipe", "data"),
                           shape={"pipe": 2, "data": 2}, coords=c)
            assert local == TS.local_shape(shape, TA.Spec(spec), mesh)
            axes = TA.Spec(spec).axes()
            ranks = [p * 2 + d for p in range(2) for d in range(2)
                     if ("pipe" in axes or p == c["pipe"])
                     and ("data" in axes or d == c["data"])]
            np.testing.assert_array_equal(
                g, np.full(local, float(sum(r + 1 for r in ranks)),
                           np.float32))


def test_nccl_collectives_stay_on_the_tensors_device(monkeypatch):
    """comm's nccl branch with torch.distributed scripted: every buffer
    handed to a collective, and every result, lies on the input's device
    (the meta device here, standing in for a card); nothing is staged
    through the host, synchronised or timed."""
    from repro_torch.parallel import comm

    seen = []

    def record(*args, **kwargs):
        seen.extend(t.device for t in (*args, *kwargs.values())
                    if isinstance(t, torch.Tensor))
        return types.SimpleNamespace(wait=lambda: None)

    monkeypatch.setattr(comm.dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(comm.dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(comm.dist, "get_rank", lambda group=None: 1)
    for name in ("all_reduce", "broadcast", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "isend", "recv"):
        monkeypatch.setattr(comm.dist, name, record)
    monkeypatch.setattr(comm.torch.cuda, "synchronize",
                        lambda *a: pytest.fail("synchronised"))
    before = (comm.staged_bytes, comm.seconds)
    t = torch.empty(4, 6, device="meta")
    outs = {"all_reduce": comm.all_reduce(t, None),
            "gather0": comm.all_gather(t, None, 0),
            "gather1": comm.all_gather(t, None, 1),
            "scatter0": comm.reduce_scatter(t, None, 0),
            "scatter1": comm.reduce_scatter(t, None, 1),
            "broadcast": comm.broadcast(t, None, 0),
            "recv": comm.recv((4, 6), torch.float32, "meta", 0, None)}
    comm.isend(t, 0, None).wait()
    assert {k: tuple(v.shape) for k, v in outs.items()} == {
        "all_reduce": (4, 6), "gather0": (8, 6), "gather1": (4, 12),
        "scatter0": (2, 6), "scatter1": (4, 3), "broadcast": (4, 6),
        "recv": (4, 6)}
    assert all(v.device.type == "meta" for v in outs.values())
    assert len(seen) >= 8 and all(d.type == "meta" for d in seen), seen
    assert (comm.staged_bytes, comm.seconds) == before
