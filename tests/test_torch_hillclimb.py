"""The port's hillclimb harness (repro_torch.launch.hillclimb) against the
reference's (repro.launch.hillclimb): the same variant space and named
variants, plan_phase's printed line equal for each strategy under the
simulate backend at the TPU v5e's numbers, the same prune shortlist. On
one card: the counted variants' rooflines, a variant with no counterpart
refused by name and left out of the results, and the card backend
raising without a card."""
import contextlib
import importlib
import io
import json
import os

import pytest

from repro.configs import SHAPES as JSHAPES, get_config as jget
from repro_torch import hw as THW
from repro_torch.configs import SHAPES, get_config
from repro_torch.core.predictor import MemoryPlan
from repro_torch.launch import hillclimb as HC

STRATEGIES = ("fastest", "staged", "exhaustive", "greedy")
CELLS = (("h2o-danube-1.8b", "train_4k"), ("mixtral-8x7b", "decode_32k"),
         ("gemma3-12b", "prefill_32k"))


def reference():
    """The reference harness, imported without leaving its XLA_FLAGS in
    this process's environment."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.hillclimb")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def printed(fn, *a, **k):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*a, **k)
    return res, buf.getvalue()


def test_space_and_variants_equal_reference():
    J = reference()
    assert HC.VARIANTS == J.VARIANTS
    assert HC.PLAN_MESH_SHAPE == J.PLAN_MESH_SHAPE
    for mine, theirs in ((HC.SPACE, J.SPACE),
                         (HC.MEASURE_SPACE, J.MEASURE_SPACE)):
        assert [(k.name, k.values, k.group) for k in mine.knobs] == \
            [(k.name, k.values, k.group) for k in theirs.knobs]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_plan_phase_line_equals_reference(arch, shape, strategy):
    J = reference()
    cj, ct = jget(arch), get_config(arch)
    bj = J.SPACE.point(cj, base=J.SP.Candidate(plan=J.MemoryPlan()))
    bt = HC.SPACE.point(ct, base=HC.SP.Candidate(plan=MemoryPlan()))
    _, want = printed(J.plan_phase, cj, JSHAPES[shape], bj, strategy,
                      "simulate")
    _, got = printed(HC.plan_phase, ct, SHAPES[shape], bt, strategy,
                     "simulate", THW.TPU_V5E)
    assert got == want and got.startswith(f"plan[{strategy}/simulate]: ")


@pytest.mark.parametrize("keep", [0, 2, 4])
def test_prune_keeps_the_reference_shortlist(keep):
    J = reference()
    names = ["baseline", "remat_full", "micro_4", "onehot_embed",
             "remat_dots", "kv_seq", "no_fsdp", "moe_group_512"]
    arch, shape = "mixtral-8x7b", "train_4k"
    cj, ct = jget(arch), get_config(arch)
    bj = J.SPACE.point(cj, base=J.SP.Candidate(plan=J.MemoryPlan()))
    bt = HC.SPACE.point(ct, base=HC.SP.Candidate(plan=MemoryPlan()))
    nj = {n: J.SPACE.point(cj, base=bj, **J.VARIANTS[n]) for n in names}
    nt = {n: HC.SPACE.point(ct, base=bt, **HC.VARIANTS[n]) for n in names}
    want, wline = printed(J.prune_variants, cj, JSHAPES[shape], nj, keep)
    got, gline = printed(HC.prune_variants, ct, SHAPES[shape], nt, keep,
                         THW.TPU_V5E)
    assert got == want and gline == wline
    assert got[0] == "baseline" and len(got) == (keep or len(names))


@pytest.mark.parametrize("vname", ["onehot_embed", "attn_replicated",
                                   "gather_w", "ep", "kv_seq", "qb_256"])
def test_variant_without_counterpart_is_refused(vname):
    cfg = get_config("h2o-danube-1.8b").reduced()
    cand = HC.SPACE.point(cfg, **HC.VARIANTS[vname])
    with pytest.raises(HC.NoCounterpart, match="no counterpart on one card"):
        HC.run_variant(cfg, SHAPES["train_4k"], cand, HC.VARIANTS[vname])


def test_main_counts_variants_and_refuses_by_name(tmp_path, monkeypatch):
    """baseline, remat_full and moe_group_512 counted on the meta device
    (a reduced config, so that it is quick); onehot_embed printed as
    FAILED and left out of the results."""
    monkeypatch.setattr(HC, "get_config", lambda a: get_config(a).reduced())
    rc, out = printed(HC.main, [
        "--arch", "mixtral-8x7b", "--shape", "train_4k", "--variants",
        "baseline,remat_full,onehot_embed,moe_group_512",
        "--compile-budget", "0", "--out", str(tmp_path)])
    assert rc == 0
    assert ("onehot_embed     FAILED: no counterpart on one card: "
            "embed_onehot\n") in out
    res = json.loads((tmp_path / "mixtral-8x7b__train_4k.json").read_text())
    assert sorted(res) == ["baseline", "moe_group_512", "remat_full"]
    base, full = res["baseline"], res["remat_full"]
    assert base["mesh"] == "card" and base["n_chips"] == 1
    assert base["t_comp"] == base["flops_per_chip"] / 989e12
    assert full["flops_per_chip"] > base["flops_per_chip"]
    assert res["moe_group_512"]["flops_per_chip"] > 0
    for vname in res:
        assert f"\n{vname:16s} comp=" in "\n" + out


def test_card_backend_raises_without_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="is_available"):
        HC.main(["--arch", "h2o-danube-1.8b", "--shape", "long_500k",
                 "--backend", "cuda"])
    cfg = get_config("h2o-danube-1.8b")
    with pytest.raises(RuntimeError, match="is_available"):
        printed(HC.main, ["--arch", cfg.name, "--shape", "long_500k",
                          "--variants", "baseline", "--memory",
                          "--out", str(tmp_path)])
