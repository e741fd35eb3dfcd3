"""Sharding strategies, planning half: the `Strategy` record the WSMC
planner and profiler pick, its logical-axis rules, and `default_strategy`.

Default strategy: batch over ("pod","data"), FSDP (ZeRO-3 style weight
sharding) over "data" on the d_model dim of every weight, TP over "model"
on heads/FFN/vocab/experts-inner dims. Optimizer state inherits parameter
specs (ZeRO).

Strategy knobs the WSMC planner can flip:
  ep       — shard the expert dim over "model" (EP) instead of intra-expert TP
  kv_shard — "heads" | "seq": decode KV-cache layout. kv_heads < 16 pads on
             the model axis, so small-kv archs default to sequence sharding.

Meshes are plain `{axis: size}` mappings here (`None` = no mesh). The
execution half — per-leaf partition specs for parameters, caches and
inputs, and placing them on a device mesh — waits for the parallel layer
(ROADMAP queue A item 5); one card runs every strategy unsharded.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import axes as pax


@dataclasses.dataclass(frozen=True)
class Strategy:
    name: str = "fsdp_tp"
    ep: bool = False
    kv_shard: str = "heads"          # heads | seq
    fsdp: bool = True                # False => pure DP + TP (weights replicated
                                     # over "data"; small models)
    pipeline: bool = False           # layer stack split over the "pipe" axis
                                     # (1F1B runtime schedule owns the stages)

    def rules(self) -> Dict[str, Any]:
        rules = dict(pax.DEFAULT_RULES)
        if self.ep:
            rules["experts"] = "model"
            rules["mlp"] = None
            rules["mlp_act"] = None
        if self.kv_shard == "seq":
            rules["kv_seq"] = "model"
            rules["kv_heads"] = None
        if not self.fsdp:
            rules["embed_w"] = None
        if self.pipeline:
            rules["layers"] = "pipe"
        return rules


def default_strategy(cfg: ModelConfig,
                     mesh_shape: Optional[Mapping[str, int]] = None
                     ) -> Strategy:
    """Pick kv layout, EP and pipelining from the mesh axes ({axis: size};
    None = no mesh, planned as a model axis of 16)."""
    model_size = 16
    pipeline = False
    if mesh_shape is not None and "model" in mesh_shape:
        model_size = int(mesh_shape["model"])
    if mesh_shape is not None and "pipe" in mesh_shape:
        pipeline = int(mesh_shape["pipe"]) > 1
    kv = "heads" if cfg.n_kv_heads % model_size == 0 else "seq"
    # EP when the expert count tiles the axis (-56% compute vs intra-expert
    # TP on llama4); otherwise dense TP inside experts.
    ep = cfg.is_moe and cfg.n_experts % model_size == 0
    return Strategy(kv_shard=kv, ep=ep, pipeline=pipeline)
