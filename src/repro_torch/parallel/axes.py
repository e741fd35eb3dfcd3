"""Logical-axis rules: models name tensor dimensions with *logical* axes; a
strategy maps logical names onto physical mesh axes (MaxText-style).

Only the rules table is ported: `sharding.Strategy.rules()` derives from it,
and the planner reads strategies. Mapping logical axes to device placements
(the reference package's `logical_to_spec`, `shard`, `gather_fsdp`,
`axis_rules`) belongs to the execution half of the parallel layer, which
waits for ROADMAP queue A item 5; on one card nothing is sharded.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]

# Default logical->physical rules for the production 2-D/3-D meshes.
# "pod" is present only in the multi-pod mesh; missing axes are dropped.
DEFAULT_RULES: Dict[str, Axis] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,             # sequence kept local by default (SP overrides)
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "inner": "model",        # xLSTM inner (v/output) dim
    "lru": "model",          # RG-LRU width
    "mlp_act": "model",
    "kv_seq": None,          # KV-cache sequence dim (SP decode overrides -> "model")
    # weights
    "embed_w": "data",       # FSDP axis for the d_model dim of weights
    "mlp": "model",          # TP axis for FFN hidden
    "q_w": "model",          # TP for flattened q/o projection dim (heads*hd)
    "kv_w": "model",         # TP for flattened k/v projection dim
    "vocab": "model",
    "experts": None,         # experts dim (EP strategy overrides -> "model")
    "layers": None,          # stacked-scan leading dim
    "conv": None,
}
