"""The distributed layer on ``torch.distributed`` (port of
``repro.distributed``): logical-axis sharding rules (``sharding``), the
decode schemes' attention and cache writes with the flash-decoding merge
(``collectives``), ring attention (``ring``) and expert parallelism
(``ep``)."""

from repro_torch.distributed.sharding import (
    AxisRules,
    DEFAULT_RULES,
    current_mesh,
    current_rules,
    logical_shard,
    logical_spec,
    shard_params,
    use_mesh,
)

__all__ = [
    "AxisRules",
    "DEFAULT_RULES",
    "current_mesh",
    "current_rules",
    "logical_shard",
    "logical_spec",
    "shard_params",
    "use_mesh",
]
