"""Sharding: logical-axis rules resolved against meshes, and the
collectives the port's mesh step runs."""

from .axes import dp_axes, make_rules, tp_axis
from .context import (NamedSharding, Rules, UnitSpec, constrain, get_rules,
                      is_spec, param_sharding, set_rules, use_rules)

__all__ = ["dp_axes", "make_rules", "tp_axis", "NamedSharding", "Rules",
           "UnitSpec", "constrain", "get_rules", "is_spec", "param_sharding",
           "set_rules", "use_rules"]
