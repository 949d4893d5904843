"""The reference's ZeRO-1 moment shardings as its docstrings state them
(``repro/optim/adamw.py:8-9``, ``repro/launch/steps.py:104-107``: the DP
axes that ``zero1_specs`` writes shard the moments).  Its own
``param_sharding`` looks the DP tuple up in the rule table as if it were a
logical name and replicates, so its moments never shard over DP; the port
resolves the tuple as the axes it names."""

import dataclasses

import jax
from repro.sharding import dp_axes
from repro.sharding import param_sharding as j_param_sharding

_DP = "__zero1_dp__"


def reference_replicates(zspecs, moments, jrules) -> bool:
    """The reference's own shardings of its ZeRO-1 specs hold no DP axis."""
    shs = jax.tree.leaves(j_param_sharding(zspecs, moments, jrules))
    return not any(a in dp_axes(jrules.mesh) for s in shs
                   for part in s.spec
                   for a in ((part,) if isinstance(part, str)
                             else (part or ())))


def zero1_shardings(zspecs, moments, jrules):
    """The reference's shardings of ``zspecs`` with the DP tuple mapped to
    the DP axes through the reference's own rule machinery."""
    rules = dataclasses.replace(
        jrules, table=dict(jrules.table, **{_DP: dp_axes(jrules.mesh)}))
    named = jax.tree.map(
        lambda spec: tuple(_DP if isinstance(a, tuple) else a for a in spec),
        zspecs, is_leaf=lambda x: isinstance(x, tuple))
    return j_param_sharding(named, moments, rules)
