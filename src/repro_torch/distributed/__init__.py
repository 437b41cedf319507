from .sharding import (  # noqa: F401
    AxisRules, DEFAULT_RULES, Mesh, current_rules, logical_constraint,
    logical_spec, use_rules,
)
