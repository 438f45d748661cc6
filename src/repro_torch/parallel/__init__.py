"""Distribution substrate: logical-axis sharding + collectives tricks."""
from . import axes, compression  # noqa: F401
from .axes import (DEFAULT_RULES, constrain, named_sharding,  # noqa: F401
                   sharding_context, spec_for)
