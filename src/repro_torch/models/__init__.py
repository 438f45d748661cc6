"""Model substrate: the reference's LM definitions in PyTorch (the dense
family so far; see :mod:`repro_torch.models.lm`)."""
from .lm import LM, build_param_defs  # noqa: F401
from . import attention, common  # noqa: F401
