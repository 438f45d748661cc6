"""Model substrate: the reference's LM definitions in PyTorch (all six
families; see :mod:`repro_torch.models.lm`) and their input specs
(:mod:`repro_torch.models.specs`)."""
from .lm import LM, build_param_defs  # noqa: F401
from . import attention, common  # noqa: F401
