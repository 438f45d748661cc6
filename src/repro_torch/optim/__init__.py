"""Optimizer substrate: AdamW on plain dict trees of tensors."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,  # noqa: F401
                    cosine_schedule, global_norm)
