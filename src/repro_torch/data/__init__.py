"""Data pipeline substrate (NumPy on the host, as the reference's)."""
from .pipeline import (DataConfig, SyntheticTextSource,  # noqa: F401
                       make_train_batches, shard_for_host)
