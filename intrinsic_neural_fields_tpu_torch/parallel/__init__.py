"""Data-parallel training over a device list, in one process."""
from .data_parallel import make_dp_epoch_fns, parallelize_trainer

__all__ = ["make_dp_epoch_fns", "parallelize_trainer"]
