"""Data-parallel training over a device list, in one process."""
from .data_parallel import (cli_devices, make_dp_epoch_fns, parallelize_trainer,
                            resolve_devices)

__all__ = ["cli_devices", "make_dp_epoch_fns", "parallelize_trainer", "resolve_devices"]
