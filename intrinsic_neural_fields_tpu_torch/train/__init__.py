"""Training: losses, epochs (kernel and eager steps), plateau LR, config
factories and the Trainer."""
from .config import (
    get_data,
    get_model_and_optim,
    get_renderer,
    get_seed,
    load_config,
    load_config_file,
)
from .losses import elementwise_loss, get_loss_fn
from .steps import AdamHyper, TrainState, create_train_state, make_epoch_fns
from .trainer import Trainer

__all__ = [
    "get_data", "get_model_and_optim", "get_renderer", "get_seed", "load_config",
    "load_config_file", "elementwise_loss", "get_loss_fn", "AdamHyper", "TrainState",
    "create_train_state", "make_epoch_fns", "Trainer",
]
