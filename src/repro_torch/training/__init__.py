"""Training substrate: optimizers, deterministic data pipeline, atomic
checkpoints, and the train-step factory."""

from .checkpoint import latest_step, restore, save
from .data import DataConfig, batch_for_step
from .optimizer import OptConfig, apply_updates, init_opt_state
from .train_loop import make_train_step, sharding_trees, train

__all__ = ["latest_step", "restore", "save", "DataConfig", "batch_for_step",
           "OptConfig", "apply_updates", "init_opt_state", "make_train_step",
           "sharding_trees", "train"]
