"""Training: losses, augments, synthetic data, train steps (single and
sharded over a (data, model) mesh), checkpoints, datasets, markup and the
stand-in pretraining entry point (``training.pretrain``)."""
from . import augment, losses, synthetic_data
from .trainer import (TrainState, create_train_state, l2_train_step,
                      make_sharded_train_step, triplet_train_step)

__all__ = ["losses", "augment", "synthetic_data", "TrainState",
           "create_train_state", "l2_train_step", "triplet_train_step",
           "make_sharded_train_step"]
