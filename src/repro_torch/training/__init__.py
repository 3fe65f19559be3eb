from repro_torch.training.train_step import (
    TrainState, init_train_state, make_train_step,
)

__all__ = ["TrainState", "init_train_state", "make_train_step"]
