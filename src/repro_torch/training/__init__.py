from repro_torch.training.train_step import (
    ShardedTrainState, TrainState, init_train_state, make_train_step,
    opt_state_axes, shard_train_state, state_shardings,
)

__all__ = ["ShardedTrainState", "TrainState", "init_train_state",
           "make_train_step", "opt_state_axes", "shard_train_state",
           "state_shardings"]
