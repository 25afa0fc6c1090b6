from repro_torch.train.state import TrainState
from repro_torch.train.step import init_train_state, make_dp_failover_step

__all__ = ["TrainState", "init_train_state", "make_dp_failover_step"]
