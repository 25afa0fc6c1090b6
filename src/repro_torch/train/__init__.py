from repro_torch.train.state import TrainState
from repro_torch.train.step import (batch_spec, init_train_state,
                                    make_dp_failover_step,
                                    make_gspmd_train_step, param_pspec,
                                    shardings_for_params)

__all__ = ["TrainState", "batch_spec", "init_train_state",
           "make_dp_failover_step", "make_gspmd_train_step", "param_pspec",
           "shardings_for_params"]
