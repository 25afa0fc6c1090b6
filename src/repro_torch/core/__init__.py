"""Numpy-free control plane of the port: the bandwidth profile, the
paper's closed-form bounds and the classic OptCC-vs-ring planner."""
