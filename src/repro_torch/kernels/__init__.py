"""Hand-written Hopper kernels of the port, one package each
(`kernel.py` binds the CUDA source, `ref.py` is its plain PyTorch version,
`ops.py` dispatches on the tensor's device)."""
