"""PyTorch/CUDA port of the OptCC training substrate.

A second package beside the JAX reference (`repro`). It keeps the JAX
package's module names, imports `torch` and numpy only, and carries its own
copy of every numpy helper it needs. Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""
