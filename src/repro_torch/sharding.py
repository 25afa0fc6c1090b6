"""Mesh descriptions and partition specs: the port's stand-in for the parts
of `jax.sharding` that the JAX package's sharding rules read.

The rules (`train/step.py::param_pspec`, `launch/mesh.py`) read only a
mesh's axis names and sizes, so a `Mesh` here is that description and
holds no devices: the production meshes, (16, 16) and (2, 16, 16), are
evaluated on any host. A `PartitionSpec` is a tuple with one entry per
dimension: an axis name, a tuple of axis names, or None (replicated).
`ShapeDtypeStruct` is a shape, a torch dtype and an optional
`NamedSharding`, as JAX's is; `eval_shape` gives the shapes and dtypes of
what a function returns without allocating its tensors (a full-width
arctic-480b is ~953 GB of parameters).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch


class PartitionSpec(tuple):
    """P("data", None) shards dim 0 over 'data' and replicates dim 1;
    P(("pod", "data")) shards dim 0 over both axes."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh as axis sizes and names, without devices."""
    axis_sizes: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        """{axis name: size}, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The number of devices the mesh spans."""
        return math.prod(self.axis_sizes)


def make_mesh(axis_shapes, axis_names) -> Mesh:
    """`jax.make_mesh`'s arguments, as a description."""
    return Mesh(tuple(axis_shapes), tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    shape: tuple
    dtype: torch.dtype
    sharding: Optional[NamedSharding] = None


def eval_shape(fn: Callable, *args, **kwargs):
    """fn(*args, **kwargs) under fake tensors: what it returns, each tensor
    carrying its shape and dtype and no storage. Tensors are made on the
    CPU's fake device, so fn must create them there."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return fn(*args, **kwargs)
