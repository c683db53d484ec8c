"""``ProcessMesh``: a named N-D grid of process ids. Counterpart:
``paddle_tpu/distributed/mesh.py:22-85`` (``shape``, ``ndim``,
``dim_names``, ``mesh``, ``process_ids``, ``size``, ``get_dim_size``).

JAX materialises the grid as a ``jax.sharding.Mesh`` over
``jax.devices()`` (``to_jax_mesh``). The port's program is single
controller, as JAX's is: one process drives every rank. In place of
``to_jax_mesh`` the mesh holds one torch device per process id. By
default that is the visible card of the id's number (``cuda:<id>``),
and an id without a card raises. An explicit list may name one device
several times: ``["cuda:0"] * 4`` runs a 4-rank ring on one card, the
counterpart of the virtual CPU devices that JAX's tests use, and
``["cpu"] * 4`` runs it on the CPU.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["ProcessMesh"]


def _default_devices(ids) -> List[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if max(ids) >= n:
        raise RuntimeError(
            f"ProcessMesh: process id {max(ids)} has no CUDA device ({n} "
            f"visible); pass devices=[...] with one torch device per "
            f"process id (a device may repeat, e.g. ['cpu'] * {len(ids)})")
    return [torch.device("cuda", i) for i in ids]


class ProcessMesh:
    def __init__(self, mesh, dim_names: Optional[Sequence[str]] = None, *,
                 devices: Optional[Sequence] = None):
        arr = np.asarray(mesh, dtype=np.int64)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        self._mesh_arr = arr
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        if len(dim_names) != arr.ndim:
            raise ValueError("dim_names must match mesh ndim")
        self._dim_names = list(dim_names)
        ids = self.process_ids
        if devices is None:
            self._devices = _default_devices(ids)
        else:
            self._devices = [torch.device(d) for d in devices]
            if len(self._devices) != len(ids):
                raise ValueError(
                    f"ProcessMesh: {len(self._devices)} devices for "
                    f"{len(ids)} process ids; give one per id")

    @property
    def shape(self) -> List[int]:
        return list(self._mesh_arr.shape)

    @property
    def ndim(self) -> int:
        return self._mesh_arr.ndim

    @property
    def dim_names(self) -> List[str]:
        return list(self._dim_names)

    @property
    def mesh(self):
        return self._mesh_arr

    @property
    def process_ids(self) -> List[int]:
        return self._mesh_arr.reshape(-1).tolist()

    @property
    def size(self) -> int:
        return int(self._mesh_arr.size)

    @property
    def devices(self) -> List[torch.device]:
        """The torch device of each process id, in ``process_ids``
        order."""
        return list(self._devices)

    def get_dim_size(self, dim_name: str) -> int:
        return self._mesh_arr.shape[self._dim_names.index(dim_name)]

    def axis_devices(self, dim_name: str) -> List[torch.device]:
        """The devices along ``dim_name``, in axis-index order. Every
        other axis must have size 1: the port places no other axis yet
        (ROADMAP queue 1, item 10)."""
        others = [n for n in self._dim_names
                  if n != dim_name and self.get_dim_size(n) > 1]
        if others:
            raise NotImplementedError(
                f"ProcessMesh: axes {others} besides {dim_name!r} have "
                f"size > 1; only a ring over one axis is ported (ROADMAP "
                f"queue 1, item 10)")
        return list(self._devices)

    def __repr__(self):
        return (f"ProcessMesh(shape={self.shape}, dim_names="
                f"{self._dim_names})")
