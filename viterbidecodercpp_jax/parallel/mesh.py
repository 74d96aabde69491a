"""Mesh construction helpers."""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "pvary"]


def pvary(x, axis_name):
    """Mark a per-shard constant as varying over ``axis_name`` (a name or
    tuple of names).

    Inside shard_map, values built from constants are typed as replicated;
    feeding them into a lax.scan carry whose other inputs are
    device-varying trips JAX's vma check."""
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)

    def mark(a):
        need = tuple(ax for ax in axes if ax not in jax.typeof(a).vma)
        return jax.lax.pcast(a, need, to="varying") if need else a

    return jax.tree_util.tree_map(mark, x)


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """Build a Mesh over the first prod(axis_sizes) devices.  The mesh
    follows the algorithm only: the cards of one host are joined all to
    all, so no device order is better than another."""
    n = int(np.prod(axis_sizes))
    devices = jax.devices()
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.array(devices[:n]).reshape(*axis_sizes)
    return Mesh(arr, tuple(axis_names))
