"""Carry state across from the JAX package to the port.

The functions take the JAX package's `NDTMap` / `NDTMapSums` leaves as numpy
arrays (the caller does `np.asarray` on the JAX side) and its `NDTConfig`
fields as plain Python values, and return the port's objects. This module
never imports jax: it lets one map, built once, be evaluated by both
packages, so derivative parity is tested apart from map-build parity.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.registration import NDTConfig, NDTMap, NDTMapSums


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype).to(device).contiguous()


def ndt_config_from_fields(fields: dict) -> NDTConfig:
    """NDTConfig from the JAX config's fields (`dataclasses.asdict`)."""
    fields = dict(fields)
    fields["grid_dims"] = tuple(int(d) for d in fields["grid_dims"])
    return NDTConfig(**fields)


def ndt_map_from_numpy(
    origin, count, mean, icov, staticvalue, valid, index, packed, keys, dims, resolution, device=None
) -> NDTMap:
    return NDTMap(
        origin=torch.as_tensor(np.array(origin, np.float32).reshape(3)),
        count=_t(count, torch.float32, device),
        mean=_t(mean, torch.float32, device),
        icov=_t(icov, torch.float32, device),
        staticvalue=_t(staticvalue, torch.float32, device),
        valid=_t(valid, torch.bool, device),
        index=_t(index, torch.int32, device),
        packed=_t(packed, torch.float32, device),
        keys=_t(keys, torch.int32, device),
        dims=tuple(int(d) for d in dims),
        resolution=float(resolution),
    )


def ndt_sums_from_numpy(origin, count, psum, ppsum, wsum, dims, resolution, device=None) -> NDTMapSums:
    return NDTMapSums(
        origin=torch.as_tensor(np.array(origin, np.float32).reshape(3)),
        count=_t(count, torch.float32, device),
        psum=_t(psum, torch.float32, device),
        ppsum=_t(ppsum, torch.float32, device),
        wsum=_t(wsum, torch.float32, device),
        dims=tuple(int(d) for d in dims),
        resolution=float(resolution),
    )
