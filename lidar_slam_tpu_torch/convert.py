"""Carry state across from the JAX package to the port.

The functions take the JAX package's `NDTMap` / `NDTMapSums` / `AloamState`
leaves as numpy arrays (the caller does `np.asarray` on the JAX side) and
its config fields as plain Python values, and return the port's objects.
This module never imports jax: it lets one map or pipeline state, built
once, be stepped by both packages, so each stage's parity is tested apart
from the stages before it. Like every entry point of the port, a converter
puts its tensors on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import device as _default_device
from .models.graph_optimizer import PoseGraph
from .models.registration import NDTMap, NDTMapSums
from .models.scan_context import ScanContextConfig, SCManager
from .ops.pointcloud import PointCloud
from .pipeline.aloam import AloamState


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype).to(_default_device(device)).contiguous()


def config_from_fields(cls, fields: dict):
    """The port's config class `cls` (NDTConfig, FrontEndConfig,
    MatchingConfig, FeatureExtractionConfig, AloamOdometryConfig,
    AloamMappingConfig, ...) from the JAX config's fields
    (`dataclasses.asdict`). A field whose default is itself a config (the
    `ndt` of FrontEndConfig and MatchingConfig) arrives as a dict and is
    built the same way."""
    fields = dict(fields)
    for f in dataclasses.fields(cls):
        if isinstance(fields.get(f.name), dict) and dataclasses.is_dataclass(f.default):
            fields[f.name] = config_from_fields(type(f.default), fields[f.name])
    if "grid_dims" in fields:
        fields["grid_dims"] = tuple(int(d) for d in fields["grid_dims"])
    return cls(**fields)


def ndt_map_from_numpy(
    origin, count, mean, icov, staticvalue, valid, index, packed, keys, dims, resolution, device=None
) -> NDTMap:
    """The port's NDTMap from the JAX map's leaves. Raises unless the keys
    meet NDTMap's invariant, checked here once on the host array: strictly
    rising voxel ids, then a tail of -1 (ascending in unsigned order)."""
    k = np.asarray(keys, np.int32).reshape(-1)
    used = int(np.count_nonzero(k >= 0))
    if not (np.all(k[used:] == -1) and np.all(np.diff(k[:used].astype(np.int64)) > 0)):
        raise ValueError("NDT map keys must be strictly rising voxel ids followed by -1 (unsigned ascending order)")
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


def pose_graph_from_numpy(fields: dict, device=None) -> PoseGraph:
    """The port's PoseGraph from the JAX PoseGraph's leaves, `fields` =
    {field name: numpy array}, each copied with its dtype."""
    dev = _default_device(device)
    return PoseGraph(**{f.name: torch.tensor(np.asarray(fields[f.name])).to(dev)
                        for f in dataclasses.fields(PoseGraph)})


def sc_manager_from_numpy(descs, count: int, cfg: ScanContextConfig, device=None) -> SCManager:
    """A port SCManager holding the JAX SCManager's history: its descriptors
    `descs` [capacity, rings, sectors] (the host mirror) and `count`."""
    descs = np.asarray(descs, np.float32)
    mgr = SCManager(cfg, capacity=descs.shape[0], device=device)
    mgr.load_history(torch.as_tensor(descs[:count].copy()))
    return mgr


def _cloud(points, mask, device=None) -> PointCloud:
    return PointCloud(points=_t(points, torch.float32, device), mask=_t(mask, torch.bool, device))


def aloam_state_from_numpy(
    prev_less_sharp, prev_less_sharp_ring, prev_less_flat, prev_less_flat_ring,
    T_rel, T_world, T_map_odom, corner_map, surf_map, has_prev, map_init, device=None,
) -> AloamState:
    """The port's AloamState from the JAX one's leaves, in its field order;
    each cloud is a (points, mask) pair."""
    return AloamState(
        prev_less_sharp=_cloud(*prev_less_sharp, device=device),
        prev_less_sharp_ring=_t(prev_less_sharp_ring, torch.int32, device),
        prev_less_flat=_cloud(*prev_less_flat, device=device),
        prev_less_flat_ring=_t(prev_less_flat_ring, torch.int32, device),
        T_rel=_t(T_rel, torch.float32, device),
        T_world=_t(T_world, torch.float32, device),
        T_map_odom=_t(T_map_odom, torch.float32, device),
        corner_map=_cloud(*corner_map, device=device),
        surf_map=_cloud(*surf_map, device=device),
        has_prev=_t(has_prev, torch.bool, device),
        map_init=_t(map_init, torch.bool, device),
    )
