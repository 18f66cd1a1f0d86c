"""K3: the NDT voxel-stat gather by key.

`gather_stats_onehot` replaces the Pallas TPU kernel
`lidar_slam_tpu/ops/pallas/ndt_reduce.py::gather_stats_onehot` with the
hand-written Hopper kernel `csrc/ndt_gather.cu` (binary search of each id
in the keys, sorted once here by a stable sort, then a sum of the matching
rows). On a CUDA tensor it launches that kernel or raises; on a CPU tensor,
and only there, it runs `gather_stats_plain`, the literal one-hot compare
and product, chunked over rows.

Both return [N, S, F]: for each id in `vids` [N, S], the sum of the `table`
rows whose key equals it, and a zero row where none does.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

ROW = 16  # the kernel's row width: four float4 loads

# Kernel launches since the last reset. Incremented only where the CUDA
# kernel is launched, never on the plain path.
launches = 0


def gather_stats_plain(keys, table, vids, max_onehot: int = 1 << 24):
    """Plain PyTorch version of K3 (any device): onehot(vids == keys) @ table,
    chunked so a one-hot block holds at most `max_onehot` floats. Exact when
    keys are unique: each output sums one row and zeros."""
    n, s = vids.shape
    flat = vids.reshape(-1)
    chunk = max(1, max_onehot // max(keys.shape[0], 1))
    out = [
        (flat[i:i + chunk, None] == keys[None, :]).to(table.dtype) @ table
        for i in range(0, flat.shape[0], chunk)
    ]
    if not out:
        return table.new_zeros((n, s, table.shape[1]))
    return torch.cat(out).reshape(n, s, table.shape[1])


def _library() -> ctypes.CDLL:
    lib = build.load("ndt_gather")
    if lib.ndt_gather_launch.argtypes is None:
        lib.ndt_gather_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ndt_gather_launch.restype = ctypes.c_int
    return lib


def gather_stats_onehot(keys, table, vids):
    """K3 (replaces ops/pallas/ndt_reduce.py::gather_stats_onehot): packed
    stat rows for every (point, slot) voxel id. `keys` [C] int32 (-1 marks
    an unused row), `table` [C, 16] float32, `vids` [N, S] int32 (ids absent
    from `keys`, such as the -2 of an out-of-bounds slot, give a zero row).
    CUDA tensors launch the Hopper kernel; CPU tensors take the plain
    version. Returns [N, S, 16] float32."""
    global launches
    dev = vids.device
    if dev.type == "cpu":
        return gather_stats_plain(keys, table, vids)
    if dev.type != "cuda":
        raise ValueError(f"gather_stats_onehot: unsupported device {dev}")
    c = keys.shape[0]
    n, s = vids.shape
    build.check_tensor("keys", keys, torch.int32, dev, (c,))
    build.check_tensor("table", table, torch.float32, dev, (c, ROW))
    build.check_tensor("vids", vids, torch.int32, dev)
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")

    sorted_keys, perm = torch.sort(keys, stable=True)
    perm = perm.to(torch.int32)
    out = torch.empty((n, s, ROW), dtype=torch.float32, device=dev)
    if n * s == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ndt_gather_launch(
            sorted_keys.data_ptr(), perm.data_ptr(), c, table.data_ptr(), vids.data_ptr(), n * s,
            out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"ndt_gather kernel launch failed: cudaError {err}")
    launches += 1
    return out
