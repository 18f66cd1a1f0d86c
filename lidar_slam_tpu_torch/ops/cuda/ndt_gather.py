"""K3: the NDT voxel-stat gather by key.

Replaces the Pallas TPU kernel
`lidar_slam_tpu/ops/pallas/ndt_reduce.py::gather_stats_onehot` with the
hand-written Hopper kernel `csrc/ndt_gather.cu`: each id is looked up in
keys that ascend in unsigned order (a binary search of every 16th key,
then one coalesced read of the 16-key segment it lands in, two lanes an
id) and the matching rows are summed in ascending row order. Two entries:

- `gather_stats_sorted` takes keys already in that order with row j
  holding keys[j]: an NDT map's keys (NDTMap's invariant). A call on CUDA
  tensors is one kernel launch: no sort, no host sync, no allocation but
  the output.
- `gather_stats_onehot` takes any keys (unsorted, repeated, -1 anywhere):
  it sorts them stably in unsigned order and the kernel reads the rows
  through the permutation.

On a CUDA tensor each launches the kernel or raises; on a CPU tensor, and
only there, each runs `gather_stats_plain`, the literal one-hot compare and
product, chunked over rows. Both return [N, S, F]: for each id in `vids`
[N, S], the sum of the `table` rows whose key equals it, and a zero row
where none does.

`assert_keys_ascend` checks the presorted entry's contract on the device:
every NDTMap constructor ends with it, and the plain version of the
presorted entry runs it, so keys out of order fail loudly on any device.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

ROW = 16  # the kernel's row width: four float4 loads

# Kernel launches since the last reset. Incremented only where the CUDA
# kernel is launched, never on the plain path.
launches = 0


def assert_keys_ascend(keys) -> None:
    """Fail unless `keys` [C] int32 ascend in unsigned order, NDTMap's
    invariant: strictly rising ids, then only -1. One small reduction and
    a device-side assert (`torch._assert_async`), so no host sync: on a
    CUDA tensor a failure is a device-side assert that the next sync
    raises; on a CPU tensor it raises a RuntimeError at once."""
    a, b = keys[:-1], keys[1:]
    ok = torch.all(torch.where(b == -1, a >= -1, (a >= 0) & (b > a)))
    torch._assert_async(ok, "NDT map keys must be strictly rising voxel ids followed by -1 (unsigned ascending order)")


def gather_stats_plain(keys, table, vids, max_onehot: int = 1 << 24, any_order: bool = False):
    """Plain PyTorch version of K3 (any device): onehot(vids == keys) @ table,
    chunked so a one-hot block holds at most `max_onehot` floats. Exact when
    keys are unique: each output sums one row and zeros. It holds the keys
    to the presorted entry's order (`assert_keys_ascend`) unless
    `any_order` (the general entry's plain version)."""
    if not any_order:
        assert_keys_ascend(keys)
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
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ndt_gather_launch.restype = ctypes.c_int
    return lib


def _launch(keys, perm, table, vids):
    global launches
    dev = vids.device
    c = keys.shape[0]
    n, s = vids.shape
    build.check_tensor("keys", keys, torch.int32, dev, (c,))
    build.check_tensor("table", table, torch.float32, dev, (c, ROW))
    build.check_tensor("vids", vids, torch.int32, dev)
    if keys.data_ptr() % 16 or table.data_ptr() % 16:
        raise ValueError("keys and table must be 16-byte aligned")
    if n * s >= 2**31:
        raise ValueError(f"{n * s} ids overflow the kernel's int id index")
    out = torch.empty((n, s, ROW), dtype=torch.float32, device=dev)
    if n * s == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ndt_gather_launch(
            keys.data_ptr(), None if perm is None else perm.data_ptr(), c, table.data_ptr(), vids.data_ptr(),
            n * s, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"ndt_gather kernel launch failed: cudaError {err}")
    launches += 1
    return out


def _device(vids, name):
    dev = vids.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def gather_stats_sorted(keys, table, vids):
    """K3 on keys that ascend in unsigned order, row j holding keys[j]: an
    NDT map's `keys` [C+1] and `packed` [C+1, 16] (NDTMap's invariant, which
    every map constructor asserts on the device; the kernel itself does not
    check it, so keys in another order give wrong rows there, and raise in
    the plain version). `vids` [N, S] int32
    (ids absent from `keys`, such as the -2 of an out-of-bounds slot, give a
    zero row). CUDA tensors launch the Hopper kernel once, with no sort and
    no host sync; CPU tensors take the plain version. Returns [N, S, 16]
    float32."""
    if _device(vids, "gather_stats_sorted").type == "cpu":
        return gather_stats_plain(keys, table, vids)
    return _launch(keys, None, table, vids)


def gather_stats_onehot(keys, table, vids):
    """K3 (replaces ops/pallas/ndt_reduce.py::gather_stats_onehot) for any
    keys: `keys` [C] int32 in any order (-1 marks an unused row, a repeated
    key sums its rows in row order), `table` [C, 16] float32, `vids` [N, S]
    int32. CUDA tensors sort the keys (stable, unsigned order) and launch
    the Hopper kernel through the permutation; CPU tensors take the plain
    version. Returns [N, S, 16] float32."""
    dev = _device(vids, "gather_stats_onehot")
    if dev.type == "cpu":
        return gather_stats_plain(keys, table, vids, any_order=True)
    build.check_tensor("keys", keys, torch.int32, dev, (keys.shape[0],))
    # flipping the sign bit turns unsigned order into signed order
    flipped, perm = torch.sort(keys ^ torch.iinfo(torch.int32).min, stable=True)
    return _launch(flipped ^ torch.iinfo(torch.int32).min, perm.to(torch.int32), table, vids)
