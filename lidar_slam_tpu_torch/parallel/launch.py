"""Start N ranks of a function, each its own process, and return rank 0's
result: the port's launcher (the JAX package needs none: one process drives
every device of its mesh).

    result = launch("package.module:function", 2, args=(...), device="cpu")

Each rank is `python -m lidar_slam_tpu_torch.parallel.launch`, which
imports only this package and the target's module, joins the process group
through a `FileStore` in a temporary directory (no TCP port, so concurrent
launches never collide), pins one torch thread, calls
`target(mesh, *args, **kwargs)` and, on rank 0, writes the result back with
every tensor moved to the host. A rank that fails ends the launch: the
others are killed and its traceback is raised here; so is a launch that
outlives its timeout.

Devices: `device=None` puts rank r on `cuda:r` under NCCL; a named device
("cpu", or "cuda:0" for ranks sharing one card) puts every rank there under
gloo.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Optional, Union

_REPO = Path(__file__).resolve().parents[2]


def _target_name(target: Union[str, Callable]) -> str:
    if isinstance(target, str):
        return target
    module = target.__module__
    if module == "__main__":  # run with -m: the module's own name
        spec = getattr(sys.modules["__main__"], "__spec__", None)
        if spec is None:
            raise ValueError("a rank cannot import a script's __main__: name the target as 'module:function'")
        module = spec.name
    return f"{module}:{target.__qualname__}"


def _resolve(target: Union[str, Callable]) -> Callable:
    module, name = _target_name(target).split(":")
    fn = importlib.import_module(module)
    for part in name.split("."):
        fn = getattr(fn, part)
    return fn


def _to_host(obj):
    """`obj` with every tensor in it (through dataclasses, dicts, lists and
    tuples) moved to the CPU."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _to_host(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def launch(
    target: Union[str, Callable],
    world_size: int,
    args: tuple = (),
    kwargs: Optional[dict] = None,
    device: Optional[str] = None,
    timeout: Optional[float] = 600.0,
):
    """Run `target(mesh, *args, **kwargs)` on `world_size` ranks; return
    rank 0's result (its tensors on the host). `target` is a module-level
    function or its 'module:function' name; the arguments are pickled.
    NCCL for `device=None` (rank r on `cuda:r`), gloo on `device`
    otherwise. Raises RuntimeError if a rank fails and TimeoutError after `timeout`
    seconds (None: no limit; a collective still fails after torch's
    default), with every rank stopped either way."""
    if world_size < 1:
        raise ValueError(f"world size {world_size}")
    with tempfile.TemporaryDirectory(prefix="slam_ranks_") as tmp:
        spec = dict(
            target=_target_name(target), args=args, kwargs=kwargs or {}, world_size=world_size,
            device=device, timeout=timeout,
            store=os.path.join(tmp, "store"),
        )
        with open(os.path.join(tmp, "spec.pkl"), "wb") as f:
            pickle.dump(spec, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([str(_REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
            env[var] = "1"
        procs = [
            subprocess.Popen([sys.executable, "-m", "lidar_slam_tpu_torch.parallel.launch", tmp, str(r)], env=env)
            for r in range(world_size)
        ]
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    r = failed[0]
                    err = Path(tmp, f"error-{r}.txt")
                    detail = err.read_text() if err.exists() else f"exit code {codes[r]}"
                    raise RuntimeError(f"rank {r} of {world_size} failed:\n{detail}")
                if all(c == 0 for c in codes):
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{spec['target']} on {world_size} ranks ran past {timeout:.0f} s")
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        with open(os.path.join(tmp, "result-0.pkl"), "rb") as f:
            return pickle.load(f)


def call_each(mesh, calls):
    """Run each (target, args, kwargs) of `calls` on this rank as
    target(*args, mesh=mesh, **kwargs), in order; return the results. Many
    cases then share one launch (`launch(call_each, n, args=(calls,))`)."""
    out = []
    for target, args, kwargs in calls:
        out.append(_resolve(target)(*args, mesh=mesh, **kwargs))
    return out


def _rank_main(out: str, rank: int) -> int:
    """One rank: join the group, run the target, write rank 0's result."""
    with open(os.path.join(out, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    try:
        import torch
        import torch.distributed as dist

        from .mesh import make_mesh

        torch.set_num_threads(1)  # ranks share the host's cores
        dev = torch.device(spec["device"] or f"cuda:{rank}")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        timeout = None if spec["timeout"] is None else datetime.timedelta(seconds=spec["timeout"])
        dist.init_process_group(
            "nccl" if spec["device"] is None else "gloo", store=dist.FileStore(spec["store"], spec["world_size"]),
            rank=rank, world_size=spec["world_size"], timeout=timeout,
        )
        try:
            result = _resolve(spec["target"])(make_mesh(device=dev), *spec["args"], **spec["kwargs"])
        finally:
            dist.destroy_process_group()
        if rank == 0:
            tmp = os.path.join(out, "result-0.pkl.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(_to_host(result), f)
            os.replace(tmp, os.path.join(out, "result-0.pkl"))
        return 0
    except BaseException:
        Path(out, f"error-{rank}.txt").write_text(traceback.format_exc())
        raise


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1], int(sys.argv[2])))
