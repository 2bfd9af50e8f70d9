"""Starts the SPMD ranks of a mesh: one process a device.

Counterpart of `__graft_entry__._provision_devices` (`:32-116`), which gives
JAX's one controller n devices (a virtual CPU platform where the host has
fewer). The port runs one process a device instead: :func:`launch` spawns
n ranks with ``torch.multiprocessing``, initialises ``torch.distributed``
in each and runs ``fn(rank, *args)`` in all of them; each rank's return
value comes back to the caller, in rank order.

- The ranks meet through a ``file://`` store in a fresh temporary
  directory, never a TCP port, so concurrent launches (test workers)
  cannot collide.
- The backend follows the device the caller asks for: ``"nccl"`` on
  ``"cuda"``, ``"gloo"`` on ``"cpu"``; ``backend=`` overrides it (gloo also
  takes CUDA tensors, and NCCL refuses two ranks on one card). Nothing is
  probed or swapped at run time.
- On CUDA, rank r runs on ``cuda:<r % device_count>`` and makes it the
  current device, so the port's ``device="cuda"`` means the rank's card.
  The CUDA kernels are built once, before the ranks start.
- ``init_process_group`` gets ``timeout=``, so a hung collective raises
  in its rank, and a rank that raises fails the launch with its
  traceback, the other ranks killed. ``deadline=`` (none by default, as a
  fit may run for hours) bounds the whole launch: past it the ranks are
  killed and the launch fails instead of hanging.
- The ranks inherit the caller's environment (``AOI_AUTO_MESH``,
  ``OMP_NUM_THREADS``).
"""

import datetime
import os
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch


def _rank_main(rank: int, fn: Callable, args: Sequence, world: int,
               device: str, backend: str, store: str, out_dir: str,
               timeout_s: float) -> None:
    import torch.distributed as dist
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method="file://" + store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n: int, device: str = "cuda", args: Sequence = (),
           backend: Optional[str] = None, timeout: float = 600.0,
           deadline: Optional[float] = None) -> List[Any]:
    """Runs ``fn(rank, *args)`` in ``n`` spawned ranks of one process group
    and returns their results (``torch.save``-able; tensors come back on
    the CPU), rank 0's first.

    ``fn`` must be importable by name (a module-level function).
    ``device``: "cuda" (a rank a card, cycling over the cards) or "cpu";
    ``backend``: "nccl" or "gloo" (default from ``device``); ``timeout``:
    seconds a collective may wait (the process group's timeout);
    ``deadline``: seconds until the launch fails and kills its ranks
    (None: no limit)."""
    import torch.multiprocessing as mp
    if device not in ("cuda", "cpu"):
        raise ValueError("device must be 'cuda' or 'cpu'")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was asked for, but torch sees "
                               "no CUDA device")
        from ..ops import cc_kernel, spatial_mlp
        cc_kernel.build()
        spatial_mlp.build()
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    with tempfile.TemporaryDirectory(prefix="aoi_launch_") as tmp:
        ctx = mp.start_processes(
            _rank_main, nprocs=n, join=False, start_method="spawn",
            args=(fn, tuple(args), n, device, backend,
                  os.path.join(tmp, "store"), tmp, timeout))
        end = None if deadline is None else time.monotonic() + deadline
        try:
            while not ctx.join(timeout=1.0):
                if end is not None and time.monotonic() > end:
                    raise TimeoutError(
                        f"the {n} ranks of {getattr(fn, '__name__', fn)} "
                        f"did not finish within {deadline} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(n)]
