"""Process-group bootstrap and the 2-D rank grid (counterpart of
d2dgs_tpu/parallel/multihost.py).

The JAX package runs one controller per host over a device mesh and lets
XLA place the collectives.  The port runs one process per rank (SPMD):
``torchrun --nproc_per_node N`` sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``, and
``maybe_init_distributed`` joins the process group from them, or from an
explicit ``init_method``.  The backend follows the device: NCCL for
``cuda``, gloo for ``cpu``, with no fallback from one to the other.  In a
single process with neither it does nothing, so the same entry point runs
everywhere.

``global_mesh`` lays the ranks out as the JAX package's (data x gauss)
mesh: rank = data_idx * n_gauss + gauss_idx, one group per data row (the
gauss axis: its ranks shard the Gaussians and the tiles of one camera)
and one per gauss column (the data axis: its ranks hold the same shard
for different cameras).
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """The collective backend of a device: NCCL on CUDA, gloo on CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {device!r}")


def maybe_init_distributed(device="cuda", init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           timeout_s: float = 600.0) -> tuple[int, int]:
    """Join the process group when this is a multi-process run: torchrun's
    environment (``WORLD_SIZE`` > 1) or an explicit ``init_method`` (with
    ``world_size`` and ``rank``).  On CUDA the rank's card is
    ``LOCAL_RANK``.  Returns (rank, world size); (0, 1) in a single
    process with neither."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if init_method is None and int(env.get("WORLD_SIZE", "1")) <= 1:
        return 0, 1
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
    kw = {}
    if init_method is not None:
        kw = dict(init_method=init_method,
                  world_size=int(env.get("WORLD_SIZE", "1"))
                  if world_size is None else world_size,
                  rank=int(env.get("RANK", "0")) if rank is None else rank)
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def local_device(device="cuda") -> torch.device:
    """This rank's device: its ``LOCAL_RANK``'s card on CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


@dataclass(frozen=True)
class RankGrid:
    """This rank's place in the (data x gauss) grid and the groups of its
    row (``gauss_group``) and column (``data_group``); the groups are None
    when no process group exists (one process, a 1 x 1 grid), and every
    collective is then the identity."""
    n_data: int
    n_gauss: int
    data_idx: int
    gauss_idx: int
    gauss_group: object = None
    data_group: object = None
    world: bool = False        # the default group spans the grid


def global_mesh(shape: tuple[int, int] = (1, 1)) -> RankGrid:
    """The 2-D rank grid over every rank of the process group.  Every rank
    creates every row and column group, in the same order, as
    ``torch.distributed.new_group`` requires."""
    n_data, n_gauss = (int(s) for s in shape)
    need = n_data * n_gauss
    if not dist.is_initialized():
        if need != 1:
            raise RuntimeError(f"a {n_data} x {n_gauss} grid needs {need} "
                               f"ranks; no process group is initialised")
        return RankGrid(1, 1, 0, 0)
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(f"a {n_data} x {n_gauss} grid needs {need} ranks, "
                           f"the process group has {world}")
    rank = dist.get_rank()
    rows = [dist.new_group([i * n_gauss + j for j in range(n_gauss)])
            for i in range(n_data)]
    cols = [dist.new_group([i * n_gauss + j for i in range(n_data)])
            for j in range(n_gauss)]
    i, j = divmod(rank, n_gauss)
    return RankGrid(n_data, n_gauss, i, j, gauss_group=rows[i],
                    data_group=cols[j], world=True)


def _rank_main(rank, fn, nprocs, store, device, threads, args):
    torch.set_num_threads(threads)
    maybe_init_distributed(device, init_method=f"file://{store}",
                           world_size=nprocs, rank=rank, timeout_s=60.0)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_local(fn, nprocs: int, *args, store: str, device="cpu",
              threads: int = 1, timeout_s: float = 120.0) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes of one
    process group, joined through the file ``store`` (a fresh path; a
    file store needs no port, so concurrent runs never collide).  ``fn``
    must be importable by name (a module's top-level function).  Raises
    when a rank fails, or when the run outlasts ``timeout_s`` (its
    processes are then killed)."""
    import time

    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main, args=(fn, nprocs, store, device,
                                               threads, args),
                             nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{nprocs} ranks of {fn.__name__} "
                                   f"outlasted {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
