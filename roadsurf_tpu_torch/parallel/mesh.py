"""Data parallelism over processes: one rank a device, explicit collectives.

Counterpart of the reference package's ``parallel/mesh.py``. There, one
program runs over a ``("data",)`` mesh of devices: the batch is sharded
over it (``P("data")``), the parameters replicated, and jit inserts the
gradient psum. Here each rank is a process that holds one device (NCCL on
CUDA, gloo on the CPU), and the collectives are explicit:

* :func:`shard_batch` takes rank r's contiguous rows ``[r·b, (r+1)·b)``
  of a global batch, which is what ``P("data")`` places on device r;
* :func:`replicate` broadcasts a tree of tensors from one rank, in one
  flat buffer per dtype;
* :meth:`DataParallelGroup.all_reduce` sums tensors over the ranks, in one
  flat buffer per dtype (the gradients: ``engine/train.py``);
* :func:`launch` spawns the ranks (``torch.multiprocessing``, spawn
  start method), rendezvous through a ``file://`` path in a fresh
  temporary directory, and hands back each rank's return value and its
  kernel launch counts.

On CUDA rank r takes ``cuda:{r % device_count}``. NCCL takes one rank a
device, so more CUDA ranks than devices raise, unless the caller asks for
gloo, which lets several ranks share a card (the compute stays on the
card; gloo carries the collectives of CUDA tensors). Nothing falls back
to fewer ranks or to the CPU.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


def default_backend(device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def default_world(device) -> int:
    """Every visible GPU for a CUDA device (the reference's default is
    every device, ``jax.devices()``); one rank on the CPU."""
    return torch.cuda.device_count() \
        if resolve_device(device).type == "cuda" else 1


def rank_device(device, rank: int) -> torch.device:
    """The device of rank ``rank``: ``cuda:{rank % device_count}`` on
    CUDA, else ``device`` itself."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def check_world(world: int, device, backend: str) -> None:
    """Refuses a world the devices cannot hold: fewer than one rank, or
    more CUDA ranks than devices unless the backend is gloo."""
    if world < 1:
        raise ValueError(f"world size {world}; at least 1 rank expected")
    dev = resolve_device(device)
    if dev.type == "cuda" and backend != "gloo" \
            and world > torch.cuda.device_count():
        raise ValueError(
            f"{world} ranks on {torch.cuda.device_count()} CUDA device(s): "
            f"{backend} takes one rank a device; pass backend='gloo' "
            "explicitly to run several ranks on one device")


@dataclass(eq=False)
class DataParallelGroup:
    """This process's place in the data-parallel group."""
    rank: int
    world: int
    device: torch.device
    backend: str

    def all_reduce(self, tensors: list) -> list:
        """The sums over the ranks of ``tensors`` (new tensors of their
        shapes), in one flat buffer per dtype."""
        out = list(tensors)
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            dist.all_reduce(flat)
            for i, part in zip(idx, flat.split(
                    [tensors[i].numel() for i in idx])):
                out[i] = part.view(tensors[i].shape)
        return out

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def data_parallel_group(rank: int, world: int, init_method: str,
                        device="cuda", backend: str | None = None,
                        timeout_s: float = 1800.0) -> DataParallelGroup:
    """Join the default process group as ``rank`` of ``world``: NCCL for
    CUDA devices and gloo for the CPU unless ``backend`` says otherwise;
    on CUDA the rank's device becomes the current one."""
    backend = backend or default_backend(device)
    check_world(world, device, backend)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return DataParallelGroup(rank, world, dev, backend)


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s contiguous rows ``[r·b, (r+1)·b)`` of every array
    or tensor of a global batch of B = world·b rows."""
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % world:
            raise ValueError(f"{k}: a batch of {B} rows does not split "
                             f"over {world} ranks")
        b = B // world
        out[k] = v[rank * b:(rank + 1) * b]
    return out


def replicate(tree, group: DataParallelGroup, src: int = 0):
    """Every tensor of ``tree`` (dicts and lists) overwritten in place with
    rank ``src``'s, in one broadcast a dtype; returns ``tree``."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        elif torch.is_tensor(t):
            leaves.append(t)

    walk(tree)
    with torch.no_grad():
        for dtype in dict.fromkeys(t.dtype for t in leaves):
            ts = [t for t in leaves if t.dtype == dtype]
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view(t.shape))
    return tree


# ---------------------------------------------------------------------------
# the launcher

def _rank_main(fn, rank: int, world: int, init_method: str, device,
               backend: str, out_dir: str, args: tuple) -> None:
    """A spawned rank: join the group, run ``fn(group, *args)``, save its
    return value and this process's kernel launch counts (or the
    traceback) under ``out_dir``."""
    from ..ops import launch_counts

    torch.set_num_threads(1)
    try:
        group = data_parallel_group(rank, world, init_method, device,
                                    backend)
        try:
            out = fn(group, *args)
        finally:
            dist.destroy_process_group()
        torch.save({"result": out, "launches": launch_counts()},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def launch(fn, world: int, *args, device="cuda", backend: str | None = None,
           timeout_s: float = 3600.0) -> list:
    """Run ``fn(group, *args)`` on ``world`` spawned ranks and return, rank
    by rank, ``{"result": its return value, "launches": its kernel launch
    counts}``. ``fn`` must be a module-level function of the package, so a
    child imports only the port. If a rank fails, the others are stopped
    and the failure is raised with the rank's traceback; every process is
    joined before this returns."""
    backend = backend or default_backend(device)
    check_world(world, device, backend)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dp_") as d:
        init = "file://" + os.path.join(d, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world, init, device, backend, d, args))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout_s} s")
                procs[0].join(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            errors = []
            for r in failed:
                path = os.path.join(d, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        errors.append(f"rank {r}:\n{f.read()}")
            raise RuntimeError(
                f"rank(s) {failed} of {world} failed (exit codes "
                f"{[procs[r].exitcode for r in failed]})\n"
                + "\n".join(errors))
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
