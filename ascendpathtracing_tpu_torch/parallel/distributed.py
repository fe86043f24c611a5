"""Process groups: one process a rank, one device a rank.

Counterpart of ``ascendpathtracing_tpu/parallel/distributed.py``:

    initialize()                        # once per process, from torchrun's env
    mesh = make_global_mesh()           # (data, model) over every rank
    rays = host_local_rays(rays, mesh)  # each rank takes its shard

A world is either one rank per card, over NCCL, or several ranks that
share one card (or the CPU), over gloo: NCCL refuses two ranks on one
GPU.  :func:`choose_backend` applies that rule, and nothing switches the
backend after a failure.  :func:`run_local_world` spawns a world of local
ranks in place of the JAX package's virtual devices: the CLI's
``--shard``, the dry run (``graft_entry``), ``chip_smoke.py`` and the
tests run their ranks through it.

The JAX package's ``TPU_ASYNC_FLAGS`` and ``apply_async_collective_flags``
are libtpu flags and have no counterpart here.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

_RANK_DEVICE: torch.device | None = None  # set by initialize


def choose_backend(device: str, local_world_size: int) -> str:
    """``"nccl"`` for one rank a card, ``"gloo"`` when the local ranks
    outnumber the cards (they share one) or run on the CPU."""
    if device == "cpu":
        return "gloo"
    if device != "cuda":
        raise ValueError(f"unknown device {device!r}; expected 'cuda' or 'cpu'")
    return "nccl" if local_world_size <= torch.cuda.device_count() else "gloo"


def _rank_env():
    env = os.environ
    world = int(env.get("WORLD_SIZE", "1"))
    rank = int(env.get("RANK", "0"))
    local_rank = int(env.get("LOCAL_RANK", str(rank)))
    local_world = int(env.get("LOCAL_WORLD_SIZE", str(world)))
    return world, rank, local_rank, local_world


def initialize(device: str = "cuda") -> torch.device:
    """Join the world that torchrun's variables (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) describe,
    with the backend :func:`choose_backend` picks, and set this rank's
    device: ``cuda:LOCAL_RANK`` with one rank a card, ``cuda:0`` when the
    ranks share it, the CPU when ``device="cpu"``.  Joins nothing for one
    process or when a group is up already.  Returns the rank's device.
    Raises when CUDA is asked for and absent."""
    global _RANK_DEVICE
    from ascendpathtracing_tpu_torch.device import resolve_device

    resolve_device(device)  # raises without CUDA
    world, rank, local_rank, local_world = _rank_env()
    if dist.is_initialized():
        backend = dist.get_backend()
    elif world > 1:
        backend = choose_backend(device, local_world)
    else:
        backend = None
    if device == "cpu":
        dev = torch.device("cpu")
    elif backend == "nccl":
        dev = torch.device("cuda", local_rank)
    else:
        dev = torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _RANK_DEVICE = dev
    if backend is not None and not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return dev


def rank_device() -> torch.device:
    """This rank's device, as :func:`initialize` set it; the CPU in a
    process that never called it."""
    return _RANK_DEVICE if _RANK_DEVICE is not None else torch.device("cpu")


def make_global_mesh(model_parallel=None):
    """(data, model) mesh over every rank of the job."""
    from ascendpathtracing_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(dist.get_world_size(), model_parallel=model_parallel)


def host_local_rays(rays_global, mesh) -> torch.Tensor:
    """This rank's shard of the full rays [N, 6] (a NumPy array or tensor
    that every process holds), on this rank's device."""
    from ascendpathtracing_tpu_torch.parallel.sharded import shard_rays

    return shard_rays(torch.as_tensor(rays_global), mesh).to(rank_device())


def process_info() -> dict:
    up = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_devices": 1,
        "global_devices": dist.get_world_size() if up else 1,
        "backend": dist.get_backend() if up else None,
        "device": str(rank_device()),
    }


# ------------------------------------------------------- local worlds ----
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, n, port, device, args, workdir):
    """A spawned rank: its output to its log, torchrun's variables, the
    group, ``fn(*args)``, its result to a file."""
    log = os.open(os.path.join(workdir, f"rank{rank}.log"), os.O_WRONLY | os.O_CREAT, 0o644)
    os.dup2(log, 1)
    os.dup2(log, 2)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(n), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
    if device == "cpu":
        torch.set_num_threads(1)
    try:
        dev = initialize(device)
        if not dist.is_initialized():  # a world of one rank still gets its group
            dist.init_process_group(choose_backend(device, n), init_method="env://",
                                    rank=rank, world_size=n)
        print(f"rank {rank} of {n}: backend {dist.get_backend()}, device {dev}", flush=True)
        result = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise SystemExit(1) from None


def run_local_world(fn, n: int, *, device: str, args=(), timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in each rank of a world of ``n`` local processes
    (``spawn``), on ``device`` ("cuda": every rank on the one card over
    gloo, or one a card over NCCL where there are ``n`` cards; "cpu":
    gloo, one thread a rank) -> the ranks' return values, in rank order.

    ``fn`` must be importable by name (a module-level function of a
    module that the ranks can import).  With ``device="cuda"`` the CUDA
    libraries are built here first, so that the ranks only load them.  A
    rank that fails, or that is still running after ``timeout`` seconds,
    fails the whole call: every rank is stopped and the RuntimeError
    carries that rank's log."""
    import multiprocessing as mp

    from ascendpathtracing_tpu_torch.device import resolve_device

    resolve_device(device)  # raises without CUDA
    if n < 1:
        raise ValueError(f"a world needs at least one rank, got {n}")
    if device == "cuda":
        from ascendpathtracing_tpu_torch.ops import build

        build.build_all(build.LIBRARIES)
    ctx = mp.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="apt_world_") as workdir:
        procs = [ctx.Process(target=_rank_main, args=(fn, r, n, port, device, args, workdir),
                             daemon=True) for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed, timed_out = None, False
        try:
            while True:
                codes = [p.exitcode for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = bad[0]
                    break
                if None not in codes:
                    break
                if time.monotonic() > deadline:
                    failed, timed_out = codes.index(None), True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                p.join(10)
        if failed is not None:
            log = Path(workdir, f"rank{failed}.log")
            text = log.read_text(errors="replace") if log.exists() else "(no log)"
            why = (f"outlived its timeout of {timeout} s" if timed_out
                   else f"exited with {procs[failed].exitcode}")
            raise RuntimeError(f"rank {failed} of {n} ({device}) {why}; its log:\n{text[-6000:]}")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(n)]
