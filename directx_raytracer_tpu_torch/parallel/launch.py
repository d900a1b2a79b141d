"""Start a multi-process render on this host: ``launch`` spawns one
process per rank, joins them into a process group over localhost and calls
a function in each.  It serves the tests, ``chip_smoke.py`` and
``tools/dryrun_multichip.py``; a job across hosts starts its processes with
its own launcher and calls ``init_distributed`` itself.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .multihost import init_distributed


def local_device(device=None) -> torch.device:
    """The device this process renders on: ``cuda:{rank % device_count}``
    by default (ranks beyond the device count share cards), the CPU only
    when asked (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to render on "
                           "the CPU")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, fn, world_size, address, out_dir, args, backend):
    init_distributed(address, world_size, rank, backend=backend)
    try:
        result = fn(rank, world_size, *args)
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn, world_size: int, args=(), timeout: float = 600.0,
           device=None) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined into one process group (``tcp://localhost`` on a free
    port; start method ``spawn``), and return their results, rank by rank.

    ``device`` is the device ``fn`` renders on, where the caller names one
    (what it hands to ``local_device``): processes that render on the CPU
    join over gloo, whatever cards the host has; left None, the processes
    render on the host's cards and ``init_distributed`` picks the backend.

    ``fn`` must be importable from the child (a module-level function) and
    its result must be something ``torch.save`` takes (CPU tensors, numbers,
    containers of them).  A process that raises fails the call with its
    traceback; when the processes are not done after ``timeout`` seconds
    they are killed and ``TimeoutError`` is raised, so a hung rendezvous
    cannot hang the caller.  On a CUDA host, build the kernel library once
    before calling (``kernels.build_kernels``), or every child
    builds it.
    """
    address = f"tcp://localhost:{_free_port()}"
    on_cpu = device is not None and torch.device(device).type == "cpu"
    backend = "gloo" if on_cpu else None
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.spawn(_worker, args=(fn, world_size, address, out_dir, args, backend),
                       nprocs=world_size, join=False)
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):  # raises if a process failed
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} processes not done after "
                                       f"{timeout:g} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(out_dir, f"{rank}.pt"),
                           weights_only=False)
                for rank in range(world_size)]
