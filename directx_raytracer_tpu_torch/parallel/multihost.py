"""Multi-process (and multi-host) scaling hooks.

Counterpart of ``directx_raytracer_tpu/parallel/multihost.py``
(``init_distributed``, ``global_mesh_shape``, ``make_global_mesh``).

The reference is a single-process, single-GPU program (SURVEY.md §2e).
The port's scaling story is pure data parallelism over rays (see
sharding.py): one process per device, every process renders its row
stripe and sample subset, the sample-axis sum is an all-reduce and the
stripes are gathered.  Where JAX is single-controller (one program, a mesh
of devices), ``torch.distributed`` is one process per device, so this
module is the entry point every process calls once before it builds a
mesh: :func:`init_distributed`, then :func:`make_global_mesh`.  A
single-process run initialises nothing, so single-device code paths never
change.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger("directx_raytracer_tpu_torch")

INIT_TIMEOUT_S = 300  # a rendezvous that hangs fails after this long


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> int:
    """Join the process group for multi-process rendering.

    ``coordinator_address`` is ``host:port`` or ``tcp://host:port``; with a
    process count and no address, the ``env://`` rendezvous of a launcher
    such as torchrun is used.  A single-process call (num_processes in
    (None, 0, 1) with no coordinator) skips initialisation entirely and
    returns 1.  Returns the process count actually joined.

    ``backend`` is the caller's choice where it knows the device its
    processes render on: ``"gloo"`` for processes that render on the CPU,
    whatever cards the host has.  Left None it is ``nccl`` when every
    process of this host has a CUDA device of its own, ``gloo`` otherwise
    (no CUDA device, or processes sharing one: NCCL refuses two ranks on
    one device; the renders still run on the card and only the reduced
    buffers cross through the host).
    """
    if coordinator_address is None and not num_processes:
        log.info("multihost: single-process run, skipping distributed init")
        return 1
    kwargs = {}
    if coordinator_address is not None:
        if "://" not in coordinator_address:
            coordinator_address = "tcp://" + coordinator_address
        kwargs = dict(init_method=coordinator_address,
                      world_size=num_processes, rank=process_id)
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes or 1))
        own_card = (torch.cuda.is_available()
                    and torch.cuda.device_count() >= local)
        backend = "nccl" if own_card else "gloo"
    dist.init_process_group(
        backend=backend,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S), **kwargs)
    n = dist.get_world_size()
    log.info("multihost: joined as process %d / %d (%s)", dist.get_rank(), n,
             dist.get_backend())
    return n


def global_mesh_shape(n_devices: int, n_samples: int = 1) -> tuple[int, int]:
    """(tiles, samples) axis sizes for ``n_devices`` total devices.

    The sample axis is clamped to divide the device count; the tile (row
    stripe) axis takes the rest.  Pure function — unit-testable without a
    cluster.
    """
    if n_devices < 1:
        raise ValueError("need at least one device")
    n_samples = max(1, min(n_samples, n_devices))
    while n_devices % n_samples:
        n_samples -= 1
    return n_devices // n_samples, n_samples


def make_global_mesh(n_samples: int = 1):
    """(tiles, samples) mesh over ALL processes of the job (every host's):
    one device per process.  Ranks are tile-major, so with ranks numbered
    host by host a host's processes hold neighbouring row stripes."""
    from .sharding import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    n_tiles, n_samples = global_mesh_shape(world, n_samples)
    return make_mesh(n_tiles=n_tiles, n_samples=n_samples)
