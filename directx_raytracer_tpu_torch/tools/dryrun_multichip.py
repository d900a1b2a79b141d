"""Multi-device dry run: one fully-sharded frame on tiny shapes.

Counterpart of ``dryrun_multichip`` in the repository's
``__graft_entry__.py``: ``dryrun_multichip(n)`` starts ``n`` processes on
this host, builds an n-process (tiles x samples) mesh and executes one
Whitted frame and one path-traced accumulation over it, with an uneven
height and an uneven spp.

    python -m directx_raytracer_tpu_torch.tools.dryrun_multichip 4 [--device cpu]

Each process renders on ``cuda:{rank % device_count}`` unless ``--device
cpu`` is given; processes on the CPU or sharing a card talk over gloo,
processes with a card each over nccl (parallel/multihost.py).
"""

from __future__ import annotations

import argparse

import torch


def _dryrun_rank(rank: int, world: int, device):
    from .. import testscenes
    from ..models.scene import build_device_scene
    from ..parallel import (local_device, make_mesh, pathtrace_multichip,
                            render_whitted_multichip)

    # 2-D sharding when possible: tiles x samples (the sample axis exercises
    # the all-reduce accumulation path).
    n_samples = 2 if world % 2 == 0 and world > 1 else 1
    n_tiles = world // n_samples
    mesh = make_mesh(n_tiles=n_tiles, n_samples=n_samples)

    # Uneven height + uneven spp exercise the padded row-stripe and
    # zero-weight dummy-sample paths (no divisibility requirements).
    height = 8 * n_tiles + 3
    scene = testscenes.cornell_box(64, height)
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dscene = build_device_scene(scene, device)
    pos, rot = scene.camera.snapshot()
    img, stats = render_whitted_multichip(
        dscene, pos, rot, 64, height, mesh,
        max_depth=2, spp=3 if n_samples > 1 else 1,
    )
    assert tuple(img.shape) == (height, 64, 3), tuple(img.shape)
    assert bool(torch.isfinite(img).all())

    # Also the path tracer over the same mesh: its per-shard random streams
    # and all-reduce accumulation have their own sharding surface.
    acc = pathtrace_multichip(
        dscene, pos, rot, 0, 64, height, mesh,
        spp=2 if n_samples > 1 else 1, max_depth=2,
    )
    assert acc.shape[1] == 3
    assert bool(torch.isfinite(acc).all())
    return {"coords": mesh.coords, "device": str(img.device),
            "image_mean": float(img.mean()), "pt_sum": float(acc.sum())}


def dryrun_multichip(n_devices: int, device=None, timeout: float = 600.0) -> list:
    """Run the dry run over ``n_devices`` processes of this host; returns
    each rank's report.  A failing rank raises."""
    from ..parallel import launch

    on_card = device is None or torch.device(device).type == "cuda"
    if on_card and torch.cuda.is_available():
        from ..kernels import build_kernels

        build_kernels()  # once, before the children race to
    return launch(_dryrun_rank, n_devices, (device,), timeout=timeout,
                  device=device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", default=None,
                   help="torch device of every process (default: its own "
                   "CUDA device)")
    args = p.parse_args(argv)
    for report in dryrun_multichip(args.n_devices, args.device):
        print(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
