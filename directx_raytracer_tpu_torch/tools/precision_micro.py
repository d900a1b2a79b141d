"""Micro-bench: the Woop fold under three dot precisions, on the card.

Counterpart of the repository's ``tools/precision_micro.py`` (its Pallas
kernel ``_body``, launched by ``launch``), with the same names and shapes.
For each of S steps, each of the step's K triangles and each of R rays it
forms ``mm = w[s]^T @ rays[0]``, a (6K, R) product of contraction depth 8,
then the production-shaped Woop tail

    tt = -mm[2K+k] / mm[5K+k]
    u  = mm[k]   + tt * mm[3K+k]
    v  = mm[K+k] + tt * mm[4K+k]
    ok = min(min(u, v), 1 - u - v) >= 0  and  tt > 1e-3

and keeps, per ray, the min over every (step, triangle) of the int32 bits
of the accepted tt (positive floats order as their bits do), or
``SENTINEL`` = 2**31 - 2 where nothing is accepted.  The precision of the
product is the variant:

  default : operands rounded to bf16 (round to nearest even), products
            summed in f32: the TPU's 1-pass bf16 dot
  highest : full f32
  split3  : hi = bf16(x), lo = bf16(x - hi) for both operands, then
            hi*hi + lo*hi + hi*lo (bf16x3, each pass a 1-pass bf16 dot)

``precision_fold`` launches ``csrc/precision_micro.cu`` for CUDA tensors
(and raises if it cannot) and takes ``precision_fold_plain`` for CPU
tensors.  Both take the JAX layout as it is, w (S, 8, 6K) f32 and rays
(1, 8, R) f32, so the JAX tool's numpy inputs are handed over unchanged:
no conversion function is needed.  The output starts at ``SENTINEL``: the
JAX kernel never initialises its output block, so its result is undefined
(its interpret-mode run reads -2**31 in every lane).

Run on the card (``--device cpu`` runs the plain version on the CPU):

    python -m directx_raytracer_tpu_torch.tools.precision_micro
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time

import numpy as np
import torch

from ..bvh import cuda_intersect as ci
from ..utils import trace

K = 128
R = 256
STEPS = 2048  # steps per launch, as in the JAX tool
VARIANTS = ("default", "highest", "split3")
SENTINEL = 2**31 - 2  # no accepted candidate
T_EPS = 1e-3  # the tail's t threshold
PLAIN_CHUNK = 64  # steps per pass of the plain version (~50 MB temporaries)
# The error probe counts a ray's min t as agreeing with float64 within the
# repository's own t gate (bench.py:156-164).
PROBE_RTOL = 1e-3


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}, expected one of {VARIANTS}")


@contextlib.contextmanager
def _full_f32():
    """Float32 matmuls in full f32 (no TF32) inside the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _split(x: torch.Tensor):
    """(hi, lo) = (bf16(x), bf16(x - hi)) as f32, rounded to nearest even."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _product(variant: str, w: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """mm (S, 6K, R) = w[s]^T @ rays[0] under the variant's precision."""
    wt = w.transpose(1, 2)
    if variant == "highest":
        return wt @ rays
    (w_hi, w_lo), (r_hi, r_lo) = _split(wt), _split(rays)
    mm = w_hi @ r_hi
    if variant == "split3":
        mm = mm + w_lo @ r_hi
        mm = mm + w_hi @ r_lo
    return mm


def _tail(mm: torch.Tensor):
    """tt (S, K, R) and its accept mask: the JAX kernel's tail
    (tools/precision_micro.py:57-64), op for op."""
    k = mm.shape[1] // 6
    tt = -mm[:, 2 * k:3 * k] / mm[:, 5 * k:6 * k]
    u = mm[:, 0:k] + tt * mm[:, 3 * k:4 * k]
    v = mm[:, k:2 * k] + tt * mm[:, 4 * k:5 * k]
    q = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
    return tt, (q >= 0.0) & (tt > T_EPS)


def precision_fold_plain(variant: str, w: torch.Tensor, rays: torch.Tensor,
                         chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain torch version of ``precision_fold``: the product as a batched
    f32 matmul with TF32 off, the tail elementwise, ``PLAIN_CHUNK`` steps
    at a time.  Returns (1, 1, R) int32."""
    _check_variant(variant)
    out = torch.full((rays.shape[2],), SENTINEL, dtype=torch.int32,
                     device=w.device)
    with _full_f32():
        for s0 in range(0, w.shape[0], chunk):
            tt, ok = _tail(_product(variant, w[s0:s0 + chunk], rays))
            packed = torch.where(ok, tt.view(torch.int32), SENTINEL)
            out = torch.minimum(out, packed.amin(dim=(0, 1)))
    return out.reshape(1, 1, -1)


def fold_min_t_f64(w: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """The same fold in float64 (product and tail): each ray's min accepted
    t as (R,) f64, +inf where nothing is accepted.  The error probe's
    reference."""
    best = torch.full((rays.shape[2],), float("inf"), dtype=torch.float64,
                      device=w.device)
    r64 = rays.double()
    for s0 in range(0, w.shape[0], PLAIN_CHUNK):
        tt, ok = _tail(w[s0:s0 + PLAIN_CHUNK].double().transpose(1, 2) @ r64)
        best = torch.minimum(best, torch.where(ok, tt, float("inf"))
                             .amin(dim=(0, 1)))
    return best


def precision_fold(variant: str, w: torch.Tensor,
                   rays: torch.Tensor) -> torch.Tensor:
    """Each ray's min packed t over every (step, triangle) of the fold, as
    (1, 1, R) int32: the ``precision_micro`` kernel for CUDA tensors (w
    (S, 8, 6K) and rays (1, 8, R) f32, K = 128, R = 256), its plain version
    for CPU tensors."""
    if w.device.type == "cpu":
        return precision_fold_plain(variant, w, rays)
    _check_variant(variant)
    dev = w.device
    steps = w.shape[0]
    ci._check("w", w, torch.float32, (steps, 8, 6 * K), dev)
    ci._check("rays", rays, torch.float32, (1, 8, R), dev)
    out = torch.full((1, 1, R), SENTINEL, dtype=torch.int32, device=dev)
    if steps:
        lib = ci._lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.dxrt_precision_fold(w.data_ptr(), rays.data_ptr(),
                                          out.data_ptr(), steps,
                                          VARIANTS.index(variant), stream)
        ci.check_launch(lib, "precision_micro", err)
        # Counted as launch.precision_micro.<variant>; the plain version
        # never counts.
        trace.count(f"launch.precision_micro.{variant}")
    return out


def min_t(packed: torch.Tensor) -> torch.Tensor:
    """(R,) f64 min t from packed (1, 1, R) int32: +inf for the sentinel."""
    flat = packed.reshape(-1)
    t = flat.view(torch.float32).double()
    return torch.where(flat == SENTINEL, float("inf"), t)


def agreement(t: torch.Tensor, ref: torch.Tensor, rtol: float) -> float:
    """Share of rays whose min t agrees with ``ref`` (both +inf, or both
    finite within ``rtol`` relative)."""
    miss, ref_miss = torch.isinf(t), torch.isinf(ref)
    rel = (t - ref).abs() / ref.abs()
    ok = (miss == ref_miss) & (ref_miss | (rel <= rtol))
    return ok.double().mean().item()


def card_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[device.index or 0]


def time_launches(fn, reps: int, device: torch.device) -> float:
    """ms per call of ``fn`` over ``reps`` calls in a row, after one
    warm-up: CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def make_inputs(steps: int, device, seed: int = 0):
    """The JAX tool's inputs: standard normal w (steps, 8, 6K) then rays
    (1, 8, R) from ``default_rng(seed)``, as f32 on ``device``."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((steps, 8, 6 * K)).astype(np.float32)
    rays = rng.standard_normal((1, 8, R)).astype(np.float32)
    return torch.from_numpy(w).to(device), torch.from_numpy(rays).to(device)


def run(device, steps: int = STEPS, reps: int = 10) -> dict:
    """The JAX tool's ``main`` on ``device``: its seeded inputs
    (``make_inputs``); per variant, ms per launch over ``reps`` launches
    and the share of rays whose min t agrees with ``fold_min_t_f64``.
    Prints one line per variant and returns {variant: {...}}."""
    device = torch.device(device)
    w, rays = make_inputs(steps, device)
    label = card_label(device)
    ref = fold_min_t_f64(w, rays)
    results = {}
    for variant in VARIANTS:
        out = precision_fold(variant, w, rays)
        ms = time_launches(lambda: precision_fold(variant, w, rays), reps,
                           device)
        agree = agreement(min_t(out), ref, PROBE_RTOL)
        results[variant] = dict(ms=ms, agree_f64=agree)
        print(f"{variant:8s}: {ms:9.4f} ms / {steps} steps "
              f"({ms / steps * 1e3:8.4f} us/step); min t within "
              f"{PROBE_RTOL:g} of float64 on {agree:.4f} of {R} rays "
              f"[{label}]", flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m directx_raytracer_tpu_torch.tools.precision_micro",
        description="Time the Woop fold under three dot precisions.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel, default) or cpu (the plain version)")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("precision_micro: no CUDA device (--device cpu runs the plain "
              "version)", file=sys.stderr)
        return 1
    run(device, args.steps, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
