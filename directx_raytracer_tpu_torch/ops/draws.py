"""Keyed draws: the path tracer's random numbers as a pure function of the
pixel, never of the queue.

Every uniform a path-tracing pass consumes is a function of four integers:
the sample key, the pixel's raster index ``py * W + px`` in the full frame,
the bounce, and the stream (0, 1: u1 and u2 of the cosine sample, 2: the
Fresnel branch pick, 3: the roulette draw).  The function is
Philox4x32-10 (Salmon, Moraes, Dror and Shaw, "Parallel random numbers: as
easy as 1, 2, 3", SC'11), run once a (pixel, bounce) with

* counter ``(raster id, bounce, domain, 0)``, domain 0 for a pass's draws;
* key ``(sample key & 0xFFFFFFFF, sample key >> 32)``;

its four 32-bit output words are the four streams, each mapped to f32 in
[0, 1) as ``(x >> 8) * 2^-24`` (exact: 24 bits fit the mantissa).  The
sample's sub-pixel jitter is words 0 and 1 of domain 1, counter
``(0, 0, 1, 0)``.  A sample's key is a function of the tracer's seed and
the sample's index k: words 0 and 1 of Philox4x32-10 with key ``(seed low
word, seed high word)`` and counter ``(k low word, k high word, 2, 0)``
(``sample_key``).  Every step is exact integer arithmetic, so the draws
do not depend on the device, the queue's order, the pixel tiling or the
band a process renders: a plain reference that follows one path a pixel
draws the same numbers.

``pt_draws`` takes the queue's pixel ids as the queue holds them
(band-local, tile-major in ``pick_schedule``'s tiles; ``Layout`` maps them
to raster ids) and returns the (4, n) f32 streams: for CUDA tensors one
launch of the hand-written kernel (``csrc/pt_draws.cu``, counted as
``launch.pt_draws``), for CPU tensors its pure-torch twin
``pt_draws_plain``, bit-equal to it.  The twin multiplies 32-bit words by
16-bit halves in int64, so no product overflows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import check_tensor, launch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10
MASK32 = 0xFFFFFFFF
SCALE = 2.0 ** -24
DOMAIN_PASS, DOMAIN_JITTER, DOMAIN_SAMPLE = 0, 1, 2


class Layout(NamedTuple):
    """How a queue's pixel ids map to raster ids: ids are tile-major in
    tiles of ``tile_h`` x ``tile_w`` pixels over a band of ``width``-pixel
    rows that starts at frame row ``row_start`` (``tile_h`` 1 and
    ``tile_w`` = ``width`` for row-major ids)."""

    tile_h: int
    tile_w: int
    width: int
    row_start: int = 0

    @classmethod
    def of(cls, tile, width: int, row_start: int = 0) -> "Layout":
        th, tw = tile if tile is not None else (1, width)
        return cls(th, tw, width, row_start)

    def raster(self, ids: torch.Tensor) -> torch.Tensor:
        """The raster ids (int64) of band-local ids."""
        ids = ids.long()
        rx, t1 = ids % self.tile_w, ids // self.tile_w
        ry, t2 = t1 % self.tile_h, t1 // self.tile_h
        tiles_x = self.width // self.tile_w
        tx, ty = t2 % tiles_x, t2 // tiles_x
        return ((ty * self.tile_h + ry + self.row_start) * self.width
                + tx * self.tile_w + rx)


def _key_words(key: int) -> tuple[int, int]:
    key = int(key) & (2**64 - 1)
    return key & MASK32, key >> 32


# ---------------------------------------------------------------------------
# The pure-torch twin
# ---------------------------------------------------------------------------


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) words of the 64-bit product of the constant ``m`` and the
    32-bit words ``x`` (int64 tensors or Python ints), from 16-bit halves."""
    mh, ml = m >> 16, m & 0xFFFF
    xh, xl = x >> 16, x & 0xFFFF
    ll = xl * ml
    mid = xh * ml + xl * mh + (ll >> 16)  # < 2^34
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = xh * mh + (mid >> 16)
    return hi, lo


def philox_plain(c0, c1, c2, c3, key: int):
    """Philox4x32-10 of the counter words ``c0``-``c3`` (int64 tensors of
    32-bit words, or Python ints) under the 64-bit ``key``: the four output
    words, int64 tensors where any counter word is one (each word reaches
    every output within three rounds), Python ints where none is."""
    k0, k1 = _key_words(key)
    c = [c0, c1, c2, c3]
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c[0])
        hi1, lo1 = _mulhilo(M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def sample_key(seed: int, k: int) -> int:
    """The 64-bit key of sample ``k`` of a tracer seeded with ``seed``."""
    k = int(k) & (2**64 - 1)
    w = philox_plain(k & MASK32, k >> 32, DOMAIN_SAMPLE, 0, seed)
    return w[0] | (w[1] << 32)


def to_unit(words: torch.Tensor) -> torch.Tensor:
    """32-bit words (int64) as f32 in [0, 1): (x >> 8) * 2^-24, exact."""
    return (words >> 8).to(torch.float32) * SCALE


def pt_draws_plain(ids: torch.Tensor, key: int, bounce: int,
                   layout: Layout) -> torch.Tensor:
    """The (4, n) f32 draws of the rows whose pixel ids are ``ids``."""
    c0 = layout.raster(ids)
    words = philox_plain(c0, int(bounce) & MASK32, DOMAIN_PASS, 0, key)
    return torch.stack([to_unit(w) for w in words])


def jitter_plain(key: int, device) -> torch.Tensor:
    """The sample's sub-pixel jitter (2,) f32."""
    c0 = torch.zeros((1,), dtype=torch.int64, device=device)
    words = philox_plain(c0, 0, DOMAIN_JITTER, 0, key)
    return torch.cat([to_unit(w) for w in words[:2]])


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def _launch(ids, n: int, key: int, bounce: int, domain: int,
            layout: Layout, device) -> torch.Tensor:
    out = torch.empty((4, n), dtype=torch.float32, device=device)
    if ids is not None:
        check_tensor("ids", ids, torch.int32, (n,), device)
    lo, hi = _key_words(key)
    launch("pt_draws", "dxrt_pt_draws", device,
           None if ids is None else ids.data_ptr(), n, lo, hi,
           int(bounce) & MASK32, domain, layout.tile_h, layout.tile_w,
           layout.width // layout.tile_w, layout.width, layout.row_start,
           out.data_ptr())
    return out


def pt_draws(ids: torch.Tensor, key: int, bounce: int,
             layout: Layout) -> torch.Tensor:
    """The (4, n) f32 draws of a pass whose queue rows hold pixel ids
    ``ids`` (n,) i32: the kernel for CUDA tensors, the twin for CPU ones."""
    if ids.device.type == "cpu":
        return pt_draws_plain(ids, key, bounce, layout)
    return _launch(ids, ids.shape[0], key, bounce, DOMAIN_PASS, layout,
                   ids.device)


def jitter(key: int, device) -> torch.Tensor:
    """The sample's sub-pixel jitter (2,) f32 on ``device``: made there,
    so no host value is copied (no host sync)."""
    device = torch.device(device)
    if device.type == "cpu":
        return jitter_plain(key, device)
    return _launch(None, 1, key, 0, DOMAIN_JITTER, Layout(1, 1, 1),
                   device)[:2, 0]

