"""The shadow batch of ``ops.shading.direct_lighting`` on the CPU: its key
and ray chains (``shadow_keys_plain``, ``shadow_rays_plain``) against
independent numpy versions written as ``csrc/shadow_batch.cu`` computes
them, ``direct_lighting`` through them against the function as it was
before they were factored out of it, bit for bit, and the wrappers'
route: CPU tensors take the plain chains and launch nothing.  The kernels
themselves are held to the plain chains on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from directx_raytracer_tpu_torch import kernels, testscenes
from directx_raytracer_tpu_torch.models.scene import build_device_scene
from directx_raytracer_tpu_torch.ops import shading as psh
from directx_raytracer_tpu_torch.ops.intersect import occluded_bruteforce
from directx_raytracer_tpu_torch.utils import trace

F32 = np.float32


def spread10(x):
    """Bit b of each 10-bit value to bit 3b (uint32 magic masks)."""
    x = x.astype(np.uint32) & np.uint32(0x3FF)
    for shift, m in ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3),
                     (2, 0x09249249)):
        x = (x | (x << np.uint32(shift))) & np.uint32(m)
    return x


def keys_numpy(points, normals, mask, lo, hi):
    """The key kernel's arithmetic in numpy float32, point by point."""
    armed = np.isfinite(points).all(1) & np.isfinite(normals).all(1)
    if mask is not None:
        armed &= mask
    ext = np.maximum(hi - lo, F32(1e-12))
    with np.errstate(invalid="ignore", over="ignore"):
        c = np.clip((points - lo) / ext * F32(1024), F32(0), F32(1023))
    cell = np.where(armed[:, None], c, 0).astype(np.int32)
    key = (spread10(cell[:, 0]) | (spread10(cell[:, 1]) << np.uint32(1))
           | (spread10(cell[:, 2]) << np.uint32(2))).astype(np.int32)
    return np.where(armed, key, np.int32(2**31 - 1)), armed.astype(F32)


def rays_numpy(points, normals, mask, lxd, lyd, lzd, dist, cos, park):
    """The ray kernel's arithmetic in numpy float32, (light, point) by
    (light, point)."""
    bias = F32(psh.SHADOW_BIAS)
    with np.errstate(invalid="ignore", over="ignore"):
        s = points + normals * bias  # (N, 3)
    fin = np.isfinite(s).all(1)
    inside = np.ones_like(fin) if mask is None else mask
    live = fin & (inside | (not park))  # (N,)
    light = np.stack([lxd, lyd, lzd], axis=-1)  # (L, N, 3)
    ok = live[None, :] & np.isfinite(light).all(-1)
    t = np.where(cos > 0, dist - F32(2 * psh.SHADOW_BIAS), F32(0))
    if mask is not None:
        t = np.where((inside & fin)[None, :], t, F32(0))
    origins = np.where(live[:, None], s, F32(1e30))
    origins = np.broadcast_to(origins, light.shape)
    dirs = np.where(ok[..., None], light, F32(1))
    return (origins.reshape(-1, 3), dirs.reshape(-1, 3).astype(F32),
            t.reshape(-1).astype(F32))


def bits_equal(got: torch.Tensor, want) -> bool:
    want = torch.from_numpy(np.array(want))
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return torch.equal(got, want)


def batch(n, n_lights=4, seed=0):
    """Points in and around the box [-1, 1]^3, some on its faces, some not
    finite; unit normals, some not finite; a mask; (L, N) light terms as
    direct_lighting computes them, with non-finite and negative entries."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.2, 1.2, (n, 3)).astype(F32)
    p[0::7, 0] = -1.0  # on the box's faces: cells 0 and 1023
    p[1::7, 1] = 1.0
    p[2::7] = [1.0, -1.0, 1.0]
    p[3::11, 2] = np.nan
    p[4::13, 0] = np.inf
    nrm = rng.normal(size=(n, 3)).astype(F32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[5::17, 1] = np.inf
    nrm[6::19, 2] = np.nan
    mask = rng.random(n) < 0.7
    lpos = rng.uniform(-3, 3, (n_lights, 3)).astype(F32)
    with np.errstate(invalid="ignore", over="ignore"):
        tx, ty, tz = (lpos[:, a:a + 1] - p[None, :, a] for a in range(3))
        dist = np.sqrt(tx * tx + ty * ty + tz * tz)
        inv = F32(1) / np.maximum(dist, F32(1e-12))
        lxd, lyd, lzd = tx * inv, ty * inv, tz * inv
        cos = np.maximum(nrm[None, :, 0] * lxd + nrm[None, :, 1] * lyd
                         + nrm[None, :, 2] * lzd, F32(0))
    cos[:, 8::23] = np.nan
    lyd[:, 9::29] = np.inf
    return p, nrm, mask, (lxd, lyd, lzd, dist, cos)


@pytest.mark.parametrize("masked", ["mask", "none", "all_off"])
def test_keys_plain_equal_a_numpy_interleave(masked):
    p, nrm, mask, _ = batch(1_001)
    mask = {"mask": mask, "none": None, "all_off": np.zeros_like(mask)}[masked]
    lo, hi = np.full(3, -1.0, F32), np.full(3, 1.0, F32)
    key, armed = psh.shadow_keys_plain(
        torch.from_numpy(p), torch.from_numpy(nrm),
        None if mask is None else torch.from_numpy(mask),
        torch.from_numpy(lo), torch.from_numpy(hi))
    want_key, want_armed = keys_numpy(p, nrm, mask, lo, hi)
    assert key.dtype == torch.int32 and armed.dtype == torch.float32
    assert bits_equal(key, want_key) and bits_equal(armed, want_armed)
    on = want_armed > 0
    if masked == "all_off":
        assert not on.any()
    else:
        cells = {int(k) & 0x09249249 for k in want_key[on]}  # x's bits
        assert 0 in cells and int(spread10(np.array([1023]))[0]) in cells


@pytest.mark.parametrize("park,masked,n_lights", [
    (True, "mask", 4), (True, "mask", 1), (False, "mask", 4),
    (False, "none", 4), (True, "all_off", 4)])
def test_rays_plain_equal_the_kernels_arithmetic(park, masked, n_lights):
    p, nrm, mask, light = batch(1_001, n_lights, seed=3)
    mask = {"mask": mask, "none": None, "all_off": np.zeros_like(mask)}[masked]
    got = psh.shadow_rays_plain(
        torch.from_numpy(p), torch.from_numpy(nrm),
        None if mask is None else torch.from_numpy(mask),
        *map(torch.from_numpy, light), park)
    want = rays_numpy(p, nrm, mask, *light, park)
    for g, w in zip(got, want):
        assert g.is_contiguous() and bits_equal(g, w)
    t_max = got[2]
    assert (t_max > 0).any() == (masked != "all_off")


def direct_lighting_before(points, normals, lights, occluder_fn, mask=None,
                           view=None, shininess=None, sort_bounds=None):
    """``direct_lighting`` as it was before its shadow chains moved into
    ``shadow_keys_plain`` and ``shadow_rays_plain`` (spans left out)."""
    n = points.shape[0]
    n_l = min(lights.n_lights, lights.position.shape[0])
    lpos = lights.position[:n_l]
    linten = lights.intensity[:n_l]
    unsort = None
    if sort_bounds is not None and occluder_fn is not None:
        armed = (mask if mask is not None
                 else torch.ones((n,), dtype=torch.bool, device=points.device))
        armed = (armed & torch.isfinite(points).all(dim=-1)
                 & torch.isfinite(normals).all(dim=-1))
        key = psh._morton_key_points(points, sort_bounds[0], sort_bounds[1],
                                     armed)
        perm = torch.sort(key, stable=True).indices
        cols = [points, normals, armed.to(torch.float32)[:, None]]
        if view is not None:
            cols += [view, shininess[:, None]]
        packed = torch.cat(cols, dim=1)[perm]
        points, normals = packed[:, 0:3], packed[:, 3:6]
        mask = packed[:, 6] > 0.5
        if view is not None:
            view, shininess = packed[:, 7:10], packed[:, 10]
        unsort = perm
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    nxc, nyc, nzc = normals[:, 0], normals[:, 1], normals[:, 2]
    tx = lpos[:, 0:1] - px[None, :]
    ty = lpos[:, 1:2] - py[None, :]
    tz = lpos[:, 2:3] - pz[None, :]
    dist = torch.sqrt(tx * tx + ty * ty + tz * tz)
    inv_d = 1.0 / dist.clamp(min=1e-12)
    lxd, lyd, lzd = tx * inv_d, ty * inv_d, tz * inv_d
    cos = (nxc[None, :] * lxd + nyc[None, :] * lyd
           + nzc[None, :] * lzd).clamp(min=0.0)
    irrad = linten[:, None] / (psh.FOUR_PI * dist.clamp(min=1e-12) ** 2)
    contrib = irrad * cos
    spec = None
    if view is not None:
        hx = lxd - view[None, :, 0]
        hy = lyd - view[None, :, 1]
        hz = lzd - view[None, :, 2]
        hinv = 1.0 / torch.sqrt(hx * hx + hy * hy + hz * hz).clamp(min=1e-12)
        ndoth = ((nxc[None, :] * hx + nyc[None, :] * hy + nzc[None, :] * hz)
                 * hinv).clamp(min=0.0)
        spec = irrad * torch.where(cos > 0.0, ndoth ** shininess[None, :], 0.0)
    if occluder_fn is not None:
        sb = psh.SHADOW_BIAS
        sox, soy, soz = px + nxc * sb, py + nyc * sb, pz + nzc * sb
        finite = (torch.isfinite(sox) & torch.isfinite(soy)
                  & torch.isfinite(soz))
        live = finite
        if unsort is not None and mask is not None:
            live = finite & mask
        sox = torch.where(live, sox, 1e30)
        soy = torch.where(live, soy, 1e30)
        soz = torch.where(live, soz, 1e30)
        ok_l = (live[None, :] & torch.isfinite(lxd) & torch.isfinite(lyd)
                & torch.isfinite(lzd))
        t_shadow = torch.where(cos > 0.0, dist - 2.0 * sb, 0.0)
        if mask is not None:
            t_shadow = torch.where((mask & finite)[None, :], t_shadow, 0.0)
        origins = torch.stack([sox.expand(n_l, n), soy.expand(n_l, n),
                               soz.expand(n_l, n)], dim=-1)
        dirs_occ = torch.stack([torch.where(ok_l, lxd, 1.0),
                                torch.where(ok_l, lyd, 1.0),
                                torch.where(ok_l, lzd, 1.0)], dim=-1)
        blocked = occluder_fn(origins.reshape(-1, 3), dirs_occ.reshape(-1, 3),
                              t_shadow.reshape(-1)).reshape(n_l, n)
        contrib = torch.where(blocked, 0.0, contrib)
        if spec is not None:
            spec = torch.where(blocked, 0.0, spec)
    if mask is not None:
        contrib = torch.where(mask[None, :], contrib, 0.0)
        if spec is not None:
            spec = torch.where(mask[None, :], spec, 0.0)
    diffuse = contrib.sum(dim=0)[:, None]
    spec_sum = None if spec is None else spec.sum(dim=0)[:, None]
    if unsort is not None:
        diffuse = torch.zeros_like(diffuse).index_copy_(0, unsort, diffuse)
        if spec_sum is not None:
            spec_sum = torch.zeros_like(spec_sum).index_copy_(0, unsort,
                                                              spec_sum)
    return diffuse if spec_sum is None else (diffuse, spec_sum)


@pytest.fixture(scope="module")
def small_scene():
    """bench_scene(3_000) on the CPU and surface points over its box:
    on a sphere field's bounding box, some not finite."""
    d = build_device_scene(testscenes.bench_scene(3_000, 32, 24), "cpu")
    geo = d.geometry
    rng = np.random.default_rng(5)
    lo, hi = geo.scene_lo.numpy(), geo.scene_hi.numpy()
    n = 1_500
    p = rng.uniform(lo, hi, (n, 3)).astype(F32)
    p[::9, 1] = lo[1]  # on the ground
    p[3::31] = np.nan
    nrm = rng.normal(size=(n, 3)).astype(F32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[::9] = [0.0, 1.0, 0.0]
    view = rng.normal(size=(n, 3)).astype(F32)
    view /= np.linalg.norm(view, axis=1, keepdims=True)
    return dict(d=d, points=torch.from_numpy(p), normals=torch.from_numpy(nrm),
                mask=torch.from_numpy(rng.random(n) < 0.8),
                view=torch.from_numpy(view),
                shininess=torch.from_numpy(rng.uniform(2, 32, n).astype(F32)))


@pytest.mark.parametrize("mask,view,sort", [
    (False, False, False), (True, False, True), (True, True, True),
    (False, True, False), (True, True, False), (False, False, True)])
def test_direct_lighting_equals_its_form_before_the_factoring(
        small_scene, mask, view, sort):
    x = small_scene
    geo = x["d"].geometry
    calls = []

    def occluder(o, d, t_max):
        calls.append(o.shape[0])
        return occluded_bruteforce(o, d, geo.woop, t_max)

    kw = dict(mask=x["mask"] if mask else None,
              view=x["view"] if view else None,
              shininess=x["shininess"] if view else None,
              sort_bounds=(geo.scene_lo, geo.scene_hi) if sort else None)
    got = psh.direct_lighting(x["points"], x["normals"], x["d"].lights,
                              occluder, **kw)
    want = direct_lighting_before(x["points"], x["normals"], x["d"].lights,
                                  occluder, **kw)
    assert calls == [calls[0]] * 2
    got, want = (got, want) if view else ((got,), (want,))
    for g, w in zip(got, want):
        assert bits_equal(g, w.numpy())
        assert (g > 0).any() and (g == 0).any()


def test_wrappers_take_the_plain_chains_for_cpu_tensors(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(kernels, "_lib", no_library)
    p, nrm, mask, light = batch(300)
    p, nrm, mask = map(torch.from_numpy, (p, nrm, mask))
    light = tuple(map(torch.from_numpy, light))
    lo, hi = torch.full((3,), -1.0), torch.full((3,), 1.0)
    before = trace.launches()
    got = psh.shadow_keys(p, nrm, mask, lo, hi)
    want = psh.shadow_keys_plain(p, nrm, mask, lo, hi)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = psh.shadow_rays(p, nrm, mask, *light, True)
    want = psh.shadow_rays_plain(p, nrm, mask, *light, True)
    assert all(bits_equal(g, w.numpy()) for g, w in zip(got, want))
    assert trace.launches() == before
