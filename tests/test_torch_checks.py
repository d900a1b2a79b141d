"""DXRT_CHECK=1 debug build of the torch port (``utils/checks.py``, the
guards in the Whitted and path-tracing passes, ``render_whitted_checked``)
on the CPU: the cases of tests/test_checks.py, on the same scene, beside
the JAX package's checked renderer.

Tolerances: the checked frame equals the unchecked one to 1e-6 (the guards
only read); against the JAX checked frame the Whitted parity gate of
tests/test_torch_whitted.py (2 u8 levels on >= 99% of pixels)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from directx_raytracer_tpu_torch import testscenes as pts
from directx_raytracer_tpu_torch.models.scene import build_device_scene
from directx_raytracer_tpu_torch.ops.draws import Layout
from directx_raytracer_tpu_torch.render import (
    render_whitted,
    render_whitted_checked,
)
from directx_raytracer_tpu_torch.render import pathtrace as ppt
from directx_raytracer_tpu_torch.render import wavefront as wf
from directx_raytracer_tpu_torch.render import whitted as pw
from directx_raytracer_tpu_torch.render.pathtrace import PathTracer
from directx_raytracer_tpu_torch.render.renderer import Renderer
from directx_raytracer_tpu_torch.utils import checks
from directx_raytracer_tpu_torch.utils.image import to_u8

torch.set_num_threads(2)


@pytest.fixture
def armed(monkeypatch):
    monkeypatch.setenv("DXRT_CHECK", "1")
    assert checks.enabled()


@pytest.fixture(scope="module")
def small_scene():
    scene = pts.cornell_box(64, 48)
    return scene, build_device_scene(scene, "cpu")


def nan_light(d):
    """The scene with its first light's intensity NaN: it flows through
    direct lighting into the contribution of every lit diffuse hit."""
    intensity = d.lights.intensity.clone()
    intensity[0] = float("nan")
    return dataclasses.replace(
        d, lights=dataclasses.replace(d.lights, intensity=intensity))


def test_enabled_reads_the_environment_per_call(monkeypatch):
    for value, want in (("", False), ("0", False), ("1", True), ("yes", True)):
        monkeypatch.setenv("DXRT_CHECK", value)
        assert checks.enabled() is want
    monkeypatch.delenv("DXRT_CHECK")
    assert not checks.enabled()
    with checks.armed():
        assert checks.enabled()
    assert not checks.enabled()


def test_unarmed_check_never_evaluates_its_predicate(monkeypatch):
    monkeypatch.setenv("DXRT_CHECK", "0")
    calls = []
    checks.check(lambda: calls.append(1) or False, "never raised")
    assert not calls
    monkeypatch.setenv("DXRT_CHECK", "1")
    checks.check(lambda: calls.append(1) or torch.tensor(True), "holds")
    assert calls == [1]
    with pytest.raises(checks.CheckError, match="broken"):
        checks.check(lambda: torch.tensor(False), "broken")
    assert issubclass(checks.CheckError, RuntimeError)


def test_clean_render_passes(small_scene, armed):
    scene, d = small_scene
    pos, rot = scene.camera.snapshot()
    img, _ = render_whitted_checked(d, pos, rot, 64, 48, max_depth=2)
    assert torch.isfinite(img).all()


def test_checked_matches_unchecked(small_scene, armed, monkeypatch):
    scene, d = small_scene
    pos, rot = scene.camera.snapshot()
    got, _ = render_whitted_checked(d, pos, rot, 64, 48, max_depth=2)
    monkeypatch.setenv("DXRT_CHECK", "0")
    ref, _ = render_whitted(d, pos, rot, 64, 48, max_depth=2)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)


def test_checked_matches_jax_checked(small_scene, armed):
    from directx_raytracer_tpu import testscenes as jts
    from directx_raytracer_tpu.models.scene import build_device_scene as j_build
    from directx_raytracer_tpu.render import render_whitted_checked as j_checked
    from directx_raytracer_tpu.utils.image import to_u8 as j_to_u8

    scene, d = small_scene
    pos, rot = scene.camera.snapshot()
    got, _ = render_whitted_checked(d, pos, rot, 64, 48, max_depth=2)
    want, _ = j_checked(j_build(jts.cornell_box(64, 48)), pos, rot, 64, 48,
                        max_depth=2)
    diff = np.abs(to_u8(got).astype(int) - j_to_u8(np.asarray(want)).astype(int))
    assert ((diff <= 2).all(axis=-1)).mean() >= 0.99


def test_seeded_nan_is_caught(small_scene, armed):
    scene, d = small_scene
    pos, rot = scene.camera.snapshot()
    with pytest.raises(checks.CheckError, match="non-finite"):
        render_whitted_checked(nan_light(d), pos, rot, 64, 48, max_depth=2)


def test_seeded_nan_raises_as_in_jax(small_scene, armed):
    """The same corruption trips the JAX package's guard with the same
    message."""
    import jax.numpy as jnp
    from jax.experimental import checkify

    from directx_raytracer_tpu import testscenes as jts
    from directx_raytracer_tpu.models.scene import build_device_scene as j_build
    from directx_raytracer_tpu.render import render_whitted_checked as j_checked

    jscene = jts.cornell_box(64, 48)
    jd = j_build(jscene)
    jd = dataclasses.replace(jd, lights=dataclasses.replace(
        jd.lights, intensity=jd.lights.intensity.at[0].set(jnp.nan)))
    pos, rot = jscene.camera.snapshot()
    with pytest.raises(checkify.JaxRuntimeError, match="non-finite") as j_err:
        j_checked(jd, pos, rot, 64, 48, max_depth=2)
    scene, d = small_scene
    with pytest.raises(checks.CheckError) as p_err:
        render_whitted_checked(nan_light(d), pos, rot, 64, 48, max_depth=2)
    assert str(p_err.value) in str(j_err.value)


def test_checked_arms_itself_and_unchecked_stays_silent(small_scene,
                                                        monkeypatch):
    """``render_whitted_checked`` guards whatever the environment says;
    the regular renderer, unarmed, lets the NaN through."""
    monkeypatch.setenv("DXRT_CHECK", "0")
    scene, d = small_scene
    pos, rot = scene.camera.snapshot()
    img, _ = render_whitted(nan_light(d), pos, rot, 64, 48, max_depth=2)
    assert torch.isnan(img).any()
    with pytest.raises(checks.CheckError, match="non-finite"):
        render_whitted_checked(nan_light(d), pos, rot, 64, 48, max_depth=2)


def test_renderer_picks_the_checked_frame_when_armed(armed, monkeypatch):
    r = Renderer(pts.cornell_box(32, 24), 32, 24, device="cpu")
    clean, _ = r.render_whitted_frame(max_depth=2)
    r.dscene = nan_light(r.dscene)
    with pytest.raises(checks.CheckError, match="non-finite"):
        r.render_whitted_frame(max_depth=2)
    monkeypatch.setenv("DXRT_CHECK", "0")
    img, _ = r.render_whitted_frame(max_depth=2)
    assert torch.isnan(img).any() and torch.isfinite(clean).all()


def test_pathtracer_checked_step(small_scene, armed):
    scene, d = small_scene
    pt = PathTracer(d, 48, 32, max_depth=2)
    pos, rot = scene.camera.snapshot()
    pt.step(pos, rot, n=1)  # clean scene: guards pass
    assert torch.isfinite(pt.image()).all()
    bad = PathTracer(nan_light(d), 48, 32, max_depth=2)
    with pytest.raises(checks.CheckError,
                       match="non-finite framebuffer contribution in shade pass"):
        bad.step(pos, rot, n=1)


# ---------------------------------------------------------------------------
# The pixel-id guards
# ---------------------------------------------------------------------------


def mirror_queue(n_alive=5, capacity=8):
    """A bounce queue over bench_scene(3000)'s mirror floor: ``n_alive``
    rays looking down at it, then parked rows."""
    scene = pts.bench_scene(3_000, 96, 48)
    d = build_device_scene(scene, "cpu")
    queue = {
        "origins": torch.tensor(wf._PARK[0:3]).repeat(capacity, 1),
        "dirs": torch.tensor(wf._PARK[3:6]).repeat(capacity, 1),
        "throughput": torch.zeros((capacity, 3)),
        "pixel": torch.full((capacity,), wf.PIXEL_SENTINEL, dtype=torch.int32),
        "active": torch.arange(capacity) < n_alive,
    }
    queue["origins"][:n_alive] = torch.tensor([0.0, 5.0, 0.0])
    queue["dirs"][:n_alive] = torch.tensor([0.0, -1.0, 0.0])
    queue["throughput"][:n_alive] = 1.0
    queue["pixel"][:n_alive] = torch.arange(n_alive, dtype=torch.int32)
    return d, queue


def whitted_shade(d):
    return functools.partial(pw._shade_hits, d, wf._default_occluder(d.geometry))


def pt_shade(d, layout):
    return functools.partial(ppt._pt_shade, d, wf._default_occluder(d.geometry),
                             0, layout)


@pytest.mark.parametrize("bad_id,raises", [
    (None, False), (100, True), (-1, True), (wf.PIXEL_SENTINEL, False)])
def test_bounce_commit_guards_the_queue_ids(armed, bad_id, raises):
    """Live ids in range or exactly the sentinel pass; an id past the
    framebuffer (which the commit would send to the sink row unseen) or a
    negative one raises.  The guard reads the ids before they are
    redirected."""
    d, queue = mirror_queue()
    if bad_id is not None:
        queue["pixel"][2] = bad_id
    fb = torch.zeros((64 + 1, 3))

    def commit():
        return wf._pass(d, queue, fb, whitted_shade(d), wf._default_intersect,
                        1, True, 8, n_alive=5)

    if raises:
        with pytest.raises(checks.CheckError, match="bounce commit pixel id "
                           "outside framebuffer/sentinel range"):
            commit()
    else:
        commit()
        assert torch.isfinite(fb).all() and fb[:64].sum() > 0


def test_primary_pass_guards_live_pixel_ids(armed):
    d, queue = mirror_queue(n_alive=8)
    fb = torch.zeros((8 + 1, 3))
    wf._pass(d, queue, fb, whitted_shade(d), wf._default_intersect, 0, True, 8)
    queue["pixel"][3] = 8  # one past the framebuffer's pixel rows
    with pytest.raises(checks.CheckError,
                       match="wavefront pixel id out of framebuffer range"):
        wf._pass(d, queue, torch.zeros((8 + 1, 3)), whitted_shade(d),
                 wf._default_intersect, 0, True, 8)


def test_pt_passes_guard_pixel_ids(armed):
    d, queue = mirror_queue(n_alive=8)
    shade = pt_shade(d, Layout(1, 8, 8))
    wf._pass(d, queue, torch.zeros((9, 3)), shade, wf._default_intersect, 0,
             True, 8)
    bad = dict(queue, pixel=queue["pixel"].clone())
    bad["pixel"][0] = 9
    with pytest.raises(checks.CheckError,
                       match="wavefront pixel id out of framebuffer range"):
        wf._pass(d, bad, torch.zeros((9, 3)), shade, wf._default_intersect, 0,
                 True, 8)
    with pytest.raises(checks.CheckError, match="bounce commit pixel id "
                       "outside framebuffer/sentinel range"):
        wf._pass(d, bad, torch.zeros((9, 3)), shade, wf._default_intersect, 1,
                 True, 8, n_alive=8)


def test_guards_cost_nothing_unarmed(small_scene, monkeypatch):
    """Unarmed, no guard's predicate runs during a frame."""
    monkeypatch.setenv("DXRT_CHECK", "0")
    seen = []
    real = checks.check

    def spy(pred, msg):
        real(lambda: seen.append(msg) or pred(), msg)

    monkeypatch.setattr(checks, "check", spy)
    scene, d = small_scene
    pos, rot = scene.camera.snapshot()
    render_whitted(d, pos, rot, 64, 48, max_depth=2)
    assert not seen
    monkeypatch.setenv("DXRT_CHECK", "1")
    render_whitted(d, pos, rot, 64, 48, max_depth=2)
    assert "non-finite framebuffer contribution in shade pass" in seen
