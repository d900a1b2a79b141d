"""Host layer of the torch port vs the JAX package: scene builders, clusters,
the numpy-handover constructors, the loader, image IO and package
isolation.  Every buffer must equal the JAX package's bit for bit (same
dtype, shape and bytes): the port's host layer is a copy, not a
re-derivation."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from directx_raytracer_tpu import testscenes as jts
from directx_raytracer_tpu.bvh.clustered import build_clusters as j_build_clusters
from directx_raytracer_tpu.io import crtscene as jcrt
from directx_raytracer_tpu.models.camera import Camera as JCamera
from directx_raytracer_tpu.models.scene import build_device_scene as j_build
from directx_raytracer_tpu.utils.image import to_u8 as j_to_u8
from directx_raytracer_tpu_torch import testscenes as pts
from directx_raytracer_tpu_torch.bvh import build_clusters, clusters_from_numpy
from directx_raytracer_tpu_torch.io import crtscene as pcrt
from directx_raytracer_tpu_torch.models.camera import Camera as PCamera
from directx_raytracer_tpu_torch.models.scene import (
    build_device_scene,
    scene_from_numpy,
)
from directx_raytracer_tpu_torch.utils.image import to_u8, write_png

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = {
    "bench_scene_3000": lambda m: m.bench_scene(3000, 96, 48),
    "cornell_box": lambda m: m.cornell_box(),
    "const_color": lambda m: m.const_color(),
    "single_triangle": lambda m: m.single_triangle(),
}


def leaves(obj, prefix=""):
    """Dataclass leaves (nested) as {dotted field path: value}; skips the
    JAX package's ``accel`` hook, which is not a buffer."""
    out = {}
    for f in dataclasses.fields(obj):
        if f.name == "accel":
            continue
        x = getattr(obj, f.name)
        if dataclasses.is_dataclass(x):
            out.update(leaves(x, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = x
    return out


def as_numpy(obj) -> dict:
    """Leaves with arrays/tensors as numpy and Python scalars as they are;
    works for the JAX package's and the port's dataclasses alike."""
    out = {}
    for key, x in leaves(obj).items():
        if isinstance(x, torch.Tensor):
            out[key] = x.numpy()
        elif isinstance(x, (bool, int)):
            out[key] = x
        else:
            out[key] = np.asarray(x)
    return out


def assert_bit_equal(port: dict, ref: dict):
    """Tolerance: none — same keys, dtypes, shapes and bytes."""
    assert set(port) == set(ref)
    for key, want in ref.items():
        got = port[key]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, key
            assert got.shape == want.shape, key
            assert got.tobytes() == want.tobytes(), key
        else:
            assert got == want, key


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene_pair(request):
    build = SCENES[request.param]
    return build(pts), build(jts)


def test_device_scene_bit_equal(scene_pair):
    pscene, jscene = scene_pair
    assert_bit_equal(as_numpy(build_device_scene(pscene)),
                     as_numpy(j_build(jscene)))


def test_scene_from_numpy_round_trip(scene_pair):
    pscene, jscene = scene_pair
    from_jax = scene_from_numpy(as_numpy(j_build(jscene)))
    assert_bit_equal(as_numpy(from_jax),
                     as_numpy(build_device_scene(pscene)))


def test_clusters_bit_equal(scene_pair):
    pscene, jscene = scene_pair
    got = as_numpy(build_clusters(build_device_scene(pscene).geometry))
    want = as_numpy(j_build_clusters(j_build(jscene).geometry))
    assert_bit_equal(got, want)
    assert got["identity_order"] is True


def test_clusters_from_numpy_round_trip(scene_pair):
    pscene, jscene = scene_pair
    ref = as_numpy(j_build_clusters(j_build(jscene).geometry))
    assert_bit_equal(as_numpy(clusters_from_numpy(ref)), ref)


def test_build_clusters_rejects_empty_scene():
    from directx_raytracer_tpu_torch.models.scene import Scene

    with pytest.raises(ValueError):
        build_clusters(build_device_scene(Scene()).geometry)


def test_device_scene_to_moves_every_tensor():
    d = build_device_scene(pts.single_triangle(), device="meta")
    for key, x in leaves(d).items():
        if isinstance(x, torch.Tensor):
            assert x.device.type == "meta", key


def test_packed_ids_are_bit_patterns():
    """Record slots 9-11 carry int32 ids bitcast into f32; read through a
    bit view they equal the id columns."""
    geo = build_device_scene(pts.cornell_box()).geometry
    ids = geo.packed[:, 9:12].contiguous().view(torch.int32)
    assert torch.equal(ids[:, 0], geo.local_id)
    assert torch.equal(ids[:, 1], geo.mesh_id)
    assert torch.equal(ids[:, 2], geo.mat_id)


def test_crtscene_loads_equal(tmp_path):
    """The port's pure-Python loader builds the same buffers as the JAX
    loader from one .crtscene document (bit equal)."""
    text = jcrt.dumps(jts.cornell_box())
    path = tmp_path / "box.crtscene"
    path.write_text(text)
    ref = as_numpy(j_build(jcrt.load(str(path), use_native=False)))
    assert_bit_equal(as_numpy(build_device_scene(pcrt.loads(text))), ref)
    assert_bit_equal(as_numpy(build_device_scene(pcrt.load(str(path)))), ref)


@pytest.mark.parametrize("ops", [
    [("pan", 30.0), ("tilt", 20.0), ("roll", 10.0)],
    [("rotate", 15.0, -30.0), ("move_forward", 2.0), ("move_right", -1.5)],
    [("zoom", 0.7), ("pan_around_target", 45.0, (1.0, 0.0, -2.0))],
])
def test_camera_matches_jax(ops):
    """Tolerance: none — the camera is copied numpy code."""
    pc, jc = PCamera((1.0, 2.0, 3.0)), JCamera((1.0, 2.0, 3.0))
    for name, *args in ops:
        getattr(pc, name)(*args)
        getattr(jc, name)(*args)
    for got, want in zip(pc.snapshot(), jc.snapshot()):
        assert got.tobytes() == want.tobytes()


def test_to_u8_and_png(tmp_path):
    """to_u8 equals the JAX package's rounding exactly, for numpy and torch
    input; the stdlib PNG writer round-trips through Pillow."""
    from PIL import Image

    img = np.random.default_rng(0).uniform(-0.2, 1.2, (9, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(to_u8(img), j_to_u8(img))
    np.testing.assert_array_equal(to_u8(torch.from_numpy(img)), j_to_u8(img))
    path = tmp_path / "x.png"
    write_png(str(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), j_to_u8(img))


def test_import_leaves_jax_out():
    """Importing every port module pulls in neither jax nor the JAX
    package."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import directx_raytracer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'directx_raytracer_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_morton_order_matches_jax():
    """Tolerance: none — copied numpy code."""
    from directx_raytracer_tpu.models.scene import _np_morton_order as j_morton
    from directx_raytracer_tpu_torch.models.scene import _np_morton_order

    rng = np.random.default_rng(5)
    v0, e1, e2 = (rng.uniform(-3, 3, (500, 3)).astype(np.float32)
                  for _ in range(3))
    np.testing.assert_array_equal(_np_morton_order(v0, e1, e2),
                                  j_morton(v0, e1, e2))
