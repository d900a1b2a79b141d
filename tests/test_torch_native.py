"""The torch port's native C++ .crtscene parser (``native/``) == its
pure-Python parser, field for field, on the documents of
tests/test_native_parser.py; == the JAX package's native parser through
``build_device_scene`` (bit-equal buffers); and the loader's
``use_native`` rules.  The library builds with g++ at first use.

Tolerances: none beyond the reference test's own (c_float rounding of ior,
specular and shininess at 1e-6 relative; normals 1e-5)."""

import dataclasses
import json
import logging
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from directx_raytracer_tpu_torch import testscenes as pts
from directx_raytracer_tpu_torch.io import crtscene
from directx_raytracer_tpu_torch.models.scene import build_device_scene
from directx_raytracer_tpu_torch.native import build, crtscene_native
from test_native_parser import _compare_scenes
from test_torch_host import as_numpy, assert_bit_equal

torch.set_num_threads(2)

SYNTHETIC = {
    "settings": {"background_color": [0.1, 0.2, 0.3],
                 "image_settings": {"width": 320, "height": 200}},
    "camera": {"matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1], "position": [1, 2, 3]},
    "lights": [{"intensity": 500, "position": [0, 5, 0]},
               {"intensity": 40.5, "position": [-1, 2, 3.5]}],
    "materials": [
        {"type": "diffuse", "albedo": [0.9, 0.1, 0.2], "smooth_shading": True,
         "specular": 0.45, "shininess": 12.5},
        {"type": "reflective", "albedo": [0.8, 0.8, 0.8], "smooth_shading": False},
        {"type": "refractive", "ior": 1.51, "smooth_shading": True},
        {"type": "constant", "albedo": "checkers", "smooth_shading": False},
        {"type": "???", "albedo": [0.5, 0.5, 0.5], "smooth_shading": False},
    ],
    "textures": [
        {"name": "flat", "type": "albedo", "albedo": [1, 0, 1]},
        {"name": "edgy", "type": "edges", "edge_color": [1, 0, 0],
         "inner_color": [0, 1, 0], "edge_width": 0.05},
        {"name": "checkers", "type": "checker", "color_A": [0, 0, 0],
         "color_B": [1, 1, 1], "square_size": 0.25},
        {"name": "pic", "type": "bitmap", "file_path": "img.png"},
        {"name": "odd", "type": "wat", "file_path": "other.png"},
    ],
    "objects": [
        {"material_index": 1,
         "vertices": [0, 0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 0],
         "uvs": [0, 0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 0],
         "triangles": [0, 1, 2, 1, 3, 2]},
        {"material_index": 0,
         "vertices": [0, 0, 1, 2, 0, 1, 1, 2, 1],
         "triangles": [0, 1, 2]},
    ],
}


def test_parser_source_is_the_jax_packages():
    import directx_raytracer_tpu.native as jnative

    ours = Path(build.SRC).read_bytes()
    theirs = (Path(jnative.__file__).parent / "parser.cpp").read_bytes()
    assert ours == theirs


def test_dragon_parity(dragon_path):
    if not os.path.exists(dragon_path):
        pytest.skip("reference Dragon.crtscene not available")
    _compare_scenes(crtscene_native.load(dragon_path),
                    crtscene.load(dragon_path, use_native=False))


def test_synthetic_scene_parity(tmp_path):
    p = tmp_path / "scene.crtscene"
    p.write_text(json.dumps(SYNTHETIC))
    native = crtscene_native.load(str(p))
    python = crtscene.load(str(p), use_native=False)
    _compare_scenes(native, python)
    # quirks: unknown material type -> refractive with white albedo;
    # string albedo -> texture reference
    assert native.materials[4].type.name == "REFRACTIVE"
    np.testing.assert_allclose(native.materials[4].albedo, 1.0)
    assert native.materials[3].texture_name == "checkers"


def test_parse_error_reported(tmp_path):
    p = tmp_path / "broken.crtscene"
    p.write_text('{"objects": [{"vertices": [1, 2, }]}')
    with pytest.raises(ValueError, match="parse failed"):
        crtscene_native.load(str(p))
    with pytest.raises(ValueError, match="parse failed"):
        crtscene.load(str(p), use_native=True)


def test_native_vertex_normals_match_numpy():
    from directx_raytracer_tpu_torch.models.mesh import vertex_normals

    rng = np.random.default_rng(0)
    verts = rng.normal(size=(50, 3)).astype(np.float32)
    tris = rng.integers(0, 50, size=(80, 3)).astype(np.int32).reshape(-1)
    got = build.vertex_normals(build.get_library(), verts, tris)
    np.testing.assert_allclose(got, vertex_normals(verts, tris), atol=1e-5)


def test_unicode_escape_parity(tmp_path):
    """Non-ASCII names: \\uXXXX escapes (incl. surrogate pairs) and raw
    UTF-8 must decode identically in both parsers."""
    doc = {
        "settings": {"background_color": [0, 0, 0],
                     "image_settings": {"width": 8, "height": 8}},
        "camera": {"matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1],
                   "position": [0, 0, 0]},
        "materials": [
            {"type": "diffuse", "albedo": "décor-木纹",
             "smooth_shading": False},
        ],
        "textures": [
            {"name": "décor-木纹", "type": "albedo",
             "albedo": [0.5, 0.5, 0.5]},
            {"name": "emoji-\U0001f409", "type": "checker",
             "color_A": [0, 0, 0], "color_B": [1, 1, 1],
             "square_size": 0.25},
        ],
        "objects": [{
            "material_index": 0,
            "vertices": [0, 0, 0, 1, 0, 0, 0, 1, 0],
            "triangles": [0, 1, 2],
        }],
    }
    for name, ensure in (("esc.crtscene", True), ("raw.crtscene", False)):
        path = tmp_path / name
        path.write_text(json.dumps(doc, ensure_ascii=ensure), encoding="utf-8")
        native = crtscene_native.load(str(path))
        python = crtscene.load(str(path), use_native=False)
        assert native.materials[0].texture_name == "décor-木纹"
        assert native.textures[1].name == "emoji-\U0001f409"
        _compare_scenes(native, python)


@pytest.mark.parametrize("name", ["cornell_box", "bench_scene_3000",
                                  "synthetic"])
def test_native_scene_buffers_equal_the_jax_native_scene(tmp_path, name):
    """One document through both packages' native parsers and
    ``build_device_scene``: bit-equal buffers."""
    from directx_raytracer_tpu.models.scene import build_device_scene as j_build
    from directx_raytracer_tpu.native import build as jbuild
    from directx_raytracer_tpu.native import crtscene_native as jnative

    if jbuild.get_library() is None:
        pytest.skip("the JAX package's native parser did not build")
    if name == "synthetic":
        doc = json.loads(json.dumps(SYNTHETIC))
        doc["textures"] = doc["textures"][:3]  # no bitmap files to open
        text = json.dumps(doc)
    else:
        scene = (pts.cornell_box() if name == "cornell_box"
                 else pts.bench_scene(3_000, 96, 48))
        text = crtscene.dumps(scene)
    path = tmp_path / "scene.crtscene"
    path.write_text(text)
    got = build_device_scene(crtscene.load(str(path), use_native=True), "cpu")
    want = j_build(jnative.load(str(path)))
    assert_bit_equal(as_numpy(got), as_numpy(want))


# ---------------------------------------------------------------------------
# The writer
# ---------------------------------------------------------------------------


DUMPED = {
    "cornell_box": lambda m: m.cornell_box(),
    "const_color": lambda m: m.const_color(),
    "bench_scene": lambda m: m.bench_scene(500, 32, 24),
}


@pytest.mark.parametrize("name", sorted(DUMPED))
def test_dumps_text_equals_jax(name):
    from directx_raytracer_tpu import testscenes as jts
    from directx_raytracer_tpu.io import crtscene as jcrt

    text = crtscene.dumps(DUMPED[name](pts))
    assert text == jcrt.dumps(DUMPED[name](jts))
    assert json.loads(text)["objects"]


def test_dumps_writes_every_texture_type_as_jax():
    """The synthetic document (every material and texture type, a string
    albedo, specular keys) loaded and written by both packages: the same
    text."""
    from directx_raytracer_tpu.io import crtscene as jcrt

    text = json.dumps(SYNTHETIC)
    assert crtscene.dumps(crtscene.loads(text)) == jcrt.dumps(jcrt.loads(text))


def test_dumps_round_trips_through_loads(tmp_path):
    doc = json.loads(json.dumps(SYNTHETIC))
    scene = crtscene.loads(json.dumps(doc))
    again = crtscene.loads(crtscene.dumps(scene))
    _compare_scenes(again, scene)
    path = tmp_path / "out.crtscene"
    crtscene.dump(scene, str(path))
    _compare_scenes(crtscene.load(str(path), use_native=False), scene)
    _compare_scenes(crtscene.load(str(path), use_native=True), scene)


# ---------------------------------------------------------------------------
# The loader's use_native rules
# ---------------------------------------------------------------------------


@pytest.fixture
def scene_file(tmp_path):
    path = tmp_path / "box.crtscene"
    crtscene.dump(pts.cornell_box(), str(path))
    return str(path)


@pytest.fixture
def broken_compiler(monkeypatch, tmp_path):
    """No library built, and a compiler path that does not exist."""
    monkeypatch.setattr(build, "COMPILER", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_libs", {})


def test_explicit_native_raises_when_the_library_cannot_be_built(
        scene_file, broken_compiler):
    with pytest.raises(build.NativeLibraryError, match="build failed"):
        crtscene.load(scene_file, use_native=True)


def test_default_falls_back_with_a_warning_naming_the_cause(
        scene_file, broken_compiler, caplog, monkeypatch):
    monkeypatch.delenv("DXRT_NATIVE_PARSER", raising=False)
    with caplog.at_level(logging.WARNING, logger="directx_raytracer_tpu_torch"):
        scene = crtscene.load(scene_file)
    _compare_scenes(scene, crtscene.load(scene_file, use_native=False))
    assert "NativeLibraryError" in caplog.text and "no-such-g++" in caplog.text


def test_env_turns_the_native_parser_off(scene_file, broken_compiler,
                                         caplog, monkeypatch):
    monkeypatch.setenv("DXRT_NATIVE_PARSER", "0")
    with caplog.at_level(logging.WARNING, logger="directx_raytracer_tpu_torch"):
        crtscene.load(scene_file)
    assert not caplog.text  # the native parser was never tried


def test_default_reports_a_parse_error_it_fell_back_from(tmp_path, caplog,
                                                         monkeypatch):
    """Under ``use_native=None`` a native parse error is logged, not
    swallowed, and the Python parser then raises its own."""
    monkeypatch.delenv("DXRT_NATIVE_PARSER", raising=False)
    p = tmp_path / "broken.crtscene"
    p.write_text('{"objects": [{"vertices": [1, 2, }]}')
    with caplog.at_level(logging.WARNING, logger="directx_raytracer_tpu_torch"):
        with pytest.raises(json.JSONDecodeError):
            crtscene.load(str(p))
    assert "parse failed" in caplog.text


def test_a_compile_error_is_reported(monkeypatch, tmp_path):
    bad = tmp_path / "parser.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "SRC", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(build.NativeLibraryError, match="error"):
        build.get_library()
    assert not list((tmp_path / "_build").glob("*.so"))
