"""The viewer's commands of the torch port (``orbit``, ``interactive``,
``pathtrace``, ``devices``) through ``main([...])`` on the CPU, beside the
JAX package's commands, and the terminal module.

The commands' reports carry timings, so the two packages' lines are compared
with their numbers masked; what a command writes (PNGs, the checkpoint, the
trace) is checked on the port's side against its own renderer.  The terminal
module is a copy of the JAX package's, held equal byte for byte."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import directx_raytracer_tpu.viewer.app as japp
import directx_raytracer_tpu.viewer.tty as jtty
import directx_raytracer_tpu_torch.viewer.app as papp
import directx_raytracer_tpu_torch.viewer.tty as ptty
from directx_raytracer_tpu_torch import testscenes as pts
from directx_raytracer_tpu_torch.ops.debug_shading import MODE_NAMES
from directx_raytracer_tpu_torch.render.pathtrace import PathTracer
from directx_raytracer_tpu_torch.render.renderer import Renderer, describe_devices
from directx_raytracer_tpu_torch.utils.image import to_u8

torch.set_num_threads(2)

SIZE = ["--width", "32", "--height", "24"]
CPU = ["--device", "cpu"]


def masked(text: str) -> str:
    """A report line with every number replaced by ``#``."""
    return re.sub(r"\d+(\.\d+)?", "#", text)


def read_png(path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path))


def test_pathtrace_command(tmp_path, capsys):
    out, state = tmp_path / "pt.png", tmp_path / "pt.npz"
    args = ["pathtrace", "--builtin", "cornell_box", *SIZE, "--depth", "2",
            "--samples", "3", "--seed", "4", "--checkpoint-every", "2"]
    papp.main([*args, *CPU, "--state", str(state), "-o", str(out)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == f"wrote {out} at 3 spp"

    r = Renderer(pts.cornell_box(), 32, 24, device="cpu")
    pos, rot = r.camera.snapshot()
    pt = PathTracer(r.dscene, 32, 24, max_depth=2, seed=4).step(pos, rot, n=3)
    want = pt.image().clamp(0.0, 1.0) ** (1.0 / 2.2)
    np.testing.assert_array_equal(read_png(out), to_u8(want))

    # --resume continues the checkpoint: 3 + 2 samples equal 5 in one go.
    out2 = tmp_path / "pt5.png"
    papp.main([*args[:-4], "--samples", "5", "--seed", "9", *CPU, "--resume",
               str(state), "--no-gamma", "-o", str(out2)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2:] == ["resumed at 3 spp", f"wrote {out2} at 5 spp"]
    pt.step(pos, rot, n=2)
    np.testing.assert_array_equal(read_png(out2), to_u8(pt.image()))

    # The JAX command reports in the same words.
    jout = tmp_path / "jpt.png"
    japp.main([*args, "-o", str(jout)])
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    assert masked(jline.replace(str(jout), "P")) == masked(
        line.replace(str(out), "P"))


@pytest.mark.parametrize("flags", [[], ["--whitted", "--depth", "2"]],
                         ids=["debug", "whitted"])
def test_orbit_command(tmp_path, capsys, flags):
    pattern = str(tmp_path / "f%02d.png")
    args = ["orbit", "--builtin", "cornell_box", *SIZE, "--mode", "5",
            "--frames", "2", *flags]
    papp.main([*args, *CPU, "-o", pattern])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"2 frames in \d+\.\d\ds -> \d+\.\d FPS, \d+\.\d Mrays/s",
                        line)
    # Frame 0 from the scene's camera, frame 1 after half a turn about the
    # origin.
    r = Renderer(pts.cornell_box(), 32, 24, device="cpu")
    for i in range(2):
        if flags:
            img, _ = r.render_whitted_frame(max_depth=2)
        else:
            img = r.render_frame(5)
        np.testing.assert_array_equal(read_png(pattern % i), to_u8(img))
        r.camera.pan_around_target(180.0, np.zeros(3, np.float32))
    assert not np.array_equal(read_png(pattern % 0), read_png(pattern % 1))

    japp.main([*args, "-o", str(tmp_path / "j%02d.png")])
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    assert masked(jline) == masked(line)


def test_orbit_profile_writes_a_trace(tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    papp.main(["orbit", "--builtin", "cornell_box", *SIZE, "--frames", "2",
               *CPU, "--profile", str(trace_dir)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == f"profiler trace written to {trace_dir}"
    assert (trace_dir / "trace.json").stat().st_size > 1000
    assert not list(tmp_path.glob("*.png"))  # no --output: nothing written


def test_devices_command(capsys):
    papp.main(["devices", *CPU])
    assert capsys.readouterr().out.strip() == describe_devices()
    japp.main(["devices"])
    assert capsys.readouterr().out.strip()  # both print a report


@pytest.mark.parametrize("cmd", ["render", "orbit", "interactive",
                                 "pathtrace", "devices"])
def test_every_command_defaults_to_cuda(cmd):
    args = papp.build_parser().parse_args([cmd])
    assert args.device == "cuda"
    assert papp.build_parser().parse_args([cmd, *CPU]).device == "cpu"


def test_tty_is_the_jax_module():
    assert Path(ptty.__file__).read_bytes() == Path(jtty.__file__).read_bytes()
    img = np.random.default_rng(2).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    for kw in (dict(max_cols=40, max_rows=10), dict(max_cols=200, max_rows=50)):
        got = ptty.frame_to_ansi(img, **kw)
        assert got == jtty.frame_to_ansi(img, **kw)
        assert got.count("\n") + 1 <= kw["max_rows"] and "▀" in got


class ScriptedKeyboard:
    """Stands in for tty.RawKeyboard: ``poll`` plays a script, one entry a
    call (None ends a frame's input)."""

    script = []

    def __init__(self, mouse=False):
        self.events = list(self.script)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def poll(self):
        return self.events.pop(0)


def test_interactive_loop_exits_on_x(monkeypatch, capsys, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(ptty, "RawKeyboard", ScriptedKeyboard)
    ScriptedKeyboard.script = [
        "w", "a", "left", "up", "q", ("mouse_drag", 2, -1), ("mouse_wheel", 1),
        "5", None,        # frame 1: mode 5 after moving
        "g", None,        # frame 2: whitted
        "p", "g", "3", None,  # saves frame.png (still whitted), then mode 3
        "x"]
    papp.main(["interactive", "--builtin", "cornell_box", *SIZE, *CPU,
               "--depth", "2"])
    out = capsys.readouterr().out
    assert out.endswith("\n")
    labels = re.findall(r"\n(\w[\w ]*) \| +\d+\.\d FPS", out)
    assert labels == [MODE_NAMES[5], "whitted", MODE_NAMES[3]]
    assert "saved frame.png" in out and out.count("▀") > 3 * 32
    assert read_png(tmp_path / "frame.png").shape == (24, 32, 3)


def test_devices_reports_the_process_group(capsys):
    """In a process that has joined a process group, ``devices`` also
    reports the job: world size, rank and backend (here a one-process gloo
    group over localhost)."""
    import torch.distributed as dist

    from directx_raytracer_tpu_torch.parallel import init_distributed
    from directx_raytracer_tpu_torch.parallel.launch import _free_port

    assert "distributed" not in describe_devices()
    assert init_distributed(f"localhost:{_free_port()}", 1, 0,
                            backend="gloo") == 1
    try:
        papp.main(["devices", *CPU])
        out = capsys.readouterr().out.strip()
    finally:
        dist.destroy_process_group()
    assert out.splitlines()[-1] == ("distributed: rank 0 of 1 processes, "
                                    "backend gloo")
    assert "distributed" not in describe_devices()
