"""The port's modules import one way: ``render`` above ``bvh`` and ``ops``,
``bvh`` above ``ops``, and the CUDA kernel library (``kernels.py``) below
all three.  Read from each source's import statements, those inside
functions included, so a function-level import cannot hide a cycle."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent / "directx_raytracer_tpu_torch"

# Each module's layer (its first name under the package), and the layers
# it must not import.
BELOW = {"kernels": {"ops", "bvh", "render"},
         "ops": {"bvh", "render"},
         "bvh": {"render"}}


def imported(path: Path) -> set:
    """The modules of the package that ``path`` imports, as dotted names
    from the package root (``ops.shading``, ``kernels``, ...); a ``from X
    import name`` also gives ``X.name``, which may be a module."""
    here = list(path.relative_to(PKG).with_suffix("").parts[:-1])
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                base = here[:len(here) - node.level + 1]
                mod = ".".join([PKG.name, *base] + ([mod] if mod else []))
            names = [mod] + [f"{mod}.{a.name}" for a in node.names]
        else:
            continue
        out |= {n[len(PKG.name) + 1:] for n in names
                if n.startswith(PKG.name + ".")}
    return out


def layer_files():
    return [p for p in sorted(PKG.rglob("*.py"))
            if p.relative_to(PKG).parts[0].removesuffix(".py") in BELOW]


@pytest.mark.parametrize("path", layer_files(),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_imports_a_layer_above_it(path):
    layer = path.relative_to(PKG).parts[0].removesuffix(".py")
    above = {name for name in imported(path)
             if name.split(".")[0] in BELOW[layer]}
    assert not above, f"{path.relative_to(PKG)} imports {sorted(above)}"


def test_the_kernel_wrappers_launch_through_the_library():
    for rel in ("ops/draws.py", "ops/shading.py", "bvh/cuda_intersect.py",
                "tools/precision_micro.py"):
        assert "kernels" in imported(PKG / rel), rel


def test_the_frames_share_the_wavefront_not_each_other():
    for rel in ("render/whitted.py", "render/pathtrace.py"):
        assert "render.wavefront" in imported(PKG / rel), rel
    assert not {n for n in imported(PKG / "render/pathtrace.py")
                if n.startswith("render.whitted")}
