"""Debug-build instrumentation (the D3D12 debug-layer analog).

Counterpart of ``directx_raytracer_tpu/utils/checks.py`` (``enabled``,
``check``).  The reference enables the D3D12 debug layer in ``_DEBUG``
builds (DXRTRenderer.cpp:24-32) to catch API hazards at runtime.  Here,
setting ``DXRT_CHECK=1`` arms explicit guards inside the render passes
(non-finite framebuffer contributions = the NaN class of bug; out-of-range
pixel scatter ids = the OOB class); a guard that fails raises
``CheckError``.  The ``*_checked`` entry points render with the guards
armed whatever the environment says.

The guards are EXPLICIT rather than an anomaly mode over every tensor:
masked wavefront lanes legitimately carry inf/NaN (parked rays at 1e30,
miss distances at inf), so checking every intermediate would fire on
healthy frames.  The checks sit exactly where garbage would become
user-visible — the values added to the framebuffer.
"""

from __future__ import annotations

import contextlib
import os

_forced = 0  # depth of ``armed()`` blocks in this process


class CheckError(RuntimeError):
    """A DXRT_CHECK guard failed."""


def enabled() -> bool:
    """True when the DXRT_CHECK debug build is armed (env, read per call so
    tests can toggle it) or an ``armed()`` block is open."""
    return _forced > 0 or os.environ.get("DXRT_CHECK", "") not in ("", "0")


@contextlib.contextmanager
def armed():
    """Arm the guards inside the block whatever ``DXRT_CHECK`` says (the
    ``*_checked`` entry points)."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def check(pred, msg: str) -> None:
    """Raise ``CheckError(msg)`` unless the predicate holds; nothing unless
    the debug build is armed.

    ``pred`` is a callable returning a 0-d bool tensor (or a bool): it is
    not even evaluated unarmed, so the regular paths pay nothing.  Armed,
    reading the verdict is one host sync per guard — the price of the debug
    build.
    """
    if enabled() and not bool(pred()):
        raise CheckError(msg)
