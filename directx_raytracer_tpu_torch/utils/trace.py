"""Spans and counters of the port's frame: its one tracing module.

Spans.  ``span(name)`` opens a range named ``name`` in a running torch
profiler's trace, on the clock of the trace's device records, and is one
shared null context when no profiler runs (a check of the bool that
``torch.profiler.profile`` sets: ~0.03 us).  So spans are on exactly while
a profiler runs: the benchmark's traced window, the viewer's ``orbit
--profile``, ``tools/profile_frames.py``.  A span is a
``_RecordFunctionFast`` range, a plain ``cpu_op``: never a user annotation
(``record_function``), which a CUDA profile would also turn into a
device-typed record over its kernels.  A torch without
``_RecordFunctionFast`` has no other Python entry that records a plain
range (``record_function`` and ``_record_function_with_args_enter`` both
record user annotations), so there the spans stay off.

Span names are ``dxrt.<layer>[.<part>]``, nested on the one host thread:

  dxrt.frame.debug / .whitted / .pathtrace   a frame (a path-traced sample)
    dxrt.pass                                a wavefront pass or PT bounce
      dxrt.raygen                            primary rays, camera upload
      dxrt.query (.stage, .bin, .walk)       the closest-hit query
      dxrt.hit_record                        the per-hit record fetch
      dxrt.shade                             attributes, lighting, shading
        dxrt.shade.draw                      a PT pass's keyed draws
        dxrt.shade.split                     a Whitted pass's specular
                                             continuations (refraction,
                                             Fresnel, the two branches)
        dxrt.occluder (.stage, .bin, .walk   the shadow batch's sort, the
                       > .items)             occluder query, the unsort
      dxrt.compact                           the wavefront compaction
      dxrt.commit                            framebuffer add, miss select,
                                             untile
  dxrt.to_u8                                 ``Renderer.to_u8_device``

``dxrt.occluder.items`` (the any-hit work items and their read) runs
inside ``dxrt.occluder.walk`` and only on the kernel path.
``dxrt.shade.draw`` (one launch of ``pt_draws``, or its twin) runs only in
a path-traced pass, first in its shading, and counts in the shading
layer.  ``dxrt.shade.split`` runs in every Whitted pass but the last,
last in its shading, and counts in the shading layer too.  The debug
frame has no ``dxrt.pass``.

Counters.  ``COUNTS`` holds plain integers, always on: ``count(key, n)``
adds, ``reset()`` clears; a key never counted reads 0.

* ``launch.<kernel>``: launches of a hand-written kernel
  (``bin_clusters``, ``bin_clusters_super``, ``closest_hit``,
  ``closest_hit_exec``, ``any_hit``, ``any_hit_exec``, ``pt_draws``,
  ``shadow_keys``, ``shadow_rays``, ``compact_keys``, ``compact_gather``,
  ``precision_micro.<variant>``); the plain versions never count.
  ``shadow_keys`` and ``shadow_rays`` launch once each per shadow batch on
  the card (one a shading pass that has an occluder), inside its
  ``dxrt.occluder`` spans; ``compact_keys`` and ``compact_gather`` once
  each per compaction, inside its ``dxrt.compact`` span (a frame of
  depth d, Whitted or path-traced, makes at most d - 1).
  ``launches()`` gives them by kernel.
* ``sync.<site>``: each point where a frame's host thread waits for the
  card: a device-to-host read, or a blocking copy of a host value to the
  device (which waits for the stream to drain).  The sites count on every
  device, so a CPU run shows the card's count, except the any-hit work
  items' read, which only the kernel path makes.  The plain versions' own
  reads (``closest_hit_plain``, ``any_hit_plain``, the clustered walker)
  do not count: on the card they run only as references.
* ``pt.rays``: the rows entering each path-traced pass (its query and
  its shading), the frame's pixels and then each bounce's live count, which the
  compaction has already read (no sync of its own).  Over frames x W x H
  it is a sample's rays a pixel (1 primary only, ``max_depth`` at most).
* ``whitted.rays``: its Whitted twin, the rows entering each Whitted
  pass's query, the pixels of each sub-pixel offset's wavefront and then
  each compaction's kept rows.  Over frames x W x H it is a frame's rays
  a pixel (spp with primary rays only).
* ``whitted.split``: the branch-B rows (refractive surfaces' Fresnel
  reflections, the branch an overflowing queue drops first) that a
  Whitted pass sends live into its compaction.  The compaction's count
  read returns it beside the live count: no sync of its own.
* ``wavefront.dropped``: the live rows a compaction had no room for in
  its queue, in both frame kinds (the frames' stats also return them per
  pass).
"""

from __future__ import annotations

import contextlib
from collections import Counter

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()
_FAST = getattr(torch._C._profiler, "_RecordFunctionFast", None)

COUNTS: Counter = Counter()


def span(name: str):
    """A range named ``name`` in the running torch profiler's trace, or
    the shared null context when none runs."""
    if _FAST is None or not _profiler._is_profiler_enabled:
        return _NULL
    return _FAST(name)


def count(key: str, n: int = 1) -> None:
    COUNTS[key] += n


def reset() -> None:
    COUNTS.clear()


def launches() -> Counter:
    """The ``launch.*`` counts, keyed by kernel."""
    return Counter({k[len("launch."):]: v for k, v in COUNTS.items()
                    if k.startswith("launch.")})


def syncs() -> int:
    """The sum of the ``sync.*`` counts."""
    return sum(v for k, v in COUNTS.items() if k.startswith("sync."))


def upload(value, device, site: str) -> torch.Tensor:
    """``value`` as f32 on ``device``, counted under ``sync.<site>`` unless
    it is a tensor already on that kind of device: a host value's copy to
    a card is a blocking one."""
    if not (isinstance(value, torch.Tensor)
            and value.device.type == torch.device(device).type):
        count("sync." + site)
    return torch.as_tensor(value, dtype=torch.float32).to(device)
