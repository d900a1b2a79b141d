"""The wavefront compaction (``render/wavefront.compact``): its key and
gather chains (``compact_keys_plain``, ``compact_gather_plain``) against
the compaction as it was before they were factored out of it
(``compact_sort_before`` below), column by column; the i32 key's order
against the i64 key's; the queue's dtypes, shapes and strides; and the
wrappers' route: CPU tensors take the plain chains and launch nothing.

Marked ``gpu`` and skipped without a CUDA device: the kernels of
``csrc/compact.cu`` against the plain chains on the card, bit for bit, and
a Whitted frame through them against the frame through the chains.  This
file imports no JAX, so on a GPU host it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_compact.py
"""

import numpy as np
import pytest
import torch

from directx_raytracer_tpu_torch import kernels, testscenes
from directx_raytracer_tpu_torch.render import wavefront as wf
from directx_raytracer_tpu_torch.render.renderer import Renderer
from directx_raytracer_tpu_torch.utils import trace

F32 = np.float32
LO, HI = (-5.0, -5.0, -5.0), (5.0, 5.0, 5.0)


def compact_sort_before(cand: dict, capacity: int, scene_lo, scene_hi,
                        split_at=None, n_samples: int = 1):
    """The compaction as it was before its key and gather became kernels
    (counters left out): one concatenated candidate list, an i32 key for
    one sample, an i64 key with the sample above it for several."""
    o, d, active = cand["origins"], cand["dirs"], cand["active"]
    q2, dev, i32 = o.shape[0], o.device, torch.int32
    ext = (scene_hi - scene_lo).clamp(min=1e-12)
    cell = ((o - scene_lo) / ext * 256.0).clamp(0.0, 255.0).to(i32)
    morton = torch.zeros((q2,), dtype=i32, device=dev)
    for bit in range(8):
        for ax in range(3):
            morton = morton | (((cell[:, ax] >> bit) & 1) << (3 * bit + ax))
    octant = (((d[:, 0] > 0).to(i32) << 2) | ((d[:, 1] > 0).to(i32) << 1)
              | (d[:, 2] > 0).to(i32))
    key = (octant << 24) | morton
    if split_at is not None:
        late = torch.arange(q2, dtype=i32, device=dev) >= split_at
        key = key | (late.to(i32) << 27)

    def gather(take, rows):
        src = torch.cat([cand["origins"], cand["dirs"], cand["throughput"],
                         cand["pixel"].clamp(max=wf.PIXEL_SENTINEL)
                         .to(torch.float32)[:, None]], dim=1)
        packed = torch.tensor(wf._PARK).repeat(rows, 1).to(dev)
        packed[:take.shape[0]] = src[take]
        return {"origins": packed[:, 0:3], "dirs": packed[:, 3:6],
                "throughput": packed[:, 6:9],
                "pixel": packed[:, 9].to(torch.int32),
                "active": torch.arange(rows, device=dev) < take.shape[0]}

    if n_samples == 1:
        key = torch.where(active, key, 1 << 29)
        order = torch.sort(key, stable=True).indices
        n_active = int(active.sum())
        n_alive = min(n_active, capacity)
        return (gather(order[:n_alive], capacity), n_alive,
                max(n_active - capacity, 0))
    sample = cand["sample"].long()
    key = torch.where(active, key.long() | (sample << 28), 1 << 62)
    key, order = torch.sort(key, stable=True)
    bounds = torch.arange(2 * n_samples + 1, device=dev) << 27
    counts = torch.searchsorted(key, bounds).diff().tolist()
    live = [a + b for a, b in zip(counts[0::2], counts[1::2])]
    alive = [min(n, capacity) for n in live]
    starts = [0]
    for n in live[:-1]:
        starts.append(starts[-1] + n)
    take = torch.cat([order[s:s + n] for s, n in zip(starts, alive)])
    queue = gather(take, n_samples * capacity)
    queue["sample"] = torch.zeros(n_samples * capacity, dtype=torch.int32,
                                  device=dev)
    queue["sample"][:take.shape[0]] = cand["sample"][take]
    return queue, alive, [n - a for n, a in zip(live, alive)]


def candidates(n: int, n_branches: int, n_samples: int, seed: int = 0,
               active_share: float = 0.6):
    """``n_branches`` branches of ``n_samples * n`` rows each, as a pass
    makes them: each sample's rows back to back, a row's sample and pixel
    the same in both branches.  Origins in and around the box (LO, HI),
    some on its faces, repeated (so the stable sort's ties matter), NaN,
    infinite or parked at 1e30; directions with zero and NaN components;
    a few pixel ids at or past the sentinel.  Branch A's rows are strided
    views into a packed (rows, 10) block, as a bounce pass's queue hands
    them on; branch B's columns are contiguous.  Returns (branches, the
    rows' sample column or None)."""
    rng = np.random.default_rng(seed)
    rows = n_samples * n
    branches = []
    for b in range(n_branches):
        o = rng.uniform(-5.5, 5.5, (rows, 3)).astype(F32)
        o[1::4] = o[0::4][:len(o[1::4])]
        o[2::9, 0] = -5.0
        o[3::9, 1] = 5.0
        o[4::17] = np.nan
        o[5::19, 2] = np.inf
        o[6::23] = 1e30
        d = rng.normal(size=(rows, 3)).astype(F32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        d[2::4] = d[0::4][:len(d[2::4])]
        d[7::11, 0] = 0.0
        d[8::29, 1] = np.nan
        t = rng.uniform(0, 1, (rows, 3)).astype(F32)
        active = rng.random(rows) < active_share
        if b == 0:
            packed = torch.from_numpy(np.concatenate(
                [o, d, t, np.zeros((rows, 1), F32)], axis=1))
            cols = {"origins": packed[:, 0:3], "dirs": packed[:, 3:6],
                    "throughput": packed[:, 6:9]}
        else:
            cols = {k: torch.from_numpy(v) for k, v in
                    (("origins", o), ("dirs", d), ("throughput", t))}
        branches.append(cols | {"active": torch.from_numpy(active)})
    pixel = np.tile(np.arange(n), n_samples).astype(np.int32)
    pixel[::31] = wf.PIXEL_SENTINEL + 7
    pixel[1::37] = wf.PIXEL_SENTINEL
    for b in branches:
        b["pixel"] = torch.from_numpy(pixel)
    sample = None
    if n_samples > 1:
        sample = torch.arange(n_samples, dtype=torch.int32).repeat_interleave(n)
    return tuple(branches), sample


def concatenated(branches, sample):
    cand = {k: torch.cat([b[k] for b in branches]) for k in branches[0]}
    if sample is not None:
        cand["sample"] = torch.cat([sample] * len(branches))
    return cand


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def queues_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].stride() == want[k].stride(), k
        assert bits_equal(got[k], want[k]), k


def box(device="cpu"):
    return (torch.tensor(LO, dtype=torch.float32, device=device),
            torch.tensor(HI, dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# The plain chains on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_branches", [1, 2])
@pytest.mark.parametrize("n_samples", [1, 4, 8])
@pytest.mark.parametrize("capacity", [300, 60])
def test_compaction_equals_its_form_before_the_kernels(n_branches, n_samples,
                                                       capacity):
    """``compact`` over the branches and ``_compact_sort`` over their
    concatenation give the old compaction's queue, column by column, and
    its counts; at capacity 60 every sample drops rows."""
    n = 128
    branches, sample = candidates(n, n_branches, n_samples, seed=n_samples)
    lo, hi = box()
    cand = concatenated(branches, sample)
    split_at = n_samples * n if n_branches == 2 else None
    want = compact_sort_before(cand, capacity, lo, hi, split_at, n_samples)
    got = wf.compact(branches, capacity, lo, hi, sample, n_samples)
    again = wf._compact_sort(cand, capacity, lo, hi, split_at, n_samples)
    for q, alive, dropped in (got, again):
        queues_equal(q, want[0])
        assert (alive, dropped) == want[1:]
    dropped = want[2] if n_samples > 1 else [want[2]]
    assert all(d > 0 for d in dropped) == (capacity == 60)


@pytest.mark.parametrize("n_samples", [1, 2, 4, 7])
@pytest.mark.parametrize("n_branches", [1, 2])
def test_the_i32_key_sorts_as_the_i64_key(n_samples, n_branches):
    """Up to 7 samples the key is i32, and its stable sort gives the
    permutation of the old key (i64 with the sample above it, inactive
    1 << 62; i32 with inactive 1 << 29 for one sample), NaN, infinite and
    1e30 origins included."""
    n = 200
    branches, sample = candidates(n, n_branches, n_samples, seed=11)
    lo, hi = box()
    key = wf.compact_keys_plain(branches, sample, n_samples, lo, hi)
    assert key.dtype == wf.key_dtype(n_samples) == torch.int32
    cand = concatenated(branches, sample)
    o = cand["origins"]
    assert torch.isnan(o).any() and (o == 1e30).any() and torch.isinf(o).any()
    old = key.long()  # the old key's bits below the inactive flag
    old = torch.where(cand["active"], old,
                      (1 << 62) if n_samples > 1 else (1 << 29))
    got = torch.sort(key, stable=True).indices
    want = torch.sort(old, stable=True).indices
    assert torch.equal(got, want)
    live = key[cand["active"]]
    assert int(live.max()) < n_samples << 28
    assert bool((key[~cand["active"]] == n_samples << 28).all())
    assert wf.key_dtype(8) == torch.int64


def test_the_queue_keeps_its_dtypes_shapes_and_strides():
    n, capacity = 96, 70
    for n_samples in (1, 4):
        branches, sample = candidates(n, 2, n_samples, seed=3)
        q, _, _ = wf.compact(branches, capacity, *box(), sample, n_samples)
        rows = n_samples * capacity
        want = {"origins": (torch.float32, (rows, 3), (10, 1)),
                "dirs": (torch.float32, (rows, 3), (10, 1)),
                "throughput": (torch.float32, (rows, 3), (10, 1)),
                "pixel": (torch.int32, (rows,), (1,)),
                "active": (torch.bool, (rows,), (1,))}
        if n_samples > 1:
            want["sample"] = (torch.int32, (rows,), (1,))
        assert list(q) == list(want)
        for k, (dtype, shape, stride) in want.items():
            assert (q[k].dtype, tuple(q[k].shape), q[k].stride()) == (
                dtype, shape, stride), k
        assert q["origins"].data_ptr() + 12 == q["dirs"].data_ptr()
        n_alive = int(q["active"].sum())
        assert bool(q["active"][:n_alive].all())
        assert bool((q["pixel"][n_alive:] == wf.PIXEL_SENTINEL).all())
        assert bool((q["pixel"][:n_alive] <= wf.PIXEL_SENTINEL).all())


def test_a_compaction_reads_its_counts_once():
    n, n_samples = 128, 4
    branches, sample = candidates(n, 2, n_samples, seed=5)
    before = dict(trace.COUNTS)
    _, alive, dropped = wf.compact(branches, 60, *box(), sample, n_samples)
    made = {k: v - before.get(k, 0) for k, v in trace.COUNTS.items()
            if v != before.get(k, 0)}
    split = sum(int(branches[1]["active"][s * n:(s + 1) * n].sum())
                for s in range(n_samples))
    assert made == {"sync.compact_count": 1, "whitted.split": split,
                    "wavefront.dropped": sum(dropped)}


def test_wrappers_take_the_plain_chains_for_cpu_tensors(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(kernels, "_lib", no_library)
    branches, sample = candidates(64, 2, 4, seed=2)
    lo, hi = box()
    before = trace.launches()
    key = wf.compact_keys(branches, sample, 4, lo, hi)
    assert torch.equal(key, wf.compact_keys_plain(branches, sample, 4, lo, hi))
    key, order = torch.sort(key, stable=True)
    bounds = torch.searchsorted(key, torch.arange(9, dtype=key.dtype) << 27)
    got = wf.compact_gather(branches, order, bounds, 50, 4)
    queues_equal(got, wf.compact_gather_plain(branches, order, bounds, 50, 4))
    wf.compact(branches, 50, lo, hi, sample, 4)
    assert trace.launches() == before


# ---------------------------------------------------------------------------
# The kernels on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def to(branches, sample, device):
    """The candidates on ``device``, A's columns still strided views."""
    out = []
    for b in branches:
        c = {k: v.to(device) for k, v in b.items()}
        if b["origins"].stride(0) == 10:  # A: one packed block on the card
            packed = b["origins"].as_strided((b["origins"].shape[0], 10),
                                             (10, 1)).to(device)
            c |= {"origins": packed[:, 0:3], "dirs": packed[:, 3:6],
                  "throughput": packed[:, 6:9]}
        out.append(c)
    return tuple(out), None if sample is None else sample.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("n_branches", [1, 2])
@pytest.mark.parametrize("n_samples", [1, 4, 8])
@pytest.mark.parametrize("capacity", [4_000, 1_500])
def test_kernels_equal_the_plain_chains(cuda, n_branches, n_samples,
                                        capacity):
    n = 3_000
    branches, sample = to(*candidates(n, n_branches, n_samples, seed=7),
                          cuda)
    assert branches[0]["origins"].stride(0) == 10
    lo, hi = box(cuda)
    before = trace.launches()
    key = wf.compact_keys(branches, sample, n_samples, lo, hi)
    want = wf.compact_keys_plain(branches, sample, n_samples, lo, hi)
    assert key.dtype == want.dtype and torch.equal(key, want)
    key, order = torch.sort(key, stable=True)
    step = 1 << 27
    bounds = torch.searchsorted(key, torch.arange(
        0, (2 * n_samples + 1) * step, step, dtype=key.dtype, device=cuda))
    got = wf.compact_gather(branches, order, bounds, capacity, n_samples)
    queues_equal(got, wf.compact_gather_plain(branches, order, bounds,
                                              capacity, n_samples))
    made = trace.launches() - before
    assert made == {"compact_keys": 1, "compact_gather": 1}
    q, alive, dropped = wf.compact(branches, capacity, lo, hi, sample,
                                   n_samples)
    host, host_sample = candidates(n, n_branches, n_samples, seed=7)
    cpu = wf.compact(host, capacity, *box(), host_sample, n_samples)
    assert (alive, dropped) == cpu[1:]
    queues_equal({k: torch.empty_strided(v.shape, v.stride(), dtype=v.dtype)
                  .copy_(v)
                  for k, v in q.items()}, cpu[0])


@pytest.mark.gpu
def test_wrappers_reject_bad_operands(cuda):
    branches, sample = to(*candidates(300, 2, 4, seed=9), cuda)
    lo, hi = box(cuda)
    before = trace.launches()
    bad = [("pixel", branches[0]["pixel"].long()),  # dtype
           ("origins", branches[0]["origins"][:, :2]),  # shape
           ("active", branches[1]["active"][:-1]),
           ("dirs", branches[1]["dirs"].cpu())]  # device
    for name, x in bad:
        b = ({**branches[0], name: x}, branches[1])
        with pytest.raises(ValueError):
            if name in ("pixel",):
                wf.compact_gather(b, torch.zeros(600 * 4, dtype=torch.int64,
                                                 device=cuda),
                                  torch.zeros(9, dtype=torch.int64,
                                              device=cuda), 100, 4)
            else:
                wf.compact_keys(b, sample, 4, lo, hi)
    with pytest.raises(ValueError):
        wf.compact_keys(branches, sample.long(), 4, lo, hi)
    with pytest.raises(ValueError):
        wf.compact_keys(branches, sample, 4, lo.cpu(), hi)
    assert trace.launches() == before


@pytest.mark.gpu
def test_a_whitted_frame_through_the_kernels_equals_the_chains(cuda,
                                                               monkeypatch):
    """A depth-3 Whitted frame at spp 4 launches each kernel once a
    compaction (2) and gives the frame the plain chains give, bit for bit."""
    r = Renderer(testscenes.bench_scene(3_000, 96, 48), 96, 48, device=cuda)
    trace.reset()
    img, stats = r.render_whitted_frame(max_depth=3, spp=4)
    made = trace.launches()
    assert made["compact_keys"] == made["compact_gather"] == 2
    monkeypatch.setattr(wf, "compact_keys", wf.compact_keys_plain)
    monkeypatch.setattr(wf, "compact_gather", wf.compact_gather_plain)
    ref, ref_stats = r.render_whitted_frame(max_depth=3, spp=4)
    assert bits_equal(img, ref)
    assert torch.equal(stats["alive"], ref_stats["alive"])
