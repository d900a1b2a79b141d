"""The port's precision micro (directx_raytracer_tpu_torch.tools.
precision_micro) vs the JAX micro-bench kernel, on the CPU.

The JAX kernel ``_body`` (tools/precision_micro.py:32) runs unedited in
interpret mode, wrapped so that its output block starts at the sentinel on
the first grid step (the JAX tool never initialises it).  Both sides get
the same seeded numpy inputs at S = 16 steps of the tool's own widths
(K = 128 triangles, R = 256 rays).

What each variant is compared with:
* ``highest``: the JAX kernel directly (f32 dots on both sides).
* ``default``: the JAX kernel on bf16-rounded w and rays.  On the CPU,
  interpret mode's default dot is f32, not the TPU's 1-pass bf16; rounding
  the operands to bf16 first and summing the exact products in f32 is the
  TPU semantics the tool's docstring names, and what the port computes.
* ``split3``: the JAX kernel on w and rays rounded to two bf16 terms,
  x = bf16(x) + bf16(x - bf16(x)).  Interpret mode keeps the lo parts in
  f32 where the TPU's default dot (and the port) rounds them to bf16; on
  such inputs lo is already a bf16 value, so both compute the same
  function.  On raw f32 inputs the lo rounding alone moves min t by up to
  5e-3 relative here.

Tolerance: identical sentinel sets, and each ray's min t within 2e-4
relative.  The two sides may sum the depth-8 products in different
orders, and tt = -mm[2K+k] / mm[5K+k] amplifies a product's rounding by
the cancellation in mm[2K+k]: on these inputs the f32 fold and the same
fold in float64 differ by up to 7.9e-5 relative, so two f32 orders may
differ by twice that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from directx_raytracer_tpu_torch.tools import precision_micro as ppm
from tools import precision_micro as jpm

S = 16
K, R = jpm.K, jpm.R
RTOL = 2e-4


def jax_fold(variant, w, rays):
    """(R,) int32: the JAX ``_body`` in interpret mode, its output block
    set to the sentinel on the first grid step."""
    body = jpm._body(variant)

    def kernel(w_ref, r_ref, init_ref, out_ref):
        @pl.when(pl.program_id(0) == 0)
        def _():
            out_ref[...] = init_ref[...]

        body(w_ref, r_ref, out_ref)

    init = np.full((1, 1, R), ppm.SENTINEL, np.int32)
    out = pl.pallas_call(
        kernel,
        grid=(w.shape[0],),
        in_specs=[pl.BlockSpec((1, 8, 6 * K), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, 8, R), lambda i: (0, 0, 0)),
                  pl.BlockSpec((1, 1, R), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((1, 1, R), lambda i: (0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, 1, R), jnp.int32),
        interpret=True,
    )(w, rays, init)
    return np.asarray(out).reshape(-1)


def bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def bf16x2(x):
    hi = bf16(x)
    return hi + bf16(x - hi)


# The operands each variant's JAX run gets (see the module docstring).
JAX_INPUTS = {"highest": lambda x: x, "default": bf16, "split3": bf16x2}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((S, 8, 6 * K)).astype(np.float32)
    rays = rng.standard_normal((1, 8, R)).astype(np.float32)
    return w, rays


def min_t(packed):
    """(R,) f64 min t, +inf for the sentinel."""
    packed = np.asarray(packed).reshape(-1)
    t = packed.view(np.float32).astype(np.float64)
    return np.where(packed == ppm.SENTINEL, np.inf, t)


@pytest.mark.parametrize("variant", ppm.VARIANTS)
def test_plain_matches_jax_kernel(inputs, variant):
    w, rays = inputs
    jw, jr = JAX_INPUTS[variant](w), JAX_INPUTS[variant](rays)
    want = min_t(jax_fold(variant, jw, jr))
    got = min_t(ppm.precision_fold_plain(variant, torch.from_numpy(w),
                                         torch.from_numpy(rays)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    hit = np.isfinite(want)
    assert hit.sum() > R // 2
    np.testing.assert_allclose(got[hit], want[hit], rtol=RTOL, atol=0)


@pytest.mark.parametrize("variant", ppm.VARIANTS)
def test_zero_denominator_is_no_hit(variant):
    """mm[5K+k] = 0 with mm[2K+k] < 0 gives tt = +inf, u = x + inf * 0 =
    NaN and v = +inf.  A min that drops NaN would pass min(u, v, 1-u-v) =
    +inf and pack 0x7f800000 below the sentinel; the reference's min
    propagates NaN, so no ray hits."""
    w = np.zeros((1, 8, 6 * K), np.float32)
    w[0, 0, 0:2 * K] = 0.25  # u, v origins
    w[0, 0, 2 * K:3 * K] = -1.0  # opz
    w[0, 0, 4 * K:5 * K] = 1.0  # dv; du and dpz stay 0
    rays = np.random.default_rng(1).standard_normal((1, 8, R)).astype(np.float32)
    rays[0, 0] = 1.0  # mm = w[:, 0] exactly
    got = ppm.precision_fold_plain(variant, torch.from_numpy(w),
                                   torch.from_numpy(rays))
    assert (got == ppm.SENTINEL).all()
    np.testing.assert_array_equal(jax_fold(variant, w, rays),
                                  np.full(R, ppm.SENTINEL, np.int32))


@pytest.mark.parametrize("variant", ppm.VARIANTS)
def test_wrapper_takes_plain_version_on_cpu(inputs, variant):
    w, rays = (torch.from_numpy(x[:4] if x.shape[0] == S else x)
               for x in inputs)
    before = dict(ppm.LAUNCHES)
    got = ppm.precision_fold(variant, w, rays)
    assert got.dtype == torch.int32 and got.shape == (1, 1, R)
    assert torch.equal(got, ppm.precision_fold_plain(variant, w, rays))
    assert ppm.LAUNCHES == before


def test_plain_chunks_agree_and_reject_bad_variant(inputs):
    w, rays = (torch.from_numpy(x) for x in inputs)
    one = ppm.precision_fold_plain("highest", w, rays, chunk=S)
    assert torch.equal(one, ppm.precision_fold_plain("highest", w, rays,
                                                     chunk=3))
    with pytest.raises(ValueError):
        ppm.precision_fold("fast", w, rays)


def test_f64_probe_is_the_fold_in_f64(inputs):
    """The error probe's reference: full f32 agrees with it on every ray
    at the tolerance above."""
    w, rays = (torch.from_numpy(x) for x in inputs)
    ref = ppm.fold_min_t_f64(w, rays)
    assert ref.dtype == torch.float64 and ref.shape == (R,)
    got = ppm.min_t(ppm.precision_fold_plain("highest", w, rays))
    assert ppm.agreement(got, ref, RTOL) == 1.0


def test_main_runs_plain_on_cpu(capsys):
    assert ppm.main(["--device", "cpu", "--steps", "4", "--reps", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0].strip() for ln in lines] == list(ppm.VARIANTS)
    assert all("ms / 4 steps" in ln and ln.endswith("[cpu]") for ln in lines)


def test_main_without_cuda_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ppm.main([]) == 1
    assert capsys.readouterr().out == ""
