"""The port's linear-attention scans against the reference.

``repro_torch.kernels.linear_scan.ssd_scan`` (on the CPU its plain
version, the chunked closed form) against the reference's Pallas
``ssd_scan`` in interpret mode and against the reference's sequential
``recurrent_scan``; the port's ``recurrent_scan`` / ``recurrent_step``
against the reference's in both modes.  Inputs are made with numpy from a
seed and handed to both packages.

Tolerances: f32 throughout.  ``SCAN_TOL`` (rtol = atol = 2e-4) is the
reference's own bound for its chunked kernel against its recurrence
(``tests/test_linear_scan_kernel.py:27-30``): the chunked closed form
and the token loop sum in different orders (measured here: <= 4.2e-5 on
outputs up to ~11).  The two token loops sum in the same order, so
``LOOP_TOL`` is 1e-5.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.linear_scan import ssd_scan as ref_ssd_scan  # noqa: E402
from repro.models.linear_attention import (  # noqa: E402
    recurrent_scan as ref_recurrent_scan,
    recurrent_step as ref_recurrent_step,
)
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.models.linear_attention import (  # noqa: E402
    recurrent_scan,
    recurrent_step,
)

SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
LOOP_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(shape, seed=0, *, decay_dim=None, state=False):
    """q, k, v, logw (<= 0) and optionally state0, as numpy f32."""
    b, t, h, dk, dv = shape
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, t, h, dk)).astype(np.float32) * 0.5
            for _ in range(2))
    v = rng.standard_normal((b, t, h, dv)).astype(np.float32) * 0.5
    wshape = (b, t, h) if decay_dim is None else (b, t, h, decay_dim)
    logw = -np.logaddexp(rng.standard_normal(wshape) * 0.5, 0.0)
    out = [q, k, v, logw.astype(np.float32)]
    if state:
        out.append(rng.standard_normal((b, h, dk, dv)).astype(np.float32))
    return out


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", [
    # (B, T, H, dk, dv, chunk): the reference test's three shapes
    (1, 64, 2, 16, 16, 16),
    (2, 128, 3, 32, 32, 32),
    (2, 256, 2, 64, 64, 128),
])
def test_ssd_scan_matches_reference_kernel(shape):
    b, t, h, dk, dv, chunk = shape
    q, k, v, logw = _inputs((b, t, h, dk, dv), seed=t)
    want = np.asarray(ref_ssd_scan(q, k, v, logw, chunk=chunk,
                                   interpret=True))
    before = ls.launches
    got = ls.ssd_scan(*_t(q, k, v, logw), chunk=chunk)
    assert ls.launches == before            # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == (b, t, h, dv)
    np.testing.assert_allclose(got.numpy(), want, **SCAN_TOL)


@pytest.mark.parametrize("shape,chunk", [
    ((2, 100, 3, 16, 32), 32),     # ragged T: 100 = 3 * 32 + 4
    ((1, 77, 2, 32, 16), 128),     # one ragged chunk
    ((2, 64, 2, 64, 64), 16),      # full width heads, T a multiple
])
def test_ssd_scan_matches_reference_recurrence(shape, chunk):
    """Ragged T, a non-zero state0 and the final state: the port's scan
    is ``recurrent_scan`` for a scalar decay per head."""
    q, k, v, logw, s0 = _inputs(shape, seed=shape[1], state=True)
    want, want_s = ref_recurrent_scan(q, k, v, logw[..., None],
                                      state0=jnp.asarray(s0),
                                      rwkv_mode=False)
    got, got_s = ls.ssd_scan(*_t(q, k, v, logw), chunk=chunk,
                             state0=torch.from_numpy(s0), return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **SCAN_TOL)


def test_ssd_scan_bf16_inputs_match_reference_kernel():
    """bf16 q/k/v (the Mamba layer's dtype): f32 sums, bf16 output, as the
    reference kernel.  Within one bf16 ulp (2^-7 relative) plus 1e-2 for
    outputs near 0 whose f32 sums round either way."""
    q, k, v, logw = _inputs((2, 128, 2, 16, 32), seed=5)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(ref_ssd_scan(*bf, logw, chunk=64, interpret=True)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .to(torch.bfloat16) for a in bf)
    got = ls.ssd_scan(tq, tk, tv, torch.from_numpy(logw), chunk=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-2)


def test_ssd_scan_steep_decay_is_finite_and_forgets():
    """logw = -60 per token: e^{L_t - L_i} above the diagonal would
    overflow; the plain version masks before the exponential.  Each token
    then sees only itself: o_t = (q_t . k_t) v_t."""
    q, k, v, _ = _inputs((1, 96, 2, 8, 8), seed=7)
    logw = np.full((1, 96, 2), -60.0, np.float32)
    got, s = ls.ssd_scan(*_t(q, k, v, logw), chunk=32, return_state=True)
    assert torch.isfinite(got).all() and torch.isfinite(s).all()
    expect = np.einsum("bthd,bthd->bth", q, k)[..., None] * v
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-3, atol=1e-3)


def test_ssd_scan_checks_its_arguments():
    q, k, v, logw = _t(*_inputs((1, 8, 1, 4, 4)))
    with pytest.raises(ValueError, match="chunk"):
        ls.ssd_scan(q, k, v, logw, chunk=256)
    with pytest.raises(ValueError, match="dk"):
        z = torch.zeros((1, 8, 1, 65))
        ls.ssd_scan(z, z, z[..., :4], logw)
    with pytest.raises(ValueError, match="dtype"):
        ls.ssd_scan(q.double(), k, v, logw)
    with pytest.raises(ValueError, match="logw"):
        ls.ssd_scan(q, k, v, logw.to(torch.bfloat16))
    with pytest.raises(ValueError, match="state0"):
        ls.ssd_scan(q, k, v, logw, state0=torch.zeros((1, 1, 4, 5)))
    meta = [a.to("meta") for a in (q, k, v, logw)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        ls.ssd_scan(*meta)


@pytest.mark.parametrize("rwkv_mode", [False, True])
def test_recurrent_scan_matches_reference(rwkv_mode):
    """Per-channel decay (B,T,H,dk), ragged T against chunk 32, state0,
    and the rwkv bonus u in rwkv mode."""
    shape = (2, 45, 3, 16, 8)
    q, k, v, logw, s0 = _inputs(shape, seed=11, decay_dim=16, state=True)
    u = np.random.default_rng(12).standard_normal((3, 16)).astype(np.float32)
    uu = u if rwkv_mode else None
    want, want_s = ref_recurrent_scan(q, k, v, logw, uu, jnp.asarray(s0),
                                      rwkv_mode=rwkv_mode)
    got, got_s = recurrent_scan(*_t(q, k, v, logw),
                                None if uu is None else torch.from_numpy(uu),
                                torch.from_numpy(s0), rwkv_mode=rwkv_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOOP_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **LOOP_TOL)


@pytest.mark.parametrize("rwkv_mode", [False, True])
def test_recurrent_step_matches_reference(rwkv_mode):
    rng = np.random.default_rng(13)
    b, h, dk, dv = 3, 2, 16, 32
    q, k, logw = (rng.standard_normal((b, h, dk)).astype(np.float32)
                  for _ in range(3))
    logw = -np.abs(logw)
    v = rng.standard_normal((b, h, dv)).astype(np.float32)
    s = rng.standard_normal((b, h, dk, dv)).astype(np.float32)
    u = rng.standard_normal((h, dk)).astype(np.float32) if rwkv_mode \
        else None
    want, want_s = ref_recurrent_step(q, k, v, logw, s, u,
                                      rwkv_mode=rwkv_mode)
    got, got_s = recurrent_step(*_t(q, k, v, logw, s),
                                None if u is None else torch.from_numpy(u),
                                rwkv_mode=rwkv_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOOP_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **LOOP_TOL)


def test_ssd_scan_equals_port_recurrence_on_scalar_decay():
    """The port's own two paths for the Mamba scan: the chunked form
    (prefill) and the token loop (the decode step's recurrence)."""
    q, k, v, logw, s0 = _inputs((1, 70, 4, 16, 32), seed=17, state=True)
    a, sa = ls.ssd_scan(*_t(q, k, v, logw), chunk=16,
                        state0=torch.from_numpy(s0), return_state=True)
    b, sb = recurrent_scan(*_t(q, k, v), torch.from_numpy(logw)[..., None],
                           state0=torch.from_numpy(s0))
    torch.testing.assert_close(a, b, **SCAN_TOL)
    torch.testing.assert_close(sa, sb, **SCAN_TOL)
