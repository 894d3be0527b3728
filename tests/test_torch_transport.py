"""The Show-o2 ODE samplers of showo_tpu_torch against the JAX package's,
on the CPU, fp32 (mirrors tests/test_transport_solvers.py).

* ``dpm_solver_pp_coeffs``: bit-exact on the same float32 grids.
* Heun, DPM-Solver++ and dopri5 against JAX on analytic drifts, atol
  1e-5; dopri5 takes JAX's steps at the pipeline's tolerances (rtol 1e-3,
  atol 1e-6) and looser ones: as many velocity evaluations, the first
  step's at the same times (later ones within 5%: the float32 norms of
  the error control sum in another order than XLA's, and the controller
  carries such an ulp on), and the same accepted and rejected steps
  (counted from JAX's evaluation times).
* The analytic checks of the JAX tests, on the port: Heun beats Euler on
  a linear flow, dopri5 is exact to rtol 1e-4 on it, DPM-Solver++ is exact
  for a constant data prediction and close to many-step Euler on a
  Gaussian flow.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.show_o2 import transport as jtransport
from showo_tpu_torch.show_o2 import transport as ttransport

torch.set_num_threads(1)


def _grids(n, factor=3.0):
    """The JAX grid, as float32 numpy, for both samplers."""
    g = np.asarray(jtransport.ode_timegrid(n, time_shifting_factor=factor))
    return g, torch.as_tensor(g)


@pytest.mark.parametrize("n,factor", [(2, None), (6, None), (20, 3.0),
                                      (50, 3.0), (50, None)])
def test_dpm_solver_pp_coeffs_bit_exact(n, factor):
    g, _ = _grids(n, factor)
    want = jtransport.dpm_solver_pp_coeffs(jnp.asarray(g))
    got = ttransport.dpm_solver_pp_coeffs(g)
    for w, t in zip(want, got):
        assert t.dtype == np.float32
        np.testing.assert_array_equal(t, np.asarray(w))


def _gaussian_drift(lib, m=1.5, s=0.5):
    """The marginal velocity of the linear path with x1 ~ N(m, s^2)."""
    def drift(x, t):
        tt = t.reshape(-1, 1)
        var = tt ** 2 * s ** 2 + (1 - tt) ** 2
        x1_hat = (tt * s ** 2 * x + (1 - tt) ** 2 * m) / lib.maximum(
            var, lib.full_like(var, 1e-8))
        x0_hat = (x - tt * x1_hat) / lib.maximum(1 - tt,
                                                 lib.full_like(tt, 1e-6))
        return x1_hat - x0_hat

    return drift


DRIFTS = {
    "linear": (lambda lib: (lambda x, t: 0.7 * x), (2, 8)),
    "gaussian": (_gaussian_drift, (16, 1)),
    "nonlinear": (lambda lib: (lambda x, t: lib.sin(x) * t.reshape(-1, 1)
                               - 0.5 * x), (4, 6)),
}


@pytest.mark.parametrize("drift", list(DRIFTS))
@pytest.mark.parametrize("method", ["heun", "dpm-solver"])
def test_fixed_grid_samplers_vs_jax(method, drift):
    make, shape = DRIFTS[drift]
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    g, tg = _grids(20)
    got = ttransport.sample(method, make(torch), torch.as_tensor(x), tg)
    fn = (jtransport.sample_ode_heun if method == "heun"
          else jtransport.sample_dpm_solver_pp)
    want = fn(make(jnp), jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _jax_dopri5_calls(drift, x, **kw):
    """JAX's dopri5 result and the times at which it evaluated the
    drift, in order."""
    times = []

    def traced(y, t):
        jax.debug.callback(lambda tt: times.append(float(tt[0])), t,
                           ordered=True)
        return drift(y, t)

    out = jtransport.sample_ode_dopri5(traced, jnp.asarray(x), **kw)
    out = np.asarray(out)
    jax.effects_barrier()
    return out, times


def _steps(times):
    """(accepted, rejected) of a dopri5 run from its evaluation times:
    after the two evaluations of the start, each attempt evaluates at
    t + dt/5 (first) and t + dt (fifth), so its (t, dt) follows; an
    attempt is accepted where the next one starts at t + dt."""
    att = [times[i:i + 6] for i in range(2, len(times), 6)]
    starts = []
    for a in att:
        dt = (a[4] - a[0]) * 5.0 / 4.0
        starts.append((a[4] - dt, dt))
    accepted = sum(1 for (t, dt), (t2, _) in zip(starts, starts[1:])
                   if t2 > t + dt / 2) + 1
    return accepted, len(att) - accepted


@pytest.mark.parametrize("drift", list(DRIFTS))
@pytest.mark.parametrize("tol", [(1e-3, 1e-6), (1e-2, 1e-5)],
                         ids=["default", "loose"])
def test_dopri5_takes_jax_steps(drift, tol):
    make, shape = DRIFTS[drift]
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    rtol, atol = tol
    want, times = _jax_dopri5_calls(make(jnp), x, rtol=rtol, atol=atol)
    calls = []

    def traced(y, t):
        calls.append(float(t[0]))
        return make(torch)(y, t)

    stats = {}
    got = ttransport.sample_ode_dopri5(traced, torch.as_tensor(x), rtol=rtol,
                                       atol=atol, stats=stats)
    assert stats["nfe"] == len(calls) == len(times)
    # the start and the first step at the same times; later the float32
    # norms, summed in another order, move the step sizes by a little
    np.testing.assert_allclose(calls[:8], times[:8], rtol=1e-6)
    np.testing.assert_allclose(calls, times, rtol=5e-2)
    accepted, rejected = _steps(times)
    assert (stats["accepted"], stats["rejected"]) == (accepted, rejected)
    assert accepted >= 2
    if drift == "gaussian":
        # its steps drift apart by up to 5% (above): the two solutions then
        # differ by the integrator's own error, held to its rtol
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# -- the JAX tests' analytic checks, on the port ----------------------------

def test_heun_beats_euler_on_linear_flow():
    x0 = torch.as_tensor(np.random.RandomState(0).randn(2, 8),
                         dtype=torch.float32)
    grid = torch.linspace(0.0, 1.0, 11)
    exact = x0 * math.exp(0.7)
    drift = DRIFTS["linear"][0](torch)
    err_e = float((ttransport.sample_ode_euler(drift, x0, grid)
                   - exact).abs().max())
    err_h = float((ttransport.sample_ode_heun(drift, x0, grid)
                   - exact).abs().max())
    assert err_h < err_e / 5 and err_h < 5e-3


def test_dopri5_linear_flow():
    x0 = torch.as_tensor(np.random.RandomState(1).randn(2, 8),
                         dtype=torch.float32)
    out = ttransport.sample_ode_dopri5(DRIFTS["linear"][0](torch), x0,
                                       rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(out.numpy(), x0.numpy() * math.exp(0.7),
                               rtol=1e-4)


def test_dpm_solver_exact_for_constant_data_prediction():
    target = torch.as_tensor(np.random.RandomState(2).randn(1, 4, 4),
                             dtype=torch.float32)

    def drift(x, t):
        tt = t.reshape(-1, 1, 1)
        return (target - x) / torch.clamp(1.0 - tt, min=1e-6)

    x0 = torch.as_tensor(np.random.RandomState(3).randn(1, 4, 4),
                         dtype=torch.float32)
    out = ttransport.sample_dpm_solver_pp(drift, x0,
                                          ttransport.ode_timegrid(6))
    np.testing.assert_allclose(out.numpy(), target.numpy(), atol=2e-3,
                               rtol=0)


def test_dpm_solver_converges_on_gaussian_flow():
    drift = _gaussian_drift(torch)
    x0 = torch.as_tensor(np.random.RandomState(4).randn(64, 1),
                         dtype=torch.float32)
    ref = ttransport.sample_ode_euler(drift, x0, torch.linspace(0.0, 1.0,
                                                                401))
    fast = ttransport.sample_dpm_solver_pp(drift, x0,
                                           ttransport.ode_timegrid(10))
    assert float((fast - ref).abs().mean()) < 0.05
