"""Flow-matching sampling: the ODE time grid and the ODE integrators.

Counterpart of ``showo_tpu/show_o2/transport.py`` (show-o2/transport/), its
sampling part, every ``sampling_method`` of the text-to-image pipeline:
  * :func:`ode_timegrid`: ``num_steps`` points from t0 to t1 (t = 1 is
    clean data), warped by ``time_shifting_factor`` f as
    ``t / (t + f - f t)`` (integrators.py:100-101) and, with ``do_shift``,
    by the resolution-aware :func:`time_shift` (transport.py:133-146);
  * :func:`sample_ode_euler`: fixed-step Euler over the grid, one
    velocity evaluation per interval (``euler``);
  * :func:`sample_ode_heun`: fixed-step Heun, two per interval (``heun``);
  * :func:`sample_dpm_solver_pp`: multistep DPM-Solver++(2M) on the linear
    flow path, one per interval, its coefficients from the host table
    :func:`dpm_solver_pp_coeffs` (``dpm-solver`` / ``dpm``);
  * :func:`sample_ode_dopri5`: adaptive Dormand-Prince 5(4) from t0 to t1,
    the algorithm of ``jax.experimental.ode.odeint`` that the JAX package
    calls (its tableau, initial step, error ratio and step controller),
    with the step decisions taken on the host (``dopri5``).

The training-side coupling plans, the SDE samplers and the likelihood ODE
are not ported (no entry point samples with them).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

SAMPLERS = ("euler", "heun", "dpm-solver", "dpm", "dopri5")


def get_lin_function(x1=256.0, y1=0.5, x2=4096.0, y2=1.15):
    m = (y2 - y1) / (x2 - x1)
    b = y1 - m * x1
    return lambda x: m * x + b


def time_shift(mu: float, sigma: float, t):
    """transport.py:133-139 on numpy or floats (t = 1 is clean data)."""
    t = 1 - t
    t = math.exp(mu) / (math.exp(mu) + (1 / np.clip(t, 1e-8, None) - 1)
                        ** sigma)
    return 1 - t


def ode_timegrid(num_steps: int, time_shifting_factor: Optional[float] = None,
                 do_shift: bool = False, seq_len: Optional[int] = None,
                 t0: float = 0.0, t1: float = 1.0) -> torch.Tensor:
    """The sampler's time grid, float32 [num_steps] on the CPU (a host-side
    table: the integrator reads each entry as a Python float)."""
    t = np.linspace(t0, t1, num_steps, dtype=np.float32)
    if time_shifting_factor:
        f = np.float32(time_shifting_factor)
        t = t / (t + f - f * t)
    if do_shift:
        mu = get_lin_function(y1=0.5, y2=1.15)(seq_len)
        t = time_shift(mu, 1.0, t).astype(np.float32)
    return torch.as_tensor(t, dtype=torch.float32)


def sample_ode_euler(drift_fn: Callable, x: torch.Tensor,
                     t_grid: torch.Tensor) -> torch.Tensor:
    """Fixed-step Euler over ``t_grid``: drift_fn(x, t [B]) -> v; returns
    the final sample.  The step is taken in x's dtype from the velocity
    widened to it, as JAX promotes the bf16 velocity by the fp32 grid."""
    grid = np.asarray(t_grid, dtype=np.float32)
    for t_cur, t_next in zip(grid[:-1], grid[1:]):
        t = torch.full((x.shape[0],), float(t_cur), dtype=x.dtype,
                       device=x.device)
        v = drift_fn(x, t)
        # the interval as the fp32 difference JAX takes
        x = x + float(t_next - t_cur) * v.to(x.dtype)
    return x


def _t_vec(x: torch.Tensor, t) -> torch.Tensor:
    return torch.full((x.shape[0],), float(t), dtype=x.dtype,
                      device=x.device)


def sample_ode_heun(drift_fn: Callable, x: torch.Tensor,
                    t_grid: torch.Tensor) -> torch.Tensor:
    """Fixed-step Heun over ``t_grid`` (integrators.py:95-118, torchdiffeq's
    'heun2'): per interval an Euler predictor and the trapezoid corrector,
    two velocity evaluations."""
    grid = np.asarray(t_grid, dtype=np.float32)
    for t_cur, t_next in zip(grid[:-1], grid[1:]):
        dt = t_next - t_cur
        v1 = drift_fn(x, _t_vec(x, t_cur))
        xp = x + float(dt) * v1.to(x.dtype)
        v2 = drift_fn(xp, _t_vec(x, t_next))
        x = x + float(np.float32(0.5) * dt) * (v1 + v2).to(x.dtype)
    return x


def dpm_solver_pp_coeffs(t_grid):
    """Per-interval coefficients (c_x, c_p0, c_p1), float32 numpy arrays
    aligned with ``t_grid[1:]``, of multistep DPM-Solver++(2M) on the flow
    schedule alpha_t = t, sigma_t = 1 - t (t = 1 clean), as the JAX
    package computes them on the host in float64:

        x_i = (sigma_i / sigma_{i-1}) x_{i-1} + alpha_i (1 - e^{-h_i}) D_i,
        D_i = (1 + 1 / (2 r_i)) P_{i-1} - 1 / (2 r_i) P_{i-2},
        r_i = h_{i-1} / h_i,  h_i = lambda_i - lambda_{i-1},
        lambda = log(alpha / sigma),

    first order at the first and the last (clean end point) interval, with
    e^{-h_i} taken as the ratio (sigma_i alpha_{i-1}) / (sigma_{i-1}
    alpha_i), finite at both end points."""
    t = np.asarray(t_grid, np.float64)
    alpha, sigma = t, 1.0 - t
    tc = np.clip(t, 1e-12, 1 - 1e-12)
    lam = np.log(tc) - np.log1p(-tc)
    n = len(t) - 1
    c_x, c_p0, c_p1 = np.zeros(n), np.zeros(n), np.zeros(n)
    for i in range(1, n + 1):
        e_mh = (sigma[i] * alpha[i - 1]) / max(sigma[i - 1] * alpha[i],
                                               1e-300)
        base = alpha[i] * (1.0 - e_mh)
        c_x[i - 1] = sigma[i] / max(sigma[i - 1], 1e-300)
        h_i = lam[i] - lam[i - 1]
        h_prev = lam[i - 1] - lam[i - 2] if i >= 2 else 0.0
        if i == 1 or i == n or h_i <= 0 or h_prev <= 0:
            c_p0[i - 1] = base
        else:
            r = h_prev / h_i
            c_p0[i - 1] = base * (1.0 + 1.0 / (2.0 * r))
            c_p1[i - 1] = base * (-1.0 / (2.0 * r))
    return (c_x.astype(np.float32), c_p0.astype(np.float32),
            c_p1.astype(np.float32))


def sample_dpm_solver_pp(drift_fn: Callable, x: torch.Tensor,
                         t_grid: torch.Tensor) -> torch.Tensor:
    """Multistep DPM-Solver++(2M) driven by the velocity on the linear flow
    path: the data prediction x + (1 - t) v (x_t = t x1 + (1 - t) x0,
    v = x1 - x0), one velocity evaluation per interval."""
    grid = np.asarray(t_grid, dtype=np.float32)
    c_x, c_p0, c_p1 = dpm_solver_pp_coeffs(grid)
    p_prev = torch.zeros_like(x)          # the first interval: c_p1 == 0
    for t_cur, cx, cp0, cp1 in zip(grid[:-1], c_x, c_p0, c_p1):
        v = drift_fn(x, _t_vec(x, t_cur))
        p_cur = x + float(np.float32(1.0) - t_cur) * v.to(x.dtype)
        x = float(cx) * x + float(cp0) * p_cur + float(cp1) * p_prev
        p_prev = p_cur
    return x


# Dormand-Prince 5(4), as jax.experimental.ode (runge_kutta_step,
# interp_fit_dopri): the nodes, the stages' weights, the fifth-order
# solution's weights and those of the error estimate
_DOPRI_ALPHA = np.array([1 / 5, 3 / 10, 4 / 5, 8 / 9, 1., 1., 0], np.float32)
_DOPRI_BETA = np.array(
    [[1 / 5, 0, 0, 0, 0, 0, 0], [3 / 40, 9 / 40, 0, 0, 0, 0, 0],
     [44 / 45, -56 / 15, 32 / 9, 0, 0, 0, 0],
     [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0, 0],
     [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0, 0],
     [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]],
    np.float32)
_DOPRI_C_SOL = np.array(
    [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0],
    np.float32)
_DOPRI_C_ERR = np.array([
    35 / 384 - 1951 / 21600, 0, 500 / 1113 - 22642 / 50085,
    125 / 192 - 451 / 720, -2187 / 6784 - -12231 / 42400,
    11 / 84 - 649 / 6300, -1. / 60.], np.float32)
_DOPRI_C_MID = np.array([
    6025192743 / 30085553152 / 2, 0, 51252292925 / 65400821598 / 2,
    -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
    -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2], np.float32)


def _combine(coeffs, k) -> torch.Tensor:
    """sum_i coeffs[i] k[i] over the stages (coeffs float32 numpy)."""
    w = torch.as_tensor(coeffs, device=k.device)
    return torch.tensordot(w, k, dims=1)


def _fma(a, b: torch.Tensor, c) -> torch.Tensor:
    """a * b + c rounded once to b's dtype, as XLA's CPU fusions contract a
    multiply and an add (a a float32 scalar, c a tensor or a scalar)."""
    c = c.double() if torch.is_tensor(c) else float(c)
    return (b.double() * float(a) + c).to(b.dtype)


def _f32(x) -> np.float32:
    return np.float32(x.item() if torch.is_tensor(x) else x)


def _rms(x: torch.Tensor) -> np.float32:
    """sqrt(mean(x^2)) in float32, the mean as the sum times 1 / n."""
    return np.sqrt(_f32((x * x).sum()) * np.float32(1.0 / x.numel()))


def _norm(x: torch.Tensor) -> np.float32:
    return np.sqrt(_f32((x * x).sum()))


def _initial_step_size(fun, t0, y0, f0, order, rtol, atol) -> np.float32:
    """jax.experimental.ode.initial_step_size (Hairer, Norsett and Wanner,
    Solving ODEs I, Sec. II.4), in float32."""
    scale = _fma(np.float32(rtol), y0.abs(), np.float32(atol))
    d0, d1 = _norm(y0 / scale), _norm(f0 / scale)
    h0 = (np.float32(1e-6) if (d0 < 1e-5) or (d1 < 1e-5)
          else np.float32(0.01) * d0 / d1)
    f1 = fun(_fma(h0, f0, y0), t0 + h0)
    d2 = _norm((f1 - f0) / scale) / h0
    if d1 <= 1e-15 and d2 <= 1e-15:
        h1 = np.maximum(np.float32(1e-6), h0 * np.float32(1e-3))
    else:
        h1 = (np.float32(0.01) / np.maximum(d1, d2)) ** np.float32(
            1.0 / (order + 1.0))
    return np.minimum(np.float32(100.0) * h0, h1)


def _optimal_step_size(last_step, error_ratio, safety=0.9, ifactor=10.0,
                       dfactor=0.2, order=5.0) -> np.float32:
    """jax.experimental.ode.optimal_step_size, in float32."""
    if error_ratio == 0:
        return last_step * np.float32(ifactor)
    dfactor = np.float32(1.0 if error_ratio < 1 else dfactor)
    factor = np.minimum(np.float32(ifactor), np.maximum(
        error_ratio ** np.float32(-1.0 / order) * np.float32(safety),
        dfactor))
    return last_step * factor


def sample_ode_dopri5(drift_fn: Callable, x: torch.Tensor, t0: float = 0.0,
                      t1: float = 1.0, rtol: float = 1e-3,
                      atol: float = 1e-6, stats: Optional[dict] = None
                      ) -> torch.Tensor:
    """Adaptive Dormand-Prince from t0 to t1 (the reference's default
    'dopri5', transport.py:400-447), the algorithm of
    ``jax.experimental.ode.odeint`` that the JAX package runs: the initial
    step of Hairer et al., steps accepted where the RMS error ratio
    (error over atol + rtol * max(|y0|, |y1|)) is <= 1, the step size
    scaled by 0.9 * ratio^(-1/5) within [0.2 (only after a rejection), 10],
    no step cap; the integration steps past t1 and the solution at t1 is
    the step's quartic interpolant there.  The state is x flattened, in
    x's dtype, its updates rounded once as XLA's fused multiply-adds are;
    the step decisions are taken on the host in float32.  ``stats``, when
    given, receives the velocity evaluations (``nfe``) and the accepted
    and rejected steps."""
    shape, dtype = x.shape, x.dtype

    def fun(y, t):
        yy = y.view(shape)
        return drift_fn(yy, _t_vec(yy, t)).to(dtype).reshape(-1)

    y = x.reshape(-1).clone()
    t, target = np.float32(t0), np.float32(t1)
    rtol32, atol32 = np.float32(rtol), np.float32(atol)
    f = fun(y, t)
    dt = _initial_step_size(fun, t, y, f, 4, rtol, atol)
    nfe, accepted, rejected = 2, 0, 0
    last_t, interp = t, None
    while t < target and dt > 0:
        k = torch.zeros((7, y.numel()), dtype=dtype, device=y.device)
        k[0] = f
        for i in range(1, 7):
            ti = np.float32(np.float64(dt) * np.float64(_DOPRI_ALPHA[i - 1])
                            + np.float64(t))
            k[i] = fun(_fma(dt, _combine(_DOPRI_BETA[i - 1], k), y), ti)
        nfe += 6
        next_y = _fma(dt, _combine(_DOPRI_C_SOL, k), y)
        err = float(dt) * _combine(_DOPRI_C_ERR, k)
        tol = _fma(rtol32, torch.maximum(y.abs(), next_y.abs()), atol32)
        ratio = _rms(err / tol)
        new_dt = _optimal_step_size(dt, ratio)
        if ratio <= 1.0:
            interp = _interp_fit_dopri(y, next_y, k, dt)
            y, f, last_t, t = next_y, k[-1], t, t + dt
            accepted += 1
        else:
            rejected += 1
        dt = new_dt
    if stats is not None:
        stats.update(nfe=nfe, accepted=accepted, rejected=rejected)
    if interp is None:
        return y.view(shape)
    s = float((target - last_t) / (t - last_t))
    out = torch.zeros_like(y)
    for c in interp:                       # jnp.polyval: Horner
        out = _fma(s, out, c)
    return out.view(shape)


def _interp_fit_dopri(y0, y1, k, dt):
    """The quartic through a step (jax.experimental.ode.interp_fit_dopri and
    fit_4th_order_polynomial): coefficients (a, b, c, d, e) in s in [0, 1]."""
    h = float(dt)
    y_mid = _fma(dt, _combine(_DOPRI_C_MID, k), y0)
    dy0, dy1 = k[0], k[-1]
    a = -2. * h * dy0 + 2. * h * dy1 - 8. * y0 - 8. * y1 + 16. * y_mid
    b = 5. * h * dy0 - 3. * h * dy1 + 18. * y0 + 14. * y1 - 32. * y_mid
    c = -4. * h * dy0 + h * dy1 - 11. * y0 - 5. * y1 + 16. * y_mid
    return a, b, c, h * dy0, y0


def sample(method: str, drift_fn: Callable, x: torch.Tensor,
           t_grid: torch.Tensor, stats: Optional[dict] = None
           ) -> torch.Tensor:
    """The pipeline's ``sampling_method`` switch (JAX
    pipelines/t2i_v2.py:113-120): heun, dpm-solver / dpm and dopri5 by
    name, Euler otherwise; ``stats`` reaches dopri5."""
    if method == "heun":
        return sample_ode_heun(drift_fn, x, t_grid)
    if method in ("dpm-solver", "dpm"):
        return sample_dpm_solver_pp(drift_fn, x, t_grid)
    if method == "dopri5":
        return sample_ode_dopri5(drift_fn, x, stats=stats)
    return sample_ode_euler(drift_fn, x, t_grid)


def check_sampler(method: str) -> str:
    """``method`` if it is one of the JAX package's ODE samplers
    (:data:`SAMPLERS`); any other name raises ValueError."""
    if method in SAMPLERS:
        return method
    raise ValueError(f"unknown sampling_method {method!r}; the JAX package "
                     f"knows {SAMPLERS}")
