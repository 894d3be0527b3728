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

The training side (transport.py:25-233 of the JAX package): the coupling
plans :class:`ICPlan` (linear), :class:`VPCPlan` and :class:`GVPCPlan`,
and :class:`Transport` (``sample_t`` under ``uniform``, ``uniform_a_b``
and ``lognorm`` with ``max_t0`` and ``do_shift``; ``sample``;
``training_losses``); the SDE samplers :func:`sample_sde_euler_maruyama`
and :func:`sample_sde_heun`, and :func:`sample_ode_likelihood` with
:func:`prior_logp`.  Their draws come from an explicit
``torch.Generator``, or are handed in (the tests hand in JAX's).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

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


# ---------------------------------------------------------------------------
# Coupling plans (show-o2/transport/path.py)
# ---------------------------------------------------------------------------

def _expand(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], *([1] * (x.dim() - 1)))


class ICPlan:
    """Linear coupling: alpha = t, sigma = 1 - t (t = 1 is clean data)."""

    def compute_alpha_t(self, t):
        return t, torch.ones_like(t)

    def compute_sigma_t(self, t):
        return 1 - t, -torch.ones_like(t)

    def compute_d_alpha_alpha_ratio_t(self, t):
        return 1 / t

    def compute_drift(self, x, t):
        t = _expand(t, x)
        alpha_ratio = self.compute_d_alpha_alpha_ratio_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        drift = alpha_ratio * x
        diffusion = alpha_ratio * (sigma_t ** 2) - sigma_t * d_sigma_t
        return -drift, diffusion

    def compute_diffusion(self, x, t, form: str = "constant",
                          norm: float = 1.0):
        t = _expand(t, x)
        if form == "constant":
            return torch.full_like(t, norm)
        if form == "SBDM":
            return norm * self.compute_drift(x, t)[1]
        if form == "sigma":
            return norm * self.compute_sigma_t(t)[0]
        if form == "linear":
            return norm * (1 - t)
        if form == "decreasing":
            return 0.25 * (norm * torch.cos(math.pi * t) + 1) ** 2
        if form == "increasing-decreasing":
            return norm * torch.sin(math.pi * t) ** 2
        raise NotImplementedError(form)

    def get_score_from_velocity(self, velocity, x, t):
        t = _expand(t, x)
        alpha_t, d_alpha_t = self.compute_alpha_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        reverse_alpha_ratio = alpha_t / d_alpha_t
        var = sigma_t ** 2 - reverse_alpha_ratio * d_sigma_t * sigma_t
        return (reverse_alpha_ratio * velocity - x) / var

    def get_noise_from_velocity(self, velocity, x, t):
        t = _expand(t, x)
        alpha_t, d_alpha_t = self.compute_alpha_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        reverse_alpha_ratio = alpha_t / d_alpha_t
        var = reverse_alpha_ratio * d_sigma_t - sigma_t
        return (reverse_alpha_ratio * velocity - x) / var

    def compute_mu_t(self, t, x0, x1):
        t = _expand(t, x1)
        alpha_t, _ = self.compute_alpha_t(t)
        sigma_t, _ = self.compute_sigma_t(t)
        return alpha_t * x1 + sigma_t * x0

    def compute_xt(self, t, x0, x1):
        return self.compute_mu_t(t, x0, x1)

    def compute_ut(self, t, x0, x1, xt):
        t = _expand(t, x1)
        _, d_alpha_t = self.compute_alpha_t(t)
        _, d_sigma_t = self.compute_sigma_t(t)
        return d_alpha_t * x1 + d_sigma_t * x0

    def plan(self, t, x0, x1):
        """(t, xt, ut): the point between noise x0 and data x1 at t, and
        the velocity there."""
        xt = self.compute_xt(t, x0, x1)
        return t, xt, self.compute_ut(t, x0, x1, xt)


class VPCPlan(ICPlan):
    """Variance-preserving coupling (beta from sigma_min to sigma_max)."""

    def __init__(self, sigma_min: float = 0.1, sigma_max: float = 20.0):
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max

    def _log_mean_coeff(self, t):
        return (-0.25 * ((1 - t) ** 2) * (self.sigma_max - self.sigma_min)
                - 0.5 * (1 - t) * self.sigma_min)

    def _d_log_mean_coeff(self, t):
        return (0.5 * (1 - t) * (self.sigma_max - self.sigma_min)
                + 0.5 * self.sigma_min)

    def compute_alpha_t(self, t):
        alpha_t = torch.exp(self._log_mean_coeff(t))
        return alpha_t, alpha_t * self._d_log_mean_coeff(t)

    def compute_sigma_t(self, t):
        p = 2 * self._log_mean_coeff(t)
        sigma_t = torch.sqrt(1 - torch.exp(p))
        d_sigma_t = (torch.exp(p) * (2 * self._d_log_mean_coeff(t))
                     / (-2 * sigma_t))
        return sigma_t, d_sigma_t

    def compute_d_alpha_alpha_ratio_t(self, t):
        return self._d_log_mean_coeff(t)

    def compute_drift(self, x, t):
        t = _expand(t, x)
        beta_t = self.sigma_min + (1 - t) * (self.sigma_max - self.sigma_min)
        return -0.5 * beta_t * x, beta_t / 2


class GVPCPlan(ICPlan):
    """Generalised variance-preserving coupling: alpha = sin(pi t / 2),
    sigma = cos(pi t / 2)."""

    def compute_alpha_t(self, t):
        return (torch.sin(t * math.pi / 2),
                math.pi / 2 * torch.cos(t * math.pi / 2))

    def compute_sigma_t(self, t):
        return (torch.cos(t * math.pi / 2),
                -math.pi / 2 * torch.sin(t * math.pi / 2))

    def compute_d_alpha_alpha_ratio_t(self, t):
        return math.pi / (2 * torch.tan(t * math.pi / 2))


_PATHS = {"Linear": ICPlan, "GVP": GVPCPlan, "VP": VPCPlan}


def time_shift_t(mu: float, t: torch.Tensor) -> torch.Tensor:
    """:func:`time_shift` with sigma 1 on a tensor (JAX
    ``_time_shift_traced``: 1 - t clipped below at 1e-8)."""
    s = (1 - t).clamp(min=1e-8)
    return 1 - math.exp(mu) / (math.exp(mu) + (1 / s - 1))


# ---------------------------------------------------------------------------
# Transport (show-o2/transport/transport.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Transport:
    """The training transport (JAX ``Transport``): the coupling plan of
    ``path_type`` (``path_sampler``), the per-sample time draw, and the
    velocity loss."""

    path_type: str = "Linear"
    prediction: str = "velocity"
    snr_type: str = "uniform"
    do_shift: bool = True
    seq_len: int = 1024
    train_eps: float = 0.0
    sample_eps: float = 0.0

    def __post_init__(self):
        self.path_sampler = _PATHS[self.path_type]()

    def base_draw(self, batch: int, generator=None, device=None):
        """The draw :meth:`sample_t` transforms: uniform [batch] under
        ``uniform*``, standard normal under ``lognorm`` (fp32)."""
        kw = dict(generator=generator, device=device, dtype=torch.float32)
        if self.snr_type.startswith("uniform"):
            return torch.rand((batch,), **kw)
        if self.snr_type == "lognorm":
            return torch.randn((batch,), **kw)
        raise NotImplementedError(self.snr_type)

    def sample_t(self, batch: int, generator=None,
                 max_t0: Optional[float] = None, draw=None, device=None):
        """Per-sample times [batch] (transport.py:98-131): ``uniform`` on
        [t0, 1] (t0 = ``max_t0`` or 0), ``uniform_a_b`` on [a, b],
        ``lognorm`` sigmoid(normal) scaled to [t0, 1]; then, with
        ``do_shift``, the resolution-aware shift of ``seq_len``.  ``draw``:
        the :meth:`base_draw` to use instead of one from ``generator``."""
        t0, t1 = 0.0, 1.0
        if max_t0 is not None:
            t0 = max_t0
        u = (self.base_draw(batch, generator, device) if draw is None
             else torch.as_tensor(draw, dtype=torch.float32, device=device))
        if self.snr_type.startswith("uniform"):
            if "_" in self.snr_type:
                _, t0s, t1s = self.snr_type.split("_")
                t0, t1 = float(t0s), float(t1s)
            t = u * (t1 - t0) + t0
        elif self.snr_type == "lognorm":
            t = 1 / (1 + torch.exp(-u)) * (t1 - t0) + t0
        else:
            raise NotImplementedError(self.snr_type)
        if self.do_shift:
            t = time_shift_t(get_lin_function(y1=0.5, y2=1.15)(self.seq_len),
                             t)
        return t

    def sample(self, x1: torch.Tensor, generator=None,
               max_t0: Optional[float] = None, draw=None, x0=None):
        """(t, x0, xt, ut) for training: t from :meth:`sample_t`, x0 a
        standard normal draw of x1's shape (or the given one), then the
        plan."""
        t = self.sample_t(x1.shape[0], generator, max_t0, draw, x1.device)
        if x0 is None:
            x0 = torch.randn(x1.shape, generator=generator, dtype=x1.dtype,
                             device=x1.device)
        t, xt, ut = self.path_sampler.plan(t, x0, x1)
        return t, x0, xt, ut

    def training_losses(self, v_pred: torch.Tensor,
                        ut: torch.Tensor) -> torch.Tensor:
        """The squared error averaged over every dim but the batch's
        (transport.py:188-198)."""
        return (v_pred - ut).square().mean(dim=tuple(range(1, v_pred.dim())))


def create_transport(path_type="Linear", prediction="velocity",
                     snr_type="uniform", do_shift=True, seq_len=1024,
                     **kwargs) -> Transport:
    return Transport(path_type=path_type, prediction=prediction,
                     snr_type=snr_type, do_shift=do_shift, seq_len=seq_len)


# ---------------------------------------------------------------------------
# SDE samplers and the likelihood ODE (show-o2/transport/integrators.py)
# ---------------------------------------------------------------------------

def _draws(x: torch.Tensor, steps: int, generator, noise, rademacher=False):
    """``steps`` draws of x's shape: the given ``noise`` [steps, *x.shape]
    or, one after another, from ``generator``."""
    if noise is not None:
        return [torch.as_tensor(n, dtype=x.dtype, device=x.device)
                for n in noise]
    out = []
    for _ in range(steps):
        if rademacher:
            out.append(torch.randint(0, 2, x.shape, generator=generator,
                                     device=x.device).to(x.dtype) * 2 - 1)
        else:
            out.append(torch.randn(x.shape, generator=generator,
                                   dtype=x.dtype, device=x.device))
    return out


def sample_sde_euler_maruyama(drift_fn: Callable, diffusion_fn: Callable,
                              x: torch.Tensor, t_grid, generator=None,
                              noise: Optional[Sequence] = None
                              ) -> torch.Tensor:
    """Euler-Maruyama (integrators.py:27-35) over ``t_grid[:-1]`` with the
    fixed dt = t[1] - t[0]: x <- x + drift dt + sqrt(2 diffusion) w
    sqrt(dt), w one normal draw a step (``noise``, or from
    ``generator``)."""
    grid = torch.as_tensor(t_grid, dtype=torch.float32)
    dt = float(grid[1] - grid[0])
    ws = _draws(x, len(grid) - 1, generator, noise)
    for t_cur, w in zip(grid[:-1].tolist(), ws):
        t = _t_vec(x, t_cur)
        mean_x = x + drift_fn(x, t) * dt
        x = mean_x + torch.sqrt(2 * diffusion_fn(x, t)) * w * math.sqrt(dt)
    return x


def sample_sde_heun(drift_fn: Callable, diffusion_fn: Callable,
                    x: torch.Tensor, t_grid, generator=None,
                    noise: Optional[Sequence] = None) -> torch.Tensor:
    """The SDE Heun step (integrators.py:37-49): the noise first, then the
    trapezoid of the drift at t and t + dt."""
    grid = torch.as_tensor(t_grid, dtype=torch.float32)
    dt = float(grid[1] - grid[0])
    ws = _draws(x, len(grid) - 1, generator, noise)
    for t_cur, w in zip(grid[:-1].tolist(), ws):
        t = _t_vec(x, t_cur)
        xhat = x + torch.sqrt(2 * diffusion_fn(x, t)) * w * math.sqrt(dt)
        k1 = drift_fn(xhat, t)
        k2 = drift_fn(xhat + dt * k1, t + dt)
        x = xhat + 0.5 * dt * (k1 + k2)
    return x


def prior_logp(z: torch.Tensor) -> torch.Tensor:
    """The standard normal log-density of each batch element
    (transport.py:60-67)."""
    n = math.prod(z.shape[1:])
    return (-n / 2.0 * math.log(2 * math.pi)
            - 0.5 * z.square().reshape(z.shape[0], -1).sum(dim=-1))


def sample_ode_likelihood(drift_fn: Callable, x: torch.Tensor,
                          generator=None, num_steps: int = 50,
                          probes: Optional[Sequence] = None):
    """The likelihood ODE (transport.py:447-503): data -> noise over
    ``num_steps`` Euler steps of the reversed drift (the model at 1 - t),
    accumulating Hutchinson's estimate of the divergence with one
    Rademacher probe a step (``probes``, or from ``generator``) through a
    Jacobian-vector product.  Returns (logp [B], z) with logp =
    prior_logp(z) - the integrated divergence."""
    grid = torch.linspace(0.0, 1.0, num_steps + 1).tolist()
    eps_all = _draws(x, num_steps, generator, probes, rademacher=True)
    delta = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
    for t_cur, t_next, eps in zip(grid[:-1], grid[1:], eps_all):
        dt = t_next - t_cur
        t_model = _t_vec(x, 1.0 - t_cur)
        v, jv = torch.func.jvp(lambda xx: drift_fn(xx, t_model), (x,),
                               (eps,))
        div = (jv * eps).reshape(x.shape[0], -1).sum(dim=-1)
        x, delta = x - dt * v, delta + dt * div
    return prior_logp(x) - delta, x
