"""Flow-matching sampling: the ODE time grid and the Euler integrator.

Counterpart of ``showo_tpu/show_o2/transport.py`` (show-o2/transport/), its
sampling part on the shipped configs' path (``sampling_method: euler``):
  * :func:`ode_timegrid`: ``num_steps`` points from t0 to t1 (t = 1 is
    clean data), warped by ``time_shifting_factor`` f as
    ``t / (t + f - f t)`` (integrators.py:100-101) and, with ``do_shift``,
    by the resolution-aware :func:`time_shift` (transport.py:133-146);
  * :func:`sample_ode_euler`: fixed-step Euler over the grid, one
    velocity evaluation per interval.

Heun, DPM-Solver++ and dopri5 raise (:func:`check_sampler`): they belong
to a later slice of the port.  The training-side coupling plans and the SDE
samplers are not ported either.
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


def check_sampler(method: str) -> str:
    """``method`` if it is ported (euler); the JAX package's other solvers
    raise NotImplementedError, unknown names ValueError."""
    if method == "euler":
        return method
    if method in SAMPLERS:
        raise NotImplementedError(
            f"sampling_method={method}: only euler is ported; heun, "
            f"dpm-solver and dopri5 belong to a later slice of the port")
    raise ValueError(f"unknown sampling_method {method!r}; the JAX package "
                     f"knows {SAMPLERS}")

