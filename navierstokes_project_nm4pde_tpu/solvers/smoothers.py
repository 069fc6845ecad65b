"""Dot-product-free inner smoothers: damped Jacobi-Richardson and Chebyshev.

Every scalar reduction is a device op with a fixed launch cost, so inner
Krylov solves (whose MGS/CG recurrences are dot-heavy) can spend as much
time in reductions as in operator applications.  These smoothers run a fixed number
of applications with *no* reductions -- they fill the role of the
reference's inner ILU-preconditioned solves to rel. 1e-2
(ref: include/Preconditioners.hpp:260-273) at a fraction of the scalar
traffic, and they vmap cleanly for ensembles.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def richardson_fixed(
    A: Callable,
    b: jax.Array,
    Minv: Callable,
    iters: int,
    omega: float = 0.9,
):
    """x_{k+1} = x_k + omega * Minv (b - A x_k), x_0 = omega*Minv(b).

    Converges for the Jacobi-preconditioned time-step block F = M/dt + ...
    whose spectrum is clustered near 1 (mass-dominated at practical dt)."""
    x = omega * Minv(b)

    def body(x, _):
        x = x + omega * Minv(b - A(x))
        return x, None

    x, _ = jax.lax.scan(body, x, None, length=max(0, iters - 1))
    return x


def chebyshev_fixed(
    A: Callable,
    b: jax.Array,
    Minv: Callable,
    iters: int,
    lam_min,
    lam_max,
):
    """Chebyshev semi-iteration for SPD Minv*A with spectrum in
    [lam_min, lam_max]; no inner products (classic three-term recurrence)."""
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma1 = theta / delta

    r = b  # x0 = 0
    z = Minv(r)
    x = z / theta
    rho_old = 1.0 / sigma1

    def body(carry, _):
        x, x_old, rho_old = carry
        r = b - A(x)
        z = Minv(r)
        rho = 1.0 / (2.0 * sigma1 - rho_old)
        # x_{k+1} = x_k + rho*(2/delta) z + rho*rho_old*(x_k - x_{k-1})
        x_new = x + rho * (2.0 / delta) * z + rho * rho_old * (x - x_old)
        return (x_new, x, rho), None

    (x, _, _), _ = jax.lax.scan(
        body, (x, jnp.zeros_like(x), rho_old), None, length=max(0, iters - 1)
    )
    return x


def power_lambda_max(A: Callable, Minv: Callable, v0: jax.Array, iters: int = 8):
    """Estimate lam_max of Minv*A by power iteration (used once per step to
    set Chebyshev bounds)."""

    def body(carry, _):
        v, lam = carry
        w = Minv(A(v))
        lam = jnp.sqrt(jnp.sum(w * w))
        v = w / jnp.maximum(lam, 1e-30)
        return (v, lam), None

    (v, lam), _ = jax.lax.scan(body, (v0 / jnp.sqrt(jnp.sum(v0 * v0)), jnp.asarray(1.0, v0.dtype)), None, length=iters)
    return lam
