"""Counter-based random sampling primitives for the Gibbs sweep.

The reference uses a two-level scheme — a global Xoroshiro128+ seeder that
hands per-proposal PCG streams (reference: src/math/Random.cpp:32-56,
264-305) — because OpenMP threads must draw reproducibly regardless of
thread count. Here the same guarantee comes for free from JAX's
counter-based threefry PRNG: keys are derived by ``fold_in`` from
(seed, phase, iteration, sweep), so results are bit-identical for any
device count or sweep schedule.

Distribution semantics follow the reference:

* ``trunc_normal`` — inverse-CDF truncated normal that *fails* when more
  than 95% of the mass is outside the truncation window
  (reference: src/math/Random.cpp:178-191). The reference inverts the CDF
  through 3001/5001-entry erf lookup tables clamped to |z| <= 3*sqrt(2)
  (src/math/Random.cpp:269-295, 307-345); we use the exact ndtr/ndtri pair,
  which matches the same distribution with strictly better tail accuracy.
* exponential / Poisson draws use jax.random equivalents of
  src/math/Random.cpp:125-175.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import ndtr, ndtri

# the reference's global epsilon (reference: src/math/Math.h — gaps::epsilon)
# (a python float, not a jnp constant: importing the package must not
# initialize the XLA backend, or jax.distributed.initialize breaks)
EPSILON = 1.0e-10


def trunc_normal(u, a, b, mean, sd):
    """Truncated-normal draw via inverse CDF, with the reference's
    far-tail failure rule (reference: src/math/Random.cpp:178-191).

    Args:
      u: uniform(0,1) draws, shape S.
      a, b: truncation bounds (broadcastable to S).
      mean, sd: untruncated parameters (broadcastable to S).
    Returns:
      (value, ok): value clipped to [a, b]; ok=False where the draw fails
      (>95% of mass below `a` or above `b`), in which case value is
      unspecified-but-finite.
    """
    sd = jnp.maximum(sd, jnp.float32(1e-30))
    p_lower = ndtr((a - mean) / sd)
    p_upper = ndtr((b - mean) / sd)
    ok = jnp.logical_not((p_lower > 0.95) | (p_upper < 0.05))
    # clamp the inversion input away from {0,1} so ndtri stays finite
    q = p_lower + u * (p_upper - p_lower)
    q = jnp.clip(q, jnp.float32(1e-7), jnp.float32(1.0 - 1e-7))
    z = mean + sd * ndtri(q)
    z = jnp.clip(z, a, b)
    return z.astype(jnp.float32), ok


def gibbs_mass(u, s, s_mu, a, b, lam=None):
    """The conditional "gibbs mass" draw (reference:
    src/gibbs_sampler/AlphaParameters.cpp:27-48): a truncated normal with
    mean (s_mu - lambda)/s (or s_mu/s when lambda is omitted — the exchange
    form) and sd 1/sqrt(s); fails when s <= epsilon."""
    s_safe = jnp.maximum(s, EPSILON)
    mu = ((s_mu - lam) if lam is not None else s_mu) / s_safe
    sd = jax.lax.rsqrt(s_safe)
    val, ok = trunc_normal(u, a, b, mu, sd)
    ok = ok & (s > EPSILON)
    return val, ok


def exponential(u, lam):
    """Exp(lam) via inverse CDF (reference: src/math/Random.cpp:172-175)."""
    u = jnp.maximum(u, jnp.float32(1e-30))
    return -jnp.log(u) / lam


def poisson(key, lam):
    """Poisson draw (reference: src/math/Random.cpp:125-170)."""
    return jax.random.poisson(key, lam, dtype=jnp.int32)


def poisson_fast(key, lam):
    """Budget-draw approximation: round(N(lam, sqrt(lam))), clipped at
    0. Used ONLY for the per-iteration update budget (GapsRunner.cpp:
    293-296) on the engine fast paths: the budget sets how much work an
    iteration does, not the chain's stationary distribution (any
    positive budget sequence leaves the sampler exact), and
    jax.random.poisson is a data-dependent rejection loop, where this
    is a fixed handful of elementwise ops. The sharded
    engine keeps the exact draw (its determinism contract pins
    trajectories)."""
    z = jax.random.normal(key, jnp.shape(lam))
    return jnp.maximum(
        jnp.round(lam + jnp.sqrt(jnp.maximum(lam, 0.0)) * z), 0.0
    ).astype(jnp.int32)


def log_uniform(u):
    """log(U) used for Metropolis accepts (reference: e.g.
    SingleThreadedGibbsSampler.h:175,217). Guarded against log(0)."""
    return jnp.log(jnp.maximum(u, jnp.float32(1e-37)))


def trunc_gamma2_y(u, b):
    """Inverse CDF of a shape-2 gamma truncated to [0, b], in the
    scale-free variable y = x/scale: solves 1 - e^-y (1+y) = u * upper
    with upper = 1 - e^-b (1+b), by Newton iteration (the reference
    inverts a 5001-entry qgamma lookup table instead,
    src/math/Random.cpp:194-200; same distribution, better resolution).
    Used by the same-bin exchange mass redistribution
    (ProposalQueue.cpp:267-277). Pure elementwise f32."""
    b = jnp.maximum(b, jnp.float32(1e-6))
    upper = 1.0 - jnp.exp(-b) * (1.0 + b)
    q = jnp.clip(u * upper, 1e-12, None)
    # h(y) = 1 - e^-y (1+y) ~ y^2/2 near 0 -> y0 = sqrt(2q)
    y = jnp.clip(jnp.sqrt(2.0 * q), 1e-6, b)
    for _ in range(12):
        ey = jnp.exp(-y)
        h = 1.0 - ey * (1.0 + y)
        dh = jnp.maximum(ey * y, jnp.float32(1e-30))
        y = jnp.clip(y - (h - q) / dh, 1e-7, b)
    return y
