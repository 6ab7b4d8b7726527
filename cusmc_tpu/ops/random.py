"""Fast fixed-round random samplers for the hot loop.

``jax.random.gamma`` lowers to a data-dependent rejection loop (a
``while_loop`` over the whole array until every lane accepts).
``fast_gamma`` is a Marsaglia-Tsang (2000) squeeze sampler with a FIXED
number of proposal rounds, fully vectorized (no while_loop): each round
accepts with p >~ 0.95 for alpha >= 1, so after 4 rounds fewer than ~1e-5
of lanes are unresolved; those fall back to the distribution mean (bias
< 1e-5 relative, far below Monte-Carlo error at any particle count). The
reference's own device-side gamma is an UNBOUNDED Marsaglia-Tsang loop per
thread (``/root/reference/src/mvt_dist.cu.cpp:20-55``) with the same math.

alpha < 1 uses the standard boost Gamma(a) = Gamma(a+1) * U^(1/a).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_DEFAULT_ROUNDS = 4


def fast_gamma(key: jax.Array, alpha, shape, dtype=jnp.float32,
               rounds: int = _DEFAULT_ROUNDS) -> jnp.ndarray:
    """Gamma(alpha, 1) draws of ``shape``; alpha is a scalar (static or
    traced). Statistically exact except for a <1e-5 mean-fallback tail."""
    alpha = jnp.asarray(alpha, dtype)
    boosted = alpha < 1.0
    a = jnp.where(boosted, alpha + 1.0, alpha)

    d = a - 1.0 / 3.0
    c = 1.0 / jnp.sqrt(9.0 * d)

    kx, ku, kb = jax.random.split(key, 3)
    xs = jax.random.normal(kx, (rounds,) + shape, dtype)
    us = jax.random.uniform(ku, (rounds,) + shape, dtype,
                            minval=jnp.finfo(dtype).tiny)

    accepted = jnp.zeros(shape, bool)
    out = jnp.full(shape, a, dtype)  # mean fallback for unresolved lanes
    for r in range(rounds):
        x = xs[r]
        v = (1.0 + c * x) ** 3
        ok = (v > 0.0) & (jnp.log(us[r]) < 0.5 * x * x + d - d * v
                          + d * jnp.log(jnp.where(v > 0.0, v, 1.0)))
        take = ok & ~accepted
        out = jnp.where(take, d * v, out)
        accepted = accepted | ok

    # The alpha<1 boost needs a pow over the whole array; alpha is a scalar,
    # so skip it entirely via cond when alpha >= 1 (the common case).
    def apply_boost(o):
        u_boost = jax.random.uniform(kb, shape, dtype,
                                     minval=jnp.finfo(dtype).tiny)
        return o * u_boost ** (1.0 / alpha)

    return jax.lax.cond(boosted, apply_boost, lambda o: o, out)


def fast_chi2(key: jax.Array, df, shape, dtype=jnp.float32) -> jnp.ndarray:
    """Chi-square(df) = 2 * Gamma(df/2)."""
    return 2.0 * fast_gamma(key, 0.5 * jnp.asarray(df, dtype), shape, dtype)


# Integer-df chi-square beats Marsaglia-Tsang up to roughly here: the
# sum-of-exponentials construction needs df/2 uniforms but only ONE log
# (of their product) regardless of df; past ~30 the f32 product risks
# underflow and the uniform traffic exceeds MT's fixed 8 arrays.
MAX_INTEGER_DF = 30


def chi2_integer_df(key: jax.Array, df: int, shape,
                    dtype=jnp.float32) -> jnp.ndarray:
    """EXACT chi-square(df) draws for small integer df — the hot path for
    MVT filtering (df is almost always a small integer like 3/5/7).

    Construction: chi2_{2m+r} = 2 * sum_{i<m} Exp(1) + r * z^2 with
    r = df mod 2. The m exponentials come from -log(prod_{i<m} U_i): ONE
    log over the whole array instead of Marsaglia-Tsang's 8 transcendental
    passes (4 rounds x (log u, log v)).

    Exact (no fixed-round fallback tail), unlike ``fast_gamma``.
    """
    if not (isinstance(df, int) and 1 <= df <= MAX_INTEGER_DF):
        raise ValueError(f"df must be an int in [1, {MAX_INTEGER_DF}], "
                         f"got {df!r}")
    m, r = divmod(df, 2)
    ku, kz = jax.random.split(key)
    out = jnp.zeros(shape, dtype)
    if m > 0:
        us = jax.random.uniform(ku, (m,) + tuple(shape), dtype,
                                minval=jnp.finfo(dtype).tiny)
        prod = us[0]
        for i in range(1, m):
            prod = prod * us[i]
        # Guard the (astronomically unlikely) f32 underflow of the product.
        prod = jnp.maximum(prod, jnp.finfo(dtype).tiny)
        out = -2.0 * jnp.log(prod)
    if r:
        z = jax.random.normal(kz, shape, dtype)
        out = out + z * z
    return out
