"""ChEES-HMC: adaptive-trajectory-length HMC for many-chain sampling.

The NUTS-class capability, accelerator-first. NUTS adapts trajectory length per
chain by building a doubling tree with data-dependent recursion — a
control-flow shape that serializes on accelerators and defeats batching
(each chain would walk a different tree). ChEES-HMC (Hoffman, Radul &
Sountsov, AISTATS 2021) reaches the same goal with the many-chain layout
this package already uses everywhere: run ONE jittered trajectory length
shared by all [C, d] chains, and adapt that length by stochastic gradient
ascent on the Change-in-Estimator-of-Expected-Square criterion

    ChEES = (1/4) E[ (||x' - E x'||^2 - ||x - E x||^2)^2 ]

whose gradient in the trajectory time tau is estimable from quantities
the trajectory already computed (final velocity = momentum):

    dChEES/dtau ~ mean_c w_c * Delta_c * (x'_c - mean x') . p'_c,
    Delta_c = ||x'_c - mean x'||^2 - ||x_c - mean x||^2,

with w_c the chain's Metropolis acceptance probability. Cross-chain
means are exactly the pooled statistics the other samplers psum over the
mesh — the criterion gets BETTER with more chains, which is the whole
point of the many-chain layout. Trajectory jitter uses the base-2 Halton sequence (the
paper's variance-reduction choice); the leapfrog loop is a
``lax.fori_loop`` with a data-dependent trip count (no wasted masked
gradient evaluations — on average half of the static-bound cost of
``hmc.py``'s masked scan), Adam adapts ``log h``, Robbins-Monro adapts
the step size toward the HMC-optimal 0.651 pooled acceptance.

The reference has no gradient machinery at all
(``/root/reference/src/samplers.cpp:7-36`` is its only sampler).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct
from jax import lax

from cusmc_tpu.mcmc.mala import _value_and_grad_batched


class ChEESState(struct.PyTreeNode):
    x: jnp.ndarray             # [C, d]
    logp: jnp.ndarray          # [C]
    grad: jnp.ndarray          # [C, d]
    log_step: jnp.ndarray      # scalar: log leapfrog step size eps
    log_traj: jnp.ndarray      # scalar: log MEAN trajectory time h
    adam_m: jnp.ndarray        # scalar Adam moments for log_traj
    adam_v: jnp.ndarray
    var_est: jnp.ndarray       # [d] diagonal mass^-1 (posterior var EMA)
    accept_count: jnp.ndarray  # [C]


class ChEESResult(struct.PyTreeNode):
    state: ChEESState
    samples: Optional[jnp.ndarray]
    accept_rate: jnp.ndarray
    step_size: jnp.ndarray     # final eps
    traj_length: jnp.ndarray   # final mean trajectory time h
    mean_leapfrog: jnp.ndarray # average leapfrog steps actually taken
    mass_var: jnp.ndarray      # [d] learned inverse-mass diagonal


def _pmean(x, axis_name):
    if axis_name is None:
        return x
    return lax.pmean(x, axis_name)


def _halton2(t: jnp.ndarray, bits: int = 24) -> jnp.ndarray:
    """Base-2 radical inverse of integer ``t`` — the Halton low-discrepancy
    sequence in (0, 1). Stratifies the trajectory jitter far better than
    iid uniforms (successive draws fill the unit interval evenly)."""
    i = jnp.arange(bits)
    b = (t >> i) & 1
    return jnp.sum(b * 0.5 ** (i + 1)) + 0.5 ** (bits + 1)


def chees_hmc_sampler(
    key: jax.Array,
    log_prob: Callable,
    init_x: jnp.ndarray,
    num_steps: int,
    step_size: float = 0.1,
    init_traj: Optional[float] = None,
    target_accept: float = 0.651,
    adapt_rate: float = 0.05,
    traj_lr: float = 0.05,
    num_adapt: Optional[int] = None,
    max_leapfrog: int = 1000,
    precondition: bool = True,
    var_ema: float = 0.1,
    init_var: Optional[jnp.ndarray] = None,
    keep_samples: bool = True,
    thin: int = 1,
    axis_name: Optional[str] = None,
) -> ChEESResult:
    """Run ``num_steps`` ChEES-HMC sweeps over [C, d] chains under one jit.

    Per sweep: trajectory time ``tau = 2 * u_t * h`` with ``u_t`` the t-th
    base-2 Halton point (mean tau = h), integrated with ``ceil(tau/eps)``
    leapfrog steps (dynamic ``fori_loop`` trip count, capped at
    ``max_leapfrog``). For the first ``num_adapt`` sweeps (default
    num_steps//2) ``eps`` Robbins-Monro-adapts toward ``target_accept``
    and ``h`` follows Adam on the ChEES gradient; both freeze after.

    ``init_traj`` defaults to ``10 * step_size`` (i.e. start near plain
    10-step HMC and let the criterion find the right length).

    ``precondition=True`` (default) learns a diagonal inverse mass
    matrix online: an EMA (rate ``var_ema``) of the cross-chain
    per-dimension variance — pooled over the mesh axis when sharded, so
    more chains mean a better estimate — scales the leapfrog step
    per dimension (``eps_d = eps * sqrt(var_d)``, the standard
    equivalence of diagonal-mass HMC with unit momenta). Frozen after
    ``num_adapt`` like every other adapted quantity, so the post-warmup
    kernel is exact HMC under a fixed metric.
    """
    if num_adapt is None:
        num_adapt = num_steps // 2
    if init_traj is None:
        init_traj = 10.0 * step_size
    c, d = init_x.shape
    dtype = init_x.dtype

    vg = _value_and_grad_batched(log_prob)
    logp0, grad0 = vg(init_x)
    state = ChEESState(
        x=init_x, logp=logp0, grad=grad0,
        log_step=jnp.asarray(jnp.log(step_size), dtype),
        log_traj=jnp.asarray(jnp.log(init_traj), dtype),
        adam_m=jnp.zeros((), dtype), adam_v=jnp.zeros((), dtype),
        var_est=(jnp.ones((d,), dtype) if init_var is None
                 else jnp.asarray(init_var, dtype)),
        accept_count=jnp.zeros((c,), dtype))

    b1, b2, aeps = 0.9, 0.95, 1e-8

    def body(state, t):
        k_t = jax.random.fold_in(key, t)
        kp, ku = jax.random.split(k_t)
        eps = jnp.exp(state.log_step)
        h = jnp.exp(state.log_traj)
        u = _halton2(t).astype(dtype)
        tau = 2.0 * u * h
        n_leap = jnp.clip(jnp.ceil(tau / eps).astype(jnp.int32),
                          1, max_leapfrog)
        tau_eff = n_leap.astype(dtype) * eps  # the time actually integrated

        p0 = jax.random.normal(kp, (c, d), dtype)
        # diagonal-mass leapfrog == per-dim step scaling with unit momenta
        eps_d = eps * jnp.sqrt(state.var_est) if precondition else eps

        # the loop's vg already computes the density at each new x; carry
        # it so the final iterate IS logp(x_prop) — one fewer full
        # density pass per sweep (material at short preconditioned
        # trajectories, where L ~ 1-2).
        def leap(_, carry):
            x, p, grad, _ = carry
            p_half = p + 0.5 * eps_d * grad
            x = x + eps_d * p_half
            logp, grad = vg(x)
            p = p_half + 0.5 * eps_d * grad
            return (x, p, grad, logp)

        x_pr, p_pr, grad_pr, logp_pr = lax.fori_loop(
            0, n_leap, leap, (state.x, p0, state.grad, state.logp))

        ke0 = 0.5 * jnp.sum(p0 * p0, axis=-1)
        ke1 = 0.5 * jnp.sum(p_pr * p_pr, axis=-1)
        log_alpha = (logp_pr - ke1) - (state.logp - ke0)
        log_alpha = jnp.where(jnp.isfinite(log_alpha), log_alpha, -jnp.inf)
        accept = jnp.log(jax.random.uniform(ku, (c,), dtype)) < log_alpha

        x_new = jnp.where(accept[:, None], x_pr, state.x)
        logp_new = jnp.where(accept, logp_pr, state.logp)
        grad_new = jnp.where(accept[:, None], grad_pr, state.grad)

        # --- ChEES gradient in log h -------------------------------
        w = jnp.exp(jnp.minimum(log_alpha, 0.0))          # accept prob
        m_cur = _pmean(jnp.mean(state.x, axis=0), axis_name)
        m_pr = _pmean(jnp.mean(x_pr, axis=0), axis_name)
        xc = state.x - m_cur
        xp = x_pr - m_pr
        delta = jnp.sum(xp * xp, axis=-1) - jnp.sum(xc * xc, axis=-1)
        # dx'/dtau: the preconditioned leapfrog moves x by eps_d*p per
        # step, so the actual end velocity is sqrt(var_est) (.) p' —
        # omitting the weighting computes the gradient in the wrong
        # metric on exactly the anisotropic targets preconditioning is
        # for (round-5 review finding).
        vel = p_pr * jnp.sqrt(state.var_est) if precondition else p_pr
        dot = jnp.sum(xp * vel, axis=-1)
        num = _pmean(jnp.mean(w * delta * dot), axis_name)
        den = _pmean(jnp.mean(w), axis_name) + 1e-12
        # d tau / d log h = tau; ascend the criterion.
        g = (num / den) * tau_eff
        # Normalize scale: Adam is invariant to it anyway, but guard inf.
        g = jnp.where(jnp.isfinite(g), g, 0.0)

        adapting = (t < num_adapt).astype(dtype)
        m_new = b1 * state.adam_m + (1 - b1) * g
        v_new = b2 * state.adam_v + (1 - b2) * g * g
        tt = t.astype(dtype) + 1.0
        m_hat = m_new / (1 - b1 ** tt)
        v_hat = v_new / (1 - b2 ** tt)
        step_h = traj_lr * m_hat / (jnp.sqrt(v_hat) + aeps)
        log_traj = state.log_traj + adapting * step_h
        # keep h integrable: at least one step, at most the cap
        log_traj = jnp.clip(
            log_traj, state.log_step,
            state.log_step + jnp.log(0.5 * max_leapfrog))

        pooled_acc = _pmean(jnp.mean(accept.astype(dtype)), axis_name)
        log_step = state.log_step + adapting * adapt_rate * (
            pooled_acc - target_accept)

        if precondition:
            m1 = _pmean(jnp.mean(x_new, axis=0), axis_name)
            m2 = _pmean(jnp.mean(x_new * x_new, axis=0), axis_name)
            bvar = jnp.maximum(m2 - m1 * m1, 1e-8)
            a_v = adapting * var_ema
            var_new = (1 - a_v) * state.var_est + a_v * bvar
        else:
            var_new = state.var_est

        new_state = ChEESState(
            x=x_new, logp=logp_new, grad=grad_new,
            log_step=log_step, log_traj=log_traj, var_est=var_new,
            adam_m=adapting * m_new + (1 - adapting) * state.adam_m,
            adam_v=adapting * v_new + (1 - adapting) * state.adam_v,
            accept_count=state.accept_count + accept.astype(dtype))
        out = (x_new,) if keep_samples else ((),)
        return new_state, (out, n_leap)

    final, (outs, n_leaps) = lax.scan(body, state, jnp.arange(num_steps))
    samples = None
    if keep_samples:
        (xs,) = outs
        samples = xs[::thin] if thin > 1 else xs
    pooled_rate = _pmean(jnp.mean(final.accept_count / num_steps),
                         axis_name)
    return ChEESResult(
        state=final, samples=samples, accept_rate=pooled_rate,
        step_size=jnp.exp(final.log_step),
        traj_length=jnp.exp(final.log_traj),
        mean_leapfrog=jnp.mean(n_leaps.astype(dtype)),
        mass_var=final.var_est)
