"""Multi-factor spot-price path simulation (JAX).

JAX replacement for the reference's native (NuGet, MKL-backed)
``Cmdty.Core.Simulation.MultiFactor.MultiFactorSpotPriceSimulator`` (call
sites: ``LsmcValuationParameters.cs:163-178``, ``multi_factor.py:49-92``).

Model (see SURVEY.md §2.2): risk-neutral forward dynamics

    dF(t,T)/F(t,T) = sum_i sigma_i(T) e^{-alpha_i (T-t)} dW_i,   corr(dW_i,dW_j)=rho_ij

so the spot S(t) = F(t,t) is log-normal around the initial forward curve:

    ln S(t_k) = ln F(0,t_k) - V_k/2 + sum_i sigma_i(t_k) * Y_i(t_k)

with dimensionless OU factor states Y_i (dY_i = -alpha_i Y_i dt + dW_i) and
V_k = Var[sum_i sigma_i(t_k) Y_i(t_k)] given by the closed-form integrated
covariance (confirmed against the reference's pure-Python mirror
``MultiFactorModel.integrated_covar``, ``multi_factor.py:145-187``).

Discretisation is **exact** (no Euler error): between sim times the factor
update is ``Y_k = e^{-alpha dt} Y_{k-1} + L_k Z_k`` where ``L_k`` is the
Cholesky factor of the exact increment covariance

    Cov(eps_i, eps_j) = rho_ij (1 - e^{-(alpha_i+alpha_j) dt}) / (alpha_i + alpha_j).

All per-step coefficients are precomputed on host in float64; the device
kernel is a ``lax.scan`` of rank-F matmuls over [F, S] normal draws from
threefry (``jax.random``), with antithetic mirroring.  The Markov factor
states Y_i are returned per (step, sim) for use as LSMC regressors
(reference ``ISpotSimResults.MarkovFactorsForPeriod``).

Seed parity with the reference's Mersenne Twister is impossible by design;
golden values are re-pinned for threefry (BASELINE.md note on seeds).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _cont_ext(x: np.ndarray, dt) -> np.ndarray:
    """(1 - e^{-x dt}) / x with the x -> 0 limit dt (reference
    ``MultiFactorModel._cont_ext``, ``multi_factor.py:225-229``)."""
    x = np.asarray(x, dtype=np.float64)
    safe = np.where(x == 0.0, 1.0, x)
    return np.where(x == 0.0, dt, (1.0 - np.exp(-safe * dt)) / safe)


@dataclass(frozen=True)
class SimCoefficients:
    """Host-precomputed per-step simulation coefficients (all float64).

    Shapes: n sim steps, F factors.
    """

    decay: np.ndarray  # [n, F] e^{-alpha_i dt_k}
    chol: np.ndarray  # [n, F, F] Cholesky of exact increment covariance
    vols: np.ndarray  # [n, F] sigma_i(t_k) of the spot for each sim period
    log_fwd_drift: np.ndarray  # [n] ln F(0,t_k) - V_k / 2


def sim_coefficients(
    mean_reversions: np.ndarray,  # [F]
    vols: np.ndarray,  # [n, F] factor vol for each simulated period
    factor_corrs: np.ndarray,  # [F, F]
    times: np.ndarray,  # [n] year fractions from the valuation date
    forwards: np.ndarray,  # [n] F(0, t_k)
) -> SimCoefficients:
    """Precompute exact-discretisation coefficients."""
    alphas = np.asarray(mean_reversions, dtype=np.float64)
    vols = np.asarray(vols, dtype=np.float64)
    corrs = np.asarray(factor_corrs, dtype=np.float64)
    times = np.asarray(times, dtype=np.float64)
    forwards = np.asarray(forwards, dtype=np.float64)
    n, num_factors = vols.shape
    alpha_sum = alphas[:, None] + alphas[None, :]  # [F, F]

    prev_times = np.concatenate([[0.0], times[:-1]])
    dts = times - prev_times
    if np.any(dts < 0.0):
        raise ValueError("Simulation times must be non-decreasing.")

    decay = np.exp(-alphas[None, :] * dts[:, None])  # [n, F]

    cov_all = corrs[None, :, :] * _cont_ext(
        alpha_sum[None, :, :], dts[:, None, None]
    )  # [n, F, F]
    try:
        # One batched LAPACK call (identical per-matrix results to the loop).
        chol = np.linalg.cholesky(cov_all)
    except np.linalg.LinAlgError:
        # Some step is semidefinite (dt == 0 or perfectly correlated
        # factors): redo per step so only the bad ones pay the eigh repair
        # jitter (which must not perturb healthy covariances).
        chol = np.empty((n, num_factors, num_factors), dtype=np.float64)
        for k in range(n):
            cov = cov_all[k]
            try:
                chol[k] = np.linalg.cholesky(cov)
            except np.linalg.LinAlgError:
                eye = np.eye(num_factors) * 1e-14
                w, v = np.linalg.eigh(cov + eye)
                w = np.clip(w, 0.0, None)
                chol[k] = np.linalg.cholesky(v @ np.diag(w) @ v.T + eye)

    # V_k = Var[sum_i sigma_i(t_k) Y_i(t_k)]
    variance = np.einsum(
        "kf,kg,fg,kfg->k",
        vols,
        vols,
        corrs,
        _cont_ext(alpha_sum[None, :, :], times[:, None, None]),
    )
    log_fwd_drift = np.log(forwards) - 0.5 * variance
    return SimCoefficients(decay=decay, chol=chol, vols=vols, log_fwd_drift=log_fwd_drift)


# Normal draws happen in fixed blocks of this many steps, each keyed by
# fold_in(key, block_start_step): the stream for steps [b, b+16) depends only
# on the key and b, never on how much of the horizon is simulated around it.
# This makes chunked re-simulation from a checkpointed OU state (the
# StreamingFactorSource below, used when full paths would blow HBM at e.g.
# hourly granularity x production path counts) bit-identical to the
# monolithic kernel — and the monolithic kernel itself never materialises
# the [n, F, S] normals array (it equalled the output in size).
_DRAW_BLOCK = 16


def _block_normals(key, b0, num_factors: int, num_sims: int, antithetic: bool, dtype):
    """Normals for the draw block starting at step ``b0`` — ALWAYS the full
    ``[_DRAW_BLOCK, F, S]`` shape (callers slice partial tail blocks), since
    threefry values depend on the requested shape."""
    k = jax.random.fold_in(key, b0)
    if antithetic:
        half = (num_sims + 1) // 2
        z = jax.random.normal(k, (_DRAW_BLOCK, num_factors, half), dtype=dtype)
        return jnp.concatenate([z, -z], axis=-1)[:, :, :num_sims]
    return jax.random.normal(k, (_DRAW_BLOCK, num_factors, num_sims), dtype=dtype)


def _advance(y, decay_k, chol_k, z_k, dtype):
    # Exact OU update: decay + correlated increment.  F is tiny, so the
    # matmul is a cheap [F,F]x[F,S] contraction fused by XLA.
    return decay_k[:, None] * y + jnp.dot(
        chol_k, z_k, preferred_element_type=dtype,
        precision=jax.lax.Precision.HIGHEST,
    )


def _scan_factor_blocks(key, y0, decay, chol, start, num_steps: int,
                        num_sims: int, antithetic: bool):
    """Advance ``num_steps`` OU steps from state ``y0`` at absolute step
    ``start`` (traced scalar, must be a multiple of ``_DRAW_BLOCK``),
    returning ``(y_final, factors [num_steps, F, S])``.

    Scans in UNROLLED BLOCKS of ``_DRAW_BLOCK`` steps: a plain per-step scan
    stacks its outputs with one [1, F, S] dynamic-update-slice per step,
    which runs far below memory bandwidth — at 1M sims the stacking
    dominated the whole simulation.  Each iteration instead writes
    one contiguous [16, F, S] block.  ``decay``/``chol`` are the FULL-horizon
    coefficient arrays (tiny), indexed absolutely.
    """
    n_all, num_factors = decay.shape
    dtype = decay.dtype
    num_blocks = num_steps // _DRAW_BLOCK
    start = jnp.asarray(start, jnp.int32)

    def block_step(y, b0):
        zero = jnp.zeros_like(b0)  # same int width as b0 (x64-safe)
        z_b = _block_normals(key, b0, num_factors, num_sims, antithetic, dtype)
        decay_b = jax.lax.dynamic_slice(decay, (b0, zero), (_DRAW_BLOCK, num_factors))
        chol_b = jax.lax.dynamic_slice(
            chol, (b0, zero, zero), (_DRAW_BLOCK, num_factors, num_factors)
        )
        ys = []
        for c in range(_DRAW_BLOCK):
            y = _advance(y, decay_b[c], chol_b[c], z_b[c], dtype)
            ys.append(y)
        return y, jnp.stack(ys)

    if num_blocks:
        starts = start + jnp.arange(num_blocks, dtype=jnp.int32) * _DRAW_BLOCK
        y_last, factors_main = jax.lax.scan(block_step, y0, starts)
        factors_main = factors_main.reshape(
            (num_blocks * _DRAW_BLOCK,) + factors_main.shape[2:]
        )
    else:
        y_last, factors_main = y0, jnp.zeros((0, num_factors, num_sims), dtype)

    tail_len = num_steps - num_blocks * _DRAW_BLOCK
    if tail_len:
        t0 = start + num_blocks * _DRAW_BLOCK
        # Normals keep the fixed block shape (threefry values depend on the
        # requested shape); the coefficient slices are exact-length so the
        # start index is never clamped at the horizon end.
        z_t = _block_normals(key, t0, num_factors, num_sims, antithetic, dtype)
        zero = jnp.zeros_like(t0)
        decay_t = jax.lax.dynamic_slice(decay, (t0, zero), (tail_len, num_factors))
        chol_t = jax.lax.dynamic_slice(
            chol, (t0, zero, zero), (tail_len, num_factors, num_factors)
        )
        tail = []
        y = y_last
        for c in range(tail_len):
            y = _advance(y, decay_t[c], chol_t[c], z_t[c], dtype)
            tail.append(y)
        y_last = y
        factors_main = jnp.concatenate([factors_main, jnp.stack(tail)], axis=0)
    return y_last, factors_main


@partial(jax.jit, static_argnames=("num_sims", "antithetic"))
def _simulate_factor_kernel(
    key,
    decay,  # [n, F]
    chol,  # [n, F, F]
    num_sims: int,
    antithetic: bool,
):
    """Device kernel: scan OU factor states over time.

    Returns ``factors [n, F, S]``.  Spot prices are a per-period deterministic
    transform of the factors (``exp(drift_k + vols_k . Y_k)``) and are
    recomputed where needed instead of stored — at production path counts the
    spot panel alone is GBs of device memory.
    """
    n, num_factors = decay.shape
    y0 = jnp.zeros((num_factors, num_sims), dtype=decay.dtype)
    _, factors = _scan_factor_blocks(
        key, y0, decay, chol, 0, n, num_sims, antithetic
    )
    return factors


@jax.jit
def spots_from_factor_paths(factors, vols, log_fwd_drift):
    """Spot-price panel ``[n, S]`` from factor paths (deterministic transform)."""
    log_spots = (
        jnp.einsum("nf,nfs->ns", vols, factors, precision=jax.lax.Precision.HIGHEST)
        + log_fwd_drift[:, None]
    )
    return jnp.exp(log_spots)


def simulate_factor_paths(
    coeffs: SimCoefficients,
    num_sims: int,
    seed: Optional[int],
    antithetic: bool = False,
    dtype=jnp.float32,
    key: Optional[jax.Array] = None,
) -> jax.Array:
    """Simulate Markov factor state paths ``[n, F, S]``."""
    if key is None:
        if seed is None:
            seed = np.random.SeedSequence().entropy % (2**63)
        key = jax.random.PRNGKey(int(seed))
    return _simulate_factor_kernel(
        key,
        jnp.asarray(coeffs.decay, dtype),
        jnp.asarray(coeffs.chol, dtype),
        num_sims=int(num_sims),
        antithetic=bool(antithetic),
    )


@partial(jax.jit, static_argnames=("num_sims", "antithetic", "every", "num_ckpt"))
def _factor_checkpoints_kernel(
    key,
    decay,  # [n, F]
    chol,  # [n, F, F]
    num_sims: int,
    antithetic: bool,
    every: int,
    num_ckpt: int,
):
    """OU states ENTERING steps 0, every, 2*every, ... — ``[num_ckpt, F, S]``.

    One pass of the simulation arithmetic that stores only span-boundary
    states (``num_ckpt`` x [F, S]) instead of the full [n, F, S] path array.
    ``every`` must be a multiple of ``_DRAW_BLOCK`` so spans re-draw the same
    threefry blocks as the monolithic kernel.
    """
    num_factors = decay.shape[1]
    dtype = decay.dtype
    y0 = jnp.zeros((num_factors, num_sims), dtype=dtype)

    def span_step(y, s0):
        y_next, _ = _scan_factor_blocks(
            key, y, decay, chol, s0, every, num_sims, antithetic
        )
        return y_next, y  # emit the ENTERING state

    starts = jnp.arange(num_ckpt, dtype=jnp.int32) * every
    _, ckpts = jax.lax.scan(span_step, y0, starts)
    return ckpts


@partial(jax.jit, static_argnames=("num_sims", "antithetic", "span_len"))
def _factor_span_kernel(
    key,
    y0,  # [F, S] state entering step span_start
    decay,
    chol,
    span_start,  # traced scalar, multiple of _DRAW_BLOCK
    num_sims: int,
    antithetic: bool,
    span_len: int,
):
    """Re-simulate factors for steps [span_start, span_start + span_len)."""
    _, factors = _scan_factor_blocks(
        key, y0, decay, chol, span_start, span_len, num_sims, antithetic
    )
    return factors


class StreamingFactorSource:
    """Factor paths regenerated per time-span from checkpointed OU states.

    At hourly granularity x production path counts the full ``[n, F, S]``
    factor array no longer fits in HBM (1y hourly x 250k paths = 26 GB), so
    the engine's chunked driver consumes paths span-by-span: one cheap
    checkpoint pass stores the OU state entering each span, and each span is
    re-simulated on demand — classic checkpointed rematerialisation, trading
    one extra pass of (tiny-F) simulation arithmetic for O(n/every) memory.
    Because normal draws are keyed per fixed 16-step block
    (see ``_block_normals``), the regenerated paths are BIT-IDENTICAL to the
    monolithic kernel's for the same key.

    Peak factor memory: one ``[every, F, S]`` span + ``[n/every, F, S]``
    checkpoints.  ``every`` is rounded up to a multiple of ``_DRAW_BLOCK``.
    """

    def __init__(self, coeffs: SimCoefficients, num_sims: int, key,
                 antithetic: bool = False, dtype=jnp.float32,
                 every: int = 512, mesh=None):
        self.num_steps = int(coeffs.decay.shape[0])
        self.num_sims = int(num_sims)
        self.antithetic = bool(antithetic)
        self.every = max(_DRAW_BLOCK, -(-int(every) // _DRAW_BLOCK) * _DRAW_BLOCK)
        self._key = key
        self._decay = jnp.asarray(coeffs.decay, dtype)
        self._chol = jnp.asarray(coeffs.chol, dtype)
        self._mesh = mesh
        self._ckpts = None  # computed on first use
        self._span_cache = None  # (span_index, [span_len, F, S]) one-slot

    def prepare(self):
        """Eagerly run the checkpoint pass (otherwise lazy on first read).

        Lets callers attribute the upfront simulation cost to their own
        timing phase (the per-span regeneration that follows is interleaved
        with consumption and folds into the consumer's phases).  Returns
        ``self`` for chaining.
        """
        import jax

        jax.block_until_ready(self._checkpoints())
        return self

    def spans(self):
        """The aligned spans [(a, b), ...] covering [0, num_steps)."""
        return [
            (a, min(a + self.every, self.num_steps))
            for a in range(0, self.num_steps, self.every)
        ]

    def _checkpoints(self):
        if self._ckpts is None:
            num_ckpt = -(-self.num_steps // self.every)
            self._ckpts = _factor_checkpoints_kernel(
                self._key, self._decay, self._chol,
                num_sims=self.num_sims, antithetic=self.antithetic,
                every=self.every, num_ckpt=num_ckpt,
            )
        return self._ckpts

    def factors(self, a: int, b: int):
        """``[b - a, F, S]`` factor states for steps [a, b).

        ``[a, b)`` must lie within one aligned span (the engine iterates the
        refinement of :meth:`spans`), so each call re-simulates at most one
        span and compiles at most two programs (full span + horizon tail).
        """
        i = a // self.every
        s0, s1 = i * self.every, min((i + 1) * self.every, self.num_steps)
        if not (s0 <= a < b <= s1):
            raise ValueError(
                f"factors({a}, {b}) crosses a span boundary (every={self.every})."
            )
        # One-slot span cache: under the XLA backward fallback the engine
        # refines each source span into many sub-spans and reads them
        # consecutively (and last() reads one step of the final span), so
        # memoizing the last regenerated span removes all redundant
        # re-simulation at the cost of one resident span.
        if self._span_cache is not None and self._span_cache[0] == i:
            out = self._span_cache[1]
        else:
            # Drop the stale span BEFORE materialising the next one: holding
            # both would transiently double the streamed-path footprint that
            # STORAGE_TPU_MAX_PATH_BYTES sized to ONE [span, F, S] block.
            self._span_cache = None
            y0 = self._checkpoints()[i]
            out = _factor_span_kernel(
                self._key, y0, self._decay, self._chol, s0,
                num_sims=self.num_sims, antithetic=self.antithetic,
                span_len=s1 - s0,
            )
            self._span_cache = (i, out)
        if a != s0 or b != s1:
            out = jax.lax.dynamic_slice_in_dim(out, a - s0, b - a, axis=0)
        if self._mesh is not None:
            from ..parallel.mesh import shard_sims

            out = shard_sims(self._mesh, out, 2)
        return out

    def last(self):
        """``[F, S]`` — the factor state of the final simulated period."""
        return self.factors(self.num_steps - 1, self.num_steps)[0]


def simulate_spot_paths(
    coeffs: SimCoefficients,
    num_sims: int,
    seed: Optional[int],
    antithetic: bool = False,
    dtype=jnp.float32,
    key: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Simulate spot paths and Markov factor states.

    Equivalent of ``MultiFactorSpotPriceSimulator.Simulate(numSims)``; the
    threefry ``seed`` replaces the reference's ``MersenneTwisterGenerator``
    seed (``multi_factor.py:76-80``).

    Returns:
      spots ``[n, S]``, factors ``[n, F, S]`` on device.
    """
    factors = simulate_factor_paths(coeffs, num_sims, seed, antithetic, dtype, key)
    spots = spots_from_factor_paths(
        factors, jnp.asarray(coeffs.vols, dtype), jnp.asarray(coeffs.log_fwd_drift, dtype)
    )
    return spots, factors
