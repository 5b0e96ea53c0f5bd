"""The engine's scans against independent float64 NumPy references.

``backward_scan`` and ``forward_scan`` are the XLA route every valuation
takes.  Here each is compared with a plain NumPy re-statement of the same
period: least-squares regression (``np.linalg.lstsq``), ``np.interp`` per
decision, argmax on the fitted continuation and the realised value on the
actual one (reference ``LsmcStorageValuation.cs:166-340, 374-490``).  Only
the per-decision economics (decision set, immediate-value coefficients) are
shared with the engine: ``step_economics`` has its own oracle tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from storage_tpu.engines.common import step_economics
from storage_tpu.engines.lsmc import backward_scan, forward_scan
from storage_tpu.ops.ratchets import INTERP_LINEAR, INTERP_STEP
from storage_tpu.ops.regression import basis_spec
from storage_tpu.utils.basis import parse_basis_functions

S = 64  # paths
F = 2  # factors
M = 3  # decision steps
RIDGE = 1e-6  # the engine's relative Tikhonov term (ops/regression.py)
SPEC = basis_spec(parse_basis_functions("1 + s + x0 + x1 + x0**2 + s*x1"), F)


def _case(num_grid: int, seed: int = 0) -> dict:
    """Three decision steps of a ratcheted facility on random factor paths."""
    rng = np.random.default_rng(seed)
    space_hi = np.array([1000.0, 980.0, 950.0, 900.0])  # steps 0..M
    pillars = np.array(
        [[0.0, -80.0, 60.0], [500.0, -90.0, 50.0], [1000.0, -100.0, 40.0]]
    )
    return dict(
        factors=rng.normal(0.0, 0.5, (M, F, S)),
        vols=np.tile([0.4, 0.2], (M, 1)),
        drift=np.log([20.0, 21.0, 19.5]),
        grids=np.stack([np.linspace(0.0, space_hi[k], num_grid) for k in range(M)]),
        next_lo=np.zeros(M),
        next_hi=space_hi[1:],
        pillars=np.broadcast_to(pillars, (M, 3, 3)).copy(),
        loss=np.full(M, 0.001),
        inject_cost=np.full(M, 0.05),
        withdraw_cost=np.full(M, 0.07),
        cons_inject=np.full(M, 0.01),
        cons_withdraw=np.full(M, 0.005),
        inv_cost_rate=np.full(M, 0.001),
        df_settle=0.999 ** np.arange(1, M + 1),
        df_start=np.full(M, 0.998),
        v_end=rng.normal(0.0, 10.0, (S, num_grid))
        + 0.02 * np.linspace(0.0, space_hi[M], num_grid),
        rng=rng,
    )


_STEP_KEYS = (
    "grids", "next_lo", "next_hi", "pillars", "loss", "inject_cost",
    "withdraw_cost", "cons_inject", "cons_withdraw", "inv_cost_rate",
    "df_settle", "df_start",
)


def _economics(case, k, inventory, interp_kind, extra):
    """The engine's per-decision economics at ``inventory``, in float64."""
    with jax.enable_x64(True):
        econ = step_economics(
            jnp.asarray(inventory, jnp.float64),
            jnp.asarray(case["pillars"][k]), interp_kind, case["loss"][k],
            case["next_lo"][k], case["next_hi"][k], case["inject_cost"][k],
            case["withdraw_cost"][k], case["cons_inject"][k],
            case["cons_withdraw"][k], case["inv_cost_rate"][k],
            case["df_settle"][k], case["df_start"][k], extra,
        )
        return jax.tree.map(np.asarray, econ)


def _np_design(spot, factors):
    cols = []
    for sp, fps in zip(SPEC.spot_powers, SPEC.factor_powers):
        col = spot ** sp
        for f, fp in enumerate(fps):
            col = col * factors[f] ** fp
        cols.append(col)
    return np.stack(cols, axis=-1)


def _np_spot(case, k, factors):
    return np.exp(case["vols"][k] @ factors + case["drift"][k])


def _ref_backward_step(case, k, v_next, interp_kind, extra):
    """One backward period in float64 NumPy.

    Returns the fitted and realised totals ``[S, G, D]`` of every decision
    and the regression ``(coeffs, mean, scale, vbar)``.
    """
    f = case["factors"][k]
    spot = _np_spot(case, k, f)
    X = _np_design(spot, f)
    mean = X.mean(axis=0)
    scale = np.sqrt(((X - mean) ** 2).mean(axis=0))
    const = scale <= 1e-12 * (1.0 + np.abs(mean))
    mean[const], scale[const] = 0.0, 1.0
    Xs = (X - mean) / scale
    vbar = v_next.mean(axis=0)
    G, B = v_next.shape[1], Xs.shape[1]
    # Ridge least squares as an augmented lstsq: [Xs; sqrt(lam) I] c = [y; 0].
    A = np.vstack([Xs, np.sqrt(RIDGE * S) * np.eye(B)])
    Y = np.vstack([v_next - vbar, np.zeros((B, G))])
    coeffs = np.linalg.lstsq(A, Y, rcond=None)[0]
    fitted = Xs @ coeffs + vbar

    econ = _economics(case, k, case["grids"][k], interp_kind, extra)
    next_grid = np.linspace(case["next_lo"][k], case["next_hi"][k], G)
    D = econ.decisions.shape[-1]
    fit_tot = np.empty((S, G, D))
    act_tot = np.empty((S, G, D))
    for d in range(D):
        after = econ.inventory_after[:, d]
        immediate = econ.price_coeff[None, :, d] * spot[:, None] - econ.cost_npv[None, :, d]
        fit_tot[..., d] = immediate + np.stack(
            [np.interp(after, next_grid, fitted[s]) for s in range(S)]
        )
        act_tot[..., d] = immediate + np.stack(
            [np.interp(after, next_grid, v_next[s]) for s in range(S)]
        )
    return fit_tot, act_tot, (coeffs, mean, scale, vbar)


def _engine_backward(case, a, b, v, dtype, interp_kind, extra):
    cast = lambda x: jnp.asarray(x, dtype)  # noqa: E731
    return backward_scan(
        cast(v), cast(case["factors"][a:b]), cast(case["vols"][a:b]),
        cast(case["drift"][a:b]), *(cast(case[key][a:b]) for key in _STEP_KEYS),
        spec=SPEC, interp_kind=interp_kind,
        num_grid_points=case["grids"].shape[1], extra_decisions=extra,
    )


# float32: products at HIGHEST precision, so only rounding separates the
# engine from the float64 reference; near-tied decisions may pick either.
_TOL = {
    "float32": dict(rtol=2e-4, tie=2e-5, coeff=2e-3),
    "float64": dict(rtol=1e-9, tie=1e-11, coeff=1e-8),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("num_grid", [9, 24])
@pytest.mark.parametrize("extra", [0, 1, 3])
@pytest.mark.parametrize("interp_kind", [INTERP_LINEAR, INTERP_STEP])
def test_backward_scan_matches_numpy(interp_kind, extra, num_grid, dtype):
    """Each period of ``backward_scan`` realises the actual continuation of
    the decision with the best fitted continuation, from a least-squares fit
    of the next period's values."""
    tol = _TOL[dtype]
    case = _case(num_grid)
    with jax.enable_x64(dtype == "float64"):
        v = case["v_end"]
        stepped = []
        for k in reversed(range(M)):
            fit_tot, act_tot, (coeffs, mean, scale, vbar) = _ref_backward_step(
                case, k, np.asarray(v, np.float64), interp_kind, extra
            )
            v_eng, c_eng, mu_eng, sd_eng, vbar_eng = _engine_backward(
                case, k, k + 1, v, dtype, interp_kind, extra
            )
            v = np.asarray(v_eng, np.float64)
            stepped.append(v)

            np.testing.assert_allclose(np.asarray(vbar_eng)[0], vbar, rtol=tol["rtol"])
            np.testing.assert_allclose(np.asarray(mu_eng)[0], mean, rtol=tol["rtol"], atol=1e-12)
            np.testing.assert_allclose(np.asarray(sd_eng)[0], scale, rtol=tol["rtol"])
            c_eng = np.asarray(c_eng, np.float64)[0]
            assert np.max(np.abs(c_eng - coeffs)) <= tol["coeff"] * np.max(np.abs(coeffs))

            # The engine's value is the realised total of a decision whose
            # fitted total is the maximum (up to rounding near ties).
            scale_fit = np.max(np.abs(fit_tot))
            best = fit_tot.max(axis=-1, keepdims=True)
            candidates = fit_tot >= best - tol["tie"] * scale_fit
            matches = np.abs(act_tot - v[..., None]) <= tol["rtol"] * (
                np.abs(act_tot) + np.max(np.abs(act_tot)) * 1e-3
            )
            assert np.all(np.any(candidates & matches, axis=-1))
            # Ties between decisions that realise different values are rare
            # (coinciding decisions at the capacity limits tie exactly).
            spread = (np.where(candidates, act_tot, -np.inf).max(axis=-1)
                      - np.where(candidates, act_tot, np.inf).min(axis=-1))
            assert np.mean(spread > 1e-6 * np.max(np.abs(act_tot))) < 0.01

        if dtype == "float64":
            # The multi-period scan is the composition of its periods.
            v_scan = _engine_backward(case, 0, M, case["v_end"], dtype, interp_kind, extra)[0]
            np.testing.assert_allclose(np.asarray(v_scan), stepped[-1], rtol=1e-12, atol=1e-9)


def _ref_forward(case, table_coeffs, mus, sds, vbars, inv0, fwd, dfd, interp_kind, extra):
    """Forward policy simulation in float64 NumPy: per path, the decision
    with the best regression continuation at its own inventory."""
    G = table_coeffs.shape[-1]
    inv = np.full(S, inv0)
    pv = np.zeros(S)
    means, deltas, rows = [], [], []
    for k in range(M):
        f = case["factors"][k]
        spot = _np_spot(case, k, f)
        Xn = (_np_design(spot, f) - mus[k]) / sds[k]
        cont_curve = Xn @ table_coeffs[k] + vbars[k]  # [S, G]
        econ = _economics(case, k, inv, interp_kind, extra)
        next_grid = np.linspace(case["next_lo"][k], case["next_hi"][k], G)
        cont = np.stack(
            [np.interp(econ.inventory_after[s], next_grid, cont_curve[s]) for s in range(S)]
        )
        immediate = econ.price_coeff * spot[:, None] - econ.cost_npv
        best = np.argmax(immediate + cont, axis=1)
        pick = lambda a: a[np.arange(S), best]  # noqa: E731
        volume, consumed, imm = pick(econ.decisions), pick(econ.consumed), pick(immediate)
        loss_amt = case["loss"][k] * inv
        net = -volume - consumed
        deltas.append(np.mean(net * spot) / fwd[k] * dfd[k])
        fields = (inv, volume, consumed, loss_amt, net, imm)
        means.append([np.mean(x) for x in fields])
        rows.append(np.stack(fields))
        inv = inv + volume - loss_amt
        pv = pv + imm
    return inv, pv, np.array(means), np.array(deltas), np.array(rows)


@pytest.mark.parametrize("extra", [0, 1, 3])
@pytest.mark.parametrize("interp_kind", [INTERP_LINEAR, INTERP_STEP])
@pytest.mark.parametrize("collect_panels", [False, True])
def test_forward_scan_matches_numpy(collect_panels, interp_kind, extra):
    """``forward_scan`` (float64) follows the regression policy path by path:
    inventories, PVs, per-period means, deltas and panels."""
    G = 16
    case = _case(G, seed=3)
    rng = case["rng"]
    B = SPEC.num_basis
    coeffs = rng.normal(0.0, 5.0, (M, B, G))
    mus = rng.normal(0.0, 0.3, (M, B))
    sds = 0.5 + rng.random((M, B))
    vbars = np.tile(0.05 * np.linspace(0.0, 1000.0, G), (M, 1))
    fwd = np.array([20.0, 21.0, 19.5])
    dfd = case["df_settle"]
    inv0 = 300.0

    with jax.enable_x64(True):
        f64 = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
        (inv, pv), outputs = forward_scan(
            (f64(np.full(S, inv0)), f64(np.zeros(S))),
            f64(case["factors"]), f64(case["vols"]), f64(case["drift"]),
            f64(coeffs), f64(mus), f64(sds), f64(vbars),
            *(f64(case[key]) for key in _STEP_KEYS[1:]), f64(fwd), f64(dfd),
            spec=SPEC, interp_kind=interp_kind, num_grid_points=G,
            extra_decisions=extra, collect_panels=collect_panels,
        )
        means, deltas, rows = (np.asarray(x) for x in outputs[:3])
    ref_inv, ref_pv, ref_means, ref_deltas, ref_rows = _ref_forward(
        case, coeffs, mus, sds, vbars, inv0, fwd, dfd, interp_kind, extra
    )
    np.testing.assert_allclose(np.asarray(inv), ref_inv, rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(np.asarray(pv), ref_pv, rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(means, ref_means, rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(deltas, ref_deltas, rtol=1e-10, atol=1e-8)
    if collect_panels:
        np.testing.assert_allclose(rows, ref_rows, rtol=1e-10, atol=1e-8)
    else:
        assert rows.shape == (M, 6, 0)
