"""LSMC engine oracle tests.

Strategy per SURVEY.md §4.1:
- Analytic-bound oracle: storage degenerating into a strip of three European
  calls priced against Black-76 closed form, NPV within [-2%, 0] (LSMC is a
  lower bound) and deltas within 2%
  (``Lsmc/LsmcStorageValuationTest.cs:309-418``).
- Cross-model consistency: tiny vol ==> LSMC converges to the intrinsic value
  (``:527-608``).
- Progress/cancellation behaviour (``:873-919``).
- Trigger-price behavioural properties (``:921-1018``).
"""
import math
from datetime import date

import numpy as np
import pandas as pd
import pytest

from storage_tpu import (
    CmdtyStorage,
    ValuationCancelledError,
    intrinsic_value,
    multi_factor_value,
)

# --------------------------------------------------------------------------- #
# Black-76 helpers (closed form; equivalent of TestHelper.cs:38-85)           #
# --------------------------------------------------------------------------- #


def norm_cdf(x):
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def black76_call(val_day, fwd_price, implied_vol, interest_rate, strike, expiry_day, settle_day):
    df = math.exp(-(settle_day - val_day).days / 365.0 * interest_rate)
    t = (expiry_day - val_day).days / 365.0
    vol_sqrt_t = implied_vol * math.sqrt(t)
    d1 = (math.log(fwd_price / strike) + implied_vol**2 / 2 * t) / vol_sqrt_t
    d2 = d1 - vol_sqrt_t
    return df * (fwd_price * norm_cdf(d1) - strike * norm_cdf(d2))


def black76_delta_undiscounted(val_day, fwd_price, implied_vol, strike, expiry_day):
    t = (expiry_day - val_day).days / 365.0
    vol_sqrt_t = implied_vol * math.sqrt(t)
    d1 = (math.log(fwd_price / strike) + implied_vol**2 / 2 * t) / vol_sqrt_t
    return norm_cdf(d1)


def one_factor_implied_vol(val_day, expiry_day, spot_vol, mean_reversion):
    """sigma_imp^2 * T = sigma_spot^2 (1 - e^{-2 a T}) / (2 a)."""
    t = (expiry_day - val_day).days / 365.0
    one_factor_variance = (1 - math.exp(-2 * mean_reversion * t)) / 2.0 / mean_reversion
    return spot_vol * math.sqrt(one_factor_variance / t)


# --------------------------------------------------------------------------- #
# Strip-of-calls storage fixture (design of TestHelper.cs:110-210)            #
# --------------------------------------------------------------------------- #

VAL_DATE = "2019-08-29"
STORAGE_START = "2019-12-01"
STORAGE_END = "2020-04-01"
MEAN_REVERSION = 16.5
INTEREST_RATE = 0.09

CALLS = [  # (expiry, notional, strike offset vs forward)
    (pd.Period("2019-12-15", "D"), 1200.0, 0.0),
    (pd.Period("2020-01-20", "D"), 800.0, 2.0),
    (pd.Period("2020-03-31", "D"), 900.0, 2.8),
]

SETTLE_BY_MONTH = {
    pd.Period("2019-12", "M"): date(2020, 1, 20),
    pd.Period("2020-01", "M"): date(2020, 2, 18),
    pd.Period("2020-02", "M"): date(2020, 3, 21),
    pd.Period("2020-03", "M"): date(2020, 4, 22),
}


def settle_rule(period):
    return SETTLE_BY_MONTH[period.asfreq("M")]


def seasonal_curves():
    """Sinusoidal daily forward and spot-vol curves (TestHelper.cs:87-108 shape)."""
    idx = pd.period_range(VAL_DATE, STORAGE_END, freq="D")
    i = np.arange(len(idx))
    fwd = 53.5 + np.sin(2.0 * np.pi / 365.0 * i) * 24.6
    vol = 0.78 + np.sin(2.0 * np.pi / 365.0 * i) * 0.35
    return pd.Series(fwd, index=idx), pd.Series(vol, index=idx)


def strip_storage(fwd_curve):
    """Storage exercisable only on the three option dates: withdrawal of the
    notional, cost per unit = strike settling with the commodity."""
    idx = pd.period_range(STORAGE_START, STORAGE_END, freq="D")
    max_wdr = pd.Series(0.0, index=idx)
    wdr_cost = pd.Series(0.0, index=idx)
    strikes = {}
    for expiry, notional, strike_offset in CALLS:
        strike = float(fwd_curve[expiry]) + strike_offset
        strikes[expiry] = strike
        max_wdr[expiry] = notional
        wdr_cost[expiry] = strike
    inventory = sum(notional for _, notional, _ in CALLS)
    storage = CmdtyStorage(
        "D", STORAGE_START, STORAGE_END,
        injection_cost=0.0,
        withdrawal_cost=wdr_cost,
        min_inventory=0.0,
        max_inventory=inventory,
        max_injection_rate=0.0,
        max_withdrawal_rate=max_wdr,
        terminal_storage_npv=lambda price, inv: 0.0,  # leftover inventory worthless
        cost_cash_flow_rule=settle_rule,  # strike settles with the commodity
    )
    return storage, inventory, strikes


def run_strip_valuation(num_sims=20_000, seed=11, fwd_sim_seed=13, **kwargs):
    fwd_curve, vol_curve = seasonal_curves()
    storage, inventory, strikes = strip_storage(fwd_curve)
    results = multi_factor_value(
        storage, VAL_DATE, inventory, fwd_curve,
        interest_rates=_flat_rates(),
        settlement_rule=settle_rule,
        factors=[(MEAN_REVERSION, vol_curve)],
        factor_corrs=None,
        num_sims=num_sims,
        basis_funcs="1 + x0 + x0**2 + x0**3",
        discount_deltas=False,
        seed=seed,
        fwd_sim_seed=fwd_sim_seed,
        **kwargs,
    )
    return results, fwd_curve, vol_curve, strikes


def _flat_rates():
    idx = pd.period_range(VAL_DATE, "2020-06-01", freq="D")
    return pd.Series(INTEREST_RATE, index=idx)


def black76_strip_value(fwd_curve, vol_curve, strikes):
    val_day = date(2019, 8, 29)
    total = 0.0
    for expiry, notional, _ in CALLS:
        strike = strikes[expiry]
        expiry_day = expiry.to_timestamp().date()
        settle_day = SETTLE_BY_MONTH[expiry.asfreq("M")]
        implied_vol = one_factor_implied_vol(
            val_day, expiry_day, float(vol_curve[expiry]), MEAN_REVERSION
        )
        total += (
            black76_call(
                val_day, float(fwd_curve[expiry]), implied_vol, INTEREST_RATE,
                strike, expiry_day, settle_day,
            )
            * notional
        )
    return total


class TestBlack76StripOracle:
    @pytest.fixture(scope="class")
    def strip(self):
        return run_strip_valuation()

    def test_npv_within_lower_bound_band_of_black76(self, strip):
        results, fwd_curve, vol_curve, strikes = strip
        expected = black76_strip_value(fwd_curve, vol_curve, strikes)
        percent_error = (results.npv - expected) / expected
        # LSMC is a lower-bound estimator: within [-2%, ~0] of the closed form
        # (reference tolerance, LsmcStorageValuationTest.cs:356-357; small
        # positive slack for Monte-Carlo noise).
        assert -0.02 <= percent_error <= 0.005, percent_error

    def test_deltas_match_black76_on_option_dates(self, strip):
        results, fwd_curve, vol_curve, strikes = strip
        val_day = date(2019, 8, 29)
        for expiry, notional, _ in CALLS:
            expiry_day = expiry.to_timestamp().date()
            implied_vol = one_factor_implied_vol(
                val_day, expiry_day, float(vol_curve[expiry]), MEAN_REVERSION
            )
            expected_delta = black76_delta_undiscounted(
                val_day, float(fwd_curve[expiry]), implied_vol, strikes[expiry], expiry_day
            ) * notional
            actual = results.deltas[expiry]
            assert actual == pytest.approx(expected_delta, rel=0.04), expiry

    def test_deltas_zero_off_option_dates(self, strip):
        results, *_ = strip
        option_dates = {expiry for expiry, _, _ in CALLS}
        for period, delta in results.deltas.items():
            if period not in option_dates:
                assert delta == pytest.approx(0.0, abs=1e-6)


class TestTinyVolEqualsIntrinsic:
    """With negligible vol the LSMC value must equal the intrinsic value
    (reference ``:527-608``)."""

    def test_lsmc_converges_to_intrinsic(self):
        storage = CmdtyStorage(
            "D", "2021-01-01", "2021-03-01",
            injection_cost=0.3, withdrawal_cost=0.4,
            min_inventory=0.0, max_inventory=2000.0,
            max_injection_rate=60.0, max_withdrawal_rate=80.0,
        )
        idx = pd.period_range("2021-01-01", "2021-03-01", freq="D")
        fwd = pd.Series(20.0 + 5.0 * np.sin(np.arange(len(idx)) / 6.0), index=idx)
        rates = pd.Series(0.02, index=pd.period_range("2021-01-01", "2021-06-01", freq="D"))
        vol = pd.Series(1e-5, index=idx)

        intrinsic = intrinsic_value(storage, "2021-01-01", 500.0, fwd, rates, None)
        lsmc = multi_factor_value(
            storage, "2021-01-01", 500.0, fwd, rates, None,
            factors=[(0.5, vol)], factor_corrs=None,
            num_sims=200, basis_funcs="1 + x0", discount_deltas=False, seed=7,
        )
        assert lsmc.npv == pytest.approx(intrinsic.npv, rel=2e-3)

    def test_tiny_vol_deltas_match_intrinsic_volumes(self):
        storage = CmdtyStorage(
            "D", "2021-01-01", "2021-02-01",
            injection_cost=0.3, withdrawal_cost=0.4,
            min_inventory=0.0, max_inventory=500.0,
            max_injection_rate=50.0, max_withdrawal_rate=50.0,
        )
        idx = pd.period_range("2021-01-01", "2021-02-01", freq="D")
        fwd = pd.Series(np.where(np.arange(len(idx)) < 16, 10.0, 30.0), index=idx)
        vol = pd.Series(1e-5, index=idx)
        # Positive rates make the optimal inject/withdraw *timing* unique
        # (defer purchases, accelerate sales); without discounting the plan is
        # degenerate and tie-breaking differs between engines.
        rates = pd.Series(0.1, index=pd.period_range("2021-01-01", "2021-06-01", freq="D"))
        intrinsic = intrinsic_value(storage, "2021-01-01", 0.0, fwd, rates, None)
        lsmc = multi_factor_value(
            storage, "2021-01-01", 0.0, fwd, rates, None,
            factors=[(0.5, vol)], factor_corrs=None,
            num_sims=200, basis_funcs="1 + x0", discount_deltas=False, seed=3,
        )
        # Deltas under certainty = net traded volumes of the intrinsic plan.
        np.testing.assert_allclose(
            lsmc.deltas.to_numpy()[:-1],
            intrinsic.profile["net_volume"].to_numpy()[:-1],
            atol=0.51,
        )


class TestComposedBasisFunctions:
    """Engines accept programmatic ``+``/``*``/``**`` monomial composition
    (reference ``PowerMonomialBuilder.cs:30-76``) equivalently to the DSL."""

    def test_composed_basis_equals_dsl_end_to_end(self):
        from storage_tpu import S, X, ones

        storage = CmdtyStorage(
            "D", "2021-01-01", "2021-01-20",
            injection_cost=0.1, withdrawal_cost=0.1,
            min_inventory=0.0, max_inventory=300.0,
            max_injection_rate=30.0, max_withdrawal_rate=30.0,
        )
        idx = pd.period_range("2021-01-01", "2021-01-20", freq="D")
        fwd = pd.Series(20.0 + 3.0 * np.sin(np.arange(len(idx))), index=idx)
        vol = pd.Series(0.5, index=idx)
        common = dict(
            factors=[(2.0, vol)], factor_corrs=None, num_sims=256,
            discount_deltas=False, seed=5, return_sim_panels=False,
        )
        dsl = multi_factor_value(
            storage, "2021-01-01", 50.0, fwd, None, None,
            basis_funcs="1 + s + x0 + x0**2 + s*x0", **common,
        )
        composed = multi_factor_value(
            storage, "2021-01-01", 50.0, fwd, None, None,
            basis_funcs=ones() + S + X(0) + X(0) ** 2 + S * X(0), **common,
        )
        assert composed.npv == dsl.npv
        pd.testing.assert_series_equal(composed.deltas, dsl.deltas)


class TestProfileSink:
    def test_profile_sink_receives_synced_phase_breakdown(self):
        storage = CmdtyStorage(
            "D", "2021-01-01", "2021-01-20",
            injection_cost=0.1, withdrawal_cost=0.1,
            min_inventory=0.0, max_inventory=200.0,
            max_injection_rate=25.0, max_withdrawal_rate=25.0,
        )
        idx = pd.period_range("2021-01-01", "2021-01-20", freq="D")
        fwd = pd.Series(20.0, index=idx)
        vol = pd.Series(0.5, index=idx)
        captured = []
        multi_factor_value(
            storage, "2021-01-01", 50.0, fwd, None, None,
            factors=[(2.0, vol)], factor_corrs=None, num_sims=128,
            basis_funcs="1 + s + x0", discount_deltas=False, seed=1,
            return_sim_panels=False, profile_sink=captured.append,
        )
        (sw,) = captured
        total = sw.elapsed("All")
        assert total > 0
        for phase in ("RegressionPriceSimulation", "ValuationPriceSimulation",
                      "BackwardInduction", "ForwardSimulation"):
            assert sw.elapsed(phase) > 0, phase
        assert sum(sw.elapsed(p) for p in sw.PHASES) <= total


class TestProgressAndCancellation:
    def _setup(self):
        storage = CmdtyStorage(
            "D", "2021-01-01", "2021-02-01",
            injection_cost=0.1, withdrawal_cost=0.1,
            min_inventory=0.0, max_inventory=100.0,
            max_injection_rate=10.0, max_withdrawal_rate=10.0,
        )
        idx = pd.period_range("2021-01-01", "2021-02-01", freq="D")
        fwd = pd.Series(10.0, index=idx)
        vol = pd.Series(0.5, index=idx)
        return storage, fwd, vol

    def test_progress_ascending_ending_at_one(self):
        storage, fwd, vol = self._setup()
        progresses = []
        multi_factor_value(
            storage, "2021-01-01", 0.0, fwd, None, None,
            factors=[(1.0, vol)], factor_corrs=None,
            num_sims=100, basis_funcs="1 + x0", discount_deltas=False, seed=1,
            on_progress_update=progresses.append,
        )
        assert progresses[-1] == 1.0
        assert all(0.0 <= p <= 1.0 for p in progresses)
        assert all(b >= a for a, b in zip(progresses, progresses[1:]))
        assert len(progresses) > 5

    def test_cancellation_raises(self):
        storage, fwd, vol = self._setup()
        calls = {"n": 0}

        def cancelled():
            calls["n"] += 1
            return calls["n"] > 2

        with pytest.raises(ValuationCancelledError):
            multi_factor_value(
                storage, "2021-01-01", 0.0, fwd, None, None,
                factors=[(1.0, vol)], factor_corrs=None,
                num_sims=100, basis_funcs="1 + x0", discount_deltas=False, seed=1,
                cancelled=cancelled,
            )


class TestTriggerPriceProperties:
    """Behavioural properties (reference ``:921-1018``)."""

    @pytest.fixture(scope="class")
    def valuation(self):
        storage = CmdtyStorage(
            "D", "2021-01-01", "2021-03-01",
            injection_cost=0.3, withdrawal_cost=0.4,
            min_inventory=0.0, max_inventory=2000.0,
            max_injection_rate=60.0, max_withdrawal_rate=80.0,
        )
        idx = pd.period_range("2021-01-01", "2021-03-01", freq="D")
        fwd = pd.Series(20.0 + 3.0 * np.sin(np.arange(len(idx)) / 8.0), index=idx)
        vol = pd.Series(0.7, index=idx)
        results = multi_factor_value(
            storage, "2021-01-01", 800.0, fwd, None, None,
            factors=[(5.0, vol)], factor_corrs=None,
            num_sims=1000, basis_funcs="1 + x0 + x0**2", discount_deltas=False, seed=5,
        )
        return results

    def test_withdraw_trigger_above_inject_trigger(self, valuation):
        both = valuation.trigger_prices.dropna()
        assert len(both) > 10
        assert (both["withdraw_trigger_price"] > both["inject_trigger_price"]).all()

    def test_withdraw_trigger_increases_with_abs_volume(self, valuation):
        # Reference: Calculate_SimpleStorage1Factor_WithdrawTriggerPricesIncreaseWithAbsVolume
        checked = 0
        for profile in valuation.trigger_profiles.dropna():
            if profile.withdraw_triggers:
                points = profile.withdraw_triggers  # ordered |volume| increasing
                vols = [p.volume for p in points]
                prices = [p.price for p in points]
                assert all(b < a for a, b in zip(vols, vols[1:]))  # more negative
                # Monotone up to regression-noise wiggle in the value-function
                # estimate (the reference's 1e-8 tolerance holds only below its
                # config's noise floor).
                assert all(
                    b >= a - 0.02 * abs(a) for a, b in zip(prices, prices[1:])
                )
                checked += 1
        assert checked > 10

    def test_summary_column_semantics_match_reference(self, valuation):
        """Pin the summary-column pairing against the full ladders: the
        reference keeps the price at the MAX inject volume on the inject side
        (``MaxInjectTriggerPrice = injectTriggerPrices[last].Price``,
        ``LsmcStorageValuation.cs:525-526``) but pairs the max withdraw VOLUME
        with the price of the SMALLEST withdrawal increment
        (``withdrawTriggerPrices[0].Price`` after the ladder reversal,
        ``LsmcStorageValuation.cs:545-554``)."""
        tp = valuation.trigger_prices
        checked = 0
        for k, profile in enumerate(valuation.trigger_profiles):
            inj, wdr = profile.inject_triggers, profile.withdraw_triggers
            if inj:
                assert tp["inject_volume"].iloc[k] == pytest.approx(inj[-1].volume)
                assert tp["inject_trigger_price"].iloc[k] == pytest.approx(inj[-1].price)
            if wdr:
                # Max |volume| ... paired with the first increment's price.
                assert tp["withdraw_volume"].iloc[k] == pytest.approx(wdr[-1].volume)
                assert abs(wdr[-1].volume) == max(abs(p.volume) for p in wdr)
                assert tp["withdraw_trigger_price"].iloc[k] == pytest.approx(wdr[0].price)
                assert abs(wdr[0].volume) == min(abs(p.volume) for p in wdr)
            if inj and wdr:
                checked += 1
        assert checked > 10

    def test_no_withdraw_trigger_at_zero_inventory_first_period(self):
        storage = CmdtyStorage(
            "D", "2021-01-01", "2021-02-01",
            injection_cost=0.3, withdrawal_cost=0.4,
            min_inventory=0.0, max_inventory=2000.0,
            max_injection_rate=60.0, max_withdrawal_rate=80.0,
        )
        idx = pd.period_range("2021-01-01", "2021-02-01", freq="D")
        fwd = pd.Series(20.0, index=idx)
        vol = pd.Series(0.7, index=idx)
        results = multi_factor_value(
            storage, "2021-01-01", 0.0, fwd, None, None,
            factors=[(5.0, vol)], factor_corrs=None,
            num_sims=500, basis_funcs="1 + x0", discount_deltas=False, seed=5,
        )
        first = results.trigger_prices.iloc[0]
        assert np.isnan(first["withdraw_trigger_price"])
        assert np.isnan(first["withdraw_volume"])
        assert results.trigger_profiles.iloc[0].withdraw_triggers == []
        # Inject side exists at empty inventory.
        assert not np.isnan(first["inject_trigger_price"])


class TestPolicyReprice:
    """Fit-once / reprice-many (the checkpoint-resume analogue, SURVEY.md §5)."""

    def test_reprice_matches_full_run_and_roundtrips_disk(self, tmp_path):
        import jax.numpy as jnp

        from storage_tpu.compile import build_valuation_context
        from storage_tpu.engines.lsmc import LsmcPolicy, fit_policy, reprice
        from storage_tpu.models.multi_factor import build_sim_coefficients
        from storage_tpu.models.simulation import simulate_factor_paths
        from storage_tpu.ops.regression import basis_spec
        from storage_tpu.utils.basis import parse_basis_functions

        storage = CmdtyStorage(
            "D", "2021-01-01", "2021-02-01",
            injection_cost=0.3, withdrawal_cost=0.4,
            min_inventory=0.0, max_inventory=500.0,
            max_injection_rate=50.0, max_withdrawal_rate=50.0,
        )
        idx = pd.period_range("2021-01-01", "2021-02-01", freq="D")
        fwd = pd.Series(20.0 + 3.0 * np.sin(np.arange(len(idx)) / 4.0), index=idx)
        vol = pd.Series(0.6, index=idx)
        ctx = build_valuation_context(storage, "2021-01-01", 100.0, fwd, None, None)
        sim_periods = list(ctx.periods[1:])
        coeffs = build_sim_coefficients(
            [(3.0, vol)], np.eye(1), ctx.val_period, fwd, sim_periods
        )
        spec = basis_spec(parse_basis_functions("1 + x0 + x0**2"), 1)
        sim_vols = jnp.asarray(coeffs.vols, jnp.float32)
        sim_drift = jnp.asarray(coeffs.log_fwd_drift, jnp.float32)

        reg = simulate_factor_paths(coeffs, 2000, seed=1)
        val_a = simulate_factor_paths(coeffs, 2000, seed=2)
        val_b = simulate_factor_paths(coeffs, 2000, seed=3)

        policy = fit_policy(ctx, reg, sim_vols, sim_drift, spec)
        res_a = reprice(ctx, policy, val_a, sim_vols, sim_drift, spec)
        res_b = reprice(ctx, policy, val_b, sim_vols, sim_drift, spec)
        # Same policy, independent path sets: NPVs agree to MC error.
        assert float(res_a.npv) == pytest.approx(float(res_b.npv), rel=0.05)

        # Disk round-trip reprices identically.
        path = str(tmp_path / "policy.npz")
        policy.save(path)
        res_a2 = reprice(ctx, LsmcPolicy.load(path), val_a, sim_vols, sim_drift, spec)
        assert float(res_a2.npv) == pytest.approx(float(res_a.npv), rel=1e-6)


def test_scan_split_is_lossless():
    """Splitting the horizon into sub-scans must be value-neutral: the
    chunked driver (progress hooks between ~3-step sub-scans) reproduces the
    single-scan materialised run."""
    storage = CmdtyStorage(
        "D", "2021-01-01", "2021-02-20",
        injection_cost=0.2, withdrawal_cost=0.3,
        min_inventory=0.0, max_inventory=900.0,
        max_injection_rate=45.0, max_withdrawal_rate=55.0,
    )
    idx = pd.period_range("2021-01-01", "2021-02-20", freq="D")
    fwd = pd.Series(19.0 + 2.0 * np.cos(np.arange(len(idx)) / 5.0), index=idx)
    vol = pd.Series(0.6, index=idx)

    def run(**kwargs):
        return multi_factor_value(
            storage, "2021-01-01", 400.0, fwd, None, None,
            factors=[(3.0, vol)], factor_corrs=None,
            num_sims=256, basis_funcs="1 + x0 + x0**2",
            discount_deltas=False, seed=9, return_sim_panels=False, **kwargs,
        )

    base = run()
    # Progress hooks route through the chunked driver: 20 sub-scans across
    # the 50-step horizon.
    split = run(on_progress_update=lambda frac: None)
    assert split.npv == pytest.approx(base.npv, rel=1e-6)
    assert np.allclose(split.deltas.values, base.deltas.values, atol=1e-4)


# --------------------------------------------------------------------------- #
# Backward-scan health probe (VERDICT r2 #4)                                  #
# --------------------------------------------------------------------------- #


class TestBackwardHealthProbe:
    """A silently-zeroed value surface (the signature of a zeroed scan
    carry) must raise, not warn: a wrong NPV with a buried warning is
    worse than an exception."""

    def _arrays(self, vbars_np):
        import jax.numpy as jnp

        coeffs = jnp.zeros((4, 5, 10), jnp.float32)
        return coeffs, jnp.asarray(vbars_np, jnp.float32)

    def test_zero_surface_raises(self):
        from storage_tpu.engines.lsmc import _check_backward_health
        from storage_tpu.exceptions import StorageError

        coeffs, vbars = self._arrays(np.zeros((6, 10)))
        with pytest.raises(StorageError, match="identically zero"):
            _check_backward_health(coeffs, vbars)

    def test_zero_surface_env_escape_hatch(self, monkeypatch, caplog):
        from storage_tpu.engines.lsmc import _check_backward_health

        monkeypatch.setenv("STORAGE_TPU_ALLOW_ZERO_SURFACE", "1")
        coeffs, vbars = self._arrays(np.zeros((6, 10)))
        with caplog.at_level("WARNING", logger="storage_tpu.lsmc"):
            _check_backward_health(coeffs, vbars)  # must not raise
        assert any("identically zero" in r.message for r in caplog.records)

    def test_nonfinite_value_surface_raises(self):
        from storage_tpu.engines.lsmc import _check_backward_health
        from storage_tpu.exceptions import StorageError

        vb = np.ones((6, 10))
        vb[3, 4] = np.nan  # NaN guards upstream never sanitize vbars
        coeffs, vbars = self._arrays(vb)
        with pytest.raises(StorageError, match="non-finite"):
            _check_backward_health(coeffs, vbars)

    def test_healthy_surface_passes(self):
        from storage_tpu.engines.lsmc import _check_backward_health

        coeffs, vbars = self._arrays(np.ones((6, 10)))
        _check_backward_health(coeffs, vbars)

    def test_zero_surface_with_zero_forward_curve_only_warns(self, caplog):
        """A zero-value surface against an identically-zero forward curve is
        the legitimately-worthless case, not the backend signature: warn
        without needing the env escape hatch."""
        from storage_tpu.engines.lsmc import _check_backward_health

        coeffs, vbars = self._arrays(np.zeros((6, 10)))
        with caplog.at_level("WARNING", logger="storage_tpu.lsmc"):
            _check_backward_health(coeffs, vbars, fwd=np.zeros(7))
        assert any("identically zero" in r.message for r in caplog.records)

    def test_zero_surface_with_nonzero_forward_curve_still_raises(self):
        from storage_tpu.engines.lsmc import _check_backward_health
        from storage_tpu.exceptions import StorageError

        coeffs, vbars = self._arrays(np.zeros((6, 10)))
        with pytest.raises(StorageError, match="identically zero"):
            _check_backward_health(coeffs, vbars, fwd=np.full(7, 16.0))


class TestForwardHealthProbe:
    """Forward-side twin (ADVICE r3 high): a zero per-sim PV vector with a
    non-zero backward estimate is the zeroed-carry signature."""

    def test_zero_pv_nonzero_backward_raises(self):
        import jax.numpy as jnp

        from storage_tpu.engines.lsmc import _check_forward_health
        from storage_tpu.exceptions import StorageError

        with pytest.raises(StorageError, match="identically zero"):
            _check_forward_health(
                jnp.zeros((64,), jnp.float32), jnp.zeros((64,), jnp.float32),
                jnp.asarray(123.4, jnp.float32),
            )

    def test_zero_pv_zero_backward_passes(self):
        import jax.numpy as jnp

        from storage_tpu.engines.lsmc import _check_forward_health

        _check_forward_health(
            jnp.zeros((64,), jnp.float32), jnp.zeros((64,), jnp.float32),
            jnp.asarray(0.0, jnp.float32),
        )

    def test_nonfinite_pv_raises(self):
        import jax.numpy as jnp

        from storage_tpu.engines.lsmc import _check_forward_health
        from storage_tpu.exceptions import StorageError

        pv = jnp.asarray(np.array([1.0, np.nan, 2.0], np.float32))
        with pytest.raises(StorageError, match="non-finite"):
            _check_forward_health(
                pv, jnp.ones((3,), jnp.float32), jnp.asarray(1.0, jnp.float32)
            )

    def test_healthy_pv_passes(self):
        import jax.numpy as jnp

        from storage_tpu.engines.lsmc import _check_forward_health

        _check_forward_health(
            jnp.ones((64,), jnp.float32), jnp.ones((64,), jnp.float32),
            jnp.asarray(123.4, jnp.float32),
        )

    def test_terminal_only_value_passes(self):
        # A facility whose entire value is terminal (do-nothing optimal at
        # every step + terminal_storage_npv): zero decision PV, non-zero
        # backward estimate, but the inventory carry holds the starting
        # inventory — NOT the zeroed-carry signature (which zeroes the
        # whole carry, inventory included).
        import jax.numpy as jnp

        from storage_tpu.engines.lsmc import _check_forward_health

        _check_forward_health(
            jnp.zeros((64,), jnp.float32),
            jnp.full((64,), 1500.0, jnp.float32),
            jnp.asarray(123.4, jnp.float32),
        )
