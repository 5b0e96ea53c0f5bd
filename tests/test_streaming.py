"""Streaming (checkpoint-rematerialised) factor-path tests.

Long-horizon x production-path configs (SURVEY.md §5 long-context row: up to
8,760 hourly steps) cannot materialise the full [n, F, S] factor array in
device memory; the engine re-simulates spans from checkpointed OU states instead
(``models/simulation.py StreamingFactorSource``).  Correctness rests on two
properties tested here: span regeneration is BIT-identical to the monolithic
kernel (per-block threefry keying), and a streamed valuation agrees with the
materialised one.
"""
import numpy as np
import pandas as pd
import pytest

from storage_tpu import CmdtyStorage, multi_factor_value


def _coeffs(n=103, F=3):
    from storage_tpu.models.simulation import sim_coefficients

    rng = np.random.default_rng(0)
    return sim_coefficients(
        np.array([2.0, 0.1, 5.0]),
        0.3 + 0.2 * rng.random((n, F)),
        np.array([[1.0, 0.3, 0.1], [0.3, 1.0, 0.2], [0.1, 0.2, 1.0]]),
        np.linspace(1 / 365, n / 365, n),
        18 + 2 * rng.random(n),
    )


class TestBitParity:
    """Chunked regeneration must reproduce the monolithic kernel exactly."""

    @pytest.mark.parametrize("antithetic", [False, True])
    def test_spans_bit_identical(self, antithetic):
        import jax

        from storage_tpu.models.simulation import (
            StreamingFactorSource,
            simulate_factor_paths,
        )

        coeffs = _coeffs()
        key = jax.random.PRNGKey(42)
        S = 64
        mono = np.asarray(
            simulate_factor_paths(coeffs, S, None, antithetic, key=key)
        )
        src = StreamingFactorSource(coeffs, S, key, antithetic, every=32)
        stream = np.concatenate(
            [np.asarray(src.factors(a, b)) for a, b in src.spans()], axis=0
        )
        assert np.array_equal(mono, stream)
        # Partial sub-span reads and the final state match too.
        assert np.array_equal(np.asarray(src.factors(33, 40)), mono[33:40])
        assert np.array_equal(np.asarray(src.last()), mono[-1])

    def test_cross_span_read_rejected(self):
        import jax

        from storage_tpu.models.simulation import StreamingFactorSource

        src = StreamingFactorSource(_coeffs(), 8, jax.random.PRNGKey(0), every=32)
        with pytest.raises(ValueError, match="span boundary"):
            src.factors(30, 40)


def _storage():
    # 6-month horizon: long enough that the forced-streaming tests below
    # split into multiple 64-step-minimum spans (single-span streaming would
    # not exercise checkpoint handoff).
    return CmdtyStorage(
        "D", "2021-01-01", "2021-07-01",
        injection_cost=0.3, withdrawal_cost=0.4,
        min_inventory=0.0, max_inventory=2000.0,
        max_injection_rate=60.0, max_withdrawal_rate=80.0,
    )


def _value(num_sims=512, **kwargs):
    idx = pd.period_range("2021-01-01", "2021-07-01", freq="D")
    fwd = pd.Series(20.0 + 3.0 * np.sin(np.arange(len(idx)) / 8.0), index=idx)
    vol = pd.Series(0.7, index=idx)
    return multi_factor_value(
        _storage(), "2021-01-01", 800.0, fwd, None, None,
        factors=[(5.0, vol), (0.0, vol)], factor_corrs=0.3,
        num_sims=num_sims, basis_funcs="1 + s + x0 + x1 + x0**2",
        discount_deltas=False, seed=5, return_sim_panels=False, **kwargs,
    )


class TestStreamedValuation:
    def test_streamed_matches_materialised(self, monkeypatch):
        base = _value()
        # Force streaming: any path budget below this config's ~236 KB.
        monkeypatch.setenv("STORAGE_TPU_MAX_PATH_BYTES", "1000")
        streamed = _value()
        # The factor paths are bit-identical (TestBitParity); the remaining
        # difference is the chunked driver's per-span hoisted regression vs
        # the whole-program scan — the same f32 reassociation bounded by
        # test_lsmc.py::test_scan_split_is_lossless.
        assert streamed.npv == pytest.approx(base.npv, rel=1e-5)
        np.testing.assert_allclose(
            streamed.deltas.values, base.deltas.values, atol=1e-3
        )
        np.testing.assert_allclose(
            streamed.expected_profile["inventory"].values,
            base.expected_profile["inventory"].values,
            atol=1.0,
        )

    def test_streaming_with_progress_hooks(self, monkeypatch):
        monkeypatch.setenv("STORAGE_TPU_MAX_PATH_BYTES", "1000")
        fracs = []
        streamed = _value(on_progress_update=fracs.append)
        assert np.isfinite(streamed.npv)
        assert fracs and abs(fracs[-1] - 1.0) < 1e-9
        assert all(b >= a for a, b in zip(fracs, fracs[1:]))

    def test_panels_rejected_when_streaming(self, monkeypatch):
        monkeypatch.setenv("STORAGE_TPU_MAX_PATH_BYTES", "1000")
        idx = pd.period_range("2021-01-01", "2021-07-01", freq="D")
        fwd = pd.Series(20.0, index=idx)
        vol = pd.Series(0.7, index=idx)
        with pytest.raises(ValueError, match="return_sim_panels"):
            multi_factor_value(
                _storage(), "2021-01-01", 800.0, fwd, None, None,
                factors=[(5.0, vol)], factor_corrs=None,
                num_sims=256, basis_funcs="1 + x0", discount_deltas=False,
                seed=5, return_sim_panels=True,
            )

    def test_streamed_meshed_pallas_matches_materialised_meshless(self, monkeypatch):
        """The full production composition — streaming factor source +
        paths mesh + chunked driver — against the materialised meshless run,
        both on the engine's XLA route.  At 512 sims the lower-bound
        estimator is sensitive to near-tie policy flips: the mesh changes
        the reduction order of every regression and mean, flipping a handful
        of near-indifferent decisions — Monte-Carlo-vanishing noise, not
        bias (the slow test below pins the convergence at 4096 sims)."""
        from storage_tpu.parallel.mesh import paths_mesh

        base = _value()
        monkeypatch.setenv("STORAGE_TPU_MAX_PATH_BYTES", "1000")
        streamed = _value(mesh=paths_mesh())
        assert streamed.npv == pytest.approx(base.npv, rel=1e-2)
        # Pointwise deltas flip discretely at near-indifferent sims; bound
        # each flip by 35% of the max rate and the average much tighter.
        # The 4096-sim slow test below pins the convergence.
        diff = np.abs(streamed.deltas.values - base.deltas.values)
        assert float(diff.max()) <= 0.35 * 80.0
        assert float(diff.mean()) <= 0.02 * 80.0

    @pytest.mark.slow
    def test_streamed_meshed_pallas_converges_at_4096(self, monkeypatch):
        """The 512-sim composition gap above is policy-flip noise: at 4096
        sims the streamed+meshed NPV converges to the materialised meshless
        one."""
        from storage_tpu.parallel.mesh import paths_mesh

        base = _value(num_sims=4096)
        monkeypatch.setenv("STORAGE_TPU_MAX_PATH_BYTES", "1000")
        streamed = _value(num_sims=4096, mesh=paths_mesh())
        assert streamed.npv == pytest.approx(base.npv, rel=5e-4)
