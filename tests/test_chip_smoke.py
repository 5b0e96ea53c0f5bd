"""``chip_smoke.py`` and ``bench.py`` on the CPU.

The phases run here at tiny sizes (the card runs them at full size); the
entry points must refuse the CPU, and the last line must keep its shape.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "benchmarks")]

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def _lines():
    lines = []
    return lines, lines.append


def test_headline_phase_tiny():
    lines, out = _lines()
    check = chip_smoke.Checks(out)
    chip_smoke.headline_phase(check, out, num_sims=512, ref_sims=256)
    assert check.failed == []
    assert set(check.results) == {
        "headline finite", "headline npv >= intrinsic", "cpu vs cpu npv rel",
    }
    text = "\n".join(lines)
    for needle in ("first call", "warm run 2", "phase split", "BackwardInduction",
                   "peak_bytes_in_use", "inventory space"):
        assert needle in text


def test_cross_model_phase_tiny(monkeypatch):
    import accuracy_study

    monkeypatch.setattr(accuracy_study, "GRID", 40)
    lines, out = _lines()
    check = chip_smoke.Checks(out)
    chip_smoke.cross_model_phase(check, out, num_sims=1024, drift_sims=256, seeds=(11, 23))
    assert set(check.results) == {"lsmc vs tree gap seed 11", "lsmc vs tree gap seed 23"}
    # A converged comparison needs the card's path count; the gap is still a
    # small finite relative number at 1,024 paths.
    assert all(np.isfinite(v) and abs(v) < 0.05 for v, _, _ in check.results.values())
    assert any("f32 vs f64 drift" in line for line in lines)


def test_intrinsic_phase():
    lines, out = _lines()
    check = chip_smoke.Checks(out)
    chip_smoke.intrinsic_phase(check, out, num_grid=1500, num_decisions=81)
    assert check.failed == []
    assert set(check.results) == {"intrinsic above optimum", "intrinsic vs optimum rel"}


def test_four_card_phase_on_four_virtual_devices():
    devices = jax.devices()[:4]
    assert len(devices) == 4
    lines, out = _lines()
    check = chip_smoke.Checks(out)
    chip_smoke.four_card_phase(check, out, devices, num_sims=4096)
    assert check.failed == []
    assert set(check.results) == {
        "mesh vs one card npv rel", "mesh vs one card max delta diff",
    }


def test_checks_record_failures():
    lines, out = _lines()
    check = chip_smoke.Checks(out)
    check("a", 1.0, 2.0, True)
    check("b", 3.0, 2.0, False)
    assert check.failed == ["b"]
    assert lines[1].startswith("check b: 3.0 (bound 2.0) FAIL")


def _stub_card(monkeypatch, phases_ok=True):
    """Run ``main`` on the CPU devices with the card-only parts stubbed (and
    the suite's own compile cache left alone).  Returns the config updates
    ``main`` made."""
    from storage_tpu.utils import compile_cache

    updates = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda name, value: updates.append((name, value)))
    monkeypatch.setattr(bench, "require_gpu", lambda: jax.devices()[0])
    monkeypatch.setattr(bench, "card_lines", lambda: "Fake Card, 123.00 W")
    for name in ("headline_phase", "cross_model_phase", "intrinsic_phase",
                 "four_card_phase"):
        def phase(check, out, *args, _name=name, **kwargs):
            check(_name, 0.0, 1.0, phases_ok)
        monkeypatch.setattr(chip_smoke, name, phase)
    return updates


@pytest.mark.parametrize("argv, count", [([], 1), (["--four-cards"], 4)])
def test_last_line_shape(monkeypatch, capsys, argv, count):
    _stub_card(monkeypatch)
    assert chip_smoke.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    device = jax.devices()[0]
    assert json.loads(lines[-1]) == {
        "ok": True,
        "device": {"platform": device.platform, "kind": device.device_kind, "count": count},
    }
    assert lines[-2] == "Fake Card, 123.00 W"


def test_failed_check_exits_nonzero_without_ok_line(monkeypatch, capsys):
    _stub_card(monkeypatch, phases_ok=False)
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out
    assert "FAILED" in out


def test_compile_cache_follows_env(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    updates = _stub_card(monkeypatch)
    chip_smoke.main([])
    assert updates == [("jax_compilation_cache_dir", str(tmp_path))]
    assert f"compile cache: {tmp_path}" in capsys.readouterr().out


def test_compile_cache_defaults_to_checkout(monkeypatch, capsys):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    updates = _stub_card(monkeypatch)
    chip_smoke.main([])
    assert updates == [("jax_compilation_cache_dir", os.path.join(REPO, ".jax_cache"))]


def _fresh_env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


def test_chip_smoke_refuses_cpu(tmp_path):
    result = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=_fresh_env(JAX_COMPILATION_CACHE_DIR=str(tmp_path)),
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert result.returncode != 0
    assert '"ok"' not in result.stdout
    assert "no GPU" in result.stderr


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    result = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py")],
        env=_fresh_env(), cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert result.returncode != 0
    assert '"ok"' not in result.stdout


def test_bench_refuses_cpu():
    result = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        env=_fresh_env(), cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert result.returncode != 0
    assert result.stdout.strip() == ""
    assert "no GPU" in result.stderr


def test_bench_case_rates():
    assert bench.MAX_RATE == 275.0
    storage, fwd_curve, _, _ = bench.build_case()
    assert len(fwd_curve) > 341 and storage.freq == "D"


@pytest.fixture
def card():
    """A GPU as seen from a fresh process (the suite itself is pinned to the
    CPU), or a skip."""
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.devices()[0].platform)"],
        env={k: v for k, v in os.environ.items()
             if k not in ("JAX_PLATFORMS", "XLA_FLAGS")},
        capture_output=True, text=True, timeout=300,
    )
    if probe.stdout.strip() != "gpu":
        pytest.skip("no GPU: this test runs on the card (pytest -m gpu)")


@pytest.mark.gpu
def test_phases_on_the_card(card):
    """The headline phase at a reduced path count (its CPU-device reference
    at the full 16,384 paths its bound is set for) and the intrinsic phase,
    on the card, in a fresh process."""
    code = (
        "import sys, chip_smoke as c; k = c.Checks(); "
        "c.headline_phase(k, print, num_sims=65_536); "
        "c.intrinsic_phase(k, print); sys.exit(1 if k.failed else 0)"
    )
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env={k: v for k, v in os.environ.items()
             if k not in ("JAX_PLATFORMS", "XLA_FLAGS")},
        timeout=900,
    )
    assert result.returncode == 0, result.stdout[-3000:] + result.stderr[-3000:]
