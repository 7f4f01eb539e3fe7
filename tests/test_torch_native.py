"""The port's copy of the native C++/OpenMP oracle
(``nbody_tpu_torch/oracle/native.py`` over the unchanged
``native/nbody_native.cpp``): the checks of ``tests/test_native.py`` held
against the copy, native against the numpy oracle on shared arrays, the
JAX package's binding on the same arrays, and ``validate --oracle
native``.  Skipped, as the JAX package's file is, where g++ cannot build
the library.

The JAX binding runs ``make -C native`` in place, so under xdist one
worker can read ``native/libnbody_native.so`` while another writes it.
Its comparison here therefore loads the port's build (the same source,
the Makefile's flags, written atomically into the build root) through the
JAX binding's own ``_load``, by pointing the binding's module globals at
it for the test; ``nbody_tpu/oracle/native.py`` is not edited.
"""

import numpy as np
import pytest

from conftest import make_small_system
from nbody_tpu.oracle import native as jax_native
from nbody_tpu_torch import cli
from nbody_tpu_torch.oracle import native
from nbody_tpu_torch.oracle.numpy_oracle import oracle_forces, oracle_run

EPS2, DT = 0.002, 0.1


@pytest.fixture(autouse=True)
def _built(monkeypatch):
    """Build the library in the test that needs it, not at collection,
    and have the JAX binding load that build, not ``native/``."""
    if not native.available():
        pytest.skip("native library not built (needs g++)")
    monkeypatch.setattr(jax_native, "_LIB_PATH",
                        str(native.built_library()))
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)


def test_native_forces_match_numpy_f64():
    pos, _, mass = make_small_system(512, seed=40)
    a_native = native.native_forces(pos, mass, EPS2, dtype=np.float64)
    a_numpy = oracle_forces(pos, mass, EPS2, dtype=np.float64)
    np.testing.assert_allclose(a_native, a_numpy, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(
        a_native, jax_native.native_forces(pos, mass, EPS2, dtype=np.float64))
    assert jax_native._lib._name == str(native.built_library())


def test_native_forces_f32():
    pos, _, mass = make_small_system(256, seed=41)
    a32 = native.native_forces(pos, mass, EPS2, dtype=np.float32)
    a64 = oracle_forces(pos, mass, EPS2, dtype=np.float64)
    assert a32.dtype == np.float32
    np.testing.assert_allclose(a32, a64, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("integrator", ["reference", "kdk"])
def test_native_run_matches_numpy(integrator):
    pos, vel, mass = make_small_system(128, seed=42)
    npos, nvel, nacc = native.native_run(pos, vel, mass, EPS2, DT, 10,
                                         integrator=integrator)
    opos, ovel, oacc = oracle_run(pos, vel, mass, EPS2, DT, 10,
                                  integrator=integrator)
    np.testing.assert_allclose(npos, opos, rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(nvel, ovel, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(nacc, oacc, rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match="integrator"):
        native.native_run(pos, vel, mass, EPS2, DT, 1, integrator="leap")


def test_native_threads():
    assert native.num_threads() >= 1


def test_cli_validate_oracle_native(capsys):
    """``--oracle native`` runs both phases on the native oracle; yoshida4
    falls back to numpy with a message; an explicit ``--oracle numpy``
    keeps the long phase on numpy."""
    base = ["validate", "--n", "256", "--steps", "5", "--long-steps", "10",
            "--device", "cpu"]
    assert cli.main([*base, "--oracle", "native"]) == 0
    out = capsys.readouterr().out
    assert "5-step lock-step phase vs native float64 oracle" in out
    assert "[long] 10-step horizon vs native f64 oracle" in out
    assert "Verification PASSED after 5 lock-step steps vs native" in out
    assert cli.main([*base, "--oracle", "native", "--integrator",
                     "yoshida4"]) == 0
    out = capsys.readouterr().out
    assert "native oracle has no yoshida4 twin; falling back to numpy" in out
    assert "[long] 10-step horizon vs numpy f64 oracle" in out
    assert cli.main([*base, "--oracle", "numpy"]) == 0
    out = capsys.readouterr().out
    assert "[long] 10-step horizon vs numpy f64 oracle" in out
    assert cli.main([*base, "--integrator", "kdk"]) == 0
    assert "[long] 10-step horizon vs native f64 oracle" in \
        capsys.readouterr().out
