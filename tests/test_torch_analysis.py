"""The port's state diagnostics (``nbody_tpu_torch/analysis.py``, numpy
float64 copies of ``nbody_tpu/analysis.py``'s) against the JAX package's on
the same arrays, at 1e-12 relative; and on a preset of the port."""

import numpy as np
import pytest

from nbody_tpu import analysis as ja
from nbody_tpu_torch import SimConfig
from nbody_tpu_torch import analysis as pa
from nbody_tpu_torch.models.init import INIT_MAKERS

TOL = 1e-12


def _system(n, seed):
    r = np.random.default_rng(seed)
    pos = r.normal(0.0, 1e4, (n, 3)).astype(np.float32)
    vel = r.normal(0.0, 3e2, (n, 3)).astype(np.float32)
    mass = r.uniform(1e5, 1e9, n).astype(np.float32)
    return pos, vel, mass


@pytest.mark.parametrize("n,seed", [(7, 0), (700, 1), (2600, 2)])
def test_structure_diagnostics_match_jax(n, seed):
    pos, vel, mass = _system(n, seed)
    np.testing.assert_allclose(pa.lagrangian_radii(pos, mass),
                               ja.lagrangian_radii(pos, mass), rtol=TOL)
    fr = (0.05, 0.25, 0.5, 0.75, 1.0)
    centre = np.array([10.0, -5.0, 3.0])
    np.testing.assert_allclose(
        pa.lagrangian_radii(pos, mass, fr, center=centre),
        ja.lagrangian_radii(pos, mass, fr, center=centre), rtol=TOL)
    for kw in ({}, {"n_bins": 16, "r_max": 2e4, "chunk": 256}):
        rp, gp = pa.pair_correlation(pos, **kw)
        rj, gj = ja.pair_correlation(pos, **kw)
        np.testing.assert_allclose(rp, rj, rtol=TOL)
        np.testing.assert_allclose(gp, gj, rtol=TOL, atol=TOL)
    for eps2 in (0.0, 0.002, 1e4):
        assert pa.virial_ratio(pos, vel, mass, eps2) == pytest.approx(
            ja.virial_ratio(pos, vel, mass, eps2), rel=TOL)
        p64, m64 = pos.astype(np.float64), mass.astype(np.float64)
        assert pa._potential_f64(p64, m64, eps2, chunk=256) == \
            pytest.approx(ja._potential_f64(p64, m64, eps2), rel=TOL)
    snaps = np.stack([pos + k * 10.0 * vel for k in range(4)])
    np.testing.assert_allclose(pa.com_drift(snaps, mass),
                               ja.com_drift(snaps, mass), rtol=TOL,
                               atol=TOL)


def test_potential_is_the_direct_pair_sum():
    pos, _, mass = _system(40, 3)
    p, m = pos.astype(np.float64), mass.astype(np.float64)
    want = 0.0
    for i in range(40):
        for j in range(i + 1, 40):
            want -= m[i] * m[j] / np.sqrt(np.sum((p[i] - p[j]) ** 2) + 0.5)
    assert pa._potential_f64(p, m, 0.5, chunk=7) == pytest.approx(want,
                                                                  rel=TOL)


def test_edge_cases_match_jax():
    with pytest.raises(ValueError):
        pa.pair_correlation(np.zeros((1, 3)))
    pos = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    assert pa.virial_ratio(pos, np.zeros((2, 3)), np.ones(2), 0.0) == 0.0
    assert pa.virial_ratio(pos, np.ones((2, 3)), np.zeros(2), 0.0) == \
        ja.virial_ratio(pos, np.ones((2, 3)), np.zeros(2), 0.0)
    np.testing.assert_array_equal(pa.com_drift([pos, pos], np.ones(2)),
                                  [0.0, 0.0])


def test_collision_preset_structure():
    """The collision preset's two clusters through the diagnostics: the
    half-mass radius about the centre of mass spans the separation, and
    each cluster about its own centre is a Plummer sphere (half-mass
    radius ~1.3 a)."""
    cfg = SimConfig(n_bodies=2000, seed=7, device="cpu")
    st = INIT_MAKERS["collision"](cfg)
    pos, mass = st.pos.numpy(), st.mass.numpy()
    a = cfg.max_pos / 10.0
    assert pa.lagrangian_radii(pos, mass, (0.5,))[0] > 3.0 * a
    for half in (slice(0, 1000), slice(1000, 2000)):
        r_half = pa.lagrangian_radii(pos[half], mass[half], (0.5,))[0]
        assert 1.0 * a < r_half < 1.7 * a, r_half
    _, g = pa.pair_correlation(pos, n_bins=32)
    assert np.all(np.isfinite(g)) and g.max() > 1.0
