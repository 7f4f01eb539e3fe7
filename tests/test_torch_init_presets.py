"""The ``--init`` presets of the port (``nbody_tpu_torch/models/init.py``) on
the CPU: each preset's transform, fed the very draws that ``jax.random``
made for the JAX maker (the test redoes the maker's key splits), against
the JAX maker's output; the statistical contracts of
``tests/test_init_presets.py`` on the port's own draws; the registry, the
generator and the CLI verbs.

Tolerance against JAX: per body, |port - JAX| <= 1e-5 |JAX| + 1e-6 max
|JAX| (float32 arithmetic on both sides; the sums of the masses and of
the momenta are reduced in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JaxSimConfig
from nbody_tpu.models import init as jinit
from nbody_tpu_torch import SimConfig, Simulation, cli
from nbody_tpu_torch.analysis import virial_ratio
from nbody_tpu_torch.models import init as pinit
from nbody_tpu_torch.models.energy import energy_f64

REL, ABS = 1e-5, 1e-6


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(port, ref, what):
    port = np.asarray(port, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert port.shape == ref.shape, what
    err = np.abs(port - ref)
    bound = REL * np.abs(ref) + ABS * np.abs(ref).max()
    assert np.all(err <= bound), (what, float((err - bound).max()))


def _state_close(port, ref, what):
    for k in ("pos", "vel", "acc", "mass"):
        _close(getattr(port, k), getattr(ref, k), f"{what} {k}")


def _jax_plummer_draws(key, cfg, n):
    """``jinit.plummer_state``'s splits and draws."""
    kr, kdir, kmass = jax.random.split(key, 3)
    return pinit.PlummerDraws(
        u=_t(jax.random.uniform(kr, (n,), minval=1e-6, maxval=1.0 - 1e-6)),
        normal=_t(jax.random.normal(kdir, (n, 3))),
        mass=_t(jax.random.uniform(kmass, (n,), minval=cfg.min_mass,
                                   maxval=cfg.max_mass)))


def _jax_virial_draws(key, cfg, n):
    """``jinit.plummer_virial_state``'s splits and draws."""
    kpos, kq, kdir = jax.random.split(key, 3)
    return pinit.VirialDraws(base=_jax_plummer_draws(kpos, cfg, n),
                             uq=_t(jax.random.uniform(kq, (n,))),
                             vnormal=_t(jax.random.normal(kdir, (n, 3))))


N_JAX = 1500


@pytest.mark.parametrize("seed", [0, 3])
def test_plummer_transforms_match_jax(seed):
    cfg = JaxSimConfig(n_bodies=N_JAX, seed=seed)
    key = jax.random.key(seed)
    a = cfg.max_pos / 10.0
    _state_close(pinit.plummer_from_draws(
        _jax_plummer_draws(key, cfg, N_JAX), a, torch.float32),
        jinit.plummer_state(cfg), "plummer")
    _state_close(pinit.plummer_virial_from_draws(
        _jax_virial_draws(key, cfg, N_JAX), a, torch.float32),
        jinit.plummer_virial_state(cfg), "plummer-virial")


@pytest.mark.parametrize("seed", [0, 5])
def test_disk_transform_matches_jax(seed):
    cfg = JaxSimConfig(n_bodies=N_JAX, seed=seed)
    kr, kphi, kz, kmass = jax.random.split(jax.random.key(seed), 4)
    draws = pinit.DiskDraws(
        u=_t(jax.random.uniform(kr, (N_JAX,), minval=1e-4, maxval=1.0)),
        phi=_t(jax.random.uniform(kphi, (N_JAX,), minval=0.0,
                                  maxval=2.0 * jnp.pi)),
        z=_t(jax.random.normal(kz, (N_JAX,))),
        mass=_t(jax.random.uniform(kmass, (N_JAX,), minval=cfg.min_mass,
                                   maxval=cfg.max_mass)))
    _state_close(pinit.disk_from_draws(draws, cfg.max_pos / 4.0, 0.05,
                                       torch.float32),
                 jinit.disk_state(cfg), "disk")


@pytest.mark.parametrize("n", [N_JAX, N_JAX + 1])
def test_collision_transform_matches_jax(n):
    """Both halves (``n // 2`` and ``n - n // 2`` bodies, odd N too)."""
    cfg = JaxSimConfig(n_bodies=n, seed=7)
    k1, k2 = jax.random.split(jax.random.key(7))
    a = cfg.max_pos / 10.0
    port = pinit.collision_from_draws(
        _jax_virial_draws(k1, cfg, n // 2),
        _jax_virial_draws(k2, cfg, n - n // 2), a, 8.0 * a, a, 0.5,
        torch.float32)
    _state_close(port, jinit.collision_state(cfg), "collision")


def test_speed_fraction_is_jnp_interp():
    """The 513-point inverse CDF: the port's float32 table is the JAX
    maker's (up to the cumulative sum's order), and searchsorted plus the
    linear blend gives ``jnp.interp``'s values on one table, at its knots,
    between them and outside it."""
    q = jnp.linspace(0.0, 1.0, 513)
    cdf = jnp.cumsum(q ** 2 * (1.0 - q ** 2) ** 3.5)
    cdf = cdf / cdf[-1]
    pcdf, pq = pinit._speed_table("cpu")
    np.testing.assert_allclose(pcdf.numpy(), np.asarray(cdf), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(q))
    u = np.concatenate([np.random.default_rng(0).random(4000),
                        np.asarray(cdf)[:-40], [-0.5, 0.0, 0.5,
                                                1.0 - 2 ** -24, 1.5]])
    u = jnp.asarray(u.astype(np.float32))
    got = pinit._interp(_t(u), _t(cdf), _t(q)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnp.interp(u, cdf, q)),
                               rtol=1e-6, atol=1e-7)
    frac = pinit._plummer_speed_fraction(torch.rand(1000)).numpy()
    assert frac.min() >= 0.0 and frac.max() <= 1.0


def _np(x):
    return np.asarray(x, dtype=np.float64)


def _momentum_rel(st):
    mass, vel = _np(st.mass), _np(st.vel)
    p = np.sum(mass[:, None] * vel, axis=0)
    return p / np.sum(mass * np.linalg.norm(vel, axis=1))


def test_plummer_virial_is_near_equilibrium():
    """Virial ratio 2K/|W| near 1, momentum zeroed, bound (E < 0)."""
    cfg = SimConfig(n_bodies=2048, seed=3, eps2=1e-6, device="cpu")
    st = pinit.plummer_virial_state(cfg)
    pos, vel, mass = _np(st.pos), _np(st.vel), _np(st.mass)
    ke = 0.5 * np.sum(mass * np.sum(vel ** 2, axis=1))
    e = float(energy_f64(st, cfg.eps2))
    assert e - ke < 0 and e < 0
    q = virial_ratio(pos, vel, mass, cfg.eps2)
    assert 0.7 < q < 1.3, q
    assert 2.0 * ke / abs(e - ke) == pytest.approx(q, rel=1e-9)
    np.testing.assert_allclose(_momentum_rel(st), 0.0, atol=1e-6)


def test_plummer_is_cold_and_centred():
    cfg = SimConfig(n_bodies=2048, seed=2, device="cpu")
    st = pinit.plummer_state(cfg)
    assert torch.all(st.vel == 0) and torch.all(st.acc == 0)
    r = np.linalg.norm(_np(st.pos), axis=1)
    # Plummer's half-mass radius is a / sqrt(2^(2/3) - 1) = 1.305 a.
    a = cfg.max_pos / 10.0
    assert 1.1 * a < np.median(r) < 1.5 * a


def test_disk_is_thin_and_rotating():
    cfg = SimConfig(n_bodies=1024, seed=5, device="cpu")
    st = pinit.disk_state(cfg)
    pos, vel, mass = _np(st.pos), _np(st.vel), _np(st.mass)
    a = cfg.max_pos / 4.0
    assert np.percentile(np.abs(pos[:, 2]), 95) < 0.2 * a
    assert np.max(np.linalg.norm(pos[:, :2], axis=1)) <= a * 1.0001
    ang = np.sum(mass[:, None] * np.cross(pos, vel), axis=0)
    assert abs(ang[2]) > 50 * max(abs(ang[0]), abs(ang[1]))
    assert np.all(pos[:, 0] * vel[:, 1] - pos[:, 1] * vel[:, 0] > 0)


def test_collision_is_momentum_balanced_two_clusters():
    cfg = SimConfig(n_bodies=2000, seed=7, device="cpu")
    st = pinit.collision_state(cfg)
    pos, vel = _np(st.pos), _np(st.vel)
    np.testing.assert_allclose(_momentum_rel(st), 0.0, atol=1e-6)
    a = cfg.max_pos / 10.0
    left, right = pos[:, 0] < 0, pos[:, 0] >= 0
    assert 0.3 < left.mean() < 0.7
    assert np.mean(pos[left, 0]) < -2 * a and np.mean(pos[right, 0]) > 2 * a
    assert np.mean(vel[left, 0]) > 0 and np.mean(vel[right, 0]) < 0


@pytest.mark.parametrize("name", sorted(pinit.INIT_MAKERS))
def test_makers_are_seeded_and_take_dtype(name):
    """Seeded from cfg.seed on the state's device; an explicit generator
    draws the same numbers; the state is in cfg.dtype."""
    maker = pinit.INIT_MAKERS[name]
    cfg = SimConfig(n_bodies=301, seed=11, device="cpu")
    a, b = maker(cfg), maker(cfg)
    c = maker(cfg, torch.Generator().manual_seed(11))
    d = maker(cfg.replace(seed=12))
    for k in ("pos", "vel", "mass"):
        assert torch.equal(getattr(a, k), getattr(b, k))
        assert torch.equal(getattr(a, k), getattr(c, k))
    assert not torch.equal(a.pos, d.pos)
    assert a.pos.shape == (301, 3) and a.mass.shape == (301,)
    assert all(bool(torch.isfinite(x).all()) for x in a)
    f64 = maker(cfg.replace(dtype="float64"))
    assert all(x.dtype == torch.float64 for x in f64)
    np.testing.assert_allclose(f64.pos.numpy(), a.pos.numpy(), rtol=1e-6,
                               atol=1e-6 * float(a.pos.abs().max()))


def test_registry_and_cli_parse():
    assert set(pinit.INIT_MAKERS) == {"plummer", "plummer-virial", "disk",
                                      "collision"}
    p = cli.build_parser()
    for name in ("uniform", "plummer", "plummer-virial", "disk",
                 "collision"):
        assert p.parse_args(["run", "--init", name]).init == name


@pytest.mark.parametrize("name", ["plummer-virial", "disk", "collision"])
def test_presets_run_through_simulation(name):
    cfg = SimConfig(n_bodies=512, seed=1, dt=0.01, device="cpu")
    sim = Simulation(cfg, state=pinit.INIT_MAKERS[name](cfg))
    res = sim.run(n_steps=3, log_every=0)
    assert np.all(np.isfinite(_np(res.state.pos)))


@pytest.mark.parametrize("name", ["uniform", "plummer", "plummer-virial",
                                  "disk", "collision"])
def test_cli_run_and_validate_take_init(name, tmp_path, capsys):
    """run starts from the preset (its checkpoint's first state is the
    maker's); validate passes its short phase from it at a small dt."""
    ckpt = str(tmp_path / "c.npz")
    assert cli.main(["run", "--init", name, "--n", "200", "--steps", "2",
                     "--dt", "0.01", "--device", "cpu", "--checkpoint",
                     ckpt, "--quiet"]) == 0
    with np.load(ckpt) as z:
        assert np.isfinite(z["pos"]).all() and int(z["step"]) == 2
        if name != "uniform":
            start = pinit.INIT_MAKERS[name](SimConfig(n_bodies=200,
                                                      device="cpu"))
            np.testing.assert_array_equal(z["mass"], start.mass.numpy())
    rc = cli.main(["validate", "--init", name, "--n", "200", "--steps", "3",
                   "--dt", "0.001", "--long-steps", "0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Verification PASSED" in out


def test_cli_bench_keeps_the_uniform_box(capsys):
    assert cli.main(["bench", "--init", "disk", "--n", "128", "--steps",
                     "1", "--trials", "1", "--device", "cpu"]) == 0
    assert "uniform box" in capsys.readouterr().err
