"""``Simulation.run(sort_every=...)`` and ``run --sort-every`` of the port
on the CPU against the JAX package's from the same numpy arrays, the
sort cadence (sorted first, then after every ``sort_every`` steps, after
that step's checkpoint), a checkpoint and resume across a sort boundary,
and the forced resident path under ``impl="auto"``.

A sort permutes body identity, and a position that lies within rounding
of a Morton cell boundary may sort differently in the two packages, so
final states are compared body by body in mass order (masses are drawn
at random, distinct, and never change).  Tolerances: the 1% gate with
the slice tests' absolute floors (1.0 for positions, 1e-2 for
velocities); resume against one uninterrupted run: bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu_torch as nt
from conftest import make_small_system
from nbody_tpu import SimConfig as JaxSimConfig
from nbody_tpu import SimState as JaxSimState
from nbody_tpu.models.simulation import Simulation as JaxSimulation
from nbody_tpu.models.state import state_to_numpy as jax_state_to_numpy
from nbody_tpu.oracle.numpy_oracle import assert_matches_oracle
from nbody_tpu_torch import cli
from nbody_tpu_torch.io import checkpoint as port_ckpt
from nbody_tpu_torch.models import simulation as port_simulation

N = 256


def _arrays(seed, n=N):
    pos, vel, mass = make_small_system(n, seed=seed)
    vel = np.random.default_rng(seed).normal(0, 50, (n, 3)).astype(
        np.float32)
    return {"pos": pos, "vel": vel, "acc": np.zeros_like(pos), "mass": mass}


def _jax_state(arrays):
    return JaxSimState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _by_mass(host):
    order = np.argsort(host["mass"])
    return {k: v[order] for k, v in host.items()}


def assert_same_bodies(got, want):
    got, want = _by_mass(got), _by_mass(want)
    np.testing.assert_array_equal(got["mass"], want["mass"])
    assert_matches_oracle(got["pos"], want["pos"], "pos", abs_tol=1.0)
    assert_matches_oracle(got["vel"], want["vel"], "vel", abs_tol=1e-2)


@pytest.mark.parametrize("impl,integrator", [("pallas_fast", "reference"),
                                             ("xla_nxn", "kdk")])
def test_sort_every_matches_jax(impl, integrator):
    arrays = _arrays(seed=131)
    jax_cfg = JaxSimConfig(n_bodies=N, impl=impl, integrator=integrator,
                           block_i=128, block_j=128, resident=False)
    jax_res = JaxSimulation(jax_cfg, state=_jax_state(arrays)).run(
        n_steps=5, log_every=0, sort_every=2)
    cfg = nt.SimConfig(n_bodies=N, impl=impl, integrator=integrator,
                       device="cpu")
    sim = nt.Simulation(cfg, state=nt.state_from_numpy(arrays, device="cpu"))
    res = sim.run(n_steps=5, log_every=0, sort_every=2)
    assert res.steps_run == 5 and sim.step_count == 5
    got = nt.state_to_numpy(res.state)
    assert_same_bodies(got, jax_state_to_numpy(jax_res.state))
    # Sorted at step 4 (the last sort), then one step: nearly Z-ordered.
    assert not np.array_equal(got["mass"], arrays["mass"])


def test_sorts_at_start_and_on_the_cadence(monkeypatch):
    """7 steps at sort_every=3, logged every 2: sorts before the first
    chunk and after steps 3 and 6 (none after the last step); chunks end
    on the sort steps."""
    calls, chunks = [], []
    real_sort = port_simulation.morton_sort_state

    def counting_sort(state, lower, upper):
        calls.append(sim.step_count)
        assert (lower, upper) == (-sim.cfg.max_pos, sim.cfg.max_pos)
        return real_sort(state, lower, upper)

    monkeypatch.setattr(port_simulation, "morton_sort_state", counting_sort)
    sim = nt.Simulation(nt.SimConfig(n_bodies=64, device="cpu"),
                        state=nt.state_from_numpy(_arrays(132, 64),
                                                  device="cpu"))
    run_chunk = sim._run_chunk
    monkeypatch.setattr(sim, "_run_chunk",
                        lambda n: (chunks.append(n), run_chunk(n)))
    sim.run(n_steps=7, log_every=2, sort_every=3)
    assert calls == [0, 3, 6]
    assert chunks == [2, 1, 2, 1, 1]


def test_resume_across_a_sort_boundary_equals_one_run(tmp_path):
    """The checkpoint of step 4 is written before that step's sort; the
    resumed run sorts first, so 4 + 2 steps equal 6 steps bit for bit."""
    arrays = _arrays(seed=133)
    cfg = nt.SimConfig(n_bodies=N, impl="pallas_fast", device="cpu")
    one = nt.Simulation(cfg, state=nt.state_from_numpy(arrays, device="cpu"))
    one.run(n_steps=6, log_every=0, sort_every=2)
    path = str(tmp_path / "c.npz")
    first = nt.Simulation(cfg, state=nt.state_from_numpy(arrays,
                                                         device="cpu"))
    first.run(n_steps=4, log_every=0, checkpoint_path=path,
              checkpoint_every=4, sort_every=2)
    assert port_ckpt.load_checkpoint_meta(path)[0] == 4
    again = nt.Simulation.resume(path, cfg=cfg, overrides={})
    again.run(n_steps=2, log_every=0, sort_every=2)
    assert again.step_count == 6
    for k in ("pos", "vel", "acc", "mass"):
        assert torch.equal(getattr(again.state, k), getattr(one.state, k)), k


def test_cli_run_sort_every_on_cpu(tmp_path, capsys):
    """``run --impl pallas_fast --sort-every K`` (the documented way to run
    K12) on the CPU, against the JAX package's run from the same
    checkpoint."""
    arrays = _arrays(seed=134)
    start = str(tmp_path / "start.npz")
    jax_cfg = JaxSimConfig(n_bodies=N, impl="pallas_fast", block_j=128,
                           block_i=128)
    port_ckpt.save_checkpoint(start, nt.state_from_numpy(arrays,
                                                         device="cpu"),
                              0, nt.SimConfig(n_bodies=N, impl="pallas_fast",
                                              device="cpu"))
    out = str(tmp_path / "out.npz")
    assert cli.main(["run", "--resume", start, "--steps", "4",
                     "--sort-every", "2", "--checkpoint", out,
                     "--device", "cpu"]) == 0
    assert "impl=pallas_fast" in capsys.readouterr().out
    jax_res = JaxSimulation(jax_cfg, state=_jax_state(arrays)).run(
        n_steps=4, log_every=0, sort_every=2)
    with np.load(out) as z:
        got = {k: z[k] for k in ("pos", "vel", "acc", "mass")}
        assert int(z["step"]) == 4
    assert_same_bodies(got, jax_state_to_numpy(jax_res.state))


def test_forced_resident_auto_run_matches_jax(capsys):
    """``Simulation(impl="auto", resident=True)`` at N=512 runs the
    resident path on the CPU (its plain twin) and matches the JAX
    package's resident run from the same arrays; ``run --resident on``
    works at N=512 (``resolve_impl`` itself: the ``resident`` cases of
    ``tests/test_torch_config.py``)."""
    n = 512
    arrays = _arrays(seed=135, n=n)
    jax_res = JaxSimulation(JaxSimConfig(n_bodies=n, resident=True),
                            state=_jax_state(arrays)).run(n_steps=3,
                                                          log_every=0)
    sim = nt.Simulation(nt.SimConfig(n_bodies=n, resident=True,
                                     device="cpu"),
                        state=nt.state_from_numpy(arrays, device="cpu"))
    assert sim.impl == "pallas_sym2" and sim._resident
    got = nt.state_to_numpy(sim.run(n_steps=3, log_every=0).state)
    want = jax_state_to_numpy(jax_res.state)
    assert_matches_oracle(got["pos"], want["pos"], "pos", abs_tol=1.0)
    assert_matches_oracle(got["vel"], want["vel"], "vel", abs_tol=1e-2)
    assert cli.main(["run", "--n", "512", "--steps", "2", "--resident", "on",
                     "--device", "cpu"]) == 0
    assert "(resident)" in capsys.readouterr().out
