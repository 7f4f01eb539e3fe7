"""The port's bounded dispatch (``prog_cap``): the program plan, the
bounded sweeps, the bounded step loop and the bounded mesh
(``parallel/multiprog.py``), the heartbeat, and their routing, against the
port's unbounded paths and the JAX package: the routing and plan cases of
``tests/test_mesh_multiprog.py`` and the bounded half of
``tests/test_flat_mode.py``.

A bounded evaluation runs the unbounded one's launches in groups, so every
bounded result must equal the unbounded one bit for bit (on one device,
and on 1, 2, 4 and 5 shards against the port's own ring).  Against the JAX
package's ``run_steps_multiprog`` (``pallas_sym`` in interpret mode, the
geometry of ``test_flat_mode.py``), from the same numpy state: per
component rel 1e-4 + 1e-6·max|x| after two steps.  JAX's sharded bounded
dispatch is not executed here (its CPU collectives abort test workers;
``tests/conftest.py``): the port's bounded mesh is held to its own ring
and to JAX's single-device bounded path.  ``should_use_multiprog`` and
``max_fused_steps`` are compared with JAX's on a grid up to 33.5M bodies,
plans only.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu_torch as nt
from conftest import make_small_system
from nbody_tpu.config import SimConfig as JaxSimConfig
from nbody_tpu.models.state import SimState as JaxSimState
from nbody_tpu.ops.forces_pallas_sym import \
    DEFAULT_PROG_CAP as JAX_DEFAULT_PROG_CAP
from nbody_tpu.ops.step import max_fused_steps as jax_max_fused_steps
from nbody_tpu.ops.step import prime_kdk as jax_prime_kdk
from nbody_tpu.ops.step import run_steps_multiprog as jax_run_multiprog
from nbody_tpu.ops.step import should_use_multiprog as jax_should_use_mp
from nbody_tpu_torch.bench_lib import run_benchmark
from nbody_tpu_torch.cli import main as cli_main
from nbody_tpu_torch.io.logger import RunLogger
from nbody_tpu_torch.models import simulation as sim_mod
from nbody_tpu_torch.models.simulation import Simulation, _ProgressHeartbeat
from nbody_tpu_torch.ops.forces_sym import (program_groups, rect_programs,
                                            sweep_programs)
from nbody_tpu_torch.ops.forces_sym_variants import (
    DEFAULT_PROG_CAP, forces_pallas_sym, forces_pallas_sym_chunked,
    forces_pallas_sym_chunked_flat, rect_forces_sym)
from nbody_tpu_torch.ops.step import (max_fused_steps, prime_kdk,
                                      run_steps, run_steps_multiprog,
                                      should_use_multiprog)
from nbody_tpu_torch.parallel.mesh import make_mesh
from nbody_tpu_torch.parallel.multiprog import (
    _ShardedBoundedForces, prime_kdk_sharded_multiprog,
    run_steps_sharded_multiprog)
from nbody_tpu_torch.parallel.ring import prime_kdk_sharded, run_steps_sharded

N = 1000
SIZES = (N, 3_464_101, 3_464_102, 1 << 22, 1 << 24, (1 << 24) + 1,
         33_554_432)
SYM_IMPLS = ("pallas_sym", "pallas_sym2", "pallas_sym_turbo",
             "pallas_sym_mxu", "pallas_sym_turbo2")
VARIANTS = ("vpu", "vpu2", "turbo", "mxu", "turbo2")
# The slots of one offset at N = 1000 (4 tiles of 256): the sweep then has
# two offset chunks to group.
SMALL_BUDGET = 24 * 1024


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Every case runs small sweeps on the CPU: torch's intra-op threads
    only contend with the other test workers' there."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _state(seed, n=N):
    pos, vel, mass = make_small_system(n, seed=seed)
    return nt.SimState(torch.from_numpy(pos), torch.from_numpy(vel),
                       torch.zeros(n, 3), torch.from_numpy(mass))


def _close(got, want, what):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 1e-4 * np.abs(w) + 1e-6 * np.abs(w).max()
    bad = np.abs(g - w) > tol
    assert not bad.any(), (f"{what}: {int(bad.sum())} components outside "
                           f"rel 1e-4 + 1e-6*max")


def _equal(a, b):
    for k in ("pos", "vel", "acc"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_default_cap_is_jax():
    assert DEFAULT_PROG_CAP == JAX_DEFAULT_PROG_CAP == 1.2e13


@pytest.mark.parametrize("impl", ["pallas_sym", "pallas_sym2",
                                  "pallas_sym_turbo", "pallas", "xla"])
def test_should_use_multiprog_and_max_fused_steps_equal_jax(impl):
    """The truth tables are JAX's, on one device and on meshes."""
    for n in SIZES:
        for cap in (None, 1e9, 1e15):
            for integrator in ("reference", "kdk", "yoshida4"):
                kw = dict(n_bodies=n, impl=impl, prog_cap=cap,
                          integrator=integrator)
                port, jax = nt.SimConfig(**kw), JaxSimConfig(**kw)
                assert max_fused_steps(port) == jax_max_fused_steps(jax), kw
                for p in (1, 4, 8):
                    assert (should_use_multiprog(port, impl, p)
                            == jax_should_use_mp(jax, impl, p)), (kw, p)


def test_program_plans():
    """A plan's interactions add up to N_pad^2; the 4M, 16.7M and 33.5M
    evaluations take 2, 24 and 94 programs under the default cap; a
    smaller cap never gives fewer programs."""
    for n, progs in ((1 << 22, 2), (1 << 24, 24), (1 << 25, 94)):
        chunks, groups = sweep_programs(n, DEFAULT_PROG_CAP)
        assert len(groups) == progs
        assert groups[0][0] == 0 and groups[-1][1] == len(chunks)
        assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    assert program_groups([3.0, 3.0, 5.0, 1.0, 9.0], 6.0) == [
        (0, 2), (2, 4), (4, 5)]
    assert program_groups([3.0, 3.0], None) == [(0, 2)]
    nb, w = 10, 256
    chunks, _ = sweep_programs(nb * w, None, slot_budget=24 * nb * w * 2)
    assert len(chunks) == 3      # five offsets, two a chunk
    counts = [len(sweep_programs(5000, cap, slot_budget=24 * 5120)[1])
              for cap in (1e9, 3e6, 1e5)]
    assert counts[0] <= counts[1] <= counts[2] and counts[2] > counts[0]
    chunks, groups = rect_programs(600, 3000, 1e6, slot_budget=24 * 768)
    assert len(chunks) == 12 and groups == [(k, k + 2)
                                            for k in range(0, 12, 2)]


def test_slot_ceiling():
    """One offset's slots must fit the 2 GiB budget: the sweep plans up to
    N_pad = 2^31 / 24 (89,478,400 bodies, whole tiles) and raises past
    it (the port's ceiling on one card; plans only)."""
    top = (2 ** 31 // 24) // 256 * 256
    chunks, groups = sweep_programs(top, DEFAULT_PROG_CAP)
    assert all(dc == 1 for _, dc in chunks) and len(groups) > 94
    with pytest.raises(ValueError, match="budget"):
        sweep_programs(top + 256, DEFAULT_PROG_CAP)


@pytest.mark.parametrize("variant", VARIANTS)
def test_bounded_forces_bitequal(variant):
    """``forces_pallas_sym_chunked`` in programs of one offset chunk each
    equals the unbounded sweep bit for bit; ``progress`` is called once a
    program; the flat entry returns the (3N,) view of the same bits."""
    s = _state(seed=61)
    calls = []
    got = forces_pallas_sym_chunked(
        s.pos, s.mass, 0.002, variant, max_prog_interactions=1.0,
        progress=lambda d, t, a: calls.append((d, t)),
        slot_budget=SMALL_BUDGET)
    want = forces_pallas_sym(s.pos, s.mass, 0.002, variant)
    assert torch.equal(got, want)
    assert calls == [(1, 2), (2, 2)]
    flat = forces_pallas_sym_chunked_flat(s.pos.reshape(-1), s.mass, 0.002,
                                          variant, slot_budget=SMALL_BUDGET)
    assert flat.shape == (3 * N,) and torch.equal(flat.view(N, 3), want)


@pytest.mark.parametrize("variant", ["vpu2", "vpu", "turbo2"])
def test_bounded_rect_bitequal(variant):
    """The rect sweep of the ring's cross rotations, in programs of one
    column chunk each, equals the unbounded one bit for bit."""
    a, b = _state(seed=62, n=600), _state(seed=63, n=700)
    calls = []
    got = rect_forces_sym(a.pos, a.mass, b.pos, b.mass, 0.002,
                          variant=variant, slot_budget=24 * 768,
                          max_prog_interactions=1.0,
                          progress=lambda d, t, acc: calls.append(d))
    want = rect_forces_sym(a.pos, a.mass, b.pos, b.mass, 0.002,
                           variant=variant)
    assert calls == [1, 2, 3]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("integrator", ["reference", "kdk", "yoshida4"])
def test_run_steps_multiprog_bitequal(integrator):
    """The bounded step loop (and prime) equals ``run_steps`` bit for
    bit."""
    cfg = nt.SimConfig(n_bodies=N, impl="pallas_sym2", prog_cap=10.0,
                       integrator=integrator, device="cpu")
    s = _state(seed=64)
    calls = []
    primed = prime_kdk(s, cfg, progress=lambda d, t, a: calls.append(d))
    assert calls == [1]
    assert torch.equal(primed.acc, prime_kdk(s, cfg.replace(prog_cap=None))
                       .acc)
    got = run_steps_multiprog(primed, cfg, 2,
                              progress=lambda d, t, a: calls.append(d))
    _equal(got, run_steps(primed, cfg, 2))
    weights = {"reference": 1, "kdk": 1, "yoshida4": 3}[integrator]
    assert len(calls) == 1 + 2 * weights
    with pytest.raises(ValueError, match="pallas_sym"):
        run_steps_multiprog(s, cfg, 1, impl="pallas")


@pytest.mark.parametrize("integrator", ["reference", "kdk"])
def test_run_steps_multiprog_matches_jax(integrator):
    """The port's bounded loop against JAX's ``run_steps_multiprog``
    (``pallas_sym`` in interpret mode) from the same arrays."""
    pos, vel, mass = make_small_system(N, seed=65)
    jcfg = JaxSimConfig(n_bodies=N, impl="pallas_sym", block_i=8,
                        block_u=128, panel_nb=3, prog_cap=5e5,
                        integrator=integrator)
    pcfg = nt.SimConfig(n_bodies=N, impl="pallas_sym", prog_cap=5e5,
                        integrator=integrator, device="cpu")
    js = JaxSimState(jnp.asarray(pos), jnp.asarray(vel),
                     jnp.zeros((N, 3), jnp.float32), jnp.asarray(mass))
    ps = nt.SimState(torch.from_numpy(pos), torch.from_numpy(vel),
                     torch.zeros(N, 3), torch.from_numpy(mass))
    if integrator != "reference":
        js, ps = jax_prime_kdk(js, jcfg), prime_kdk(ps, pcfg)
    jout = jax_run_multiprog(js, jcfg, 2)
    pout = run_steps_multiprog(ps, pcfg, 2)
    for k in ("pos", "vel", "acc"):
        _close(getattr(pout, k).numpy(), np.asarray(getattr(jout, k)), k)


@pytest.mark.parametrize("p", [5, 4, 2, 1])
def test_bounded_mesh_bitequal_ring(p):
    """A tiny cap gives every shard's sweep programs of their own; the
    bounded mesh equals the unbounded ring bit for bit at every parity,
    and its progress counts the plan's programs."""
    s = _state(seed=66)
    cfg = nt.SimConfig(n_bodies=N, impl="pallas_sym", device="cpu")
    mesh = make_mesh(p, "cpu")
    calls = []
    got = run_steps_sharded_multiprog(
        s, cfg, mesh, 2, impl="pallas_sym", max_prog_interactions=5e4,
        progress=lambda d, t, a: calls.append((d, t)))
    _equal(got, run_steps_sharded(s, cfg, mesh, 2, impl="pallas_sym",
                                  comm="ring"))
    total = _ShardedBoundedForces(cfg, mesh, "pallas_sym", 5e4).total_programs
    assert total == p * (1 + (p - 1) // 2 + (p % 2 == 0 and p > 1))
    assert calls == [(d, total) for d in range(1, total + 1)] * 2


def test_bounded_mesh_matches_jax_single_device():
    """The bounded mesh (4 shards, N not a multiple of the shards' tiles)
    against JAX's single-device bounded loop."""
    n = 900
    pos, vel, mass = make_small_system(n, seed=67)
    jcfg = JaxSimConfig(n_bodies=n, impl="pallas_sym", block_i=8,
                        block_u=128, panel_nb=3, prog_cap=5e5)
    js = JaxSimState(jnp.asarray(pos), jnp.asarray(vel),
                     jnp.zeros((n, 3), jnp.float32), jnp.asarray(mass))
    cfg = nt.SimConfig(n_bodies=n, impl="pallas_sym", device="cpu")
    got = run_steps_sharded_multiprog(
        _state(seed=67, n=n), cfg, make_mesh(4, "cpu"), 2,
        impl="pallas_sym", max_prog_interactions=5e4)
    assert got.n == n
    jout = jax_run_multiprog(js, jcfg, 2)
    for k in ("pos", "vel"):
        _close(getattr(got, k).numpy(), np.asarray(getattr(jout, k)), k)


def test_bounded_mesh_kdk_and_prime():
    """KDK on the bounded mesh equals the unbounded ring; a binding cap
    routes ``prime_kdk_sharded`` through the bounded mesh, bit-equal to
    the fused prime."""
    s = _state(seed=68)
    mesh = make_mesh(4, "cpu")
    cfg = nt.SimConfig(n_bodies=N, impl="pallas_sym", integrator="kdk",
                       prog_cap=5e4, device="cpu")
    calls = []
    primed = prime_kdk_sharded(s, cfg, mesh, impl="pallas_sym",
                               progress=lambda d, t, a: calls.append(t))
    assert calls and calls[-1] >= 2
    direct = prime_kdk_sharded_multiprog(s, cfg, mesh, impl="pallas_sym")
    fused = prime_kdk_sharded(s, cfg.replace(prog_cap=None), mesh,
                              impl="pallas_sym")
    assert torch.equal(primed.acc, direct.acc)
    assert torch.equal(primed.acc, fused.acc)
    _equal(run_steps_sharded_multiprog(primed, cfg, mesh, 2,
                                       impl="pallas_sym"),
           run_steps_sharded(primed, cfg, mesh, 2, impl="pallas_sym"))


def test_bad_comm_and_impl_raise():
    s = _state(seed=69, n=64)
    cfg = nt.SimConfig(n_bodies=64, impl="pallas_sym", device="cpu")
    mesh = make_mesh(2, "cpu")
    with pytest.raises(ValueError, match="ring"):
        run_steps_sharded_multiprog(s, cfg, mesh, 1, impl="pallas_sym",
                                    comm="allgather")
    with pytest.raises(ValueError, match="pallas_sym"):
        run_steps_sharded_multiprog(s, cfg, mesh, 1, impl="pallas")


def test_sharded_multiprog_auto_impl():
    """impl None / auto resolves to the exact tier pallas_sym2."""
    s = _state(seed=70, n=512)
    cfg = nt.SimConfig(n_bodies=512, prog_cap=5e4, device="cpu")
    mesh = make_mesh(4, "cpu")
    _equal(run_steps_sharded_multiprog(s, cfg, mesh, 2),
           run_steps_sharded(s, cfg, mesh, 2, impl="pallas_sym2"))


def test_simulation_routes_mesh_multiprog():
    """A binding prog_cap routes a ring mesh through the bounded mesh
    (its result the ring's); the default cap divides by the mesh size; the
    all-gather and K13 keep their fused sweeps."""
    s = _state(seed=71, n=512)
    cfg = nt.SimConfig(n_bodies=512, impl="pallas_sym", prog_cap=5e4,
                       device="cpu")
    mesh = make_mesh(4, "cpu")
    sim = Simulation(cfg, state=s, mesh=mesh)
    assert sim._use_multiprog and not sim._flat
    sim.run(n_steps=2, log_every=0)
    _equal(sim.state, run_steps_sharded(s, cfg, mesh, 2, impl="pallas_sym"))
    for comm in ("allgather", "rdma"):
        assert not Simulation(cfg, state=s, mesh=mesh,
                              comm=comm)._use_multiprog
    big = nt.SimConfig(n_bodies=4_000_000, impl="pallas_sym2")
    assert should_use_multiprog(big, "pallas_sym2", 1)
    assert not should_use_multiprog(big, "pallas_sym2", 8)
    plan = _ShardedBoundedForces(nt.SimConfig(n_bodies=33_554_432),
                                 make_mesh(8, "cpu"), "pallas_sym2", 1.2e13)
    assert plan.c == 33_554_432 // 8 and plan.total_programs > 8


def test_resident_and_bounded_routing():
    """A forced resident run keeps a cap that does not split one step; a
    cap that splits it (or the flat state) preempts and raises, as in the
    JAX package; auto in the resident window yields to the bounded
    dispatch."""
    n = 4096
    kw = dict(n_bodies=n, impl="pallas_sym2", device="cpu")
    sim = Simulation(nt.SimConfig(resident=True, prog_cap=1e15, **kw))
    assert sim._resident and not sim._use_multiprog
    with pytest.raises(ValueError, match="preempts"):
        Simulation(nt.SimConfig(resident=True, prog_cap=1e3, **kw))
    with pytest.raises(ValueError, match="preempts"):
        Simulation(nt.SimConfig(resident=True, flat_state=True, **kw))
    sim = Simulation(nt.SimConfig(prog_cap=1e3, **kw))
    assert sim._use_multiprog and not sim._resident


class _Lines:
    def __init__(self):
        self.lines = []

    def banner(self, text):
        self.lines.append(text)


def test_heartbeat_lines_and_syncs(monkeypatch):
    """The heartbeat prints every total // 10 programs and at the last,
    waits for the stream only when it prints, and stays silent below
    min_programs."""
    syncs = []
    monkeypatch.setattr(sim_mod, "sync_stream", lambda dev: syncs.append(1))
    log = _Lines()
    beat = _ProgressHeartbeat(log)
    acc = torch.zeros(3)
    for total in (24, 5, 24):
        for done in range(1, total + 1):
            beat(done, total, acc)
    assert len(log.lines) == 24 and len(syncs) == 24
    assert log.lines[0].startswith("  force eval: 2/24 programs (8%), ETA ")
    assert log.lines[11].startswith("  force eval: 24/24 programs (100%)")
    log2 = _Lines()
    beat2 = _ProgressHeartbeat(log2, sync_every=5)
    for done in range(1, 8):
        beat2(done, 7, acc)
    assert [ln.split()[2] for ln in log2.lines] == ["5/7", "7/7"]


def test_simulation_heartbeat_on_the_bounded_mesh():
    """A run whose evaluations span 6+ programs prints the heartbeat when
    its logger is not quiet, and removes its heartbeat afterwards."""
    buf = io.StringIO()
    cfg = nt.SimConfig(n_bodies=512, impl="pallas_sym2", prog_cap=5e4,
                       device="cpu")
    sim = Simulation(cfg, mesh=make_mesh(5, "cpu"),
                     logger=RunLogger(stream=buf))
    sim.run(n_steps=2, log_every=0)
    beats = [ln for ln in buf.getvalue().splitlines() if "force eval" in ln]
    assert len(beats) == 2 * 15 and beats[-1].strip().startswith(
        "force eval: 15/15 programs (100%)")
    assert sim.progress is None
    quiet = Simulation(cfg, mesh=make_mesh(5, "cpu"))
    quiet.run(n_steps=1, log_every=0)
    assert quiet.progress is None


def test_cli_prog_cap_run_with_services(tmp_path):
    """``run --prog-cap`` with a checkpoint a step, energy and frames
    equals the same run without the cap (its frames too); the 5-shard run
    prints the heartbeat."""
    out = {}
    for tag, extra in (("cap", ["--prog-cap", "5e4"]), ("none", [])):
        ckpt = str(tmp_path / f"{tag}.npz")
        frames = tmp_path / f"f_{tag}"
        buf = io.StringIO()
        from contextlib import redirect_stdout
        with redirect_stdout(buf):
            rc = cli_main(["run", "--n", "512", "--steps", "2", "--impl",
                           "pallas_sym2", "--shards", "5", "--checkpoint",
                           ckpt, "--checkpoint-every", "1", "--energy",
                           "--viz", "--viz-dir", str(frames),
                           "--device", "cpu", *extra])
        assert rc == 0
        out[tag] = (np.load(ckpt)["pos"], buf.getvalue(),
                    sorted(p.read_bytes() for p in frames.iterdir()))
    np.testing.assert_array_equal(out["cap"][0], out["none"][0])
    assert "force eval: 15/15" in out["cap"][1]
    assert "force eval" not in out["none"][1]
    assert len(out["cap"][2]) == 2 and out["cap"][2] == out["none"][2]


def test_cli_save_trajectory_streams_under_cap(tmp_path):
    """Under a binding cap ``--save-trajectory`` steps through the bounded
    chunks and streams ``snap_*`` entries, equal to the unbounded
    trajectory; the result renders and analyzes."""
    traj, plain = str(tmp_path / "t.npz"), str(tmp_path / "p.npz")
    common = ["run", "--n", "600", "--steps", "4", "--impl", "pallas_sym",
              "--snap-every", "2", "--device", "cpu", "--quiet"]
    assert cli_main(common + ["--prog-cap", "5e4", "--save-trajectory",
                              traj]) == 0
    assert cli_main(common + ["--save-trajectory", plain]) == 0
    from nbody_tpu_torch.io.checkpoint import load_trajectory
    snaps, mass, every = load_trajectory(traj)
    ref, _, _ = load_trajectory(plain)
    assert len(snaps) == 2 and every == 2 and mass.shape == (600,)
    with np.load(traj) as z:
        assert "snap_000001" in z.files
    for k in range(2):
        np.testing.assert_array_equal(snaps[k], ref[k])
    assert cli_main(["render", traj, "--out-dir", str(tmp_path / "r"),
                     "--width", "64", "--height", "48",
                     "--device", "cpu"]) == 0
    assert len(list((tmp_path / "r").iterdir())) == 2
    assert cli_main(["analyze", traj, "--bins", "8", "--json"]) == 0


@pytest.mark.parametrize("kw", [{"prog_cap": 1e5}, {"flat_state": True},
                                {"prog_cap": 1e5, "shards": 3}])
def test_bench_bounded_and_flat(kw):
    """The bench's bounded, flat and bounded-mesh routes run, report
    their route, and end finite."""
    res = run_benchmark(n=600, steps=1, trials=1, impl="pallas_sym2",
                        device="cpu", **kw)
    assert res["finite"] and res["flat"] is bool(kw.get("flat_state"))
    assert res["shards"] == kw.get("shards", 1) and not res["resident"]
