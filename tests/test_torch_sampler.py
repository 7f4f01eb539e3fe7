"""A seeded sampler of the routes both packages take: about 40 draws of
(N, impl, integrator, dtype, x64, resident, flat_state, prog_cap, block_i,
block_j, block_u, shards, comm, steps, init preset, checkpoint-resume),
fixed at collection by ``numpy.random.default_rng(27)``, each a case whose
id spells the draw out.  The draws come from ``chip_smoke.sampler_draws``,
the generator the card's sampler draws from, at the CPU's sizes.

Each draw starts both packages from the same seeded numpy state (the
port's preset, on the CPU) and drives each through its ``Simulation``, the
layer that routes a run to the resident kernels, the flat state, the
bounded dispatch, the per-step loop or the mesh (``parallel/ring.py``,
K13's ``rdma`` comms, the bounded mesh); with ``resume`` it runs half the
steps, writes a checkpoint, resumes it and runs the rest.  JAX runs its
Pallas kernels in interpret mode (off the TPU, as its own tests do), the
port its kernels' plain versions.  Then:

- the end states (pos, vel, acc) agree at the tier's tolerance against
  JAX (``tests/test_torch_ring.py``'s ``TOLS``: exact rel 1e-4 +
  1e-6·max, tensor-core tiers 1e-3 + 1e-4·max, K12 5e-3 + 1e-4·max;
  float64 with x64 on 1e-9 + 1e-12·max; a bfloat16 state at
  ``tests/test_torch_bf16.py``'s parity tolerance, 2^-6·max), plus four
  times the draw's own sensitivity: the spread between the port's run
  and its run from the start moved by one unit in the last place (the
  presets' close pairs amplify rounding within three steps);
- the port's first force evaluation meets the tier's gate against the
  float64 numpy oracle (``FIRST_GATES``), or, where a few hundred bodies
  are too few for the tier's statistic and JAX's own first evaluation of
  the draw misses the gate too, is no further off than JAX's; a bfloat16
  state no further off than JAX's bfloat16 evaluation, within the bf16
  parity tolerance;
- where JAX raises, the port raises the same exception class (a draw both
  reject passes).

Where a draw lands on a difference by design (``ROADMAP.md`` Queue 3), it
is held against float64 alone and its id ends with the difference:
``design-bf16-resume`` (the JAX loader cannot read its own bf16
checkpoint), ``design-k12-close`` (a pair under K12's close-pair test at
some evaluation of the run: JAX's centred distance is wrong there, the
port takes the direct one) and ``design-jax-dtype-check`` (a bfloat16 or
float64 state given a Pallas impl on the mesh or the bounded dispatch:
JAX's check of the kernels' float32 contract sits in ``compute_forces``,
which those paths skip, so JAX runs the state in interpret mode or fails
inside the kernel; the port refuses it with the per-step path's
``ValueError``).  No draw is filtered out.  The other differences of that
list (real massless bodies on the mass-scaled sym tiers and K13, K15's
padding, validate's cold-start gates) need a massless body, an ablation
or validate, which no draw reaches.

Two draws of three are made to fit (``chip_smoke.sampler_fit``: a
forced mode on an impl it serves, K13's comms on theirs); the third keeps its combination, a
refusal both packages must make.  Mesh draws (2, 3, 5 or 8 shards of the
8 virtual CPU devices, against the port's ``make_mesh(p, "cpu")``) keep
the conftest's envelope: at most 128 bodies a device and 1–2 steps.  The file's cost: under 90 s of worker
time, no case above 20 s (the block sizes drawn are JAX's; the port's
tiles are fixed, and the tensor-core tiers and K12 are given JAX's tiles
at the port's tile sizes, where their per-tile corrections group alike).
The last test keeps the fault the card's sampler found: a resident
``pallas_sym`` KDK run's resume.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import nbody_tpu_torch as nt
from nbody_tpu import SimConfig as JaxSimConfig
from nbody_tpu import SimState as JaxSimState
from nbody_tpu.io.checkpoint import save_checkpoint as jax_save
from nbody_tpu.models.simulation import Simulation as JaxSimulation
from nbody_tpu.oracle.numpy_oracle import oracle_forces, relative_mismatch
from nbody_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nbody_tpu_torch.models.init import INIT_MAKERS
from nbody_tpu_torch.ops.forces_fast import FAST_TILE_J, close_pairs
from nbody_tpu_torch.ops.forces_tiled_tc import TC_TILE_J
from nbody_tpu_torch.parallel.mesh import make_mesh

N_DRAWS = 40
IMPLS = chip_smoke.SAMPLER_IMPLS
INTEGRATORS = chip_smoke.SAMPLER_INTEGRATORS
COMMS = chip_smoke.SAMPLER_COMMS
INITS = chip_smoke.SAMPLER_INITS
PALLAS = chip_smoke.SAMPLER_PALLAS
SYM_IMPLS = chip_smoke.SAMPLER_SYM
# The CPU's sizes: N up to 700 on one device; 2, 3, 5 or 8 shards of the
# 8 virtual CPU devices at most 128 bodies a device; bfloat16 states too.
N_MAX, PER_DEVICE = 700, 128
SHARDS = (None, None, 2, 3, 5, 8)
DTYPES = ("float32",) * 4 + ("bfloat16", "float64")
TC = ("pallas_turbo", "pallas_mxu", "pallas_sym_turbo", "pallas_sym_turbo2",
      "pallas_sym_mxu")
# Against JAX, (rel, floor of the largest |x|) a component.
EXACT_TOL, TC_TOL, FAST_TOL = (1e-4, 1e-6), (1e-3, 1e-4), (5e-3, 1e-4)
F64_TOL, BF16_TOL = (1e-9, 1e-12), (0.0, 2.0 ** -6)
# The first evaluation against float64: (p99 of the relative error or
# None, the largest fraction of components outside 1% with a 1e-4 floor):
# chip_smoke.py's TIER_GATES, validate's acc allowance for the exact
# paths and JAX's ring gate for K12 on unsorted bodies.  A bfloat16 state
# computes in bfloat16 on both sides (up to ~1e-1 of the largest |a| off
# float64 in either package): its largest error may exceed the JAX
# package's on the same draw by the bf16 parity tolerance, 2^-6 of the
# largest |a|.
FIRST_GATES = {"pallas_turbo": (5e-2, 0.1), "pallas_sym_turbo": (5e-2, 0.1),
               "pallas_sym_turbo2": (5e-2, 0.1), "pallas_mxu": (None, 1e-3),
               "pallas_sym_mxu": (5e-3, 5e-3), "pallas_fast": (None, 2e-3)}
EXACT_GATE = (None, 5e-4)


def _start(d):
    """The draw's seeded numpy state: the port's preset on the CPU."""
    cfg = nt.SimConfig(n_bodies=d["n"], seed=d["seed"], device="cpu")
    state = INIT_MAKERS.get(d["init"], nt.init_state)(cfg)
    return {k: v.numpy().copy() for k, v in state._asdict().items()}


def _k12_close(d):
    """Whether a float32 K12 draw puts a pair under the close-pair test
    at any force evaluation of its run (the trajectory followed on the
    plain ``xla_nxn`` path, which K12's stays within rounding of)."""
    from nbody_tpu_torch.ops.forces import compute_forces
    from nbody_tpu_torch.ops.step import _advance, prime_kdk
    s = _start(d)
    cfg = nt.SimConfig(n_bodies=d["n"], impl="xla_nxn",
                       integrator=d["integrator"], device="cpu")
    state = nt.SimState(*(torch.from_numpy(s[k])
                          for k in ("pos", "vel", "acc", "mass")))
    seen = []

    def forces(pos):
        close = close_pairs(pos, pos, state.mass, cfg.eps2)
        close.fill_diagonal_(False)
        seen.append(bool(close.any()))
        return compute_forces(pos, state.mass, cfg, impl="xla_nxn")
    if d["integrator"] != "reference":
        state = prime_kdk(state, cfg, impl="xla_nxn")
        forces(state.pos)
    for _ in range(d["steps"]):
        state = _advance(state, cfg, forces)
    return any(seen)


def _design(d):
    """The documented difference by design a draw lands on, or None."""
    if d["dtype"] != "float32" and d["impl"] in PALLAS and (
            d["shards"] or (d["impl"] in SYM_IMPLS
                            and (d["prog_cap"] is not None
                                 or d["flat_state"]))):
        return "jax-dtype-check"
    if d["dtype"] == "bfloat16" and d["resume"]:
        return "bf16-resume"
    if d["impl"] == "pallas_fast" and d["dtype"] == "float32" and _k12_close(
            d):
        return "k12-close"
    return None


def _draws():
    """The sampler's draws at the CPU's sizes, two of three fitted, each
    id ending with the difference by design it lands on, if any."""
    draws = chip_smoke.sampler_draws(N_DRAWS, n_max=N_MAX,
                                     per_device=PER_DEVICE, shards=SHARDS,
                                     dtypes=DTYPES, fixed_n=(), every=False)
    for d in draws:
        d["design"] = _design(d)
        if d["design"]:
            d["id"] += f"-design-{d['design']}"
    return draws


DRAWS = _draws()


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small sweeps on the CPU: torch's intra-op threads only contend
    with the other test workers' there."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture
def x64(request):
    """JAX's x64 mode as the draw asks (on for some float64 draws, off
    otherwise), put back after it."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", request.node.callspec.params["d"]
                      ["x64"])
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _jax_blocks(d):
    """JAX's tiles for the draw: the drawn ones, or for the tensor-core
    tiers and K12 the port's (their per-tile corrections group by tile)."""
    if d["impl"] in ("pallas_turbo", "pallas_mxu"):
        return {"block_i": 256, "block_j": TC_TILE_J, "block_u": 256}
    if d["impl"] == "pallas_fast":
        return {"block_i": 256, "block_j": FAST_TILE_J, "block_u": 256}
    if d["impl"] in TC:
        return {"block_i": 256, "block_j": 256, "block_u": 256}
    return {k: d[k] for k in ("block_i", "block_j", "block_u")}


def _cfg_fields(d):
    return dict(n_bodies=d["n"], impl=d["impl"], integrator=d["integrator"],
                dtype=d["dtype"], resident=d["resident"],
                flat_state=d["flat_state"], prog_cap=d["prog_cap"],
                seed=d["seed"], chunk=64)


def _arrays(state):
    """(pos, vel, acc) of a state as float64 (N, 3) host arrays."""
    out = []
    for k in ("pos", "vel", "acc"):
        x = getattr(state, k)
        if isinstance(x, torch.Tensor):
            x = x.detach().float() if x.dtype == torch.bfloat16 else x
            x = x.numpy()
        out.append(np.asarray(x, dtype=np.float64).reshape(-1, 3))
    return out


def _run(resume, sim, d, path, save, **kw):
    """``d['steps']`` steps of ``sim``, or half, a checkpoint, a resume
    and the rest."""
    if not d["resume"]:
        sim.run(d["steps"])
        return sim.state
    half = max(1, d["steps"] // 2)
    sim.run(half)
    save(path, sim.state, half, sim.cfg)
    sim = resume(path, **kw)
    if d["steps"] > half:
        sim.run(d["steps"] - half)
    return sim.state


def run_jax(d, start, path, first_only=False):
    cfg = JaxSimConfig(**_cfg_fields(d), **_jax_blocks(d))
    dt = {"float32": jnp.float32, "float64": jnp.float64,
          "bfloat16": jnp.bfloat16}[d["dtype"]]
    state = JaxSimState(*(jnp.asarray(start[k], dtype=dt)
                          for k in ("pos", "vel", "acc", "mass")))
    mesh = jax_make_mesh(d["shards"]) if d["shards"] else None
    kw = {"mesh": mesh, "comm": d["comm"] or "ring"}
    sim = JaxSimulation(cfg, state, **kw)
    if first_only:
        if d["integrator"] == "reference":
            sim.run(1)
        return sim.state
    return _run(JaxSimulation.resume, sim, d, path, jax_save, **kw)


def run_port(d, start, path, first_only=False):
    cfg = nt.SimConfig(**_cfg_fields(d), device="cpu")
    state = nt.SimState(*(torch.from_numpy(start[k]).to(cfg.torch_dtype)
                          for k in ("pos", "vel", "acc", "mass")))
    mesh = make_mesh(d["shards"], "cpu") if d["shards"] else None
    kw = {"mesh": mesh, "comm": d["comm"] or "ring"}
    sim = nt.Simulation(cfg, state, **kw)
    if first_only:
        # The first force evaluation: the KDK prime's, or the first
        # reference step's.
        if d["integrator"] == "reference":
            sim.run(1)
        return sim.state
    return _run(lambda p, **k: nt.Simulation.resume(p, device="cpu", **k),
                sim, d, path, nt.save_checkpoint, **kw)


def _tol(d):
    if d["dtype"] == "float64":
        return F64_TOL if d["x64"] else EXACT_TOL
    if d["dtype"] == "bfloat16":
        return BF16_TOL
    if d["impl"] == "pallas_fast":
        return FAST_TOL
    return TC_TOL if d["impl"] in TC else EXACT_TOL


def _first_gate(d):
    return FIRST_GATES.get(d["impl"], EXACT_GATE)


def _nudged(d, start):
    """The start with every position moved by about one unit in the last
    place of the draw's dtype (float32's for float64: JAX without x64
    holds float32)."""
    step = 2.0 ** -7 if d["dtype"] == "bfloat16" else 2.0 ** -23
    return dict(start, pos=(start["pos"] * (1 + step)).astype(np.float32))


def _first_numbers(first, ref):
    """(p99 of the relative error, fraction of components outside 1% with
    a 1e-4 floor, largest error over the largest |a|)."""
    p99 = float(np.percentile(np.abs(first - ref) / (np.abs(ref) + 1e-30),
                              99))
    return (p99, float(relative_mismatch(first, ref, 0.01, 1e-4).mean()),
            float(np.abs(first - ref).max() / np.abs(ref).max()))


def _first_evaluation_meets_the_gate(d, start):
    """The port's first evaluation against float64 at the tier's gate.  A
    bfloat16 state, and a float32 draw whose evaluation misses the gate
    (a few hundred components are too few for a tier's statistics), are
    held to the JAX package's own first evaluation of the draw: JAX must
    miss the same gate, and the port must be no further off than it (the
    p99 within 5%, no more components outside 1%, for bf16 the largest
    error within the parity tolerance)."""
    first = _arrays(run_port(d, start, None, first_only=True))[2]
    dtype = nt.SimConfig(dtype=d["dtype"]).torch_dtype
    pos0, mass = (torch.from_numpy(start[k]).to(dtype).double().numpy()
                  for k in ("pos", "mass"))
    ref = oracle_forces(pos0, mass, 0.002)
    p99_gate, frac_gate = _first_gate(d)
    p99, frac, worst = _first_numbers(first, ref)
    bf16 = d["dtype"] == "bfloat16"
    if not bf16 and frac <= frac_gate and (p99_gate is None
                                           or p99 < p99_gate):
        return
    assert d["design"] != "k12-close", f"first evaluation: {p99}, {frac}"
    j99, jfrac, jworst = _first_numbers(_arrays(run_jax(
        dict(d, resume=False), start, None, first_only=True))[2], ref)
    if bf16:
        assert worst <= jworst + BF16_TOL[1], (worst, jworst)
        return
    assert jfrac > frac_gate or (p99_gate is not None and j99 >= p99_gate), (
        f"first evaluation: p99 {p99:.3e}, {frac:.3e} outside 1%; JAX "
        f"meets the gate ({j99:.3e}, {jfrac:.3e})")
    assert frac <= jfrac and p99 <= 1.05 * j99, (p99, frac, j99, jfrac)


@pytest.mark.parametrize("d", DRAWS, ids=[d["id"] for d in DRAWS])
def test_sampled_route_matches_jax_and_float64(d, x64, tmp_path):
    start = _start(d)
    if d["design"] == "jax-dtype-check":
        # JAX's mesh and bounded paths skip compute_forces' dtype
        # check; the port refuses a kernel's non-float32 state there as
        # on the per-step path, as JAX's per-step path does.
        with pytest.raises(ValueError, match="float32 only"):
            run_port(d, start, str(tmp_path / "p.npz"))
        return
    # A bf16 draw with a resume: JAX runs it without the resume, for
    # its refusals only (its loader cannot read the checkpoint).
    jd = dict(d, resume=False) if d["design"] == "bf16-resume" else d
    jax_err = want = None
    try:
        want = _arrays(run_jax(jd, start, str(tmp_path / "j.npz")))
    except Exception as e:  # noqa: BLE001 -- compared below
        jax_err = e
    if jax_err is not None:
        with pytest.raises(type(jax_err)):
            run_port(d, start, str(tmp_path / "p.npz"))
        return
    got = _arrays(run_port(d, start, str(tmp_path / "p.npz")))
    for a in got:
        assert np.isfinite(a).all()
    if d["design"] is None:
        # The draw's own sensitivity: the same route from the start
        # moved by one unit in the last place.  Up to 4x that spread
        # is the trajectory's, not the port's.
        spread = [np.abs(g - n) for g, n in zip(got, _arrays(run_port(
            d, _nudged(d, start), str(tmp_path / "n.npz"))))]
        rel, floor = _tol(d)
        for k, g, w, sp in zip(("pos", "vel", "acc"), got, want,
                               spread):
            bad = relative_mismatch(g, w, rel,
                                    floor * np.abs(w).max() + 4 * sp)
            assert bad.sum() == 0, (
                f"{k}: {int(bad.sum())}/{bad.size} components differ "
                f"from JAX; max rel "
                f"{np.abs(g - w).max() / np.abs(w).max():.3e}")
    _first_evaluation_meets_the_gate(d, start)


def test_draws_are_fixed_and_cover_every_axis():
    """The draws come out the same on every collection (the pass count
    must not move between runs), and together they take every impl,
    integrator, dtype (float64 with x64 on and off), comm, shard count,
    preset, resident and flat setting, a binding and a non-binding cap,
    a resume, and N at a prime, at tile +- 1 and odd."""
    assert [d["id"] for d in _draws()] == [d["id"] for d in DRAWS]
    assert len(DRAWS) == N_DRAWS

    def seen(key, where=lambda d: True):
        return {d[key] for d in DRAWS if where(d)}
    assert seen("impl") == set(IMPLS)
    assert set(PALLAS) <= seen("impl", lambda d: d["dtype"] == "float32")
    assert seen("integrator") == set(INTEGRATORS)
    assert seen("dtype") == {"float32", "bfloat16", "float64"}
    assert seen("x64", lambda d: d["dtype"] == "float64") == {True, False}
    assert seen("comm", lambda d: d["shards"]) == set(COMMS)
    assert seen("shards") == set(SHARDS)
    assert seen("init") == set(INITS)
    assert seen("resident") == {None, True, False}
    assert seen("flat_state") == {None, True, False}
    assert seen("resume") == {True, False}
    caps = [(d["prog_cap"], float(d["n"]) ** 2 / (d["shards"] or 1))
            for d in DRAWS if d["prog_cap"] is not None]
    assert any(c < n2 for c, n2 in caps) and any(c >= n2 for c, n2 in caps)
    ns = seen("n")
    assert any(n in chip_smoke.sampler_primes(2, 1024) for n in ns)
    assert any(n % 128 in (1, 127) for n in ns)
    assert any(n % 2 for n in ns)
    assert all(d["n"] <= PER_DEVICE * d["shards"] and d["steps"] <= 2
               for d in DRAWS if d["shards"])


@pytest.mark.parametrize("impl", ["pallas_sym", "pallas_sym2"])
@pytest.mark.parametrize("integrator", ["kdk", "yoshida4"])
def test_resident_kdk_resume_repeats_the_uninterrupted_run(impl, integrator,
                                                           tmp_path):
    """The card's sampler found a resident ``pallas_sym`` KDK run whose
    resume left the uninterrupted run's bits: the resident kernels sum as
    K2 does for both impls they serve, and the prime (again at a resume)
    took ``pallas_sym``'s own tile.  A resident run now primes on K2, so
    half the steps, a checkpoint, a resume and the rest end bit-equal to
    the run that never stopped (here on the plain versions)."""
    d = {"n": 300, "impl": impl, "integrator": integrator,
         "dtype": "float32", "resident": True, "flat_state": None,
         "prog_cap": None, "seed": 5, "shards": None, "comm": None,
         "steps": 4, "resume": False, "init": "uniform"}
    start = _start(d)
    once = run_port(d, start, None)
    resumed = run_port(dict(d, resume=True), start, str(tmp_path / "r.npz"))
    for k in ("pos", "vel", "acc"):
        assert torch.equal(getattr(once, k), getattr(resumed, k)), k
