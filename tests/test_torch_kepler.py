"""The port's closed-form two-body gates (``nbody_tpu_torch/models/kepler.py``)
on the CPU: the closed forms against ``nbody_tpu.models.kepler``'s in
float64, the gates through the kernels' plain twins against the JAX
package's (Pallas in interpret mode), the split form that reaches the
pair-symmetric impls' pair tile, the order / half-force / momentum /
reversibility properties of ``tests/test_kepler.py`` through the port's
``run_steps``, ``validate --analytic``, and ``chip_smoke.py``'s table of
the JAX package's figures.

Tolerances: the closed forms 1e-12 (float64 on both sides).  A float32
gate error against the JAX package's: |port - JAX| <= 5% of JAX's + 5e-5,
the gates' own float32 noise term: the float32 errors of both packages
carry rounding noise on top of the discretization error
(``tests/kepler_jax_figures.py``).  The verdicts must be equal.
"""

import math
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from kepler_jax_figures import (NOISE_OFFSETS, PAIR_IMPLS, SPLIT_IMPLS,
                                jax_gates)
from nbody_tpu.models import kepler as jk
from nbody_tpu_torch import SimConfig, cli
from nbody_tpu_torch.models import kepler as pk
from nbody_tpu_torch.models.energy import energy_f64
from nbody_tpu_torch.ops.step import prime_kdk, run_steps

GATES = ["circular/reference", "circular/kdk", "circular/yoshida4",
         "elliptic(e=0.6)/kdk", "elliptic(e=0.6)/yoshida4"]
CLOSED_FORM_TOL = 1e-12
ERR_REL, ERR_ABS = 0.05, 5e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The gates run thousands of small steps: torch's intra-op threads
    only contend with the other test workers' there."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture()
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _np(state):
    return [np.asarray(x, dtype=np.float64) for x in
            (state.pos, state.vel, state.acc, state.mass)]


def test_closed_forms_match_jax(x64):
    for integ in ("reference", "kdk"):
        for d, eps2 in ((1.0, 0.01), (2.5, 0.0)):
            assert pk.circular_omega(d, 1.5, eps2, integ) == pytest.approx(
                jk.circular_omega(d, 1.5, eps2, integ), rel=CLOSED_FORM_TOL)
        ps, pw = pk.two_body_circular(1.0, 1.0, 0.5, 0.01, integ, "float64",
                                      device="cpu")
        js, jw = jk.two_body_circular(1.0, 1.0, 0.5, 0.01, integ, "float64")
        assert ps.pos.dtype == torch.float64 and ps.pos.device.type == "cpu"
        assert pw == pytest.approx(jw, rel=CLOSED_FORM_TOL)
        for a, b in zip(_np(ps), _np(js)):
            np.testing.assert_allclose(a, b, rtol=CLOSED_FORM_TOL, atol=0)
        for t in (0.0, 0.7, 13.1):
            np.testing.assert_allclose(
                pk.circular_positions(t, 1.0, 1.0, 0.5, 0.01, integ),
                jk.circular_positions(t, 1.0, 1.0, 0.5, 0.01, integ),
                rtol=0, atol=CLOSED_FORM_TOL)
    for e in (0.0, 0.6, 0.95):
        ps, pp = pk.two_body_elliptic(1.0, e, 1.0, 0.5, "float64",
                                      device="cpu")
        js, jp = jk.two_body_elliptic(1.0, e, 1.0, 0.5, "float64")
        assert pp == pytest.approx(jp, rel=CLOSED_FORM_TOL)
        for a, b in zip(_np(ps), _np(js)):
            np.testing.assert_allclose(a, b, rtol=CLOSED_FORM_TOL, atol=0)
        for t in (0.0, 0.3, 2.9, 40.0):
            np.testing.assert_allclose(
                pk.elliptic_positions(t, 1.0, e, 1.0, 0.5),
                jk.elliptic_positions(t, 1.0, e, 1.0, 0.5),
                rtol=0, atol=CLOSED_FORM_TOL)
        m_anom = np.linspace(-1.0, 8.0, 37)
        np.testing.assert_allclose(pk.solve_kepler(m_anom, e),
                                   jk.solve_kepler(m_anom, e),
                                   rtol=0, atol=CLOSED_FORM_TOL)
    ref = jk.circular_positions(0.4)
    pos = ref + 1e-3
    assert pk.max_rel_error(torch.tensor(pos), ref, 2.0) == pytest.approx(
        jk.max_rel_error(pos, ref, 2.0), rel=CLOSED_FORM_TOL)


def test_states_take_dtype_and_device():
    for dtype, tdt in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        st, _ = pk.two_body_elliptic(dtype=dtype, device="cpu")
        assert all(x.dtype == tdt and x.device.type == "cpu" for x in st)
        assert st.pos.shape == (2, 3) and st.mass.shape == (2,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pk.two_body_circular()


def test_solve_kepler_roundtrip():
    ecc = np.linspace(0.0, 2.0 * np.pi, 101)
    for e in (0.0, 0.3, 0.9, 0.99):
        m_anom = ecc - e * np.sin(ecc)
        np.testing.assert_allclose(pk.solve_kepler(m_anom, e), ecc,
                                   atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gate_cases_are_jaxs(dtype, x64):
    """Names, order, steps, eps2 and tolerances of the five gates, against
    the JAX package's result lines; in float64 the errors too (both
    packages' float64 steps round alike)."""
    spp = 256
    cases = list(pk.gate_cases(dtype, spp, device="cpu"))
    assert [c.gate for c in cases] == GATES
    assert [c.eps2 for c in cases] == [0.01] * 3 + [1e-10] * 2
    jres = jk.run_analytic_gates("xla_nxn", dtype, spp)
    pres = pk.run_analytic_gates("xla_nxn", dtype, spp, device="cpu")
    assert [r["gate"] for r in pres] == GATES
    for c, p, j in zip(cases, pres, jres):
        assert c.steps == p["steps"] == j["steps"] == spp
        assert c.tol == p["tol"] == pytest.approx(j["tol"], rel=1e-15)
        if dtype == "float64":
            assert p["max_rel_err"] == pytest.approx(j["max_rel_err"],
                                                     rel=1e-6)
            assert p["ok"] and j["ok"]


def _assert_like_jax(port, jax_figs, what):
    for gate, p, (jerr, jtol) in zip(GATES, port, jax_figs):
        assert p["tol"] == pytest.approx(jtol, rel=1e-12), (what, gate)
        assert abs(p["max_rel_err"] - jerr) <= ERR_REL * jerr + ERR_ABS, (
            what, gate, p["max_rel_err"], jerr)
        assert p["ok"] == (jerr <= jtol), (what, gate, p, jerr)


@pytest.mark.parametrize("impl", ["xla_nxn", "pallas", "pallas_sym2",
                                  "pallas_fast", "pallas_turbo"])
def test_analytic_gates_twins_match_jax(impl):
    """The five gates at 256 steps a period through the port's twins and
    through the JAX package's impl (Pallas in interpret mode; its sym
    tiles at 128, which hold N = 2 in one diagonal tile as 512 does)."""
    port = pk.run_analytic_gates(impl, "float32", 256, device="cpu")
    block = 128 if impl.startswith("pallas_sym") else None
    _assert_like_jax(port, jax_gates(impl, "float32", 256, block=block),
                     impl)


def _split_gates(impl, spp):
    """The port's five gates from ``split_pair`` states (bodies 0 and 256)
    through ``run_steps``."""
    out = []
    for case in pk.gate_cases("float32", spp, device="cpu"):
        cfg = SimConfig(n_bodies=257, dt=case.dt, eps2=case.eps2, impl=impl,
                        integrator=case.integrator, device="cpu")
        st = pk.split_pair(case.state)
        if case.integrator != "reference":
            st = prime_kdk(st, cfg)
        out.append(pk.gate_result(case, run_steps(st, cfg, spp).pos[[0, 256]]))
    return out


def test_split_pair_layout():
    st, _ = pk.two_body_circular(dtype="float32", device="cpu")
    sp = pk.split_pair(st)
    assert sp.pos.shape == (257, 3) and sp.mass.shape == (257,)
    assert torch.equal(sp.pos[[0, 256]], st.pos)
    assert torch.equal(sp.vel[[0, 256]], st.vel)
    assert torch.equal(sp.mass[[0, 256]], st.mass)
    assert torch.all(sp.mass[1:256] == 0)
    assert torch.all(sp.pos[1:256] == torch.tensor([0.0, 0.0, 50.0]))
    assert torch.all(sp.vel[1:256] == 0) and torch.all(sp.acc == 0)


@pytest.mark.parametrize("impl,spp", [("pallas_sym2", 256),
                                      ("pallas_sym_turbo", 512)])
def test_split_form_twins_match_jax(impl, spp):
    """Bodies 0 and 256 sit in two 256-wide superblocks, so the pair is
    computed on the pair tile: the twins against JAX at block_i = block_u
    = 256.  K5's tier fails circular/kdk there, as JAX's does."""
    port = _split_gates(impl, spp)
    jax_figs = jax_gates(impl, "float32", spp, split=True)
    _assert_like_jax(port, jax_figs, f"{impl} split")
    if impl == "pallas_sym_turbo":
        assert not port[1]["ok"]


def _orbit_error(gate, steps_per_period):
    """One period through run_steps in float64 (xla_nxn)."""
    integ = gate.split("/")[1]
    if gate.startswith("circular"):
        eps2 = 0.01
        state, w = pk.two_body_circular(1.0, 1.0, 0.5, eps2, integ,
                                        "float64", device="cpu")
        period = 2.0 * math.pi / w
        ref = pk.circular_positions(period, 1.0, 1.0, 0.5, eps2, integ)
    else:
        eps2 = 1e-10
        state, period = pk.two_body_elliptic(1.0, 0.6, 1.0, 0.5, "float64",
                                             device="cpu")
        ref = pk.elliptic_positions(period, 1.0, 0.6, 1.0, 0.5)
    cfg = SimConfig(n_bodies=2, dt=period / steps_per_period, eps2=eps2,
                    impl="xla_nxn", dtype="float64", integrator=integ,
                    device="cpu")
    if integ != "reference":
        state = prime_kdk(state, cfg)
    return pk.max_rel_error(run_steps(state, cfg, steps_per_period).pos,
                            ref, 1.0)


@pytest.mark.parametrize("gate,lo,hi", [
    # The error ratio when dt halves, the bounds of tests/test_kepler.py:
    # ~2 for the first-order reference scheme, ~4 for KDK, ~16 for
    # yoshida4 (at coarser dt, above the float64 noise).
    ("circular/reference", 1.7, 2.8),
    ("circular/kdk", 3.4, 4.6),
    ("elliptic/kdk", 3.4, 4.6),
    ("circular/yoshida4", 13.0, 19.5),
    ("elliptic/yoshida4", 13.0, 19.5),
])
def test_convergence_order(gate, lo, hi):
    spp = 128 if gate.endswith("yoshida4") else 1024
    e1, e2, e4 = (_orbit_error(gate, k * spp) for k in (1, 2, 4))
    assert lo < e1 / e2 < hi, (e1, e2)
    assert lo < e2 / e4 < hi, (e2, e4)


def test_reference_scheme_is_half_force():
    """A circular orbit set up for true-force dynamics leaves its circle
    under the reference scheme; the half-force set-up stays on it."""
    eps2, spp = 0.01, 1024

    def run(integrator_for_omega):
        state, w = pk.two_body_circular(1.0, 1.0, 0.5, eps2,
                                        integrator_for_omega, "float64",
                                        device="cpu")
        period = 2.0 * math.pi / w
        cfg = SimConfig(n_bodies=2, dt=period / spp, eps2=eps2,
                        impl="xla_nxn", dtype="float64",
                        integrator="reference", device="cpu")
        ref = pk.circular_positions(period, 1.0, 1.0, 0.5, eps2,
                                    integrator_for_omega)
        return pk.max_rel_error(run_steps(state, cfg, spp).pos, ref, 1.0)

    matched, mismatched = run("reference"), run("kdk")
    assert matched < 1e-3
    assert mismatched > 100 * matched


def test_elliptic_energy_bounded_over_10_periods():
    """KDK is symplectic: over 10 periods of the e = 0.6 orbit the energy
    error stays below 1e-6 relative in float64 (no secular drift)."""
    state, period = pk.two_body_elliptic(1.0, 0.6, 1.0, 0.5, "float64",
                                         device="cpu")
    spp = 2048
    cfg = SimConfig(n_bodies=2, dt=period / spp, eps2=1e-10,
                    impl="xla_nxn", dtype="float64", integrator="kdk",
                    device="cpu")
    state = prime_kdk(state, cfg)
    e0 = energy_f64(state, cfg.eps2)
    worst = 0.0
    for _ in range(10):
        state = run_steps(state, cfg, spp)
        worst = max(worst, abs(energy_f64(state, cfg.eps2) - e0) / abs(e0))
    assert worst < 1e-6, worst


def test_two_body_momentum_zero():
    for st in (pk.two_body_circular(dtype="float64", device="cpu")[0],
               pk.two_body_elliptic(dtype="float64", device="cpu")[0]):
        p = (st.mass[:, None] * st.vel).sum(dim=0).numpy()
        np.testing.assert_allclose(p, 0.0, atol=1e-15)


@pytest.mark.parametrize("integ", ["kdk", "yoshida4"])
def test_time_reversibility(integ):
    """KDK and yoshida4 are palindromic: one period forward, velocities
    negated, one period back returns to the start within 1e-9."""
    state, period = pk.two_body_elliptic(1.0, 0.6, 1.0, 0.5, "float64",
                                         device="cpu")
    spp = 512
    cfg = SimConfig(n_bodies=2, dt=period / spp, eps2=1e-10,
                    impl="xla_nxn", dtype="float64", integrator=integ,
                    device="cpu")
    pos0 = state.pos.numpy().copy()
    fwd = run_steps(prime_kdk(state, cfg), cfg, spp)
    out = run_steps(prime_kdk(fwd._replace(vel=-fwd.vel), cfg), cfg, spp)
    assert pk.max_rel_error(out.pos, pos0, 1.0) < 1e-9


def test_reference_scheme_not_reversible():
    state, period = pk.two_body_elliptic(1.0, 0.6, 1.0, 0.5, "float64",
                                         device="cpu")
    spp = 512
    cfg = SimConfig(n_bodies=2, dt=period / spp, eps2=1e-10,
                    impl="xla_nxn", dtype="float64",
                    integrator="reference", device="cpu")
    pos0 = state.pos.numpy().copy()
    fwd = run_steps(state, cfg, spp)
    out = run_steps(fwd._replace(vel=-fwd.vel), cfg, spp)
    assert pk.max_rel_error(out.pos, pos0, 1.0) > 1e-4


def test_cli_validate_analytic(capsys):
    assert cli.main(["validate", "--analytic", "--steps", "1024",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("[OK ]") == 5 and "[FAIL]" not in out
    for gate in GATES:
        assert f"[OK ] {gate}: max rel pos err" in out
    assert "after 1024 steps" in out
    assert out.strip().splitlines()[-1] == "Analytic verification PASSED"
    assert cli.main(["validate", "--analytic", "--shards", "2",
                     "--device", "cpu"]) == 2
    assert "single-device" in capsys.readouterr().err


def test_cli_validate_analytic_default_steps(capsys):
    """validate's default of 10 steps takes 2048 steps a period; in
    float64 every gate passes there."""
    assert cli.main(["validate", "--analytic", "--dtype", "float64",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("[OK ]") == 5 and out.count("after 2048 steps") == 5


def test_chip_smoke_jax_table():
    """``chip_smoke.JAX_KEPLER`` holds a cell for every placement, impl
    and step count the card is held to, each gate at every offset of
    ``NOISE_OFFSETS`` (float64: one), and its float64 and
    discretization-dominated float32 figures are the JAX package's,
    recomputed here (the float32 rounding noise of the other gates depends
    on the host's code generation as well as on the package)."""
    assert chip_smoke.KEPLER_OFFSETS == NOISE_OFFSETS
    assert set(chip_smoke.KEPLER_SPLIT_IMPLS) == set(SPLIT_IMPLS)
    assert {chip_smoke.KEPLER_JAX_IMPL.get(i, i)
            for i in chip_smoke.KEPLER_PAIR_IMPLS} == set(PAIR_IMPLS)
    for spp in chip_smoke.KEPLER_STEPS:
        keys = [("pair", "xla_nxn/float64")]
        keys += [("pair", i) for i in chip_smoke.KEPLER_PAIR_IMPLS]
        keys += [("split", i) for i in chip_smoke.KEPLER_SPLIT_IMPLS]
        for place, impl in keys:
            cell = chip_smoke.jax_kepler(place, impl, spp)
            n = 1 if impl.endswith("float64") else len(NOISE_OFFSETS)
            assert len(cell) == 5 and all(len(g) == n for g in cell)
    for (err, _), g in zip(jax_gates("xla_nxn", "float64", 1024),
                           chip_smoke.jax_kepler("pair", "xla_nxn/float64",
                                                 1024)):
        assert g[0] == pytest.approx(err, rel=1e-5)
    k0 = NOISE_OFFSETS.index(0)
    for (err, _), g, gate in zip(
            jax_gates("pallas", "float32", 1024),
            chip_smoke.jax_kepler("pair", "pallas", 1024), GATES):
        if gate in ("circular/reference", "elliptic(e=0.6)/kdk"):
            assert g[k0] == pytest.approx(err, rel=1e-2), gate


def test_new_modules_import_without_jax():
    """The Kepler gates, the presets and the diagnostics run where JAX is
    not installed, and build no kernel when imported."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "from nbody_tpu_torch.models import kepler, init\n"
        "from nbody_tpu_torch import analysis\n"
        "from nbody_tpu_torch.ops import _build\n"
        "assert not any(m == 'nbody_tpu' or m.startswith('nbody_tpu.') "
        "for m in sys.modules)\n"
        "assert not _build._LIBS\n"
        "r = kepler.run_analytic_gates('pallas', 'float32', 64, "
        "device='cpu')\n"
        "assert [x['gate'] for x in r][0] == 'circular/reference'\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
