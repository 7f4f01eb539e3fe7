"""Config #2's long-horizon gate on the CPU: the port's ``validate
--long-steps`` on its plain versions against the JAX package's
``validate`` on the same arguments, for every impl, and the oracle
sharing of ``chip_smoke.py --long-horizon``.

N = 320 (past one 256-body tile, so the sym tiers reach a pair tile), 4
lock-step steps and 40 long steps at eps2 = 1e7, where the float64 oracle
conserves its energy (well-posed: the energy gate applies).  Both CLIs
take ``--oracle numpy`` (the JAX package's native binding is not built
in its test runs), so both long phases hold their run to the same float64
trajectory, from the JAX package's uniform box in both (the port draws
its own box from torch's generator).  Each impl goes through JAX's own
Pallas kernel in interpret mode, as its tests run it; the tensor-core
tiers get their lock-step allowances (``chip_smoke.py``'s
``TIER_GATES``) on both sides.  Held: the same exit code and verdict, the
same oracle self-conservation (rel 1e-9: one numpy oracle on the same
state), the device-vs-oracle energy drift at the scale of JAX's own
(``EXACT_REL``, ``TC_FACTOR`` below; both drifts are ~1e-8, far under
validate's 1e-3 gate, so that gate alone would pass a port drifting a
thousand times more than JAX), and the same momentum and
angular-momentum verdicts.
"""

import re

import numpy as np
import pytest
import torch

import nbody_tpu as jt
import nbody_tpu_torch as nt
from nbody_tpu import cli as jax_cli
from nbody_tpu_torch import cli
from nbody_tpu_torch.models import init as port_init

IMPLS = ("auto", "xla", "xla_nxn", "pallas", "pallas_kahan", "pallas_mxu",
         "pallas_fast", "pallas_turbo", "pallas_sym", "pallas_sym2",
         "pallas_sym_turbo", "pallas_sym_turbo2", "pallas_sym_mxu")
# Lock-step allowances of the tensor-core tiers (chip_smoke.TIER_GATES).
ALLOW = {"pallas_turbo": 0.1, "pallas_sym_turbo": 0.1,
         "pallas_sym_turbo2": 0.1, "pallas_mxu": 1e-3,
         "pallas_sym_mxu": 5e-3, "pallas_fast": 2e-3}
GATE = 1e-3
# The port's drift against JAX's.  Readings on the CPU (port / JAX, each
# as validate prints it): the exact impls 7.419e-09 to 7.792e-09 against
# 7.404e-09 to 7.584e-09, at most 2.74e-2 apart relative to JAX's (xla);
# the ALLOW tiers (lower-precision sums, rounded differently from JAX's
# in the port) 4.437e-09 (pallas_sym_turbo) to 1.363e-08 (pallas_turbo),
# a ratio to JAX's of 0.599 to 1.008.  A port that summed an exact tier
# in lower precision, or let a tier's rounding error grow, would drift
# orders of magnitude past these.
EXACT_REL = 1e-1
TC_FACTOR = 3.0
_NUM = r"([0-9.eE+-]+)"
LINES = {"chaos": re.compile(r"self-conservation \|dE\|/\|E0\| = " + _NUM),
         "drift": re.compile(r"energy: device vs oracle drift " + _NUM),
         "energy": re.compile(r"\[(OK |FAIL|INFO)\] energy:"),
         "momentum": re.compile(r"\[(OK |FAIL)\] momentum:"),
         "angular": re.compile(r"\[(OK |FAIL)\] angular momentum:"),
         "verdict": re.compile(r"Verification (PASSED|FAILED)")}


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _numbers(out):
    found = {k: rx.search(out) for k, rx in LINES.items()}
    assert all(found.values()), out
    return {k: (float(m.group(1)) if k in ("chaos", "drift")
                else m.group(1).strip()) for k, m in found.items()}


@pytest.mark.parametrize("impl", IMPLS)
def test_long_gate_matches_jax(impl, capsys, monkeypatch):
    # The port draws its uniform box from torch's generator: both CLIs
    # start from the JAX package's box here.
    start = jt.init_state(jt.SimConfig(n_bodies=320))
    monkeypatch.setattr(port_init, "init_state", lambda cfg: nt.SimState(
        *(torch.from_numpy(np.array(a)) for a in start)))
    argv = ["validate", "--n", "320", "--steps", "4", "--long-steps", "40",
            "--eps2", "1e7", "--oracle", "numpy", "--impl", impl]
    if impl in ALLOW:
        argv += ["--max-bad-frac", str(ALLOW[impl]), "--max-bad-frac-acc",
                 str(max(ALLOW[impl], 5e-4))]
    rc = cli.main(argv + ["--device", "cpu"])
    port = _numbers(capsys.readouterr().out)
    jax_rc = jax_cli.main(argv)
    want = _numbers(capsys.readouterr().out)
    assert (rc, port["verdict"]) == (jax_rc, want["verdict"])
    assert port["chaos"] <= GATE, "the oracle should be well-posed here"
    np.testing.assert_allclose(port["chaos"], want["chaos"], rtol=1e-9)
    if impl in ALLOW:
        ratio = port["drift"] / want["drift"]
        assert 1 / TC_FACTOR <= ratio <= TC_FACTOR, (port, want)
    else:
        np.testing.assert_allclose(port["drift"], want["drift"],
                                   rtol=EXACT_REL)
    for k in ("energy", "momentum", "angular"):
        assert port[k] == want[k], (k, port[k], want[k])


def test_shared_native_oracle_returns_the_unshared_arrays():
    """``chip_smoke.py``'s oracle sharing: a second call with the same
    inputs is not recomputed and returns the unshared run's arrays (its
    own copies); other inputs are a run of their own; undone, the module
    holds the unshared function again."""
    import chip_smoke
    from conftest import make_small_system
    from nbody_tpu_torch.oracle import native
    if not native.available():
        pytest.skip("native oracle needs g++")
    pos, vel, mass = make_small_system(96, seed=4)
    real = native.native_run
    want = real(pos, vel, mass, 1e6, 0.1, 5, dtype=np.float64,
                integrator="kdk")
    seconds = []
    undo = chip_smoke.share_oracle_runs(seconds)
    try:
        first = native.native_run(pos, vel, mass, 1e6, 0.1, 5,
                                  dtype=np.float64, integrator="kdk")
        first[0][0, 0] += 1.0       # a caller's own copy
        again = native.native_run(pos, vel, mass, 1e6, 0.1, 5,
                                  dtype=np.float64, integrator="kdk")
        assert [name for name, _ in seconds] == ["native_run"]
        other = native.native_run(pos, vel, mass, 1e6, 0.1, 6,
                                  dtype=np.float64, integrator="kdk")
        assert len(seconds) == 2
    finally:
        undo()
    assert native.native_run is real
    for g, w in zip(again, want):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(other[0], want[0])
