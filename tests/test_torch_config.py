"""The port's SimConfig against the JAX package's: same fields, defaults
and vocabulary; the execution modes (``flat_state``, ``prog_cap``,
``shards``) accepted and recorded as in the JAX package; ``resolve_impl``
off CUDA as the JAX package resolves off the TPU."""

import dataclasses

import pytest
import torch

from nbody_tpu.config import SimConfig as JaxSimConfig
from nbody_tpu.config import _VALID_IMPLS as JAX_IMPLS
from nbody_tpu.ops.forces import resolve_impl as jax_resolve_impl
from nbody_tpu_torch.config import _VALID_IMPLS, SimConfig
from nbody_tpu_torch.ops.forces import SYM_CROSSOVER_N, resolve_impl
from nbody_tpu_torch.ops.resident import should_use_resident


def test_fields_and_defaults_equal_jax():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxSimConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(SimConfig)}
    assert port_fields.pop("device") == "cuda"
    assert port_fields == jax_fields
    assert _VALID_IMPLS == JAX_IMPLS
    assert SimConfig(dtype="float64").torch_dtype == torch.float64
    assert SimConfig(n_bodies=100).interactions_per_step == 10000


# Explicit ids keep each case's name stable.  The three modes were refused
# until their slices landed (kw3, ``shards``: the one-card mesh; kw1 and
# kw2, ``flat_state`` and ``prog_cap``: huge N); each is now accepted and
# recorded as in the JAX package, and routing decides what runs
# (``should_use_flat``, ``should_use_multiprog``, the mesh in Simulation).
@pytest.mark.parametrize("kw", [
    pytest.param({"flat_state": True}, id="kw1-item 13"),
    pytest.param({"prog_cap": 1e9}, id="kw2-item 13"),
    pytest.param({"shards": 2}, id="kw3-item 14"),
])
def test_unported_modes_raise(kw):
    (field, value), = kw.items()
    assert getattr(SimConfig(**kw), field) == value
    assert getattr(JaxSimConfig(**kw), field) == value
    assert dataclasses.asdict(SimConfig(**kw))[field] == value
    # None / False keep the per-step path.
    SimConfig(resident=False, flat_state=False)


@pytest.mark.parametrize("resident", [True, False, None])
def test_resident_is_accepted_and_left_to_routing(resident):
    """``resident=True`` forces the resident kernels K3/K4; whether the run
    is in their scope is decided (and refused) by ``should_use_resident``,
    as in the JAX package."""
    cfg = SimConfig(resident=resident)
    assert cfg.resident is resident
    jax_cfg = JaxSimConfig(resident=resident)
    assert cfg.resident == jax_cfg.resident


def test_invalid_values_raise_value_error():
    for kw in ({"impl": "warp"}, {"integrator": "rk4"}, {"n_bodies": 0},
               {"dtype": "int8"}):
        with pytest.raises(ValueError):
            SimConfig(**kw)


# ``resident=True`` cases at the N of the forced-resident fault: ``auto``
# once resolved to ``xla_nxn`` / ``xla`` off the card (``pallas`` below the
# crossover on it) and the resident path then raised.
@pytest.mark.parametrize("dtype,n,resident", [
    *(pytest.param(d, n, None, id=f"{d}-{n}")
      for d in ("float32", "float64")
      for n in (256, 2048, 4096, 4097, 8192, 65536)),
    *(pytest.param(d, n, True, id=f"{d}-{n}-resident")
      for d in ("float32", "float64") for n in (512, 1024, 8192))])
def test_resolve_impl_off_cuda_matches_jax_off_tpu(dtype, n, resident):
    port = resolve_impl(SimConfig(n_bodies=n, dtype=dtype, resident=resident,
                                  device="cpu"))
    want = jax_resolve_impl(JaxSimConfig(n_bodies=n, dtype=dtype,
                                         resident=resident))
    assert port == want
    if resident and dtype == "float32":
        # At any N and on either device, so the resident path engages;
        # float64 keeps the plain paths.
        assert want == "pallas_sym2"
        cfg = SimConfig(n_bodies=n, resident=True, device="cuda")
        assert resolve_impl(cfg) == want
        assert should_use_resident(cfg, want)


def test_resolve_impl_on_cuda_uses_the_crossover():
    """Decided from the config alone, so this runs without a card."""
    below = SimConfig(n_bodies=SYM_CROSSOVER_N - 1, device="cuda")
    at = SimConfig(n_bodies=SYM_CROSSOVER_N, device="cuda")
    assert resolve_impl(below) == "pallas"
    assert resolve_impl(at) == "pallas_sym2"
    assert resolve_impl(SimConfig(n_bodies=8192)) == "pallas_sym2"
    assert resolve_impl(SimConfig(n_bodies=1 << 20)) == "pallas_sym2"
    assert resolve_impl(SimConfig(n_bodies=8192, dtype="float64")) == "xla"
    assert resolve_impl(SimConfig(impl="xla")) == "xla"
