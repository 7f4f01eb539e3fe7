"""The port's SimConfig against the JAX package's: same fields, defaults
and vocabulary; unported impls and modes refused; ``resolve_impl`` off
CUDA as the JAX package resolves off the TPU."""

import dataclasses

import pytest
import torch

from nbody_tpu.config import SimConfig as JaxSimConfig
from nbody_tpu.config import _VALID_IMPLS as JAX_IMPLS
from nbody_tpu.ops.forces import resolve_impl as jax_resolve_impl
from nbody_tpu_torch.config import UNPORTED_IMPLS, _VALID_IMPLS, SimConfig
from nbody_tpu_torch.ops.forces import SYM_CROSSOVER_N, resolve_impl


def test_fields_and_defaults_equal_jax():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxSimConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(SimConfig)}
    assert port_fields.pop("device") == "cuda"
    assert port_fields == jax_fields
    assert _VALID_IMPLS == JAX_IMPLS
    assert SimConfig(dtype="float64").torch_dtype == torch.float64
    assert SimConfig(n_bodies=100).interactions_per_step == 10000


@pytest.mark.parametrize("impl", sorted(UNPORTED_IMPLS))
def test_unported_impls_raise_with_roadmap_item(impl):
    with pytest.raises(NotImplementedError, match=UNPORTED_IMPLS[impl]):
        SimConfig(impl=impl)


@pytest.mark.parametrize("kw,match", [
    ({"resident": True}, "K3"),
    ({"flat_state": True}, "item 13"),
    ({"prog_cap": 1e9}, "item 13"),
    ({"shards": 2}, "item 14"),
])
def test_unported_modes_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        SimConfig(**kw)
    # None / False keep the per-step path.
    SimConfig(resident=False, flat_state=False)


def test_invalid_values_raise_value_error():
    for kw in ({"impl": "warp"}, {"integrator": "rk4"}, {"n_bodies": 0},
               {"dtype": "int8"}):
        with pytest.raises(ValueError):
            SimConfig(**kw)


@pytest.mark.parametrize("n", [256, 2048, 4096, 4097, 8192, 65536])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_resolve_impl_off_cuda_matches_jax_off_tpu(n, dtype):
    port = resolve_impl(SimConfig(n_bodies=n, dtype=dtype, device="cpu"))
    assert port == jax_resolve_impl(JaxSimConfig(n_bodies=n, dtype=dtype))


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
