"""K2-rect (``rect_forces_sym``: each pair of two disjoint body sets once,
both sides) of the PyTorch port against the JAX package's
``rect_forces_sym`` and a float64 direct sum of the cross pairs.

On the CPU the rect wrappers run the kernels' plain twins: the square
sweep's pair tiles over the rect sweep's superblocks, enumeration, slots
and reduction order.  The JAX side runs Pallas in interpret mode at
``block_i=256, block_u=256`` (classic), where its tiles are the port's
256 x 256 tiles, and at ``block_u`` of 512, 768, 1024 and 2048 for the
fold schedule (the port's fold at the same ``block_u``: two to eight row
tiles a superblock, the kernel's cluster size).  Tolerances, per component: the exact variants
(vpu, vpu2, fold) within rel 1e-4 + 1e-6·max|a| of JAX and of float64;
the tensor-core variants within rel 1e-3 + 1e-4·max|a| of JAX (the
tensor-core tiers' tolerance, test_torch_forces_sym_tc.py) and at their
tier gates against float64 on two sets of 512 (PERF.md §2: turbo,
turbo2, turbof p99 < 5e-2 and a bad fraction < 0.1; mxu p99 < 5e-3 and
< 5e-3), the shape of the JAX package's own rect gate
(``tests/test_pallas_sym.py::test_rect_sym_turbo_loose_tier``); turbop
bit-equal to turbo.  The gates are set for sums over hundreds of bodies:
on the 300 x 700 sets the p99 of JAX's own turbof reads 5.54e-2 over B
and its turbo2 5.28e-2 over A, the port's the same, so there the
tensor-core variants are held to JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_small_system
from nbody_tpu.ops.forces_pallas_sym import rect_forces_sym as jax_rect
from nbody_tpu.oracle.numpy_oracle import relative_mismatch
from nbody_tpu_torch.ops import forces_sym, forces_sym_tc
from nbody_tpu_torch.ops.forces_sym_variants import (RECT_CLASSIC,
                                                     SYM_VARIANTS,
                                                     rect_forces_sym)

EPS2 = 0.002
EXACT = ("vpu", "vpu2")
TIER_GATES = {"turbo": (5e-2, 0.1), "turbop": (5e-2, 0.1),
              "turbo2": (5e-2, 0.1), "turbof": (5e-2, 0.1),
              "mxu": (5e-3, 5e-3)}
CASES = [(v, None) for v in SYM_VARIANTS] + [(v, "fold") for v in EXACT]
# (na, nb): whole 256-wide tiles and 512-wide fold superblocks on A, and
# ragged sides of unequal length (fold takes the classic sweep there).
SHAPES = [(512, 512), (300, 700)]


def sets(na, nb, seed, massless=()):
    pos, _, mass = make_small_system(na + nb, seed=seed)
    mass[list(massless)] = 0.0
    return pos[:na], mass[:na], pos[na:], mass[na:]


def cross_f64(pa, ma, pb, mb):
    """The float64 cross accelerations: of A from B and of B from A."""
    def one(xi, xj, mj):
        r = xj[None].astype(np.float64) - xi[:, None].astype(np.float64)
        d2 = (r * r).sum(-1) + EPS2
        return ((mj[None].astype(np.float64) / d2 ** 1.5)[..., None]
                * r).sum(1)
    return one(pa, pb, mb), one(pb, pa, ma)


def port(pa, ma, pb, mb, variant, schedule, **kw):
    out = rect_forces_sym(torch.from_numpy(pa), torch.from_numpy(ma),
                          torch.from_numpy(pb), torch.from_numpy(mb), EPS2,
                          variant=variant, schedule=schedule,
                          block_u=512 if schedule else None, **kw)
    return tuple(t.numpy() for t in out)


def jax(pa, ma, pb, mb, variant, schedule):
    out = jax_rect(jnp.asarray(pa), jnp.asarray(ma), jnp.asarray(pb),
                   jnp.asarray(mb), EPS2, block_i=256,
                   block_u=512 if schedule else 256, variant=variant,
                   schedule=schedule)
    return tuple(np.asarray(t) for t in out)


def assert_close(got, want, what, rel, floor):
    bad = relative_mismatch(got, want, rel, floor * np.abs(want).max())
    assert bad.sum() == 0, (
        f"{what}: {int(bad.sum())}/{bad.size} components differ; max "
        f"rel {np.abs(got - want).max() / np.abs(want).max():.3e}")


def tol(variant):
    return (1e-4, 1e-6) if variant in EXACT else (1e-3, 1e-4)


def assert_gate(acc, ref, variant, what):
    if variant in EXACT:
        assert_close(acc, ref, what, 1e-4, 1e-6)
        return
    p99_gate, frac_gate = TIER_GATES[variant]
    err = np.abs(acc - ref) / (np.abs(ref) + 1e-30)
    assert np.percentile(err, 99) < p99_gate, what
    assert relative_mismatch(acc, ref, 0.01, 1e-4).mean() < frac_gate, what


@pytest.mark.parametrize("na,nb", SHAPES)
@pytest.mark.parametrize("variant,schedule", CASES)
def test_rect_twin_matches_jax_and_float64(variant, schedule, na, nb):
    pa, ma, pb, mb = sets(na, nb, seed=61)
    got = port(pa, ma, pb, mb, variant, schedule)
    want = jax(pa, ma, pb, mb, variant, schedule)
    ref = cross_f64(pa, ma, pb, mb)
    assert got[0].shape == (na, 3) and got[1].shape == (nb, 3)
    for side, g, w, r in zip("ab", got, want, ref):
        what = f"{variant}/{schedule} acc_{side}, {na}x{nb}"
        assert_close(g, w, what + " vs JAX", *tol(variant))
        if variant in EXACT or na == nb:
            assert_gate(g, r, variant, what + " vs float64")


@pytest.mark.parametrize("variant,schedule", CASES)
def test_rect_real_massless_bodies_match_float64(variant, schedule):
    """Real bodies of mass 0 on both sides get their whole cross sum: the
    mass-scaled variants (vpu2, turbof) recompute such a row one-sided over
    the other set, where JAX's rect leaves it with nothing."""
    na, nb = 512, 300
    massless = (3, 400, na + 5, na + 299)
    pa, ma, pb, mb = sets(na, nb, seed=62, massless=massless)
    acc_a, acc_b = port(pa, ma, pb, mb, variant, schedule)
    ref_a, ref_b = cross_f64(pa, ma, pb, mb)
    rows_a, rows_b = [3, 400], [5, 299]
    rel = 1e-4 if variant in EXACT + ("turbof",) else 5e-2
    for got, ref in ((acc_a[rows_a], ref_a[rows_a]),
                     (acc_b[rows_b], ref_b[rows_b])):
        err = np.linalg.norm(got - ref, axis=1) / np.linalg.norm(ref, axis=1)
        assert (err < rel).all(), (variant, schedule, err)
    if variant in EXACT:
        assert_gate(acc_a, ref_a, variant, f"{variant}/{schedule} acc_a")
        assert_gate(acc_b, ref_b, variant, f"{variant}/{schedule} acc_b")


@pytest.mark.parametrize("variant,schedule", CASES)
def test_rect_chunks_are_bit_invariant(variant, schedule):
    """Column superblocks in chunks of one give the one-chunk result bit
    for bit (the running A-side sum and the per-chunk B columns)."""
    na, nb = 512, 1100
    pa, ma, pb, mb = sets(na, nb, seed=63)
    one = port(pa, ma, pb, mb, variant, schedule)
    width = 512 if schedule else 256
    chunked = port(pa, ma, pb, mb, variant, schedule,
                   slot_budget=24 * -(-na // width) * width)
    for a, b in zip(one, chunked):
        np.testing.assert_array_equal(a, b)


# (block_u, na, nb): A in whole superblocks of three, four (the default)
# and eight row tiles, one and two of them; B ragged.
FOLD_CASES = [(768, 1536, 700), (1024, 2048, 1100), (2048, 2048, 1300),
              (2048, 4096, 300)]


def rect_fold(pa, ma, pb, mb, variant, block_u):
    port_out = rect_forces_sym(torch.from_numpy(pa), torch.from_numpy(ma),
                               torch.from_numpy(pb), torch.from_numpy(mb),
                               EPS2, variant=variant, schedule="fold",
                               block_u=block_u)
    jax_out = jax_rect(jnp.asarray(pa), jnp.asarray(ma), jnp.asarray(pb),
                       jnp.asarray(mb), EPS2, block_i=256, block_u=block_u,
                       variant=variant, schedule="fold")
    return ([t.numpy() for t in port_out], [np.asarray(t) for t in jax_out])


@pytest.mark.parametrize("variant", EXACT)
@pytest.mark.parametrize("block_u,na,nb", FOLD_CASES)
def test_rect_fold_twin_at_three_four_and_eight_row_tiles(variant, block_u,
                                                          na, nb):
    """The rect fold's twin (the kernels' grouping: row sums a 256-column
    tile, added across column tiles; column sums a row tile, added across
    row tiles) at the cluster sizes 3, 4 and 8, against JAX's rect fold at
    the same superblock and against float64."""
    pa, ma, pb, mb = sets(na, nb, seed=66)
    got, want = rect_fold(pa, ma, pb, mb, variant, block_u)
    ref = cross_f64(pa, ma, pb, mb)
    for side, g, w, r in zip("ab", got, want, ref):
        what = f"{variant}/fold U={block_u} acc_{side}, {na}x{nb}"
        assert_close(g, w, what + " vs JAX", 1e-4, 1e-6)
        assert_gate(g, r, variant, what + " vs float64")


@pytest.mark.parametrize("variant", EXACT)
def test_rect_fold_real_massless_bodies_at_eight_row_tiles(variant):
    """Massless bodies on both sides of the rect fold at U=2048: every row
    against float64, and against JAX's rect fold on every row where JAX is
    right (all for vpu; vpu2's JAX gives a massless row nothing from the
    other set, where the port recomputes it one-sided)."""
    na, nb = 2048, 1300
    massless = (3, 2047, na + 5, na + 1299)
    pa, ma, pb, mb = sets(na, nb, seed=67, massless=massless)
    got, want = rect_fold(pa, ma, pb, mb, variant, 2048)
    ref = cross_f64(pa, ma, pb, mb)
    zero = ([3, 2047], [5, 1299])
    for side, g, w, r, z in zip("ab", got, want, ref, zero):
        what = f"{variant}/fold U=2048 with massless bodies, acc_{side}"
        assert_gate(g, r, variant, what + " vs float64")
        keep = (np.arange(len(g)) if variant == "vpu"
                else np.setdiff1d(np.arange(len(g)), z))
        assert_close(g[keep], w[keep], what + " vs JAX", 1e-4, 1e-6)


@pytest.mark.parametrize("na,nb,massless", [(256, 344, ()),
                                             (512, 488, (7, 512 + 300))])
def test_square_k2_twin_is_self_plus_rect_vpu2(na, nb, massless):
    """The ring's decomposition: K2's square twin on A u B equals, body by
    body, K2's twin on A (on B) plus the A side (the B side) of
    ``rect_forces_sym_vpu2``'s twin across them, within the exact
    tolerance (rel 1e-4 + 1e-6·max|a|; the tiles' sums fall in another
    order).  A rect sweep that dropped or doubled a tile would be off by
    a whole tile's pull.  N = 600 (one tile of A, a ragged B) and N =
    1000 with a real massless body in each set (its self row and its
    cross row each recomputed one-sided)."""
    pa, ma, pb, mb = (torch.from_numpy(x) for x in
                      sets(na, nb, seed=66, massless=massless))
    whole = forces_sym.forces_sym(torch.cat([pa, pb]), torch.cat([ma, mb]),
                                  EPS2).numpy()
    cross_a, cross_b = forces_sym.rect_forces_sym_vpu2(pa, ma, pb, mb, EPS2)
    parts = torch.cat([forces_sym.forces_sym(pa, ma, EPS2) + cross_a,
                       forces_sym.forces_sym(pb, mb, EPS2) + cross_b])
    assert_close(parts.numpy(), whole, f"self + rect vpu2, {na}+{nb}",
                 1e-4, 1e-6)
    assert forces_sym.rect_forces_sym_vpu2.launches == 0


def test_rect_chunks_plan():
    assert forces_sym.rect_chunks(512, 5, budget=24 * 512 * 2) == [
        (0, 2), (2, 2), (4, 1)]
    assert forces_sym.rect_chunks(512, 3) == [(0, 3)]
    with pytest.raises(ValueError, match="budget"):
        forces_sym.rect_chunks(512, 3, budget=100)


def test_rect_turbop_is_turbo():
    pa, ma, pb, mb = sets(300, 700, seed=64)
    for a, b in zip(port(pa, ma, pb, mb, "turbop", None),
                    port(pa, ma, pb, mb, "turbo", None)):
        np.testing.assert_array_equal(a, b)


def test_rect_entry_point_contract():
    pa, ma, pb, mb = (torch.from_numpy(x) for x in sets(300, 512, seed=65))
    with pytest.raises(ValueError, match="variant"):
        rect_forces_sym(pa, ma, pb, mb, EPS2, variant="warp")
    with pytest.raises(ValueError, match="fold"):
        rect_forces_sym(pa, ma, pb, mb, EPS2, variant="turbo",
                        schedule="fold")
    with pytest.raises(ValueError, match="256"):
        rect_forces_sym(pa, ma, pb, mb, EPS2, variant="vpu2", block_u=512)
    with pytest.raises(ValueError, match="float32"):
        rect_forces_sym(pa.double(), ma.double(), pb, mb, EPS2)
    # The VMEM knobs are accepted and ignored; a ragged A side takes the
    # classic sweep on the fold schedule, as in the JAX package.
    base = rect_forces_sym(pa, ma, pb, mb, EPS2, variant="vpu2")
    knobs = rect_forces_sym(pa, ma, pb, mb, EPS2, block_i=64, panel_nb=3,
                            variant="vpu2", schedule="fold", block_u=512)
    for a, b in zip(base, knobs):
        assert torch.equal(a, b)
    # Each variant's classic wrapper is a wrapper of its own kernel.
    assert {v: w.__name__ for v, w in RECT_CLASSIC.items()} == {
        v: f"rect_forces_sym_{v}" for v in SYM_VARIANTS}
    assert forces_sym_tc.rect_forces_sym_turbop.launches == 0
