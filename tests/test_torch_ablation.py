"""K15, the bench-only ablations of the pair-symmetric tiles
(``nbody_tpu_torch/ops/ablation_sym.py``), against the JAX package's
``nbody_tpu/ops/ablation_sym.py`` through ``forces_pallas_sym`` and
``rect_forces_sym``; their registration; and the entry points that must
refuse them.

On the CPU the wrappers run the kernels' plain twins: K2's 256-wide
tiles, the ``tile_pairs`` enumeration, the slots and the reduce order.
The JAX side runs Pallas in interpret mode at ``block_i=128,
block_u=256``, where its superblocks are the port's tiles and its
diagonal the port's exact diagonal tiles.  Tolerances, per component:
``vpu_*`` within rel 1e-4 + 1e-6·max|a| (the exact tiers'), ``tmm_*``
within rel 1e-3 + 1e-4·max|a| (the tensor-core tiers',
test_torch_forces_sym_tc.py).

Four of the seven compute wrong physics on purpose, and how wrong depends
on the tiling: the JAX package pads the bodies to an odd number of
superblocks, so at N = 1000 its sweep also visits a fifth superblock of
massless ghosts at the origin, whose columns feed ``vpu_fix0``'s and
``tmm_noscat``'s tile-0 sums and ``tmm_nomm``'s bf16(m_i inv) row sums.
The port's even-nb half offset visits no ghost superblock.  For those
three the N = 1000 case hands the port JAX's padding as explicit massless
bodies at the origin; the other four match JAX on the 1000 bodies alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_small_system
from nbody_tpu.ops import ablation_sym as jax_ablation
from nbody_tpu.ops import forces_pallas_sym as jax_fps
from nbody_tpu.oracle.numpy_oracle import relative_mismatch
from nbody_tpu_torch import SimConfig, cli
from nbody_tpu_torch.ops import ablation_sym, forces_sym, forces_sym_tc
from nbody_tpu_torch.ops import forces_sym_variants as variants
from nbody_tpu_torch.ops.forces_sym import SYM_TILE
from nbody_tpu_torch.ops.forces_tiled_tc import (pair_inv_fma, position_pack,
                                                 tile_result)

EPS2 = 0.002
NAMES = ablation_sym.ABLATION_NAMES
# The ablations whose wrong physics reads the columns of ghost bodies.
GHOST_READERS = ("vpu_fix0", "tmm_noscat", "tmm_nomm")


def tolerance(name):
    return (1e-4, 1e-6) if name.startswith("vpu_") else (1e-3, 1e-4)


def assert_close(got, want, what, tol):
    rel, floor = tol
    bad = relative_mismatch(got, want, rel, floor * np.abs(want).max())
    assert bad.sum() == 0, (
        f"{what}: {int(bad.sum())}/{bad.size} components differ; max rel "
        f"{np.abs(got - want).max() / np.abs(want).max():.3e}")


@pytest.fixture
def enabled(monkeypatch):
    """``enable()`` on both packages, with every global it touches
    restored afterwards (pytest-xdist runs many files in one process)."""
    for module in (variants, jax_fps):
        monkeypatch.setattr(module, "SYM_VARIANTS", module.SYM_VARIANTS)
        for reg in ("ABLATION_SYM_KERNELS", "ABLATION_RECT_KERNELS"):
            monkeypatch.setattr(module, reg, dict(getattr(module, reg)))
    ablation_sym.enable()
    jax_ablation.enable()


def t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("n", [1280, 1000])
@pytest.mark.parametrize("name", NAMES)
def test_twin_matches_jax(enabled, name, n):
    pos, _, mass = make_small_system(n, seed=151)
    want = np.asarray(jax_fps.forces_pallas_sym(
        jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=128,
        block_u=SYM_TILE, variant=name))
    n_pad = n
    if name in GHOST_READERS:
        n_pad = 1280                          # JAX's 5 superblocks of 256
    pos = np.concatenate([pos, np.zeros((n_pad - n, 3), np.float32)])
    mass = np.concatenate([mass, np.zeros(n_pad - n, np.float32)])
    got = variants.forces_pallas_sym(t(pos), t(mass), EPS2,
                                     variant=name).numpy()[:n]
    assert_close(got, want, f"{name} twin vs JAX, N={n}", tolerance(name))


@pytest.mark.parametrize("name", NAMES)
def test_rect_twin_matches_jax(enabled, name):
    """A = 512, B = 768: B spans three superblocks, so tile 0 of B differs
    from the others for vpu_fix0 and tmm_noscat."""
    pos, _, mass = make_small_system(512 + 768, seed=152)
    sets = (pos[:512], mass[:512], pos[512:], mass[512:])
    want = jax_fps.rect_forces_sym(*(jnp.asarray(x) for x in sets), EPS2,
                                   block_i=128, block_u=SYM_TILE,
                                   variant=name)
    got = variants.rect_forces_sym(*(t(x) for x in sets), EPS2,
                                   variant=name)
    for side, g, w in zip("ab", got, want):
        w = np.asarray(w)
        if side == "b" and ablation_sym.J_MODE[name] == "none":
            assert not w.any() and not g.numpy().any()
            continue
        assert_close(g.numpy(), w, f"{name} rect twin vs JAX, acc_{side}",
                     tolerance(name))


@pytest.mark.parametrize("rect", [False, True])
@pytest.mark.parametrize("name, control", [("vpu_rc", "vpu"),
                                           ("tmm_full", "turbo")])
def test_exact_ablations_match_their_controls(enabled, name, control, rect):
    """vpu_rc is K7's physics and tmm_full K5's: each within its tolerance
    of its control's twin (they are bit-equal on the CPU)."""
    pos, _, mass = make_small_system(1000, seed=153)
    if rect:
        sets = (t(pos[:300]), t(mass[:300]), t(pos[300:]), t(mass[300:]))
        got = variants.rect_forces_sym(*sets, EPS2, variant=name)
        want = variants.rect_forces_sym(*sets, EPS2, variant=control)
    else:
        got = [variants.forces_pallas_sym(t(pos), t(mass), EPS2,
                                          variant=name)]
        want = [variants.forces_pallas_sym(t(pos), t(mass), EPS2,
                                           variant=control)]
    for g, w in zip(got, want):
        assert_close(g.numpy(), w.numpy(), f"{name} vs {control}",
                     tolerance(name))


@pytest.mark.parametrize("seed, n, na", [(153, 1000, 300), (164, 1300, 257)])
@pytest.mark.parametrize("rect", [False, True])
def test_vpu_rc_twin_is_k7s_bit_for_bit(enabled, rect, seed, n, na):
    """vpu_rc's twin takes the differences again for the accumulate, as
    its kernel does; they equal the first ones, so its results are K7's
    twin's bit for bit, square and rect (both sides, ragged sets), as the
    card's vpu_rc is K7's."""
    pos, _, mass = make_small_system(n, seed=seed)
    if rect:
        sets = (t(pos[:na]), t(mass[:na]), t(pos[na:]), t(mass[na:]))
        got = variants.rect_forces_sym(*sets, EPS2, variant="vpu_rc")
        want = variants.rect_forces_sym(*sets, EPS2, variant="vpu")
    else:
        got = [variants.forces_pallas_sym(t(pos), t(mass), EPS2,
                                          variant="vpu_rc")]
        want = [variants.forces_pallas_sym(t(pos), t(mass), EPS2,
                                           variant="vpu")]
    for g, w in zip(got, want):
        assert w.any() and torch.equal(g, w)


@pytest.mark.parametrize("na, nb", [(300, 700), (1000, 257)])
def test_vpu_fix0_rect_acc_a_is_k2_rect_vpus(na, nb):
    """Rect vpu_fix0's pair pass is K2-rect vpu's (on the card its very
    kernel), and both reduce passes add A's row slots in column order:
    acc_a is K2-rect vpu's bit for bit; B gets only superblock 0's sums."""
    pos, _, mass = make_small_system(na + nb, seed=165)
    sets = (t(pos[:na]), t(mass[:na]), t(pos[na:]), t(mass[na:]))
    acc_a, acc_b = ablation_sym.rect_forces_sym_ablation(*sets, EPS2,
                                                         "vpu_fix0")
    k7_a, k7_b = forces_sym.rect_forces_sym_vpu(*sets, EPS2)
    assert torch.equal(acc_a, k7_a)
    assert acc_b[:SYM_TILE].any() and not acc_b[SYM_TILE:].any()
    assert k7_b[SYM_TILE:].any()


@pytest.mark.parametrize("name", NAMES)
def test_control_of_each_ablation(enabled, name):
    """Each ablation's control (the variant it is timed and pinned
    against) is the kernel whose tile it ablates: K7 for vpu_noj, vpu_rc
    and vpu_fix0, which run K7's pair tile; K5 for tmm_*.  Every control
    is a variant of the entry point."""
    want = {"vpu_rc": "vpu", "vpu_fix0": "vpu", "vpu_noj": "vpu"}
    control = ablation_sym.CONTROLS[name]
    assert control == want.get(name, "turbo")
    assert control in variants.SYM_VARIANTS
    assert set(ablation_sym.CONTROLS) == set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_twins_are_chunk_invariant(name):
    """One offset (one column superblock) a slot chunk gives the same bits
    as one chunk, fix0's tile-0 sums included."""
    pos, _, mass = make_small_system(1300, seed=154)
    p, m = t(pos), t(mass)
    one = ablation_sym.forces_sym_ablation(p, m, EPS2, name)
    per_offset = ablation_sym.forces_sym_ablation(
        p, m, EPS2, name, slot_budget=24 * 6 * SYM_TILE)
    np.testing.assert_array_equal(one.numpy(), per_offset.numpy())
    sets = (p[:300], m[:300], p[300:], m[300:])
    one = ablation_sym.rect_forces_sym_ablation(*sets, EPS2, name)
    per_col = ablation_sym.rect_forces_sym_ablation(
        *sets, EPS2, name, slot_budget=24 * 2 * SYM_TILE)
    for x, y in zip(one, per_col):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_enable_twice_registers_each_name_once(enabled):
    ablation_sym.enable()
    for name in NAMES:
        assert variants.SYM_VARIANTS.count(name) == 1
    assert variants.SYM_VARIANTS[:7] == ("vpu", "vpu2", "turbo", "turbof",
                                         "turbo2", "mxu", "turbop")
    assert variants.ABLATION_SYM_KERNELS == ablation_sym.SYM_WRAPPERS
    assert variants.ABLATION_RECT_KERNELS == ablation_sym.RECT_WRAPPERS
    assert all(w.__name__ == f"forces_sym_{n}" and w.launches == 0
               for n, w in ablation_sym.SYM_WRAPPERS.items())


@pytest.mark.parametrize("name", NAMES)
def test_fold_schedule_refuses_every_ablation(enabled, name):
    pos, _, mass = make_small_system(600, seed=155)
    p, m = t(pos), t(mass)
    with pytest.raises(ValueError, match="fold"):
        variants.forces_pallas_sym(p, m, EPS2, variant=name,
                                   schedule="fold")
    with pytest.raises(ValueError, match="fold"):
        variants.rect_forces_sym(p[:256], m[:256], p[256:], m[256:], EPS2,
                                 variant=name, schedule="fold")
    with pytest.raises(ValueError, match="fold"):
        jax_fps.resolve_schedule("fold", name)


# These run after the tests above in the same process (file order), so
# they also show the fixture restored every global enable() touched.
@pytest.mark.parametrize("name", NAMES)
def test_unreachable_before_enable(name, capsys):
    assert name not in variants.SYM_VARIANTS
    assert not variants.ABLATION_SYM_KERNELS
    assert not variants.ABLATION_RECT_KERNELS
    assert name not in variants.SYM_IMPL_VARIANTS.values()
    pos, _, mass = make_small_system(600, seed=156)
    p, m = t(pos), t(mass)
    with pytest.raises(ValueError, match="enable"):
        variants.forces_pallas_sym(p, m, EPS2, variant=name)
    with pytest.raises(ValueError, match="enable"):
        variants.rect_forces_sym(p[:256], m[:256], p[256:], m[256:], EPS2,
                                 variant=name)
    with pytest.raises(ValueError, match="impl"):
        SimConfig(impl=name)
    with pytest.raises(SystemExit) as exc:
        cli.main(["bench", "--n", "256", "--steps", "1", "--device", "cpu",
                  "--impl", name])
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def _tiles(seed, k=2):
    """k (row tile, column tile) pairs of 256 bodies each, as the sweeps
    hand them to a pair tile: (xi, mi, xj, mj)."""
    pos, _, mass = make_small_system(2 * k * SYM_TILE, seed=seed)
    x = t(pos).view(2 * k, SYM_TILE, 3)
    m = t(mass).view(2 * k, SYM_TILE)
    return x[:k], m[:k], x[k:], m[k:]


@pytest.mark.parametrize("seed", [166, 167])
def test_vpu_noj_rows_are_k7s_on_two_tiles(seed):
    """vpu_noj is K7's pair tile less its j side: on two 256-body tile
    pairs its row sums are K7's twin's bit for bit, within the exact
    tolerance of a float64 sum of m_j r / (|r|^2 + eps2)^(3/2), and it
    has no column sums."""
    tiles = _tiles(seed)
    xi, _, xj, mj = tiles
    rows, cols = ablation_sym._pair_tiles(EPS2, "vpu_noj")(*tiles)
    k7_rows, k7_cols = forces_sym._pair_tiles(EPS2, True, 1)(*tiles)
    assert torch.equal(rows, k7_rows)
    assert k7_cols.any() and not cols.any()
    r = (xj[:, None, :, :] - xi[:, :, None, :]).double()
    d2 = (r * r).sum(-1) + EPS2
    want = ((mj.double()[:, None, :] * d2 ** -1.5)[..., None] * r).sum(2)
    assert_close(rows.numpy(), want.numpy(), "vpu_noj rows vs float64",
                 tolerance("vpu_noj"))


@pytest.mark.parametrize("na, nb", [(300, 700), (1000, 257)])
def test_vpu_noj_rect_acc_a_is_k2_rect_vpus(na, nb):
    """On ragged sets the rect sweep of vpu_noj gives A K2-rect vpu's
    acc_a bit for bit (its row slots are K2-rect vpu's, added in the same
    order) and B nothing."""
    pos, _, mass = make_small_system(na + nb, seed=168)
    sets = (t(pos[:na]), t(mass[:na]), t(pos[na:]), t(mass[na:]))
    acc_a, acc_b = ablation_sym.rect_forces_sym_ablation(*sets, EPS2,
                                                         "vpu_noj")
    k7_a, k7_b = forces_sym.rect_forces_sym_vpu(*sets, EPS2)
    assert torch.equal(acc_a, k7_a)
    assert k7_b.any() and not acc_b.any()


def _k5_weights(xi, mi, xj, mj):
    """K5's bf16 weights, from its trimmed geometry: bf16(m_j inv) for
    the force on i, bf16(m_i inv) for the force on j, as float32."""
    inv = pair_inv_fma(xi, xj, EPS2)
    return ((mj[:, None, :] * inv).to(torch.bfloat16).float(),
            (mi[:, :, None] * inv).to(torch.bfloat16).float())


def test_tmm_noj_rows_are_k5s_on_two_tiles():
    """tmm_noj is K5's tile less its j side: on two 256-body tile pairs
    its row sums are K5's, the bf16(m_j inv) weights times the column
    positions, bit for bit, and it has no column sums."""
    tiles = _tiles(160)
    xi, _, xj, _ = tiles
    wi, _ = _k5_weights(*tiles)
    want = tile_result(wi @ position_pack(xj), xi)
    rows, cols = ablation_sym._pair_tiles(EPS2, "tmm_noj")(*tiles)
    k5_rows, k5_cols = forces_sym_tc._pair_tiles(*tiles, EPS2, "turbo")
    assert torch.equal(rows, want) and torch.equal(k5_rows, want)
    assert k5_cols.any() and not cols.any()


@pytest.mark.parametrize("na, nb", [(300, 700), (1000, 257)])
def test_tmm_noj_rect_acc_a_is_k5s(na, nb):
    """On ragged sets the rect sweep of tmm_noj gives A K2-rect turbo's
    acc_a bit for bit (a row reads only its own row sums, added in the
    same order) and B nothing."""
    pos, _, mass = make_small_system(na + nb, seed=161)
    sets = (t(pos[:na]), t(mass[:na]), t(pos[na:]), t(mass[na:]))
    acc_a, acc_b = ablation_sym.rect_forces_sym_ablation(*sets, EPS2,
                                                         "tmm_noj")
    k5_a, k5_b = forces_sym_tc.rect_forces_sym_tc_plain(*sets, EPS2, "turbo")
    assert torch.equal(acc_a, k5_a)
    assert k5_b.any() and not acc_b.any()


@pytest.mark.parametrize("seed", [162, 163])
def test_tmm_nomm_sums_k5s_weights(seed):
    """tmm_nomm's tile is, in each of the three components of a row, the
    sum over the row of K5's bf16 weights of both sides, bf16(m_j inv) and
    bf16(m_i inv), those that give K5's twin's row and column sums; it has
    no column sums."""
    tiles = _tiles(seed)
    xi, _, xj, _ = tiles
    wi, wj = _k5_weights(*tiles)
    rows, cols = ablation_sym._pair_tiles(EPS2, "tmm_nomm")(*tiles)
    k5_rows, k5_cols = forces_sym_tc._pair_tiles(*tiles, EPS2, "turbo")
    assert torch.equal(tile_result(wi @ position_pack(xj), xi), k5_rows)
    assert torch.equal(
        tile_result(wj.transpose(1, 2) @ position_pack(xi), xj), k5_cols)
    want = wi.sum(2) + wj.sum(2)
    for c in range(3):
        assert torch.equal(rows[..., c], want)
    assert not cols.any()


def test_wrappers_check_their_inputs():
    pos, _, mass = make_small_system(300, seed=157)
    with pytest.raises(ValueError, match="ablation must be one of"):
        ablation_sym.forces_sym_ablation(t(pos), t(mass), EPS2, "vpu")
    with pytest.raises(ValueError, match="float32"):
        ablation_sym.forces_sym_ablation(t(pos).double(), t(mass).double(),
                                         EPS2, "vpu_noj")
    assert forces_sym.SYM_TILE == forces_sym_tc.SYM_TILE == SYM_TILE
