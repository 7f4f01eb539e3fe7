"""The JAX rounds' platform probes, hand-written in CUDA, and their runs.

``scripts/r3_platbug.py`` and ``scripts/r8_mosaic_rules.py`` tested two
TPU mechanisms that shaped the JAX package's kernels; their Pallas kernels
are the last ``pl.pallas_call`` sites of the repository outside
``nbody_tpu/``.  Their counterparts are in ``csrc/probes.cu``:

- r3, the operand-ingestion bug (the reason every tensor-core tier derives
  its bf16 position pack inside the kernel): ``pack_sum`` sums the columns
  of a premade bf16 pack ``[x_hi y_hi z_hi x_lo y_lo z_lo 1 0]`` in blocks
  of U rows (``red_kernel``, r3_platbug.py:69), ``derive_pack_sum`` the
  same pack derived in the kernel from float32 positions with the tiers'
  own ``split_bf16`` (``derive_kernel``, :91).  Each block's sum is a
  float32 running sum a thread (rows t, t + 256, ...) and a fixed tree
  over the 256 threads; the blocks' sums are added in block order from
  zero, as the TPU grid accumulates them.  ``run_r3`` feeds ``pack_sum``
  a pack built on the card by torch, the same bits round-tripped through
  the host, and ``derive_pack_sum`` the positions: the three agree bit for
  bit when a premade pack reaches a kernel intact.
- r8, Mosaic's lowering rules for manual-DMA kernels (which shaped K13):
  the six bodies behind ``run`` (r8_mosaic_rules.py:31) as
  ``workspace_copy`` (1a, 1b: ``k_any`` through a (2, 8, 128) device
  workspace), ``staged_copy`` (1c, ``k_ws``), ``ref_slice`` (2a,
  ``k_refslice``: rows 0-2 only, the output allocated NaN as interpret
  mode leaves it), ``value_slice`` (2b, ``k_valslice``), ``narrow_copy``
  (3a, ``k_narrow``, an (8, 3) buffer) and ``value_transpose`` (3b,
  ``k_transpose``); and probe 4's remote copy to device 0 at P = 1
  (``k_remote``, :121) as ``peer_copy``: the staged tile stored into the
  receiver's buffer (at P = 1 the card's own output), then a flag released
  at system scope and waited on, K13's mechanism across cards
  (``csrc/peer_flags.cuh``).  The flag word, its epoch and the error word
  are the probe's own, one of each a card, so that this layer does not
  reach into ``parallel/``.

The wrappers take the plain PyTorch versions (``*_plain``: the same block,
thread and tree order in float32 for r3, torch indexing for r8) only for
CPU tensors; the plain versions are also the arrays the JAX bodies define,
as ``tests/test_torch_probes.py`` holds them.  For a CUDA tensor they
launch the kernel or raise.  Launches are counted on each wrapper's
``launches``.

``run_r3`` and ``run_r8`` run the scripts' probes (``scripts/
r3_platbug_torch.py``, ``scripts/r8_mosaic_rules_torch.py``): each runs
every probe on a device and returns a record whose ``ok`` is False when a
probe failed or differs from its plain version.  Unlike the JAX scripts
they write no file.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

# r3's threads a block (PROBE_THREADS in csrc/probes.cu) and r8's tile
# (R8_ROWS, R8_LANES).
PROBE_THREADS = 256
R8_SHAPE = (8, 128)
# csrc/probes.cu's R8Probe indices.
R8_KERNELS = {"workspace": 0, "staged": 1, "ref_slice": 2, "value_slice": 3,
              "narrow": 4, "transpose": 5}

# r3_platbug.py's system: N positions uniform in +-1e5 from
# numpy.random.default_rng(3), summed in blocks of U rows (R3_U in
# csrc/probes.cu).
R3_N, R3_U, R3_SEED = 16384, 2048, 3
# The JAX script's expectation of the sums against float64 (r3_platbug.py:
# 131: "~1e-3-level agreement"), held as a gate here.
R3_REL_GATE = 1e-3

_c_ll, _c_ptr, _c_int = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
_c_ull = ctypes.c_ulonglong


def _lib():
    lib = _build.load("probes")
    if lib.nbt_probe_geometry.argtypes is None:
        lib.nbt_probe_pack_sum.argtypes = [_c_ptr, _c_int, _c_ll, _c_ptr,
                                           _c_ptr, _c_ptr]
        lib.nbt_probe_copy.argtypes = [_c_int, _c_ptr, _c_ptr, _c_ptr,
                                       _c_ptr]
        lib.nbt_probe_peer_copy.argtypes = [_c_ptr, _c_ptr, _c_ptr, _c_ull,
                                            _c_ull, _c_ptr, _c_ptr]
        lib.nbt_probe_geometry.argtypes = [_c_int]
        for fn in (lib.nbt_probe_pack_sum, lib.nbt_probe_copy,
                   lib.nbt_probe_peer_copy):
            fn.restype = _c_int
        lib.nbt_probe_geometry.restype = _c_ll
        built = [_build.query(None, lib.nbt_probe_geometry, k)
                 for k in range(10)]
        if built != [PROBE_THREADS, R3_U, *R8_SHAPE, *R8_KERNELS.values()]:
            raise RuntimeError(f"the probes' layout in csrc/probes.cu "
                               f"({built}) differs from ops/probes.py's")
    return lib


# -- r3: the bf16 pack's column sums

def pack8(pos: torch.Tensor) -> torch.Tensor:
    """The bf16 pack ``[x_hi y_hi z_hi x_lo y_lo z_lo 1 0]`` of (N, 3)
    float32 positions: hi = bf16(x), lo = bf16(x - hi), both to nearest
    even (r3_platbug.py's ``pack8_jnp``)."""
    hi = pos.to(torch.bfloat16)
    lo = (pos - hi.float()).to(torch.bfloat16)
    one = torch.ones(pos.shape[0], 1, dtype=torch.bfloat16, device=pos.device)
    return torch.cat([hi, lo, one, torch.zeros_like(one)], dim=1)


def _check_blocks(what: str, n: int) -> None:
    if n < 1 or n % R3_U:
        raise ValueError(f"{what}: N = {n} rows: N must be a positive "
                         f"multiple of U = {R3_U}")


def pack_sum_plain(pack: torch.Tensor) -> torch.Tensor:
    """Plain twin of the kernel: in each block of ``R3_U`` rows thread t
    sums rows t, t + 256, ... in float32, the 256 sums meet in a tree (sum
    t += sum t + s for t < s, s = 128 .. 1), and the blocks' sums are added
    in block order from zero.  (N, 8) bf16 -> (8,) float32."""
    x = pack.float().view(pack.shape[0] // R3_U, R3_U // PROBE_THREADS,
                          PROBE_THREADS, 8)
    acc = torch.zeros_like(x[:, 0])
    for k in range(x.shape[1]):
        acc = acc + x[:, k]
    width = PROBE_THREADS
    while width > 1:
        width //= 2
        acc = acc[:, :width] + acc[:, width:2 * width]
    out = torch.zeros(8, dtype=torch.float32, device=pack.device)
    for b in range(acc.shape[0]):
        out = out + acc[b, 0]
    return out


def derive_pack_sum_plain(pos: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``derive_pack_sum``: ``pack_sum_plain`` of
    ``pack8(pos)``.  (N, 3) float32 -> (8,) float32."""
    return pack_sum_plain(pack8(pos))


def _pack_launch(what: str, t: torch.Tensor, derive: bool) -> torch.Tensor:
    lib = _lib()
    n = t.shape[0]
    partials = torch.empty(n // R3_U, 8, dtype=torch.float32,
                           device=t.device)
    out = torch.empty(8, dtype=torch.float32, device=t.device)
    _build.launch(what, out, lib.nbt_probe_pack_sum, t.data_ptr(),
                  int(derive), n, partials.data_ptr(), out.data_ptr())
    return out


def pack_sum(pack: torch.Tensor) -> torch.Tensor:
    """Column sums of a premade (N, 8) bf16 pack in blocks of ``R3_U``
    rows (r3's ``red_kernel``).  Returns (8,) float32."""
    if (pack.dtype != torch.bfloat16 or pack.dim() != 2
            or pack.shape[1] != 8 or not pack.is_contiguous()):
        raise ValueError("pack_sum: the pack must be a contiguous (N, 8) "
                         f"bfloat16 tensor, got {pack.dtype} "
                         f"{tuple(pack.shape)}")
    _check_blocks("pack_sum", pack.shape[0])
    if pack.device.type == "cpu":
        return pack_sum_plain(pack)
    if pack.data_ptr() % 16:
        raise ValueError("pack_sum: the pack must be 16-byte aligned")
    pack_sum.launches += 1
    return _pack_launch("pack_sum (r3)", pack, False)


# r3 pack sums launched through the wrapper.
pack_sum.launches = 0


def derive_pack_sum(pos: torch.Tensor) -> torch.Tensor:
    """The same column sums with the pack derived in the kernel from (N, 3)
    float32 positions (r3's ``derive_kernel``).  Returns (8,) float32."""
    if (pos.dtype != torch.float32 or pos.dim() != 2 or pos.shape[1] != 3
            or not pos.is_contiguous()):
        raise ValueError("derive_pack_sum: positions must be a contiguous "
                         f"(N, 3) float32 tensor, got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    _check_blocks("derive_pack_sum", pos.shape[0])
    if pos.device.type == "cpu":
        return derive_pack_sum_plain(pos)
    derive_pack_sum.launches += 1
    return _pack_launch("derive_pack_sum (r3)", pos, True)


# r3 derived-pack sums launched through the wrapper.
derive_pack_sum.launches = 0


def r3_positions(n: int = R3_N, seed: int = R3_SEED) -> np.ndarray:
    """r3_platbug.py's positions: uniform in +-1e5, float32."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1e5, 1e5, (n, 3)).astype(np.float32)


def run_r3(device="cuda", log=print) -> dict:
    """r3_platbug.py on ``device``: the pack sums fed (a) the pack built on
    the device by torch on ``pos * 1.0``, (b) the same bits round-tripped
    through the host, (c) the positions, the pack derived in the kernel;
    each against the float64 host sum, (a) against (b), and every sum
    against its plain version on the same input.  The record's ``ok``:
    the three bit-equal, each equal to its plain version, within
    ``R3_REL_GATE`` of float64, and the verdict clean."""
    from ..utils.device import require_device
    dev = require_device(device)
    log(f"device: {dev}")
    pos_host = torch.from_numpy(r3_positions())
    pos_dev = pos_host.to(dev)
    pack_dev = pack8(pos_dev * 1.0)
    pack_host = pack_dev.cpu().to(dev)
    if not torch.equal(pack_dev.cpu(), pack_host.cpu()):
        raise RuntimeError("r3: the host round trip changed the pack")
    ref = pack8(pos_host).double().sum(0)
    res = {"premade_dev": pack_sum(pack_dev),
           "premade_host": pack_sum(pack_host),
           "derived": derive_pack_sum(pos_dev)}
    plain = {"premade_dev": pack_sum_plain(pack_dev),
             "premade_host": pack_sum_plain(pack_host),
             "derived": derive_pack_sum_plain(pos_dev)}
    max_rel, plain_equal = {}, {}
    for k, v in res.items():
        rel = (v.cpu().double() - ref).abs() / (ref.abs() + 1e-30)
        max_rel[k] = float(rel.max())
        plain_equal[k] = bool(torch.equal(v, plain[k]))
        log(f"[{k}] max rel err vs f64 host sum: {max_rel[k]:.3g}")
    dev_vs_host = float((res["premade_dev"] - res["premade_host"]).abs()
                        .max())
    log(f"[premade dev vs host] max abs diff: {dev_vs_host:.3g}")
    clean = (dev_vs_host == 0.0
             and abs(max_rel["premade_dev"] - max_rel["derived"]) < 1e-6)
    if clean:
        log("VERDICT: premade-operand ingestion CLEAN on this probe "
            "(bug not reproduced)")
    else:
        log("VERDICT: premade-operand corruption REPRODUCED "
            "(workaround stays)")
    bit_equal = all(torch.equal(res["premade_dev"], v) for v in res.values())
    log(f"[variants] bit-equal: {bit_equal}; each equal to its plain "
        f"version: {plain_equal}")
    return {"stage": "r3_platbug", "device": str(dev), "n": R3_N, "u": R3_U,
            "max_rel": max_rel, "dev_vs_host_absdiff": dev_vs_host,
            "sums": res["premade_dev"].cpu().tolist(),
            "verdict": "clean" if clean else "reproduced",
            "bit_equal": bit_equal, "plain_equal": plain_equal,
            "ok": bool(clean and bit_equal and all(plain_equal.values())
                       and max(max_rel.values()) <= R3_REL_GATE)}


# -- r8: the copy probes on an (8, 128) float32 tile

def _check_tile(what: str, x: torch.Tensor) -> None:
    if (x.dtype != torch.float32 or tuple(x.shape) != R8_SHAPE
            or not x.is_contiguous()
            or x.device.type not in ("cpu", "cuda")):
        raise ValueError(f"{what}: x must be a contiguous (8, 128) float32 "
                         f"tensor on the CPU or a CUDA card, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def workspace_copy_plain(x: torch.Tensor) -> torch.Tensor:
    ws = x.new_empty(2, *R8_SHAPE)
    ws[0] = x
    return ws[0].clone()


def staged_copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def ref_slice_plain(x: torch.Tensor) -> torch.Tensor:
    out = torch.full_like(x, float("nan"))
    out[:3] = x[:3]
    return out


def value_slice_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[:3] * 2.0, x[3:]])


def narrow_copy_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[:, :3], x.new_zeros(R8_SHAPE[0], R8_SHAPE[1] - 3)],
                     dim=1)


def value_transpose_plain(x: torch.Tensor) -> torch.Tensor:
    tile = x[0:3].T * x[3:4].T
    return torch.cat([tile.T, x.new_zeros(1, R8_SHAPE[1])])


def peer_copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def _copy_probe(what: str, which: str, plain, out_rows: int = R8_SHAPE[0],
                fill: "float | None" = None):
    def probe(x: torch.Tensor) -> torch.Tensor:
        _check_tile(what, x)
        if x.device.type == "cpu":
            return plain(x)
        lib = _lib()
        shape = (out_rows, R8_SHAPE[1])
        out = (x.new_empty(shape) if fill is None
               else x.new_full(shape, fill))
        ws = x.new_empty(2, *R8_SHAPE) if which == "workspace" else None
        probe.launches += 1
        _build.launch(f"{what} (r8)", out, lib.nbt_probe_copy,
                      R8_KERNELS[which], x.data_ptr(),
                      ws.data_ptr() if ws is not None else None,
                      out.data_ptr())
        return out
    probe.__name__ = probe.__qualname__ = what
    probe.__doc__ = (f"r8's {which} probe on an (8, 128) float32 tile "
                     f"(csrc/probes.cu, nbt_probe_copy); its plain version "
                     f"is ``{plain.__name__}``.")
    probe.launches = 0
    return probe


workspace_copy = _copy_probe("workspace_copy", "workspace",
                             workspace_copy_plain)
staged_copy = _copy_probe("staged_copy", "staged", staged_copy_plain)
ref_slice = _copy_probe("ref_slice", "ref_slice", ref_slice_plain,
                        fill=float("nan"))
value_slice = _copy_probe("value_slice", "value_slice", value_slice_plain)
narrow_copy = _copy_probe("narrow_copy", "narrow", narrow_copy_plain)
value_transpose = _copy_probe("value_transpose", "transpose",
                              value_transpose_plain, out_rows=4)

# probe 4's flag word, its epoch and the error word a card, kept across
# calls: the epoch counts up.  The bound of its wait (at P = 1 the flag is
# its own, so the wait ends at once unless the release is lost).
_PEER_FLAGS: dict = {}
PEER_SPIN_NS = 10 ** 9


class _PeerFlag:
    def __init__(self, device: torch.device):
        self.word = torch.zeros(1, dtype=torch.int64, device=device)
        self.err = torch.zeros(1, dtype=torch.int64, device=device)
        self.epoch = 0


def peer_copy_errors() -> None:
    """Raise if probe 4's wait ran out on a card (after the card's queued
    work); that card's flag is then made anew."""
    for device, flag in list(_PEER_FLAGS.items()):
        code = int(flag.err)
        if code:
            del _PEER_FLAGS[device]
            raise RuntimeError(f"peer_copy: the wait for flag value {code} "
                               f"on {device} ran past "
                               f"{PEER_SPIN_NS / 1e9:g} s")


def peer_copy(x: torch.Tensor) -> torch.Tensor:
    """r8's probe 4, a remote copy to device 0 at P = 1, as K13's hop
    across cards: x staged in shared memory, stored into the receiver's
    buffer (this call's output), a flag released at system scope in the
    receiver's flag word and waited on."""
    _check_tile("peer_copy", x)
    if x.device.type == "cpu":
        return peer_copy_plain(x)
    lib = _lib()
    device = torch.device("cuda", x.device.index
                          if x.device.index is not None
                          else torch.cuda.current_device())
    flag = _PEER_FLAGS.get(device)
    if flag is None:
        flag = _PEER_FLAGS[device] = _PeerFlag(device)
    out = torch.empty_like(x)
    flag.epoch += 1
    peer_copy.launches += 1
    _build.launch("peer_copy (r8 probe 4)", out, lib.nbt_probe_peer_copy,
                  x.data_ptr(), out.data_ptr(), flag.word.data_ptr(),
                  flag.epoch, PEER_SPIN_NS, flag.err.data_ptr())
    return out


# r8 probe 4 launches made through the wrapper.
peer_copy.launches = 0


def r8_tile() -> np.ndarray:
    """r8_mosaic_rules.py's x8: arange(1024) float32 as (8, 128)."""
    return np.arange(8 * 128, dtype=np.float32).reshape(R8_SHAPE)


# r8_mosaic_rules.py's probes in its order: label, the expectation the
# script records on the v5e relay stack (August 2026), the wrapper and its
# plain version.
R8_PROBES = (
    ("1a ANY scratch", "FAIL", workspace_copy, workspace_copy_plain),
    ("1b HBM scratch", "FAIL", workspace_copy, workspace_copy_plain),
    ("1c VMEM scratch + ANY in/out", "OK", staged_copy, staged_copy_plain),
    ("2a sublane ref slice", "FAIL", ref_slice, ref_slice_plain),
    ("2b value row split", "OK", value_slice, value_slice_plain),
    ("3a narrow-lane scratch", "FAIL", narrow_copy, narrow_copy_plain),
    ("3b narrow value transpose", "OK", value_transpose,
     value_transpose_plain),
    ("4 remote DMA to self", "OK", peer_copy, peer_copy_plain),
)


def run_r8(device="cuda", log=print) -> dict:
    """r8_mosaic_rules.py on ``device``: every probe on x8, OK when it ran,
    exact when its output equals, bit for bit and NaN for NaN, its plain
    version on the host's copy of x8 (the array its JAX body defines).
    The v5e expectation is reported as text only.  The record's ``ok``:
    every probe OK and exact."""
    from ..utils.device import require_device
    dev = require_device(device)
    log(f"device: {dev}")
    x_host = torch.from_numpy(r8_tile())
    x = x_host.to(dev)
    probes = []
    for label, v5e, probe, plain in R8_PROBES:
        rec = {"label": label, "kernel": probe.__name__, "v5e": v5e}
        try:
            out = probe(x)
            if probe is peer_copy:
                peer_copy_errors()
            got = out.cpu()
        except Exception as e:  # recorded as the JAX script records it
            rec.update(ok=False, exact=False,
                       error=f"{type(e).__name__}: {e}")
            log(f"{label}: FAIL (v5e expected {v5e}) — "
                f"{str(e)[:90].replace(chr(10), ' ')}")
            probes.append(rec)
            continue
        want = plain(x_host)
        exact = bool(got.shape == want.shape
                     and torch.equal(got.nan_to_num(), want.nan_to_num())
                     and torch.equal(got.isnan(), want.isnan()))
        rec.update(ok=True, exact=exact)
        log(f"{label}: OK exact={exact} (v5e expected {v5e})")
        probes.append(rec)
    return {"stage": "r8_mosaic_rules", "device": str(dev), "probes": probes,
            "ok": all(p["ok"] and p["exact"] for p in probes)}
