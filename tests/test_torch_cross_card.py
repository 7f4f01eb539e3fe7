"""The mesh across cards, on the CPU: the placement rule of
``parallel/mesh.py``, K13's launch plan and flag layout
(``parallel/rdma_ring.py`` against ``csrc/rdma_ring.cu``), a model of the
flag protocol, and the device guard every call into a built library goes
through (``ops/_build.py``).

The model runs each shard's program of ``group_ring`` (csrc/rdma_ring.cu)
as a generator that stops at every wait of the kernel, its flag words kept
across evaluations as the wrapper keeps them; a seeded scheduler resumes
any shard whose wait the flags allow, the shards of one card's launch end
together, and a card starts its next launch only once its last has ended.
Its payloads are real: the phases run the plain twin's tiles
(``rdma_ring._phase``) on what the protocol has delivered, so the sums are
held to ``rdma_ring_plain`` bit for bit.  It asserts that no slot is
written while a read of its last payload is still to come, that no launch
is written into, nor a shard's bodies read, once that launch has ended,
that every schedule finishes, and that every flag ends at the value
``RingPlan.flags_after`` gives.  The kernel itself is held to the
grid-sync kernel and to its twin on the card by ``chip_smoke.py``.
"""

import ast
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from nbody_tpu_torch.config import _VALID_IMPLS
from nbody_tpu_torch.models.integrators import KDK_WEIGHTS
from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.ops.forces_sym import rect_descale_plain
from nbody_tpu_torch.parallel import multiprog, rdma_ring, ring
from nbody_tpu_torch.parallel.mesh import make_mesh, placement
from nbody_tpu_torch.parallel.rdma_ring import (EPOCH_SHIFT, FLAG,
                                                launch_plan, ring_phases)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EPS2 = 0.002
T = rdma_ring.SYM_TILE


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


# -- placement

@pytest.mark.parametrize("cards", [1, 2, 4])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5])
def test_placement_cuda_round_robin(p, cards):
    """``"cuda"``: shard i on card i % count, JAX's device i while P is at
    most the card count."""
    want = [f"cuda:{i % cards}" for i in range(p)]
    assert placement(p, "cuda", cards) == want
    if p <= cards:
        assert placement(p, "cuda", cards) == [f"cuda:{i}" for i in range(p)]


@pytest.mark.parametrize("k", [0, 1, 3])
def test_placement_one_named_card(k):
    assert placement(5, f"cuda:{k}", 4) == [f"cuda:{k}"] * 5
    assert placement(3, "cpu", 4) == ["cpu"] * 3
    with pytest.raises(ValueError, match="card"):
        placement(2, "cuda:4", 4)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        placement(2, "cuda", 0)
    with pytest.raises(ValueError, match="positive"):
        placement(0, "cuda", 2)


def test_describe_names_cards_and_crossing_hops():
    from nbody_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh(tuple(torch.device(d) for d in placement(5, "cuda", 4)))
    line = mesh.describe()
    assert "shards 0,4 on cuda:0" in line and "shards 3 on cuda:3" in line
    assert "hops across cards: 0->1, 1->2, 2->3, 3->4" in line
    assert "one device" in make_mesh(3, "cpu").describe()


# -- the launch plan and the kernel's layout

def test_launch_plan_five_shards_on_four_cards():
    """Card 0 holds shards 0 and 4: its launch has a hop within it (4 ->
    0) and one leaving it (0 -> 1); the return hops go D = 2 back."""
    plan = launch_plan(placement(5, "cuda", 4))
    assert plan.launches == (("cuda:0", (0, 4)), ("cuda:1", (1,)),
                             ("cuda:2", (2,)), ("cuda:3", (3,)))
    assert plan.hops == ("peer", "peer", "peer", "peer", "local")
    assert (plan.half, plan.d_final) == (2, 2)
    assert plan.returns == ((3, "peer"), (4, "peer"), (0, "peer"),
                            (1, "peer"), (2, "peer"))
    one = launch_plan(placement(5, "cuda:0", 4))
    assert one.launches == (("cuda:0", (0, 1, 2, 3, 4)),)
    assert set(one.hops) == {"local"}
    assert launch_plan(["a"] * 4, one_sided=True).returns == (None,) * 4


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 8])
def test_flags_after(p):
    e = 3 << EPOCH_SHIFT
    plan = launch_plan(["x"] * p)
    half, d = ring_phases(p, False)
    words = plan.flags_after(3, overlap=True, readers={1})
    assert words[FLAG["enter"]] == e + 1
    assert words.get(FLAG["ack"]) == (e + d if p > 1 else None)
    assert words.get(FLAG["ret"]) == (e + 1 if half else None)
    assert words.get(FLAG["data"] + d % 2) == (e + d if d else None)
    odd = max([k for k in range(1, d + 1) if k % 2], default=0)
    assert words.get(FLAG["trav"] + 1) == (e + odd if half else None)
    assert words[FLAG["done"] + 1] == e + 1


def _c_constants():
    src = (ROOT / "nbody_tpu_torch/csrc/rdma_ring.cu").read_text()
    defines = dict(re.findall(r"#define (RING_\w+) (\d+)", src))
    body = re.search(r"enum RingFlag \{(.*?)\};", src, re.S).group(1)
    flags = dict(re.findall(r"RF_(\w+) = (\w+)", body))
    waits = re.search(r"enum RingWait \{(.*?)\};", src, re.S).group(1)
    return src, defines, flags, dict(re.findall(r"RW_(\w+) = (\d+)", waits))


def test_layout_mirrors_the_kernel():
    """The flag words, the epoch shift, the payload floats a body and the
    error word's wait kinds, as csrc/rdma_ring.cu has them (``bind``
    checks the same against a build on the card)."""
    src, defines, flags, waits = _c_constants()
    assert int(defines["RING_MAX_SHARDS"]) == rdma_ring.RING_MAX_SHARDS
    assert int(defines["RING_EPOCH_SHIFT"]) == rdma_ring.EPOCH_SHIFT
    assert int(defines["RING_PEER_FLOATS"]) == rdma_ring.PEER_FLOATS
    assert {k.lower(): int(v) for k, v in flags.items()
            if k != "WORDS"} == FLAG
    assert re.search(r"RF_WORDS = RF_DONE \+ RING_MAX_SHARDS", src)
    assert sorted(map(int, waits.values())) == sorted(rdma_ring.WAITS)
    # 2 x 3 + 2 data floats, 2 x 3 travel, 3 return-hop rows a body.
    assert rdma_ring.PEER_FLOATS == 2 * 4 + 2 * 3 + 3


# -- the flag protocol, modelled

class _Card:
    """A card's stream: its launches one after another."""

    def __init__(self, shards):
        self.shards = shards
        self.epoch = 0          # the launch running (or last run)
        self.ended = 0          # the last launch that has ended


class _Model:
    """Every shard's ``group_ring`` over ``evals`` evaluations (see the
    module docstring)."""

    def __init__(self, pos, mass, devices, variant, one_sided, overlap,
                 evals, seed):
        self.p = p = len(devices)
        self.nt = pos.shape[0] // p // T
        self.xs = pos.view(p, self.nt, T, 3)
        self.ms = mass.view(p, self.nt, T)
        self.variant, self.one_sided, self.overlap = (variant, one_sided,
                                                      overlap)
        self.half, self.d = ring_phases(p, one_sided)
        self.plan = launch_plan(devices, one_sided)
        self.cards = {d: _Card(sh) for d, sh in self.plan.launches}
        self.card_of = {s: d for d, sh in self.plan.launches for s in sh}
        self.descale = variant in rdma_ring._MASS_SCALED
        zero = (self.ms == 0).flatten(1).any(1).tolist()
        self.readers = ({s for s in range(p) if zero[s]} if self.descale
                        else set())
        self.flags = [dict() for _ in range(p)]
        self.evals = evals
        self.rng = np.random.default_rng(seed)
        self.out = {}

    # flags
    def flag(self, s, word):
        return self.flags[s].get(word, 0)

    def signal(self, s, word, value):
        assert value >= self.flag(s, word), "a flag went down"
        self.flags[s][word] = value

    # buffers: (epoch, shard) -> slot -> payload; pending reads per slot
    def write(self, e, s, slot, value, reads):
        card = self.cards[self.card_of[s]]
        assert card.epoch == e and card.ended < e, (
            f"shard {s}'s launch {e} is written into while not running")
        buf = self.bufs.setdefault((e, s), {})
        old = self.pending.get((e, s, slot), set())
        assert not old, (f"slot {slot} of shard {s} written while {old} "
                         f"of its last payload are still to come")
        buf[slot] = value
        self.pending[(e, s, slot)] = set(reads)

    def read(self, e, s, slot, who):
        self.pending[(e, s, slot)].discard(who)
        return self.bufs[(e, s)][slot]

    def bodies(self, e, q):
        card = self.cards[self.card_of[q]]
        assert card.epoch == e and card.ended < e and \
            self.flag(q, FLAG["enter"]) >= (e << EPOCH_SHIFT) + 1, (
                f"shard {q}'s bodies read outside its launch {e}")
        return self.xs[q], self.ms[q]

    def phase(self, s, d, data, trav):
        return rdma_ring._phase(self.variant, EPS2, self.xs[s], self.ms[s],
                                *data, trav, self.overlap, d == 0)

    def reads_of(self, d, kind):
        """Who reads the payload of phase d in a slot, as (step, phase)
        tags: the phase's compute (its data; its travel rows on a
        two-sided phase), the next phase's forward, or the return hop."""
        tags = set()
        if d > 0 and (kind == "data" or d <= self.half):
            tags.add(("compute", d))
        if d < self.d:
            tags.add(("forward", d + 1))
        elif kind == "trav":
            tags.add(("return", d))
        return tags

    def program(self, s, e):
        p, d_fin, E = self.p, self.d, e << EPOCH_SHIFT
        right, left = (s + 1) % p, (s - 1) % p
        any_trav = self.half > 0
        self.signal(s, FLAG["enter"], E + 1)
        if p > 1:
            self.signal(left, FLAG["ack"], E)
        zeros = torch.zeros_like(self.xs[s])
        own = (self.xs[s], self.ms[s])
        acc = None
        for d in range(d_fin + 1):
            dst, src = d % 2, (d + 1) % 2
            two = 0 < d <= self.half
            nxt = d < d_fin
            if d == 0:
                if self.overlap and nxt:
                    yield s, FLAG["ack"], E
                rows, _ = self.phase(s, 0, own, None)
                if nxt and not self.overlap:
                    self.write(e, s, ("data", 0), own, self.reads_of(0,
                                                                     "data"))
                    if any_trav:
                        self.write(e, s, ("trav", 0), zeros,
                                   self.reads_of(0, "trav"))
                elif nxt:
                    self.write(e, right, ("data", 1), own,
                               self.reads_of(1, "data"))
                    self.signal(right, FLAG["data"] + 1, E + 1)
                    if any_trav:
                        self.write(e, right, ("trav", 1), zeros,
                                   self.reads_of(1, "trav"))
                        self.signal(right, FLAG["trav"] + 1, E + 1)
                acc = rows
                continue
            if not self.overlap:
                yield s, FLAG["ack"], E + d - 1
                payload = self.read(e, s, ("data", src), ("forward", d))
                self.write(e, right, ("data", dst), payload,
                           self.reads_of(d, "data"))
                if any_trav:
                    t = self.read(e, s, ("trav", src), ("forward", d))
                    self.write(e, right, ("trav", dst), t,
                               self.reads_of(d, "trav"))
                self.signal(right, FLAG["data"] + dst, E + d)
                self.signal(left, FLAG["ack"], E + d)
                yield s, FLAG["data"] + dst, E + d
                data = self.read(e, s, ("data", dst), ("compute", d))
                trav = (self.read(e, s, ("trav", dst), ("compute", d))
                        if two else None)
                rows, t = self.phase(s, d, data, trav)
                if two:
                    self.bufs[(e, s)][("trav", dst)] = t
                acc = acc + rows
                continue
            yield s, FLAG["data"] + dst, E + d
            if nxt:
                yield s, FLAG["ack"], E + d - 1
            data = self.read(e, s, ("data", dst), ("compute", d))
            if nxt:
                payload = self.read(e, s, ("data", dst), ("forward", d + 1))
                self.write(e, right, ("data", src), payload,
                           self.reads_of(d + 1, "data"))
                self.signal(right, FLAG["data"] + src, E + d + 1)
            rows, jacc = self.phase(s, d, data,
                                    torch.zeros_like(self.xs[s]) if two
                                    else None)
            acc = acc + rows
            if any_trav:
                yield s, FLAG["trav"] + dst, E + d
            if two:   # travel + jacc
                t = self.read(e, s, ("trav", dst), ("compute", d))
                self.bufs[(e, s)][("trav", dst)] = t + jacc
            if any_trav and nxt:
                t = self.read(e, s, ("trav", dst), ("forward", d + 1))
                self.write(e, right, ("trav", src), t,
                           self.reads_of(d + 1, "trav"))
                self.signal(right, FLAG["trav"] + src, E + d + 1)
            if nxt:
                self.signal(left, FLAG["ack"], E + d)
        if any_trav:
            home = (s - d_fin) % p
            t = self.read(e, s, ("trav", d_fin % 2), ("return", d_fin))
            self.write(e, home, "ret", t, {("finish", 0)})
            self.signal(home, FLAG["ret"], E + 1)
            yield s, FLAG["ret"], E + 1
            acc = acc + self.read(e, s, "ret", ("finish", 0))
        if self.overlap and d_fin > 0:
            self.signal(left, FLAG["ack"], E + d_fin)
        out = acc.reshape(-1, 3)
        if self.descale:
            reads = s in self.readers
            if reads:
                for q in range(p):
                    yield q, FLAG["enter"], E + 1
                every = [self.bodies(e, q) for q in range(p)]
                pos_all = torch.cat([x.reshape(-1, 3) for x, _ in every])
                mass_all = torch.cat([m.reshape(-1) for _, m in every])
            else:   # no body of mass 0: the descale reads no other shard
                pos_all, mass_all = self.xs[s].reshape(-1, 3), None
            out = rect_descale_plain(out, self.xs[s].reshape(-1, 3),
                                     self.ms[s].reshape(-1), pos_all,
                                     mass_all, EPS2)
            if reads:
                for q in range(p):
                    if q != s:
                        self.signal(q, FLAG["done"] + s, E + 1)
            for r in sorted(self.readers - {s}):
                yield s, FLAG["done"] + r, E + 1
        if p > 1:
            yield s, FLAG["ack"], E + d_fin
        self.out[e, s] = out

    def run(self):
        self.bufs, self.pending = {}, {}
        running = {}          # shard -> (generator, its wait or None)
        done = {d: set() for d in self.cards}

        def start(card_name):
            card = self.cards[card_name]
            card.epoch += 1
            for s in card.shards:
                running[s] = [self.program(s, card.epoch), None]
        for name in self.cards:
            start(name)
        while running:
            ready = [s for s, (_, w) in running.items()
                     if w is None or self.flag(w[0], w[1]) >= w[2]]
            assert ready, f"deadlock: every shard waits: {running}"
            s = int(self.rng.choice(ready))
            try:
                running[s][1] = next(running[s][0])
            except StopIteration:
                del running[s]
                name = self.card_of[s]
                card = self.cards[name]
                done[name].add(s)
                if done[name] == set(card.shards):   # the launch ends
                    card.ended = card.epoch
                    done[name] = set()
                    if card.epoch < self.evals:
                        start(name)
        left = {k: v for k, v in self.pending.items() if v}
        assert not left, f"payload reads that never came: {left}"
        want = self.plan.flags_after(self.evals, self.overlap,
                                     frozenset(self.readers))
        for s in range(self.p):
            got = {w: v for w, v in self.flags[s].items()}
            assert got == {w: v for w, v in want.items()
                           if not (w == FLAG["done"] + s)}, s
        return [torch.cat([self.out[e, s] for s in range(self.p)])
                for e in range(1, self.evals + 1)]


def _bodies(p, seed, zero=()):
    rng = np.random.default_rng(seed)
    n = p * T
    pos = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    mass[list(zero)] = 0.0
    return pos, mass


PLACEMENTS = {"one card": lambda p: ["cuda:0"] * p,
              "a card a shard": lambda p: [f"cuda:{i}" for i in range(p)],
              "four cards": lambda p: placement(p, "cuda", 4)}


@pytest.mark.parametrize("family", ["sym", "one-sided"])
@pytest.mark.parametrize("overlap", [False, True], ids=["seq", "overlap"])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6, 7, 8])
def test_flag_protocol_model(p, overlap, family):
    """Two evaluations in a row under two seeded schedules a placement:
    every schedule finishes, no slot is overwritten while unread, the
    flags end at their epoch, and the sums are the twin's bits."""
    one_sided = family == "one-sided"
    variant = "vpu" if one_sided else "vpu2"
    pos, mass = _bodies(p, 10 + p)
    want = rdma_ring.rdma_ring_plain(pos, mass, p, EPS2, variant, one_sided,
                                     overlap)
    for k, (name, place) in enumerate(PLACEMENTS.items()):
        model = _Model(pos, mass, place(p), variant, one_sided, overlap,
                       evals=2, seed=100 * p + k)
        for got in model.run():
            assert torch.equal(got, want), name


@pytest.mark.parametrize("overlap", [False, True], ids=["seq", "overlap"])
def test_massless_finish_reads_unvisited_shards(overlap):
    """A real massless body on shard 0 of P = 5 under vpu2: the half ring
    brings shard 0 the payloads of shards 4 and 3 only, so its finish
    reads shards 1 and 2 through their pointers.  The model holds every
    read inside the read shard's launch (after it entered, before it
    ended: the positions barrier) and the rows to the twin's bits."""
    pos, mass = _bodies(5, 3, zero=(7, 300))
    want = rdma_ring.rdma_ring_plain(pos, mass, 5, EPS2, "vpu2", False,
                                     overlap)
    assert torch.isfinite(want[[7, 300]]).all()
    assert want[7].abs().sum() > 0
    for k, (name, place) in enumerate(PLACEMENTS.items()):
        for seed in range(3):
            model = _Model(pos, mass, place(5), "vpu2", False, overlap,
                           evals=2, seed=seed + 10 * k)
            assert model.readers == {0, 1}
            for got in model.run():
                assert torch.equal(got, want), name


def test_model_sees_a_missing_ack():
    """The model is not blind: a sequential forward that skips its ack
    wait overwrites a slot whose payload is still to be read."""
    pos, mass = _bodies(4, 1)

    class NoAck(_Model):
        def program(self, s, e):
            for wait in super().program(s, e):
                if wait[1] == FLAG["ack"] and wait[0] == s and wait[2] > (
                        e << EPOCH_SHIFT) and s == 0:
                    continue
                yield wait
    with pytest.raises(AssertionError, match="still to come|not running"):
        for seed in range(20):
            NoAck(pos, mass, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"],
                  "vpu", True, False, evals=2, seed=seed).run()


# -- the sharded entry on the CPU

def test_rdma_ring_sharded_cpu_and_refusals():
    pos, mass = _bodies(3, 4)
    want = rdma_ring.rdma_ring_plain(pos, mass, 3, EPS2, "vpu2")
    got = rdma_ring.rdma_ring_sharded(list(pos.split(T)),
                                      list(mass.split(T)), EPS2, "vpu2")
    assert torch.equal(torch.cat(got), want)
    meta = [torch.empty(T, 3, device="meta"), torch.empty(T, 3)]
    with pytest.raises(ValueError, match="all lie on CUDA cards"):
        rdma_ring.rdma_ring_sharded(meta, [torch.empty(T)] * 2, EPS2, "vpu")


# -- the device guard

def _direct_entry_calls(path):
    tree = ast.parse(path.read_text())
    return [f"{path.relative_to(ROOT)}:{n.lineno}" for n in ast.walk(tree)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr.startswith("nbt_")]


def test_no_entry_is_called_past_the_guard():
    """No C entry (``nbt_*``) of a built library is called directly in the
    package, chip_smoke.py or tools/: each goes through ``_build.launch``
    or ``_build.query``."""
    files = [*sorted((ROOT / "nbody_tpu_torch").rglob("*.py")),
             ROOT / "chip_smoke.py", *sorted((ROOT / "tools").glob("*.py"))]
    bad = [hit for f in files for hit in _direct_entry_calls(f)]
    assert not bad, bad


class _FakeCDLL:
    """A library whose entries record the guard's device when called."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("nbt_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, _build._GUARD.device, args))
            return 0
        return entry


class _Tensor:
    def __init__(self, device):
        self.device = torch.device(device)


def test_guard_enters_the_tensors_card(monkeypatch):
    """``launch`` makes the tensor's card current around the call and
    passes that card's stream; ``query`` the named card's, or none for a
    layout constant; an entry called outside both raises."""
    entered = []

    class Device:
        def __init__(self, d):
            self.d = d

        def __enter__(self):
            entered.append(self.d)

        def __exit__(self, *exc):
            entered.append(None)
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(_build, "stream_handle",
                        lambda t: 1000 + t.device.index)
    fake = _FakeCDLL()
    lib = _build.Library(fake)
    before = _build.DEVICE_LAUNCHES[3]
    _build.launch("k", _Tensor("cuda:3"), lib.nbt_go, 7)
    assert fake.calls[-1] == ("nbt_go", torch.device("cuda:3"), (7, 1003))
    assert entered == [torch.device("cuda:3"), None]
    assert _build.DEVICE_LAUNCHES[3] == before + 1
    assert _build.query("cuda:2", lib.nbt_blocks, 1) == 0
    assert fake.calls[-1][1] == torch.device("cuda:2")
    _build.query(None, lib.nbt_tile)
    assert fake.calls[-1][1] == "host"
    assert _build._GUARD.device is None
    with pytest.raises(RuntimeError, match="outside the device guard"):
        lib.nbt_go(7)
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.launch("k", _Tensor("cuda:1"), lambda *a: 2)
    # A CPU tensor makes no card current (only a stand-in library sees one).
    entered.clear()
    _build.query("cpu", lib.nbt_tile)
    assert fake.calls[-1][1] == torch.device("cpu") and entered == []
    # argtypes / restype pass through to the entry.
    entry = _build.Library(_CTypesLike()).nbt_x
    entry.argtypes = [int]
    assert entry.argtypes == [int]


class _CTypesLike:
    class _Fn:
        argtypes = None

        def __call__(self, *a):
            return 0

    def __init__(self):
        self.nbt_x = self._Fn()


# -- the card's matrix (chip_smoke.py --cross-card)

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _accepts(impl, comm):
    """Whether the port's sharded entry points take ``impl`` under
    ``comm`` with a kernel: the rect kernels' table for the ring and the
    all-gather, K13's families (``rdma_variant``) for the rdma comms."""
    if comm.startswith("rdma"):
        try:
            ring._local_impl(impl, make_mesh(2, "cpu"), comm)
        except ValueError:
            return False
        return True
    return impl in ring._RECT_VARIANTS


def test_cross_card_pairs_are_every_pair_the_mesh_takes():
    """The 8192 matrix is exactly the (impl, comm) pairs that
    ``_RECT_VARIANTS``, ``_SYM_VARIANTS`` and ``_RDMA_ONE_SIDED`` accept:
    34 a shard count, none twice, each with a float64 gate."""
    smoke = _chip_smoke()
    impls = [i for i in _VALID_IMPLS if i != "auto"]
    want = {(impl, comm) for impl in impls for comm in ring.COMMS
            if _accepts(impl, comm)}
    assert len(smoke.CROSS_PAIRS) == len(set(smoke.CROSS_PAIRS)) == 34
    assert set(smoke.CROSS_PAIRS) == want
    assert {i for i, c in want if c.startswith("rdma")} == {
        *ring._SYM_VARIANTS, *rdma_ring._RDMA_ONE_SIDED}
    assert set(smoke.CROSS_GATES) == set(ring._RECT_VARIANTS)


def test_cross_card_integrators_and_bounded_mesh_are_complete():
    """Every KDK-composed integrator runs under the N3L ring on an exact
    and a tensor-core tier and under K13; the bounded mesh runs every tier
    it takes (``multiprog._bounded_impl``) and only those; config #4's N
    runs the N3L ring on every tier of the ladder and K13 on K14a's form."""
    smoke = _chip_smoke()
    assert set(smoke.CROSS_INTEGRATORS) == {
        (integrator, impl, comm) for integrator in KDK_WEIGHTS
        for impl, comm in (("pallas_sym2", "ring"),
                           ("pallas_sym_turbo2", "ring"),
                           ("pallas_sym2", "rdma"))}
    assert all((impl, comm) in smoke.CROSS_PAIRS
               for _, impl, comm in smoke.CROSS_INTEGRATORS)
    bounded = set()
    for impl in _VALID_IMPLS:
        try:
            multiprog._bounded_impl(impl)
        except ValueError:
            continue
        bounded.add(impl)
    assert bounded - {"auto"} == set(smoke.CROSS_BOUNDED) == set(
        ring._SYM_VARIANTS)
    assert {i for i, c in smoke.CROSS_4M if c == "ring"} == set(
        ring._SYM_VARIANTS)
    assert ("pallas_sym_turbo2", "rdma") in smoke.CROSS_4M
    assert smoke.CROSS_CLI_IMPL in ring._SYM_VARIANTS
    assert smoke.CROSS_CLI_IMPL not in ("pallas_sym", "pallas_sym2")


@pytest.mark.parametrize("fn,names", [
    ("check_cross_card", {"CROSS_PAIRS", "CROSS_GATES", "CROSS_INTEGRATORS",
                          "CROSS_BOUNDED", "cross_card_cli",
                          "cross_card_4m"}),
    ("cross_card_4m", {"CROSS_4M", "CROSS_4M_N"}),
    ("cross_card_cli", {"CROSS_CLI_IMPL"})])
def test_cross_card_runs_its_tables(fn, names):
    """The cross-card phases loop over the tables above (so a pair added
    to a table runs on the cards), and ``--cross-card`` calls them."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    used = {n.id for n in ast.walk(funcs[fn]) if isinstance(n, ast.Name)}
    assert names <= used, names - used
    main = {n.id for n in ast.walk(funcs["main"]) if isinstance(n, ast.Name)}
    assert "check_cross_card" in main
