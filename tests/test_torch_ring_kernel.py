"""The port's ring collectives (ytk_mp4j_tpu_torch/ops/ring_kernel.py)
against the JAX package's Pallas RDMA ring kernels, interpreted on the
8-device CPU mesh, over the cases of tests/test_ring_kernel.py:26-181.
On the CPU the port computes its kernels' plain version, which chunks
with a granule of 1 element as the reference's interpret mode does, so
the two are compared BITWISE for every dtype and operator (NaN compared
as NaN: its payload is not part of jnp.maximum's contract). The CUDA
kernels themselves are held against this plain version in
tests/test_torch_gpu.py and chip_smoke.py.

The port's slot/credit protocols (ring_kernel.PROTOCOL for the
global-memory kernel, ring_kernel.CLUSTER_PROTOCOL for the cluster
kernel, both driven by RingPlan: the schedule the CUDA sources mirror)
run here under the reference's skew-adversarial scheduler (_RingModel,
tests/test_ring_kernel.py:203), and the launch plan that picks the path
and cuts the chunks is checked for every dtype, n, mode and direction
count.
"""

import functools
from functools import partial

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from test_ring_kernel import _RingModel, _model_wants
from ytk_mp4j_tpu.operators import Operators as JOperators
from ytk_mp4j_tpu.ops import ring_kernel as jrk
from ytk_mp4j_tpu.parallel import make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.operators import Operator, Operators
from ytk_mp4j_tpu_torch.ops import ring_kernel as rk

OPS = ("SUM", "PROD", "MAX", "MIN")
NP_OPS = {"SUM": np.sum, "MAX": np.max, "MIN": np.min, "PROD": np.prod}
DTYPES = (np.float32, np.float64, np.int32, np.int64, np.int16, np.int8,
          ml_dtypes.bfloat16)


def _jax(mode, n, data, op_name="SUM", bidir=False):
    """The reference kernel in interpret mode; [n, ...] per member."""
    op = getattr(JOperators, op_name)

    @partial(jax.shard_map, mesh=make_mesh(n), in_specs=P("mp4j"),
             out_specs=P("mp4j"), check_vma=False)
    def f(x):
        if mode == "allreduce":
            y = jrk.ring_allreduce_kernel(x[0], op, "mp4j", interpret=True,
                                          bidirectional=bidir)
        elif mode == "reduce_scatter":
            y = jrk.ring_reduce_scatter_kernel(x[0], op, "mp4j",
                                               interpret=True,
                                               bidirectional=bidir)
        else:
            y = jrk.ring_allgather_kernel(x[0], "mp4j", interpret=True,
                                          bidirectional=bidir)
        return y[None]

    return np.asarray(jax.jit(f)(jnp.asarray(data)))


@functools.lru_cache(maxsize=None)
def _jax_all_ops(mode, n, L, dt_name, bidir, seed):
    """(data, {op: reference output}) for seeded inputs, all four
    operators from one compiled program (compiles dominate this file)."""
    dt = ml_dtypes.bfloat16 if dt_name == "bfloat16" else np.dtype(dt_name)
    data = _data(np.random.default_rng(seed), (n, L), dt)

    @partial(jax.shard_map, mesh=make_mesh(n), in_specs=P("mp4j"),
             out_specs=P("mp4j"), check_vma=False)
    def f(x):
        fn = (jrk.ring_allreduce_kernel if mode == "allreduce"
              else jrk.ring_reduce_scatter_kernel)
        return tuple(fn(x[0], getattr(JOperators, o), "mp4j",
                        interpret=True, bidirectional=bidir)[None]
                     for o in OPS)

    outs = jax.jit(f)(jnp.asarray(data))
    return data, {o: np.asarray(y) for o, y in zip(OPS, outs)}


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _port(mode, data, op_name="SUM", bidir=False, **kw):
    x = _to_torch(data)
    op = getattr(Operators, op_name)
    if mode == "allreduce":
        y = rk.ring_allreduce_kernel(x, op, bidir, **kw)
    elif mode == "reduce_scatter":
        y = rk.ring_reduce_scatter_kernel(x, op, bidir, **kw)
    else:
        y = rk.ring_allgather_kernel(x, bidir, **kw)
    return _to_numpy(y)


def assert_same(got, want):
    """Bitwise, with NaN equal to NaN at the same places."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype.kind in "fV":
        gn = np.isnan(got.astype(np.float64))
        wn = np.isnan(want.astype(np.float64))
        np.testing.assert_array_equal(gn, wn)
        got, want = np.where(gn, 0, got), np.where(wn, 0, want)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _data(rng, shape, dt):
    if np.dtype(dt).kind in "iu":
        return rng.integers(-100, 100, shape).astype(dt)
    return rng.standard_normal(shape).astype(dt)


# ---- mirrors of tests/test_ring_kernel.py ---------------------------------
@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("op_name", OPS)
def test_allreduce_matches(n, op_name, bidir):
    """Bitwise against the reference; 1e-5 relative against numpy (the
    reference test's tolerance: the fold order differs from np.sum's)."""
    data, ref = _jax_all_ops("allreduce", n, 4 * n, "float32", bidir, 0)
    out = _port("allreduce", data, op_name, bidir)
    assert_same(out, ref[op_name])
    want = NP_OPS[op_name](data, axis=0)
    for r in range(n):
        np.testing.assert_allclose(out[r], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("L", [1, 7, 13])
def test_allreduce_any_length(rng, L, bidir):
    """Any L: identity padding inside the wrapper, sliced back."""
    n = 4
    data = rng.standard_normal((n, L)).astype(np.float32)
    out = _port("allreduce", data, bidir=bidir)
    assert out.shape == (n, L)
    assert_same(out, _jax("allreduce", n, data, bidir=bidir))


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("op_name", OPS)
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
def test_every_dtype_and_operator(dt, op_name, bidir):
    """Narrow integers wrap and bf16 rounds at every step, as the
    reference's jnp ops do: bitwise (the reduce-scatter one way; the
    chunk-layout tests cover its other direction)."""
    n = 3
    cases = [("allreduce", 13)] + ([] if bidir else [("reduce_scatter", 12)])
    for mode, L in cases:
        data, ref = _jax_all_ops(mode, n, L, np.dtype(dt).name, bidir, 1)
        assert_same(_port(mode, data, op_name, bidir), ref[op_name])


@pytest.mark.parametrize("op_name", OPS)
def test_integer_wraparound(op_name):
    """int8 SUM/PROD overflow wraps like numpy, not saturating."""
    data = np.array([[120, -120, 7, 100], [100, -100, 9, 100],
                     [3, -90, 11, 100]], np.int8)
    assert_same(_port("allreduce", data, op_name),
                _jax("allreduce", 3, data, op_name))


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("op_name", ["MAX", "MIN"])
def test_nan_propagates(rng, op_name, bidir):
    """MAX/MIN propagate NaN (jnp.maximum does; fmaxf would not)."""
    n = 4
    data = rng.standard_normal((n, 16)).astype(np.float32)
    data[0, 1] = data[2, 9] = data[3, 15] = np.nan
    out = _port("allreduce", data, op_name, bidir)
    assert np.isnan(out[:, [1, 9, 15]]).all()
    assert_same(out, _jax("allreduce", n, data, op_name, bidir))


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
def test_reduce_scatter_chunk_layout(rng, n, bidir):
    """Member r ends with chunk r -- the coll.reduce_scatter contract."""
    L = 6 * n
    data = rng.standard_normal((n, L)).astype(np.float32)
    out = _port("reduce_scatter", data, bidir=bidir)
    assert out.shape == (n, L // n)
    assert_same(out, _jax("reduce_scatter", n, data, bidir=bidir))
    np.testing.assert_allclose(out, data.sum(0).reshape(n, -1), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
def test_allgather_block_layout(rng, n, bidir):
    c = 6
    data = rng.standard_normal((n, c)).astype(np.float32)
    out = _port("allgather", data, bidir=bidir)
    assert_same(out, _jax("allgather", n, data, bidir=bidir))
    for r in range(n):
        np.testing.assert_array_equal(out[r].reshape(n, c), data)


def test_single_member_noop(rng):
    data = rng.standard_normal((1, 8)).astype(np.float32)
    x = torch.from_numpy(data)
    assert rk.ring_allreduce_kernel(x) is x
    assert rk.ring_reduce_scatter_kernel(x) is x
    assert rk.ring_allgather_kernel(x) is x


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("mode", ["allreduce", "reduce_scatter", "allgather"])
def test_force_kernel_single_member_is_identity(rng, mode, bidir):
    """n = 1 with force_kernel: zero steps, output equals input."""
    data = rng.standard_normal((1, 8)).astype(np.float32)
    assert_same(_port(mode, data, bidir=bidir, force_kernel=True), data)


def test_reduce_scatter_rejects_indivisible():
    with pytest.raises(Mp4jError, match="divisible"):
        rk.ring_reduce_scatter_kernel(torch.ones(4, 7))


def test_bidirectional_odd_chunk_rejected():
    with pytest.raises(Mp4jError, match="multiples of 2"):
        rk.ring_reduce_scatter_kernel(torch.ones(4, 20),
                                      bidirectional=True)  # chunks of 5
    with pytest.raises(Mp4jError, match="multiples of 2"):
        rk.ring_allgather_kernel(torch.ones(4, 5), bidirectional=True)


def test_custom_operator_names_the_ring_algo():
    """Intended divergence: the kernel cannot run a Python function."""
    absmax = Operator.custom(
        "ABSMAX", lambda a, b: torch.where(a.abs() >= b.abs(), a, b), 0.0)
    with pytest.raises(Mp4jError, match='algo="ring"'):
        rk.ring_allreduce_kernel(torch.ones(2, 4), absmax)
    with pytest.raises(Mp4jError, match='algo="ring"'):
        rk.ring_allreduce_reference(torch.ones(2, 4), absmax)


def test_rejects_bad_inputs():
    with pytest.raises(Mp4jError, match=r"\[n, L\]"):
        rk.ring_allreduce_kernel(torch.ones(8))
    with pytest.raises(Mp4jError, match="dtype"):
        rk.ring_allreduce_kernel(torch.ones(2, 4, dtype=torch.bool))
    with pytest.raises(Mp4jError, match="cpu or cuda"):
        rk.ring_allreduce_kernel(torch.ones(2, 4, device="meta"))


def _all_counts():
    return [getattr(fn, k) for fn in (rk.ring_kernel, rk.ring_kernel_bidir)
            for k in ("launches", "cluster_launches", "global_launches")]


def test_cpu_tensors_take_the_plain_version_without_a_launch(rng):
    before = _all_counts()
    data = rng.standard_normal((4, 33)).astype(np.float32)
    for bidir in (False, True):
        assert_same(_port("allreduce", data, bidir=bidir),
                    _to_numpy(rk.ring_allreduce_reference(
                        torch.from_numpy(data), bidirectional=bidir)))
    assert _all_counts() == before


def test_granule_is_defined_once():
    """1 element on the CPU (the reference's interpret mode), 16 bytes on
    CUDA. round_up_chunk pads to it, at least one element."""
    for dt in (torch.float32, torch.int8, torch.bfloat16, torch.float64):
        assert rk.granule(dt, "cpu") == 1
    assert rk.granule(torch.float32, "cuda") == 4
    assert rk.granule(torch.float64, "cuda:0") == 2
    assert rk.granule(torch.bfloat16, "cuda") == 8
    assert rk.granule(torch.int8, "cuda") == 16
    assert rk.round_up_chunk(0, torch.float32, "cpu") == 1
    assert rk.round_up_chunk(7, torch.float32, "cpu") == 7
    assert rk.round_up_chunk(7, torch.float32, "cuda") == 8
    assert rk.round_up_chunk(17, torch.int8, "cuda") == 32


@pytest.mark.parametrize("dt", [torch.float32, torch.int8, torch.bfloat16])
def test_identity_padding_never_changes_a_result(rng, dt):
    """Allreduce pads every member to equal chunks; with the CUDA
    granule (forced here through the plain version) the padding is
    larger, and the result must not move."""
    n, L = 3, 11
    x = _to_torch(_data(rng, (n, L), {torch.float32: np.float32,
                                      torch.int8: np.int8,
                                      torch.bfloat16: ml_dtypes.bfloat16}[dt]))
    for op in (Operators.SUM, Operators.PROD, Operators.MAX, Operators.MIN):
        want = rk.ring_allreduce_reference(x, op)
        xp = torch.cat([x, torch.full((n, 13), op.identity(dt), dtype=dt)],
                       dim=1)
        got = rk.ring_allreduce_reference(xp, op)[:, :L]
        folded = x[0]
        for r in range(1, n):
            folded = op.torch_fn(folded, x[r])
        # padding only shifts chunk boundaries: each element still folds
        # all n members; MAX/MIN and integers are exact in any order
        if op.name in ("MAX", "MIN") or not dt.is_floating_point:
            assert torch.equal(got, want) and torch.equal(got[0], folded)
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2e-2, atol=2e-2)


# ---- the credit protocol under the reference's adversarial scheduler ------
class _PortRingModel(_RingModel):
    """The reference's skew-adversarial scheduler driving the port's
    schedule (RingPlan) and protocol (PROTOCOL). A "send" is the CUDA
    kernel's store into the neighbour's slot: it lands at once, so the
    only freedom left is the interleaving of members -- which the
    scheduler picks adversarially (stalling a victim while anything else
    can move). Flags hold step numbers and only grow."""

    def __init__(self, n, use_credits, seed=0, victim=None,
                 mode="allreduce", dirs=("R",), segments=1,
                 proto=rk.PROTOCOL):
        super().__init__(n, use_credits, seed, victim, mode, dirs)
        self.segments = segments
        self.proto = proto
        slots = proto["slots"]
        z = lambda: [[0] * slots for _ in range(n)]   # noqa: E731
        self.rflag = {d: z() for d in dirs}
        self.cflag = {d: z() for d in dirs}
        self.rbuf = {d: [[(None, False)] * slots for _ in range(n)]
                     for d in dirs}

    def _member(self, me, chunks):
        n, dirs = self.n, self.dirs
        plan = rk.RingPlan(n, self.mode, len(dirs))
        proto = self.proto
        g = 0

        def exchange(vals):
            nonlocal g
            for dn in dirs:
                for op in proto["begin"](g):
                    if op[0] == "wait_credit":
                        if self.use_credits:
                            yield ("wait_credit", dn, op[1], op[2])
                    else:
                        yield ("send", dn, op[1], op[2], vals[dn])
            got = {}
            for dn in dirs:
                for op in proto["finish"](g):
                    if op[0] == "signal_credit" and not self.use_credits:
                        continue
                    r = yield (op[0], dn) + tuple(op[1:])
                    if op[0] == "consume":
                        got[dn] = r
            g += 1
            return got

        results = []
        for _ in range(self.segments):
            out = {dn: [None] * n for dn in dirs}
            if self.mode == "allgather":
                v = {dn: chunks[dn][0] for dn in dirs}
                for dn in dirs:
                    out[dn][me] = v[dn]
                for s in range(n - 1):
                    v = yield from exchange(v)
                    for d, dn in enumerate(dirs):
                        out[dn][plan.forward(me, d, s)] = v[dn]
                results.append(out)
                continue
            v = {dn: chunks[dn][plan.start(me, d)]
                 for d, dn in enumerate(dirs)}
            for s in range(n - 1):
                got = yield from exchange(v)
                v = {dn: got[dn] + chunks[dn][plan.merge(me, d, s)]
                     for d, dn in enumerate(dirs)}
            if self.mode == "reduce_scatter":
                results.append(v)
                continue
            for d, dn in enumerate(dirs):
                out[dn][plan.finish(me, d)] = v[dn]
            for s in range(n - 1):
                v = yield from exchange(v)
                for d, dn in enumerate(dirs):
                    out[dn][plan.forward(me, d, s)] = v[dn]
            results.append(out)
        if self.use_credits:
            drains = [proto["drain"](g) for _ in dirs]
            for i in range(len(drains[0])):
                for dn, ops in zip(dirs, drains):
                    yield ("wait_credit", dn, ops[i][1], ops[i][2])
        self.out[me] = results

    def _runnable(self, r, a):
        kind, dn, slot = a[0], a[1], a[2]
        if kind == "wait_credit":
            return self.cflag[dn][r][slot] >= a[3]
        if kind == "wait_recv":
            return self.rflag[dn][r][slot] >= a[3]
        return True

    def _apply(self, r, a):
        kind, dn, slot = a[0], a[1], a[2]
        d = self.dirs.index(dn)
        if kind == "send":
            dst = rk.RingPlan.dest(r, d, self.n)
            if self.rbuf[dn][dst][slot][1]:   # unconsumed data overwritten
                self.violations += 1
            self.rbuf[dn][dst][slot] = (a[4], True)
            self.rflag[dn][dst][slot] = a[3]
        elif kind == "consume":
            value, unconsumed = self.rbuf[dn][r][slot]
            if not unconsumed:
                self.violations += 1
            self.rbuf[dn][r][slot] = (value, False)
            return value
        elif kind == "signal_credit":
            self.cflag[dn][rk.RingPlan.upstream(r, d, self.n)][slot] = a[3]
        return None

    def assert_clean(self):
        assert self.violations == 0
        assert not self.pending
        for dn in self.dirs:       # every slot consumed, nothing left over
            assert all(not v[1] for row in self.rbuf[dn] for v in row)


def _protocol_safe(n, seed, mode, dirs, segments, proto):
    rng = np.random.default_rng(seed)
    data = {d: rng.standard_normal((n, n)).astype(np.float64) for d in dirs}
    want = _model_wants(mode, data, dirs)
    for victim in [None, 0, n - 1]:
        m = _PortRingModel(n, use_credits=True, seed=seed, victim=victim,
                           mode=mode, dirs=dirs, segments=segments,
                           proto=proto)
        m.run(data)
        m.assert_clean()
        for r in range(n):
            assert len(m.out[r]) == segments
            for res in m.out[r]:
                for d in dirs:
                    w = want[d][r] if mode == "reduce_scatter" else want[d]
                    np.testing.assert_allclose(res[d], w, rtol=1e-12)


@pytest.mark.parametrize("segments", [1, 2])
@pytest.mark.parametrize("dirs", [("R",), ("R", "L")],
                         ids=["unidir", "bidir"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mode", ["allreduce", "reduce_scatter",
                                  "allgather"])
def test_port_protocol_safe_under_any_schedule(n, seed, mode, dirs,
                                               segments):
    """The global kernel's protocol (2 slots), with credits: no slot
    overwritten before it was consumed, no deadlock, every segment's
    result right -- for random and victim-stalling schedules (tolerance
    1e-12 relative: f64 sums)."""
    _protocol_safe(n, seed, mode, dirs, segments, rk.PROTOCOL)


@pytest.mark.parametrize("slots", [2, 3])
@pytest.mark.parametrize("segments", [1, 2])
@pytest.mark.parametrize("dirs", [("R",), ("R", "L")],
                         ids=["unidir", "bidir"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mode", ["allreduce", "reduce_scatter",
                                  "allgather"])
def test_port_protocol_safe_under_any_schedule_cluster_slots(
        n, seed, mode, dirs, segments, slots):
    """The same for the cluster kernel's protocol, each step waiting the
    credit of the next step's slot: with its CLUSTER_SLOTS (2) and with
    one slot more (the source takes any kSlots >= 2)."""
    _protocol_safe(n, seed, mode, dirs, segments,
                   rk.protocol(slots, ahead=1))


@pytest.mark.parametrize("proto", [rk.CLUSTER_PROTOCOL,
                                   rk.protocol(3, ahead=1)],
                         ids=["cluster", "cluster-3-slots"])
def test_port_protocol_without_credits_overwrites_a_slot_any_slots(proto):
    """The cluster kernel's protocol, over two segments: without credits
    the adversary overwrites an unconsumed slot, whatever the slot
    count; the credits are what keeps it safe."""
    n = 4
    rng = np.random.default_rng(0)
    data = {"R": rng.standard_normal((n, n)).astype(np.float64)}
    hits = 0
    for victim in range(n):
        m = _PortRingModel(n, use_credits=False, seed=1, victim=victim,
                           segments=2, proto=proto)
        m.run(data)
        hits += m.violations
    assert hits > 0


def test_port_protocol_without_credits_overwrites_a_slot():
    """The race is real for the port's schedule too: without the credit
    waits, stalling one member lets its upstream overwrite a slot it has
    not read."""
    n = 4
    rng = np.random.default_rng(0)
    data = {"R": rng.standard_normal((n, n)).astype(np.float64)}
    hits = 0
    for victim in range(n):
        m = _PortRingModel(n, use_credits=False, seed=1, victim=victim)
        m.run(data)
        hits += m.violations
    assert hits > 0


@pytest.mark.parametrize("mode", ["allreduce", "reduce_scatter",
                                  "allgather"])
def test_plan_step_counts_and_drain(mode):
    """The plan's exchanges per segment, and the drain's last credits."""
    plan = rk.RingPlan(5, mode)
    assert plan.steps == (8 if mode == "allreduce" else 4)
    assert rk.PROTOCOL["drain"](0) == []
    assert rk.PROTOCOL["drain"](1) == [("wait_credit", 0, 1)]
    assert rk.PROTOCOL["drain"](4) == [("wait_credit", 0, 3),
                                       ("wait_credit", 1, 4)]
    assert rk.PROTOCOL["begin"](1) == [("send", 1, 2)]
    assert rk.PROTOCOL["begin"](2) == [("wait_credit", 0, 1),
                                       ("send", 0, 3)]
    cp = rk.CLUSTER_PROTOCOL
    assert cp["slots"] == rk.CLUSTER_SLOTS == 2
    assert cp["begin"](0) == [("send", 0, 1)]
    assert cp["begin"](1) == [("wait_credit", 0, 1), ("send", 1, 2)]
    assert cp["begin"](2) == [("wait_credit", 1, 2), ("send", 0, 3)]
    assert cp["drain"](5) == [("wait_credit", 0, 5), ("wait_credit", 1, 4)]
    three = rk.protocol(3, ahead=1)
    assert three["begin"](1) == [("send", 1, 2)]
    assert three["begin"](2) == [("wait_credit", 0, 1), ("send", 2, 3)]
    assert three["drain"](5) == [("wait_credit", 0, 4),
                                 ("wait_credit", 1, 5),
                                 ("wait_credit", 2, 3)]


# ---- the launch plan: which kernel, and how it cuts the chunks -----------
def _chunk_width(mode, n, L, dtype, ndir):
    """Each direction's chunk width, as the entry points lay it out on
    CUDA (granule 16 bytes; reduce-scatter and allgather chunks are
    multiples of ndir granules)."""
    if mode == "allreduce":
        return rk.round_up_chunk(-(-L // (ndir * n)), dtype, "cuda")
    c = -(-L // (ndir * rk.granule(dtype, "cuda"))) * ndir * rk.granule(
        dtype, "cuda")
    return c // ndir


@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64, torch.int32,
                                torch.int64, torch.int16, torch.int8,
                                torch.bfloat16], ids=str)
def test_launch_plan_covers_every_chunk_once(dt, n, ndir):
    """For every mode: the columns and segments cover [0, w) exactly once,
    every boundary and length is a multiple of 16 bytes, a slot fits its
    size, and the path is cluster for n <= 8, global above (or where the
    card takes no such cluster)."""
    item = torch.empty((), dtype=dt).element_size()
    for mode in ("allreduce", "reduce_scatter", "allgather"):
        for L in (1, 1001, 3 * 4096 + 5, 1 << 20, 37 << 20):
            w = _chunk_width(mode, n, L, dt, ndir)
            for clusters, cap in ((16, 528), (1, 2 * n), (0, 396)):
                lp = rk.launch_plan(n, w, dt, ndir, "cuda",
                                    clusters=clusters, capacity=cap)
                cluster = n <= rk.CLUSTER_LIMIT and clusters > 0
                assert lp.path == ("cluster" if cluster else "global")
                if cluster:
                    assert lp.cols <= clusters
                    assert lp.slots == rk.CLUSTER_SLOTS
                    assert lp.slot_bytes * ndir <= rk.CLUSTER_SEG_BYTES
                else:
                    assert lp.seg == rk.GLOBAL_SEG and lp.slots == 2
                    assert lp.cols <= max(1, cap // n)
                covered = []
                for col in range(lp.cols):
                    lo, hi = lp.columns()[col]
                    assert lo * item % 16 == 0 and hi * item % 16 == 0
                    for s, ln in lp.segments(col):
                        assert 0 < ln <= lp.seg
                        assert s * item % 16 == 0 and ln * item % 16 == 0
                        covered.append((s, ln))
                pos = 0
                for s, ln in sorted(covered):
                    assert s == pos
                    pos += ln
                assert pos == w
