"""The list form's ring kernel (``ops/csrc/ring_member.cu``, a launch a
member) on the CPU, where its plain version runs: every chunk folded over
the members in the order table that the native call takes
(``ring_kernel.fold_order`` / ``member_order``, built from ``RingPlan``).

- The order table is the ring's schedule bit for bit: the packed plain
  version (``_plain``, which runs the ring step by step) under an
  operator that writes the fold order into the digits of an integer
  (``acc * base + x``) gives back exactly ``fold_order``.
- The kernel's plain version equals ``_plain`` bit for bit for every
  mode, both directions, n in {2, 3, 4, 5, 8, 9}, SUM / PROD / MAX / MIN
  and f32 / f64 / bf16 / i8 (wrapping), on inputs that mix magnitudes
  (1e16, 1, 1e-3 and both signs), where a sum or product folded in
  another order gives other bits.
- For the reduction modes it equals the reference's Pallas ring kernels
  in interpret mode, bit for bit (NaN as NaN), as
  ``tests/test_torch_device_list.py`` runs them, on the 8-device CPU
  mesh (so n <= 8).
- The launch plan (tasks, jobs, columns, the one-shot threshold) and the
  list call's refusals.
"""

import functools
from functools import partial
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from test_torch_ring_kernel import _to_torch
from ytk_mp4j_tpu.operators import Operators as JOperators
from ytk_mp4j_tpu.ops import ring_kernel as jrk
from ytk_mp4j_tpu.parallel import make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.operators import Operators
from ytk_mp4j_tpu_torch.ops import ring_kernel as rk

MEMBERS = (2, 3, 4, 5, 8, 9)
OPS = ("SUM", "PROD", "MAX", "MIN")
DTYPES = (np.float32, np.float64, ml_dtypes.bfloat16, np.int8)
MODES = ("allreduce", "reduce_scatter", "allgather")


def _mixed(rng, shape, dt):
    """Seeded inputs whose order of folding shows: magnitudes 1e16, 1 and
    1e-3 of both signs (floats), the whole int8 range (wrapping)."""
    if np.dtype(dt).kind == "i":
        return rng.integers(-128, 128, shape).astype(dt)
    mag = rng.choice([1e16, 1.0, 1e-3], shape)
    sign = rng.choice([-1.0, 1.0], shape)
    return (mag * sign * rng.uniform(1.0, 2.0, shape)).astype(dt)


def _same(got, want):
    """Bitwise, NaN equal to NaN at the same places (compared on the
    bits, so bf16 needs no numpy arithmetic)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.is_floating_point():
        gn, wn = got.isnan(), want.isnan()
        assert torch.equal(gn, wn)
        got, want = got[~gn], want[~wn]
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    size = got.element_size()
    assert torch.equal(got.view(bits[size]), want.view(bits[size]))


def _list(data):
    x = _to_torch(data)
    return x, [row.clone() for row in x]


def _layout(mode, n, L, ndir):
    """The wrappers' layout of a call on [n, L] members (granule 1)."""
    if mode == "allreduce":
        c = -(-L // (ndir * n))
        return rk._Layout(w=c, stride=c, base=(0, n * c)[:ndir],
                          vbase=(0, 0)[:ndir], in_row=ndir * n * c,
                          out_row=ndir * n * c)
    c = L // n if mode == "reduce_scatter" else L
    w = c // ndir
    return rk._Layout(w=w, stride=c, base=(0, w)[:ndir], vbase=(0, w)[:ndir],
                      in_row=L, out_row=c if mode == "reduce_scatter"
                      else n * c)


# ----------------------------------------------------------------------
# the order table is the ring's schedule
# ----------------------------------------------------------------------
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("mode", ["allreduce", "reduce_scatter"])
@pytest.mark.parametrize("n", MEMBERS)
def test_order_table_is_the_ring_schedule(n, mode, ndir):
    """Member m's every element is m + 1 and the operator is ``acc * base
    + x``: each fold's result spells, in base n + 1, the members in the
    order the ring folded them. ``_plain`` steps the ring; the table must
    give the same order for every chunk of every direction, and the
    kernel's table must be its rotation."""
    base = n + 1
    digits = SimpleNamespace(torch_fn=lambda acc, x: acc * base + x)
    lay = _layout(mode, n, ndir * n * (1 if mode == "allreduce" else 2),
                  ndir)
    x = (torch.arange(n, dtype=torch.int64) + 1)[:, None].expand(
        n, lay.in_row).contiguous()
    out = rk._plain(x, rk.RingPlan(n, mode, ndir), lay, digits)
    order = rk.fold_order(n, mode, ndir)

    def spelled(value):
        got = []
        while value:
            value, m = divmod(int(value), base)
            got.append(m - 1)
        return tuple(reversed(got))

    for d in range(ndir):
        for k in range(n):
            if mode == "reduce_scatter":
                value = out[k, lay.vbase[d]]
            else:
                value = out[0, lay.base[d] + k * lay.stride]
                assert all(int(out[r, lay.base[d] + k * lay.stride]) == value
                           for r in range(n))
            assert spelled(value) == order[d][k]
            assert sorted(order[d][k]) == list(range(n))
    table = rk.member_order(n, mode, ndir)
    for d in range(ndir):
        for k in range(n):
            assert tuple((k + table[d * n + j]) % n
                         for j in range(n)) == order[d][k]


def test_order_table_directions_mirror():
    """Direction 1 folds in the mirrored order of direction 0."""
    for n in MEMBERS:
        for mode in ("allreduce", "reduce_scatter"):
            one, two = rk.fold_order(n, mode, 2)
            assert all(tuple((-m) % n for m in one[k]) == two[(-k) % n]
                       for k in range(n))


# ----------------------------------------------------------------------
# the kernel's plain version against the ring's, bit for bit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("n", MEMBERS)
def test_member_plain_equals_ring_plain(n, dt, ndir, mode):
    rng = np.random.default_rng(100 + 10 * n + ndir)
    L = {"allreduce": 2 * n * 7 + 3, "reduce_scatter": 2 * n * 6,
         "allgather": 10}[mode]
    x, xs = _list(_mixed(rng, (n, L), dt))
    bidir = ndir == 2
    for name in (OPS if mode != "allgather" else ("SUM",)):
        op = Operators.by_name(name)
        if mode == "allreduce":
            want = rk.ring_allreduce_kernel(x, op, bidir, True)
            got = rk.ring_allreduce_kernel(xs, op, bidir, True)
        elif mode == "reduce_scatter":
            want = rk.ring_reduce_scatter_kernel(x, op, bidir, True)
            got = rk.ring_reduce_scatter_kernel(xs, op, bidir, True)
        else:
            want = rk.ring_allgather_kernel(x, bidir, True)
            got = rk.ring_allgather_kernel(xs, bidir, True)
        assert isinstance(got, list) and len(got) == n
        for r in range(n):
            _same(got[r], want[r])


def test_member_plain_shows_a_wrong_order():
    """The mixed inputs do tell orders apart: the same chunks folded in
    the order of the other direction give other bits."""
    rng = np.random.default_rng(7)
    n = 5
    x, _ = _list(_mixed(rng, (n, 2 * n * 8), np.float32))
    lay = _layout("allreduce", n, x.shape[1], 2)
    order = rk.fold_order(n, "allreduce", 2)

    def fold(members, at):
        acc = x[members[0], at:at + lay.w]
        for m in members[1:]:
            acc = acc + x[m, at:at + lay.w]
        return acc

    differs = [not torch.equal(fold(order[0][k], k * lay.stride),
                               fold(order[1][k], k * lay.stride))
               for k in range(n)]
    assert any(differs)


# ----------------------------------------------------------------------
# against the reference's Pallas ring kernels (interpret mode)
# ----------------------------------------------------------------------
# (mode, n, ndir, dtype): every dtype in both modes and both directions,
# n over the rig's 8 devices (a compile a case, all four operators)
JAX_CASES = [
    ("allreduce", 2, 1, np.float32), ("allreduce", 3, 2, np.float32),
    ("allreduce", 5, 1, np.float64), ("allreduce", 8, 2, np.float64),
    ("allreduce", 3, 1, ml_dtypes.bfloat16),
    ("allreduce", 5, 2, ml_dtypes.bfloat16),
    ("allreduce", 8, 1, np.int8), ("allreduce", 2, 2, np.int8),
    ("reduce_scatter", 3, 1, np.float32),
    ("reduce_scatter", 8, 2, np.float32),
    ("reduce_scatter", 2, 1, np.float64),
    ("reduce_scatter", 5, 2, np.float64),
    ("reduce_scatter", 8, 1, ml_dtypes.bfloat16),
    ("reduce_scatter", 2, 2, ml_dtypes.bfloat16),
    ("reduce_scatter", 5, 1, np.int8), ("reduce_scatter", 3, 2, np.int8),
]


@functools.lru_cache(maxsize=None)
def _reference(mode, n, L, dt_name, bidir, seed):
    """(data, {op: the reference's output}) on seeded mixed inputs."""
    dt = ml_dtypes.bfloat16 if dt_name == "bfloat16" else np.dtype(dt_name)
    data = _mixed(np.random.default_rng(seed), (n, L), dt)

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


@pytest.mark.parametrize(
    "mode,n,ndir,dt", JAX_CASES,
    ids=[f"{m}-{n}-{d}-{np.dtype(t).name}" for m, n, d, t in JAX_CASES])
def test_member_plain_equals_the_reference_kernel(mode, n, ndir, dt):
    L = 2 * n * 4 + (3 if mode == "allreduce" else 0)
    data, want = _reference(mode, n, L, np.dtype(dt).name, ndir == 2,
                            200 + n)
    _, xs = _list(data)
    fn = (rk.ring_allreduce_kernel if mode == "allreduce"
          else rk.ring_reduce_scatter_kernel)
    for name in OPS:
        got = fn(xs, Operators.by_name(name), ndir == 2)
        _same(torch.stack(got), _to_torch(want[name]).reshape(n, -1))


# ----------------------------------------------------------------------
# the launch plan and the refusals
# ----------------------------------------------------------------------
def test_member_plan_tasks_and_launches():
    f32, f64 = torch.float32, torch.float64
    rs = rk.member_plan(8, "reduce_scatter", 1, 1 << 20, 8 << 20, f64, 132,
                        8)
    assert (rs.tasks, rs.jobs, rs.launches) == ((rk._FOLD_OWN,), (1,), 8)
    assert rs.cols == (rk.FOLD_BLOCKS_PER_SM * 132 // 8,)
    ag = rk.member_plan(8, "allgather", 2, 1 << 20, 2 << 20, f64, 132, 8)
    assert (ag.tasks, ag.jobs, ag.launches) == ((rk._COPY_INPUTS,), (16,), 8)
    assert ag.cols == (-(-(rk.COPY_BLOCKS_PER_SM * 132 // 8) // 16),)
    small = rk.member_plan(4, "allreduce", 2, 64, 512, f32, 132, 4)
    assert (small.tasks, small.jobs, small.cols) == ((rk._FOLD_ALL,), (8,),
                                                     (1,))
    row = rk.ONE_SHOT_BYTES // 4 // 4 + 4
    big = rk.member_plan(4, "allreduce", 1, row // 4, row, f32, 132, 4)
    assert big.tasks == (rk._FOLD_OWN, rk._COPY_OWNERS)
    assert big.jobs == (1, 3) and big.launches == 8
    forced = rk.member_plan(4, "allreduce", 1, 64, 256, f32, 132, 4,
                            path="two_round")
    assert forced.rounds == 2 and forced.launches == 8
    assert rk.member_plan(4, "allreduce", 1, row // 4, row, f32, 132, 4,
                          path="one_shot").rounds == 1
    # a column takes at least a 16-byte vector a thread
    assert rk.member_plan(2, "allgather", 1, 1000, 1000, f32, 132,
                          1).cols == (1,)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_allreduce_rounds_follow_the_threshold(n):
    for dt in (torch.float32, torch.float64, torch.int8):
        item = torch.empty((), dtype=dt).element_size()
        at = rk.ONE_SHOT_BYTES // (n * item)
        assert rk.allreduce_rounds(n, at, dt) == 1
        assert rk.allreduce_rounds(n, at + 1, dt) == (1 if n == 1 else 2)


def test_member_plan_refusals():
    f32 = torch.float32
    with pytest.raises(Mp4jError, match="member path"):
        rk.member_plan(4, "allreduce", 1, 64, 256, f32, 132, 4,
                       path="global")
    with pytest.raises(Mp4jError, match="forces the form of an allreduce"):
        rk.member_plan(4, "reduce_scatter", 1, 64, 256, f32, 132, 4,
                       path="one_shot")
    with pytest.raises(Mp4jError, match="forces the form of an allreduce"):
        rk.member_plan(1, "allreduce", 1, 64, 64, f32, 132, 1,
                       path="two_round")


@pytest.mark.parametrize("kw", [dict(spin_s=0.5), dict(stall_member=1),
                                dict(spin_s=0.5, stall_member=0)])
def test_list_call_refuses_spin_and_stall(kw):
    """A list's launches never wait on each other: the packed launch's
    spin bound and stall hook are refused by name, on every entry."""
    xs = [torch.arange(8.0) + r for r in range(4)]
    for call in (lambda: rk.ring_allreduce_kernel(xs, **kw),
                 lambda: rk.ring_reduce_scatter_kernel(xs, **kw),
                 lambda: rk.ring_allgather_kernel(xs, **kw)):
        with pytest.raises(Mp4jError, match="spin_s and stall_member"):
            call()
    # the defaults, passed as such, are no refusal
    got = rk.ring_allreduce_kernel(xs, spin_s=rk.SPIN_SECONDS,
                                   stall_member=-1)
    assert all(torch.equal(t, sum(xs)) for t in got)
