"""The port's key codecs (ytk_mp4j_tpu_torch/comm/keycodec.py, a copy of
the reference's numpy module) against ytk_mp4j_tpu/comm/keycodec.py, over
the cases of tests/test_keycodec.py: the same key streams give the same
codes, decodes, placements and errors in both, and the port's
``GpuCommCluster`` map path uses its codecs as ``TpuCommCluster`` does."""

import numpy as np
import pytest

from ytk_mp4j_tpu.comm import keycodec as jkc
from ytk_mp4j_tpu_torch import GpuCommCluster, Operands, Operators, meta
from ytk_mp4j_tpu_torch.comm import keycodec
from ytk_mp4j_tpu_torch.comm.keycodec import (IntKeyCodec, ObjKeyCodec,
                                              codec_for_key)
from ytk_mp4j_tpu_torch.exceptions import Mp4jError

from test_torch_sparse import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

CODECS = [
    (IntKeyCodec, jkc.IntKeyCodec, lambda i: i * 13 - 40),
    (ObjKeyCodec, jkc.ObjKeyCodec, lambda i: f"feat:{i * 13 - 40}"),
]
IDS = ["int", "obj"]


def test_codec_for_key_kinds():
    for key in (7, np.int32(7), "w7", True, (1, 2), 2.5):
        assert keycodec.kind_of(key) == jkc.kind_of(key)
        assert (type(codec_for_key(key)).__name__
                == type(jkc.codec_for_key(key)).__name__)
    assert isinstance(codec_for_key(True), ObjKeyCodec)   # bool is NOT int


@pytest.mark.parametrize("cls,jcls,mk", CODECS, ids=IDS)
def test_codes_equal_the_reference_on_one_stream(cls, jcls, mk, rng):
    """Calls of drifting, overlapping key sets: every call's codes and
    decodes equal the reference codec's, and the vocabularies grow
    alike."""
    c, j = cls(), jcls()
    for _ in range(6):
        keys = list(dict.fromkeys(
            mk(int(i)) for i in rng.integers(0, 120, 40)))
        got = c.encode(keys, len(keys))
        want = j.encode(keys, len(keys))
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert c.decode(got) == j.decode(want) == keys
        assert c.size == j.size
    assert c.export() == j.export()


@pytest.mark.parametrize("cls,jcls,mk", CODECS, ids=IDS)
def test_codec_roundtrip_and_growth(cls, jcls, mk):
    c = cls()
    d1 = {mk(i): None for i in range(50)}
    codes1 = c.encode(d1.keys(), len(d1))
    assert codes1.dtype == np.int32 and c.size == 50
    assert sorted(codes1.tolist()) == list(range(50))  # dense codes
    assert c.decode(codes1) == list(d1.keys())
    np.testing.assert_array_equal(c.encode(d1.keys(), len(d1)), codes1)
    assert c.size == 50
    d2 = {mk(i): None for i in range(30, 80)}
    codes2 = c.encode(d2.keys(), len(d2))
    assert c.size == 80
    assert c.decode(codes2) == list(d2.keys())
    old = dict(zip(d1.keys(), codes1.tolist()))
    new = dict(zip(d2.keys(), codes2.tolist()))
    assert all(old[k] == new[k] for k in d2 if k in d1)


@pytest.mark.parametrize("cls,jcls,mk", CODECS, ids=IDS)
def test_codec_partition_matches_meta_and_reference(cls, jcls, mk):
    c, j = cls(), jcls()
    keys = [mk(i) for i in range(40)]
    codes = c.encode(keys, len(keys))
    j.encode(keys, len(keys))
    for n in (3, 4):
        got = c.partition(codes, n)
        np.testing.assert_array_equal(got, j.partition(codes, n))
        np.testing.assert_array_equal(
            got, [meta.key_partition(k, n) for k in keys])
    more = [mk(i) for i in range(40, 55)]
    codes2 = c.encode(more, len(more))
    np.testing.assert_array_equal(
        c.partition(codes2, 4), [meta.key_partition(k, 4) for k in more])


@pytest.mark.parametrize("cls,jcls,mk", CODECS, ids=IDS)
def test_novel_truncate_export_import_match_reference(cls, jcls, mk):
    c, j = cls(), jcls()
    keys = [mk(i) for i in range(30)]
    c.encode(keys, 30)
    j.encode(keys, 30)
    probe = [mk(i) for i in range(25, 40)]
    assert c.novel(probe, len(probe)) == j.novel(probe, len(probe))
    c.partition(np.arange(30, dtype=np.int32), 3)
    c.truncate(20)
    j.truncate(20)
    assert c.size == j.size == 20
    assert c.export() == j.export() == keys[:20]
    np.testing.assert_array_equal(c.encode(probe, len(probe)),
                                  j.encode(probe, len(probe)))
    # a re-grown code's placement is recomputed after the rollback
    np.testing.assert_array_equal(
        c.partition(np.arange(c.size, dtype=np.int32), 3),
        [meta.key_partition(k, 3) for k in c.export()])
    d = cls()
    d.import_keys(c.export())
    assert d.export() == c.export()
    with pytest.raises(Mp4jError, match="empty"):
        d.import_keys([mk(0)])


def test_int_codec_rejects_non_int_keys():
    c = IntKeyCodec()
    with pytest.raises(Mp4jError, match="integer"):
        c.encode(["a", "b"], 2)
    # floats must RAISE, not silently truncate into a colliding int key
    with pytest.raises(Mp4jError, match="integer"):
        c.encode([2.5, 3.0], 2)
    cl = GpuCommCluster(2, device="cpu")
    with pytest.raises(Mp4jError, match="integer"):
        cl.allreduce_map([{2: 1.0}, {2.5: 1.0}], Operands.DOUBLE,
                         Operators.SUM)


@pytest.mark.parametrize("cls,jcls,mk", CODECS, ids=IDS)
def test_codec_overflow_checked_before_growth(cls, jcls, mk, monkeypatch):
    """The int32/SENTINEL overflow raises BEFORE the vocabulary grows."""
    monkeypatch.setattr(keycodec, "SENTINEL", 3)
    c = cls()
    c.encode([mk(0), mk(1)], 2)
    with pytest.raises(Mp4jError, match="overflow"):
        c.encode([mk(2), mk(3)], 2)
    assert c.size == 2
    np.testing.assert_array_equal(c.encode([mk(0), mk(1)], 2), [0, 1])


def test_int_codec_negative_and_large_keys():
    c, j = IntKeyCodec(), jkc.IntKeyCodec()
    keys = [-(2 ** 62), -1, 0, 5, 2 ** 62]
    codes = c.encode(keys, len(keys))
    np.testing.assert_array_equal(codes, j.encode(keys, len(keys)))
    assert c.decode(codes) == keys
    assert all(type(k) is int for k in c.decode(codes))


def test_pack_values_and_pow2_bucket_match_reference():
    for x in (1, 2, 3, 5, 64, 65, 1000):
        assert keycodec.pow2_bucket(x) == jkc.pow2_bucket(x)
    vals = {"a": 1.5, "b": -2.0}.values()
    np.testing.assert_array_equal(
        keycodec.pack_values(vals, 2, (), np.float32),
        jkc.pack_values(vals, 2, (), np.float32))
    for bad in ([1.0, np.ones(1)], [np.ones(2), np.ones(3)]):
        with pytest.raises(Mp4jError, match="share"):
            keycodec.pack_values(bad, 2, np.shape(bad[0]), np.float64)
        with pytest.raises(Exception, match="share"):
            jkc.pack_values(bad, 2, np.shape(bad[0]), np.float64)


# ------------------------------------------------- device map integration
def test_device_allreduce_map_int_keys(rng):
    """Int feature-id keys on the device map path: values merge exactly,
    keys come back as python ints."""
    cl = GpuCommCluster(4, device="cpu")
    maps = [{int(k): float(v) for k, v in
             zip(rng.integers(0, 300, 90), rng.standard_normal(90))}
            for _ in range(4)]
    want = {}
    for m in maps:
        for k, v in m.items():
            want[k] = want.get(k, 0.0) + v
    cl.allreduce_map(maps, Operands.DOUBLE, Operators.SUM)
    for m in maps:
        assert set(m) == set(want)
        assert all(type(k) is int for k in m)
        for k in want:
            np.testing.assert_allclose(m[k], want[k], rtol=1e-9)


def test_device_map_vocab_persists_across_calls():
    cl = GpuCommCluster(4, device="cpu")
    for _ in range(3):
        maps = [{f"w{i}": 1.0 for i in range(100)} for _ in range(4)]
        cl.allreduce_map(maps, Operands.DOUBLE, Operators.SUM)
    assert cl._codecs["obj"].size == 100
    imaps = [{i: 1.0 for i in range(40)} for _ in range(4)]
    cl.allreduce_map(imaps, Operands.DOUBLE, Operators.SUM)
    assert cl._codecs["int"].size == 40
    assert cl._codecs["obj"].size == 100
    for m in imaps:
        assert m == {i: 4.0 for i in range(40)}


def test_device_reduce_scatter_map_int_keys(rng):
    """The partition cache places int keys as meta.key_partition."""
    cl = GpuCommCluster(4, device="cpu")
    maps = [{int(k): float(r) for k in rng.integers(0, 200, 60)}
            for r in range(4)]
    want = {}
    for m in maps:
        for k, v in m.items():
            want[k] = want.get(k, 0.0) + v
    cl.reduce_scatter_map(maps, Operands.DOUBLE, Operators.SUM)
    seen = {}
    for r, m in enumerate(maps):
        for k, v in m.items():
            assert meta.key_partition(k, 4) == r
            seen[k] = v
    assert set(seen) == set(want)
    for k in want:
        np.testing.assert_allclose(seen[k], want[k], rtol=1e-9)
