"""The port's libsvm / libffm reader (ytk_mp4j_tpu_torch/utils/libsvm.py
and its native parser, a copy of csrc/mp4j_parse.cpp built into the
port's own build directory) against ytk_mp4j_tpu/utils/libsvm.py, over
the reader cases of tests/test_fm.py and tests/test_linear.py: the same
text gives the same arrays, byte for byte, and the same errors, with the
same line numbers, on the native path and on the line-by-line replay."""

import numpy as np
import pytest

from ytk_mp4j_tpu.exceptions import Mp4jError as JMp4jError
from ytk_mp4j_tpu.utils import libsvm as jlibsvm
from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models.fm import FMConfig, FMTrainer
from ytk_mp4j_tpu_torch.utils import native
from ytk_mp4j_tpu_torch.utils.libsvm import (_parse_chunk_slow, dense_chunks,
                                             parse_line, read_libsvm)

from test_fm import make_sparse_classification
from test_torch_sparse import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def _same_chunks(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def _both(lines, **kw):
    """The port's chunks and the reference's, on the same lines."""
    return (list(read_libsvm(iter(lines), **kw)),
            list(jlibsvm.read_libsvm(iter(lines), **kw)))


def test_read_libsvm_formats(tmp_path):
    text = ("1 0:3:1.0 1:7:2.0\n"
            "0 2:5:0.5\n"
            "\n"                              # blank lines are skipped
            "1 0:1:1.0 1:2:1.0 2:3:1.0\n")
    p = tmp_path / "data.ffm"
    p.write_text(text)
    got = list(read_libsvm(str(p), chunk_rows=2, max_nnz=3))
    _same_chunks(got, jlibsvm.read_libsvm(str(p), chunk_rows=2, max_nnz=3))
    assert len(got) == 2                      # 2 + 1 rows
    feats, fields, vals, y = got[0]
    assert feats.shape == (2, 3) and feats.dtype == np.int32
    np.testing.assert_array_equal(y, [1.0, 0.0])
    np.testing.assert_array_equal(feats[0], [3, 7, 0])
    np.testing.assert_array_equal(fields[0], [0, 1, 0])
    np.testing.assert_allclose(vals[0], [1.0, 2.0, 0.0])
    got, want = _both(["1 4:2.0 9:1.0"], chunk_rows=8, max_nnz=2)
    _same_chunks(got, want)
    np.testing.assert_array_equal(got[0][0][0], [4, 9])
    np.testing.assert_array_equal(got[0][1][0], [0, 0])


@pytest.mark.parametrize("lines,match", [
    (["1 1:1 2:1 3:1"], "line 1: 3 entries exceed max_nnz=2"),
    (["1 1:1", "x 1:1"], "line 2: label 'x' is not a number"),
    (["1 1:2:3:4"], "line 1: token '1:2:3:4' is neither"),
    (["1 0:1:1.0 2:1.0"], "line 1: token '2:1.0' is neither"),
    (["", "1 1:1", "1 a:b"], "line 3: malformed token 'a:b'"),
    (["bad 1:2", "1 1:1", "1 1:1 2:1 3:1"], "line 1.*not a number"),
])
def test_read_libsvm_errors_name_the_line(lines, match):
    """A chunk the scanner refuses replays line by line: the first defect
    in file order raises, with its line number (blank lines counted), as
    in the reference."""
    for reader, error in ((read_libsvm, Mp4jError),
                          (jlibsvm.read_libsvm, JMp4jError)):
        with pytest.raises(error, match=match):
            list(reader(iter(lines), chunk_rows=4, max_nnz=2))


def test_read_libsvm_chunk_rows_checked():
    with pytest.raises(Mp4jError, match="chunk_rows"):
        list(read_libsvm(iter(["1 1:1"]), chunk_rows=0, max_nnz=4))


def test_read_libsvm_exotic_literals_and_overflow():
    """Literals the strict scanner refuses but Python accepts (inf
    labels, underscore ints) parse through the replay; out-of-int32 ids
    raise, never wrap."""
    got, want = _both(["inf 4:1_0"], chunk_rows=4, max_nnz=2)
    _same_chunks(got, want)
    assert np.isinf(got[0][3][0]) and got[0][2][0, 0] == 10.0
    assert native.parse_libsvm_chunk(b"inf 4:1_0", 1, 2) is None
    with pytest.raises((OverflowError, Mp4jError)):
        list(read_libsvm(iter(["1 5000000000:1.0"]), chunk_rows=4,
                         max_nnz=2))


def test_native_rounding_parity():
    """Literals where a single-rounding strtof differs from Python's
    float() -> float32 parse byte-identically on the native path."""
    lines = ["1 3:0.0000180163488039397634566",
             "0 3:0.0000049054617647925624624",
             "1 3:0.0188519200310111045837402"]
    blob = "\n".join(lines).encode()
    got = native.parse_libsvm_chunk(blob, 3, 4)
    assert got is not None
    _same_chunks([got], [_parse_chunk_slow(lines, [1, 2, 3], 4)])
    _same_chunks([got], list(jlibsvm.read_libsvm(iter(lines), 8, 4)))


def _random_lines(rng, n):
    """Well-formed lines the native scanner accepts: plain numeric
    labels and values, ids within int32, libsvm or libffm."""
    lines = []
    for _ in range(n):
        label = (str(int(rng.integers(-5, 6))) if rng.random() < 0.5
                 else f"{rng.uniform(-1e6, 1e6):.6g}")
        width = int(rng.integers(2, 4))
        toks = []
        for _s in range(int(rng.integers(0, 5))):
            feat = int(rng.integers(0, 2 ** 31 - 1))
            scale = 10.0 ** rng.integers(-30, 30)
            val = (f"{rng.standard_normal() * scale:.17g}"
                   if rng.random() < 0.8
                   else str(rng.choice(["0", "1e-40", "2.5e38", "-0.0"])))
            toks.append(f"{feat}:{val}" if width == 2
                        else f"{int(rng.integers(0, 51))}:{feat}:{val}")
        lines.append(f"{label} " + " ".join(toks))
    return lines


@pytest.mark.parametrize("seed", range(4))
def test_native_equals_replay_and_reference_bytewise(seed):
    """Random well-formed chunks: the native scanner's arrays equal the
    line-by-line replay's and the reference reader's, byte for byte
    (-0.0 against +0.0 and 1-ulp roundings included)."""
    rng = np.random.default_rng(seed)
    lines = _random_lines(rng, 40)
    got = native.parse_libsvm_chunk("\n".join(lines).encode(), 40, 4)
    assert got is not None
    _same_chunks([got], [_parse_chunk_slow(lines, list(range(1, 41)), 4)])
    port, ref = _both(lines, chunk_rows=16, max_nnz=4)
    _same_chunks(port, ref)


def test_parse_line_matches_reference():
    for line in ("1 0:3:1.5 2:9:-2", "-1 4:0.25", "0.5"):
        assert parse_line(line, 4, 7) == jlibsvm.parse_line(line, 4, 7)


def test_dense_chunks_match_reference():
    lines = ["1 2:1.5 2:0.5 0:3.0", "0 3:1.0", "1"]
    got = list(dense_chunks(read_libsvm(iter(lines), 2, 4), 4))
    want = list(jlibsvm.dense_chunks(jlibsvm.read_libsvm(iter(lines), 2, 4),
                                     4))
    _same_chunks(got, want)
    np.testing.assert_allclose(got[0][0][0], [3.0, 0.0, 2.0, 0.0])
    with pytest.raises(Mp4jError, match="out of range"):
        list(dense_chunks(read_libsvm(iter(["1 9:1.0"]), 4, 4), 6))


def test_parser_builds_into_the_ports_build_dir():
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert {s.parent for s in native.SOURCES} == {path.parent.parent}
    assert "mp4j_parse.cpp" in {s.name for s in native.SOURCES}
    assert path.name.startswith("libmp4j_native-") and path.exists()
    assert native.build() == path            # an unchanged source: reused


def test_parser_build_failure_raises(monkeypatch, tmp_path):
    """No compiler, or a source that does not compile: Mp4jError, and
    nothing falls back."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(Mp4jError, match="no C\\+\\+ compiler"):
        native.build()
    monkeypatch.undo()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "SOURCES", (bad,))
    with pytest.raises(Mp4jError, match="building bad.cpp failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_stream_from_libffm_file_end_to_end(rng, tmp_path):
    """File -> read_libsvm -> FMTrainer.fit_stream, one chunk in memory
    at a time."""
    feats, fields, vals, y = make_sparse_classification(rng, n=200)
    lines = [f"{y[i]:.0f} " + " ".join(
        f"{fields[i, j]}:{feats[i, j]}:{vals[i, j]:.1f}" for j in range(4))
        for i in range(200)]
    p = tmp_path / "train.ffm"
    p.write_text("\n".join(lines) + "\n")
    tr = FMTrainer(FMConfig(n_features=64, n_fields=4, k=8, max_nnz=4,
                            model="ffm", learning_rate=0.5, init_scale=0.1),
                   mesh=make_mesh(4, "cpu"), sparse_grads=True)
    params, all_losses = None, []
    for _ in range(6):
        params, losses = tr.fit_stream(
            read_libsvm(str(p), chunk_rows=64, max_nnz=4), params=params,
            batch_rows=64)
        all_losses.extend(losses)
    assert all_losses[-1] < all_losses[0] * 0.8
