"""The port's linear trainer (ytk_mp4j_tpu_torch/models/linear.py, n
members on the CPU) against the JAX package's ``LinearTrainer`` on a mesh
of the same shape, over the cases of tests/test_linear.py, on inputs made
by numpy from a seed.

Losses and parameters agree with the reference to rtol 1e-5, atol 1e-6:
one autograd pass over every member's rows against per-member gradients
and ``psum``, so sums round in another order (the reference's own
distributed-vs-single checks use rtol 1e-4 and 2e-5). Within the port,
on the CPU, ``fit_stream`` over one full-batch chunk per epoch equals
``fit`` BITWISE, and the serialized stream equals the double-buffered
one bitwise.

The logistic cases start from nonzero parameters: at a margin of exactly
0 the reference's gradient is wrong (see
``test_logistic_gradient_at_zero_margin``), and the port's is
sigmoid(0) - y.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ytk_mp4j_tpu.models._base import per_example_loss as jloss
from ytk_mp4j_tpu.models.linear import LinearConfig as JLinearConfig
from ytk_mp4j_tpu.models.linear import LinearTrainer as JLinearTrainer
from ytk_mp4j_tpu.parallel import make_hier_mesh as jmake_hier_mesh
from ytk_mp4j_tpu.parallel import make_mesh as jmake_mesh
from ytk_mp4j_tpu_torch.device import make_hier_mesh, make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models._base import per_example_loss
from ytk_mp4j_tpu_torch.models.linear import (LinearConfig, LinearTrainer,
                                              params_from_numpy)
from ytk_mp4j_tpu_torch.utils.libsvm import dense_chunks, read_libsvm

from test_linear import make_classification, make_regression
from test_torch_sparse import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

RTOL, ATOL = 1e-5, 1e-6
MESHES = {
    "flat1": (lambda: jmake_mesh(1), lambda: make_mesh(1, "cpu")),
    "flat4": (lambda: jmake_mesh(4), lambda: make_mesh(4, "cpu")),
    "flat8": (lambda: jmake_mesh(8), lambda: make_mesh(8, "cpu")),
    "hier2x4": (lambda: jmake_hier_mesh(2, 4),
                lambda: make_hier_mesh(2, 4, "cpu")),
}


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _both(kw, x, y, mesh="flat4", **fit_kw):
    """(reference params, losses), (port trainer, params, losses)."""
    jm, pm = MESHES[mesh]
    jp, jl = JLinearTrainer(JLinearConfig(**kw), mesh=jm()).fit(x, y,
                                                                **fit_kw)
    ptr = LinearTrainer(LinearConfig(**kw), mesh=pm())
    pp, pl = ptr.fit(x, y, **fit_kw)
    return (jp, jl), (ptr, pp, pl)


def _start(rng, shape_w, shape_b=()):
    return (rng.standard_normal(shape_w).astype(np.float32) * 0.1,
            np.full(shape_b, 0.05, np.float32))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("loss", ["squared", "logistic", "softmax"])
def test_matches_reference(loss, mesh, rng):
    """N = 501 (padding on every mesh), momentum, L1 and L2."""
    x, y, _ = make_regression(rng, n=501, d=5)
    kw = dict(n_features=5, loss=loss, learning_rate=0.2, momentum=0.9,
              l1=0.01, l2=1e-3)
    params = None
    if loss == "logistic":
        y = (y > np.median(y)).astype(np.float32)
        params = _start(rng, 5)
    elif loss == "softmax":
        y = np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(np.int32)
        kw["n_classes"] = 3
    (jp, jl), (ptr, pp, pl) = _both(kw, x, y, mesh, n_steps=20,
                                    params=params)
    assert pl.dtype == np.float32 and pl.shape == (20,)
    _close(pl, jl)
    _close(pp[0], jp[0])
    _close(pp[1], jp[1])
    jtr = JLinearTrainer(JLinearConfig(**kw), mesh=jmake_mesh(1))
    _close(ptr.predict(pp, x), jtr.predict(jp, x))


def test_squared_loss_recovers_weights(rng):
    x, y, w_true = make_regression(rng)
    tr = LinearTrainer(LinearConfig(n_features=x.shape[1], loss="squared",
                                    learning_rate=0.3),
                       mesh=make_mesh(8, "cpu"))
    (w, b), losses = tr.fit(x, y, n_steps=200)
    assert losses[-1] < losses[0] * 0.01
    np.testing.assert_allclose(w.numpy(), w_true, rtol=0.1, atol=0.05)
    assert abs(float(b) - 0.5) < 0.05


def test_logistic_separates(rng):
    x, y = make_classification(rng)
    tr = LinearTrainer(LinearConfig(n_features=x.shape[1], loss="logistic",
                                    learning_rate=0.5),
                       mesh=make_mesh(8, "cpu"))
    params, losses = tr.fit(x, y, n_steps=300)
    assert losses[-1] < losses[0]
    p = tr.predict(params, x)
    assert isinstance(p, torch.Tensor)
    assert float(np.mean((p.numpy() > 0.5) == (y > 0.5))) > 0.95


def test_logistic_gradient_at_zero_margin():
    """At z = 0 the logloss's gradient is sigmoid(0) - y = 0.5 - y. The
    port's is; the reference's autodiff of ``maximum(z, 0)`` and
    ``abs(z)`` gives 0 - y there (a defect of the reference: its linear
    trainer starts from w = 0, b = 0, so its first logistic step is off).
    Away from 0 the two agree."""
    z = np.array([0.0, 0.0, 1.0, -2.0], np.float32)
    y = np.array([1.0, 0.0, 0.0, 1.0], np.float32)
    zt = torch.tensor(z, requires_grad=True)
    per_example_loss(zt, torch.from_numpy(y), "logistic").sum().backward()
    want = 1 / (1 + np.exp(-z.astype(np.float64))) - y
    np.testing.assert_allclose(zt.grad.numpy(), want, rtol=1e-6)
    jg = np.asarray(jax.grad(
        lambda v: jnp.sum(jloss(v, jnp.asarray(y), "logistic")))(z))
    np.testing.assert_array_equal(jg[:2], -y[:2])
    np.testing.assert_allclose(jg[2:], want[2:], rtol=1e-6)
    # the forward values agree everywhere
    np.testing.assert_allclose(
        per_example_loss(torch.from_numpy(z), torch.from_numpy(y),
                         "logistic").numpy(),
        np.asarray(jloss(jnp.asarray(z), jnp.asarray(y), "logistic")),
        rtol=1e-7)


@pytest.mark.parametrize("mesh", ["flat4", "hier2x4"])
def test_distributed_matches_single_device(mesh, rng):
    x, y, _ = make_regression(rng, n=501)
    cfg = LinearConfig(n_features=x.shape[1], loss="squared",
                       learning_rate=0.2, momentum=0.9, l2=1e-3)
    pd, ld = LinearTrainer(cfg, mesh=MESHES[mesh][1]()).fit(x, y,
                                                            n_steps=50)
    ps, ls = LinearTrainer(cfg, mesh=make_mesh(1, "cpu")).fit(x, y,
                                                              n_steps=50)
    _close(pd[0], ps[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ld, ls, rtol=1e-4, atol=1e-6)


def test_l1_sparsifies(rng):
    x, y, _ = make_regression(rng, d=10)
    x[:, 5:] = rng.standard_normal((x.shape[0], 5)).astype(np.float32)
    tr = LinearTrainer(LinearConfig(n_features=10, loss="squared",
                                    learning_rate=0.2, l1=0.05),
                       mesh=make_mesh(4, "cpu"))
    (w, _), _ = tr.fit(x, y, n_steps=200)
    assert int((w.abs() < 1e-6).sum()) >= 1


def test_bad_loss_and_shape_raise():
    with pytest.raises(Mp4jError):
        LinearConfig(n_features=4, loss="hinge")
    with pytest.raises(Mp4jError, match="n_classes"):
        LinearConfig(n_features=2, loss="softmax", n_classes=1)
    tr = LinearTrainer(LinearConfig(n_features=4), mesh=make_mesh(2, "cpu"))
    with pytest.raises(Mp4jError, match=r"\[N, 4\]"):
        tr.fit(np.zeros((8, 3), np.float32), np.zeros(8, np.float32),
               n_steps=1)
    with pytest.raises(Mp4jError, match="y must be"):
        tr.fit(np.zeros((8, 4), np.float32), np.zeros(7, np.float32),
               n_steps=1)


def test_model_files_load_in_both_packages(rng, tmp_path):
    x, y, _ = make_regression(rng, n=256, d=4)
    kw = dict(n_features=4, learning_rate=0.3)
    (jp, _), (ptr, pp, _) = _both(kw, x, y, "flat4", n_steps=30)
    ptr.save_params(str(tmp_path / "port.model"), pp)   # exact path
    JLinearTrainer(JLinearConfig(**kw), mesh=jmake_mesh(2)).save_params(
        str(tmp_path / "ref.model"), jp)
    jcfg, jparams = JLinearTrainer.load_params(str(tmp_path / "port.model"),
                                               JLinearConfig)
    assert jcfg == JLinearConfig(**kw)
    jserve = JLinearTrainer(jcfg, mesh=jmake_mesh(1))
    _close(jserve.predict(jparams, x), ptr.predict(pp, x), rtol=1e-6)
    pcfg, pparams = LinearTrainer.load_params(str(tmp_path / "ref.model"),
                                              LinearConfig)
    assert pcfg == LinearConfig(**kw)
    serve = LinearTrainer(pcfg, mesh=make_mesh(1, "cpu"))
    _close(serve.predict(pparams, x), jserve.predict(jp, x), rtol=1e-6)
    # load -> re-save round trip (numpy params)
    serve.save_params(str(tmp_path / "resaved.model"), pparams)
    _, params3 = LinearTrainer.load_params(str(tmp_path / "resaved.model"),
                                           LinearConfig)
    for a, b in zip(pparams, params3):
        np.testing.assert_array_equal(a, b)


def test_params_from_numpy(rng):
    x = rng.standard_normal((40, 3)).astype(np.float32)
    cfg = LinearConfig(n_features=3, loss="softmax", n_classes=4)
    params = (rng.standard_normal((3, 4)).astype(np.float32),
              rng.standard_normal(4).astype(np.float32))
    mesh = make_mesh(2, "cpu")
    pp = params_from_numpy(params, cfg, mesh)
    assert all(p.device.type == "cpu" for p in pp)
    jtr = JLinearTrainer(JLinearConfig(n_features=3, loss="softmax",
                                       n_classes=4), mesh=jmake_mesh(1))
    _close(LinearTrainer(cfg, mesh=mesh).predict(pp, x),
           jtr.predict(params, x), rtol=1e-6)
    with pytest.raises(Mp4jError, match="w must be"):
        params_from_numpy((params[0][:, :2], params[1]), cfg, mesh)


def test_eval_set_and_early_stopping(rng):
    x_all, y_all, _ = make_regression(rng, n=500, d=4)
    x, y = x_all[:400], y_all[:400]
    x_va, y_va = x_all[400:], y_all[400:]
    kw = dict(n_features=4, learning_rate=0.3)
    tr = LinearTrainer(LinearConfig(**kw), mesh=make_mesh(2, "cpu"))
    tr.fit(x, y, n_steps=25, eval_set=(x_va, y_va))
    assert len(tr.eval_history_) == 25
    assert tr.eval_history_[-1] < tr.eval_history_[0]
    jtr = JLinearTrainer(JLinearConfig(**kw), mesh=jmake_mesh(2))
    jtr.fit(x, y, n_steps=25, eval_set=(x_va, y_va))
    np.testing.assert_allclose(tr.eval_history_, jtr.eval_history_,
                               rtol=1e-5)

    y_noise = rng.standard_normal(100).astype(np.float32)
    tr2 = LinearTrainer(LinearConfig(**kw), mesh=make_mesh(2, "cpu"))
    params2, losses2 = tr2.fit(x, y, n_steps=60, eval_set=(x_va, y_noise),
                               early_stopping_rounds=3)
    assert len(losses2) < 60
    best = int(np.argmin(tr2.eval_history_))
    assert len(losses2) == best + 1
    assert tr2._eval_loss(params2, (torch.from_numpy(x_va),
                                    torch.from_numpy(y_noise))) == (
        pytest.approx(min(tr2.eval_history_), rel=1e-6))
    with pytest.raises(Mp4jError, match="eval_set"):
        tr2.fit(x, y, n_steps=3, early_stopping_rounds=2)
    with pytest.raises(Mp4jError, match="eval y"):
        tr2.fit(x, y, n_steps=1, eval_set=(x_va, y_noise[:5]))


def test_softmax_multiclass_separates(rng):
    N, F, C = 1200, 4, 3
    centers = np.array([[3, 0, 0, 0], [0, 3, 0, 0], [0, 0, 3, 0]],
                       np.float32)
    y = rng.integers(0, C, N).astype(np.int32)
    x = centers[y] + rng.standard_normal((N, F)).astype(np.float32)
    tr = LinearTrainer(LinearConfig(n_features=F, loss="softmax",
                                    n_classes=C, learning_rate=0.5),
                       n_devices=4, device="cpu")
    params, losses = tr.fit(x, y, n_steps=60)
    assert losses[-1] < losses[0] * 0.5
    p = tr.predict(params, x).numpy()
    assert p.shape == (N, C)
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-5)
    assert (p.argmax(1) == y).mean() > 0.9


def test_softmax_distributed_matches_single_device(rng):
    N, F, C = 203, 3, 4
    x = rng.standard_normal((N, F)).astype(np.float32)
    y = rng.integers(0, C, N).astype(np.int32)
    cfg = LinearConfig(n_features=F, loss="softmax", n_classes=C,
                       learning_rate=0.3, l2=1e-3, momentum=0.5)
    p1, l1 = LinearTrainer(cfg, n_devices=1, device="cpu").fit(x, y,
                                                               n_steps=10)
    p8, l8 = LinearTrainer(cfg, n_devices=8, device="cpu").fit(x, y,
                                                               n_steps=10)
    for a, b in zip(p1, p8):
        _close(a, b, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(l1, l8, rtol=2e-5, atol=2e-6)


def test_softmax_label_validation(rng):
    tr = LinearTrainer(LinearConfig(n_features=2, loss="softmax",
                                    n_classes=3), device="cpu")
    x = rng.standard_normal((10, 2)).astype(np.float32)
    with pytest.raises(Mp4jError, match="softmax labels"):
        tr.fit(x, np.full(10, 3, np.int32), n_steps=1)


def test_softmax_loss_matches_numpy_and_reference(rng):
    N, C = 64, 5
    z = rng.standard_normal((N, C)).astype(np.float32) * 10
    y = rng.integers(0, C, N)
    got = per_example_loss(torch.from_numpy(z), torch.from_numpy(y),
                           "softmax").numpy()
    m = z.max(axis=1, keepdims=True)
    want = m[:, 0] + np.log(np.exp(z - m).sum(axis=1)) - z[np.arange(N), y]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jloss(jnp.asarray(z), jnp.asarray(y), "softmax")),
        rtol=1e-6, atol=1e-6)


def test_column_vector_labels_rejected(rng):
    x = rng.standard_normal((10, 2)).astype(np.float32)
    for loss, kw in (("squared", {}), ("logistic", {}),
                     ("softmax", {"n_classes": 2})):
        tr = LinearTrainer(LinearConfig(n_features=2, loss=loss, **kw),
                           device="cpu")
        with pytest.raises(Mp4jError, match="1-D"):
            tr.fit(x, np.zeros((10, 1)), n_steps=1)


# ------------------------------------------------------------ streaming
def test_fit_stream_single_chunk_equals_fit_bitwise(rng):
    """One full-batch chunk per epoch == fit(n_steps=E), momentum
    threading across chunks; the serialized loop runs the same steps."""
    x, y, _ = make_regression(rng, n=96, d=5)
    cfg = LinearConfig(n_features=5, learning_rate=0.1, momentum=0.9,
                       l2=1e-3, l1=1e-3)
    p_f, l_f = LinearTrainer(cfg, mesh=make_mesh(4, "cpu")).fit(x, y,
                                                                n_steps=4)
    p_s, l_s = LinearTrainer(cfg, mesh=make_mesh(4, "cpu")).fit_stream(
        ((x, y) for _ in range(4)))
    np.testing.assert_array_equal(l_s, l_f)
    for a, b in zip(p_s, p_f):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    _, l_s0 = LinearTrainer(cfg, mesh=make_mesh(4, "cpu")).fit_stream(
        ((x, y) for _ in range(4)), max_in_flight=0)
    np.testing.assert_array_equal(l_s0, l_s)


def test_fit_stream_matches_reference(rng):
    """Uneven softmax chunks (the last padded to batch_rows) against the
    reference's stream; an oversized chunk raises."""
    x = rng.standard_normal((100, 4)).astype(np.float32)
    y = rng.integers(0, 3, 100)
    kw = dict(n_features=4, loss="softmax", n_classes=3, learning_rate=0.3,
              momentum=0.5)
    chunks = [(x[:64], y[:64]), (x[64:], y[64:])] * 2
    jp, jl = JLinearTrainer(JLinearConfig(**kw), mesh=jmake_mesh(4)
                            ).fit_stream(iter(chunks), batch_rows=64)
    tr = LinearTrainer(LinearConfig(**kw), mesh=make_mesh(4, "cpu"))
    pp, pl = tr.fit_stream(iter(chunks), batch_rows=64)
    assert pl.shape == (4,) and pl[-1] < pl[0]
    _close(pl, jl)
    _close(pp[0], jp[0])
    with pytest.raises(Mp4jError, match="exceeds batch_rows"):
        tr.fit_stream(iter([(x, y)]), batch_rows=64)


def test_linear_stream_from_libsvm_text(rng):
    """libsvm text -> dense_chunks -> fit_stream end to end."""
    x, y = make_classification(rng, n=128, d=6)
    lines = [f"{y[i]:.0f} " + " ".join(f"{j}:{x[i, j]:.5f}"
                                       for j in range(6))
             for i in range(128)]
    tr = LinearTrainer(LinearConfig(n_features=6, loss="logistic",
                                    learning_rate=0.5),
                       mesh=make_mesh(4, "cpu"))
    params = None
    for _ in range(8):
        params, _ = tr.fit_stream(
            dense_chunks(read_libsvm(iter(lines), chunk_rows=64,
                                     max_nnz=6), 6),
            params=params, batch_rows=64)
    acc = float(np.mean((tr.predict(params, x).numpy() > 0.5) == (y > 0.5)))
    assert acc > 0.9, acc


def test_sample_weight_equals_duplication(rng):
    x, y, _ = make_regression(rng, n=48, d=4)
    k = rng.integers(1, 4, 48)
    xd, yd = np.repeat(x, k, axis=0), np.repeat(y, k)
    cfg = LinearConfig(n_features=4, learning_rate=0.2, momentum=0.5)
    mesh = make_mesh(4, "cpu")
    _, l_w = LinearTrainer(cfg, mesh=mesh).fit(
        x, y, n_steps=3, sample_weight=k.astype(np.float32))
    _, l_d = LinearTrainer(cfg, mesh=mesh).fit(xd, yd, n_steps=3)
    np.testing.assert_allclose(l_w, l_d, rtol=1e-5, atol=1e-7)
    _, l_s = LinearTrainer(cfg, mesh=mesh).fit_stream(
        ((x, y, k.astype(np.float32)) for _ in range(3)))
    np.testing.assert_array_equal(l_s, l_w)
    with pytest.raises(Mp4jError, match="sample_weight"):
        LinearTrainer(cfg, mesh=make_mesh(2, "cpu")).fit(
            x, y, n_steps=1, sample_weight=np.ones(7))


def test_empty_input_trains_like_the_reference():
    """N = 0: both packages take the steps, losses 0, parameters 0."""
    for loss in ("squared", "softmax"):
        kw = dict(n_features=3, loss=loss, n_classes=3)
        x = np.zeros((0, 3), np.float32)
        y = np.zeros(0, np.int32 if loss == "softmax" else np.float32)
        (jp, jl), (_, pp, pl) = _both(kw, x, y, "flat4", n_steps=2)
        np.testing.assert_array_equal(pl, jl)
        for a, b in zip(pp, jp):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
