"""The JAX package's Pallas ring kernels in interpret mode over more
members than tests/conftest.py's 8 virtual devices: run in a child
interpreter of 16 (``XLA_FLAGS`` is read when JAX starts, so the test
process cannot grow its own mesh).

    python tests/torch_ring_reference.py N OUT.npz

computes, for N members and each of :data:`DTYPES`, every case of
:data:`CASES` in one jitted program on seeded inputs (:func:`inputs`) and
writes ``<dtype>.<key>.x`` (the input) and ``<dtype>.<key>.y`` (the
reference's output) for each :func:`key` into OUT.npz.
``tests/test_torch_ring_global.py`` starts it and holds the port against
what it writes.
"""

import os
import sys

import numpy as np

DTYPES = ("float32", "float64")
# (mode, operator, bidirectional): the reducing modes under SUM and MAX,
# the allgather (no operator), each direction count
CASES = tuple((mode, op, bidir)
              for mode, op in (("allreduce", "SUM"), ("allreduce", "MAX"),
                               ("reduce_scatter", "SUM"),
                               ("reduce_scatter", "MAX"),
                               ("allgather", "SUM"))
              for bidir in (False, True))


def key(mode, op, bidir):
    return f"{mode}-{op}-{'bidir' if bidir else 'unidir'}"


def inputs(n, dtype):
    """{key: [n, L] input}: allreduce at an odd length (padding),
    reduce-scatter chunks and allgather shards of 6 (two halves of 3);
    NaN at two places of the MAX inputs. Seeded by n."""
    rng = np.random.default_rng(n)
    shapes = {"allreduce": (n, 4 * n + 3), "reduce_scatter": (n, 6 * n),
              "allgather": (n, 6)}
    out = {}
    for mode, op, bidir in CASES:
        x = rng.standard_normal(shapes[mode]).astype(dtype)
        if op == "MAX":
            x[0, 1] = x[n - 1, 2] = np.nan
        out[key(mode, op, bidir)] = x
    return out


def main(n, path):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from functools import partial

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ytk_mp4j_tpu.operators import Operators
    from ytk_mp4j_tpu.ops import ring_kernel as jrk
    from ytk_mp4j_tpu.parallel import make_mesh

    @partial(jax.shard_map, mesh=make_mesh(n), in_specs=P("mp4j"),
             out_specs=P("mp4j"), check_vma=False)
    def run(*parts):
        outs = []
        for (mode, op, bidir), x in zip(CASES, parts):
            operator = getattr(Operators, op)
            if mode == "allreduce":
                y = jrk.ring_allreduce_kernel(x[0], operator, "mp4j",
                                              interpret=True,
                                              bidirectional=bidir)
            elif mode == "reduce_scatter":
                y = jrk.ring_reduce_scatter_kernel(x[0], operator, "mp4j",
                                                   interpret=True,
                                                   bidirectional=bidir)
            else:
                y = jrk.ring_allgather_kernel(x[0], "mp4j", interpret=True,
                                              bidirectional=bidir)
            outs.append(y[None])
        return tuple(outs)

    keys = [key(*case) for case in CASES]
    arrays = {}
    for dt in DTYPES:
        xs = inputs(n, np.dtype(dt))
        ys = jax.jit(run)(*[jnp.asarray(xs[k]) for k in keys])
        for k, y in zip(keys, ys):
            arrays[f"{dt}.{k}.x"] = xs[k]
            arrays[f"{dt}.{k}.y"] = np.asarray(y)
    np.savez(path, **arrays)


if __name__ == "__main__":
    # read when JAX starts, which main() does
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    main(int(sys.argv[1]), sys.argv[2])
