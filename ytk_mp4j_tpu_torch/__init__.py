"""ytk-mp4j in PyTorch on an NVIDIA H100.

The port of ``ytk_mp4j_tpu`` (JAX on a TPU), which stays beside it as the
reference. Slice 1: data-parallel GBDT on one GPU, whose histogram build
is a hand-written CUDA kernel for Hopper (``ops/csrc/hist_kernel.cu``).
Slice 2: the dense device collective plane, ``GpuCommCluster`` with n
members on one card and the algos ``xla``, ``ring`` and ``rdma`` -- the
last the hand-written CUDA ring kernels (``ops/csrc/ring_cluster.cu``,
one thread-block cluster per ring, for n <= 8 members;
``ops/csrc/ring_kernel.cu`` above). Slice 5:
the GBDT trainer over a mesh of members (``device.make_mesh`` /
``make_hier_mesh``) with zero-weight row padding and rank-order folds of
the histograms and leaf sums, quantile binning (``models/binning.py``),
``train_raw`` / ``predict_raw``, model files either package loads, and
the entry points (``entry.py``). Slice 6: the sparse map plane
(``ops/sparse.py``, ``comm/keycodec.py`` and the map family of
``GpuCommCluster``), the FM/FFM trainer with a replicated or sharded
embedding table (``models/fm.py``), the linear trainer
(``models/linear.py``), streaming fits and the libsvm reader
(``utils/libsvm.py``, with its native parser). Slice 7: the
multi-process plane over ``torch.distributed`` (``comm/distributed.py``:
``init_distributed``, ``DistributedComm``, ``global_mesh``), GBDT over
processes with the histograms and leaf sums folded across the ranks in
rank order, ``train(comm=)`` / ``train_raw(comm=)`` and
``QuantileBinner.fit_distributed``, and the check program
``check/checkdist.py``. Slice 8: FM/FFM and linear over processes.
Slice 9: the socket plane, copied from the reference -- the rendezvous
``comm/master.py``, ``comm/process_comm.ProcessCommSlave`` over the TCP
and shared-memory transports (``transport/``) with the native merge and
raw data plane (``csrc/mp4j_native.cpp``, ``csrc/mp4j_transport.cpp``),
the progression engine (``comm/progress.py``),
``comm/thread_comm.ThreadCommSlave``, and the ``obs/`` and
``resilience/`` planes they import. Slice 10: the serve plane
(``serve/``) and the check suites. Slice 11: per-collective tracing on
every plane (``trace``, ``trace_collectives``; ``utils/trace.py``) and
the ``mp4j-lint`` static analyzer (``analysis/``, run as ``python -m
ytk_mp4j_tpu_torch.analysis``). It imports torch and numpy, never
jax and nothing of ``ytk_mp4j_tpu``. Entry points run on ``cuda:0`` unless
the caller passes ``device="cpu"``.
"""

from ytk_mp4j_tpu_torch import meta
from ytk_mp4j_tpu_torch.comm.gpu_comm import GpuCommCluster
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models.fm import FMConfig, FMTrainer
from ytk_mp4j_tpu_torch.models.gbdt import (GBDTConfig, GBDTTrainer,
                                            trees_from_numpy)
from ytk_mp4j_tpu_torch.models.linear import LinearConfig, LinearTrainer
from ytk_mp4j_tpu_torch.operands import Operand, Operands
from ytk_mp4j_tpu_torch.operators import Operator, Operators
from ytk_mp4j_tpu_torch.utils import trace
from ytk_mp4j_tpu_torch.utils.trace import trace_collectives

__all__ = ["FMConfig", "FMTrainer", "GBDTConfig", "GBDTTrainer",
           "GpuCommCluster", "LinearConfig", "LinearTrainer", "Mp4jError",
           "Operand", "Operands", "Operator", "Operators", "meta", "trace",
           "trace_collectives", "trees_from_numpy"]
