"""ytk-mp4j's flagship workload in PyTorch on an NVIDIA H100.

The port of ``ytk_mp4j_tpu`` (JAX on a TPU), which stays beside it as the
reference. This slice: data-parallel GBDT on one GPU -- a boosting round
whose histogram build is a hand-written CUDA kernel for Hopper
(``ops/csrc/hist_kernel.cu``). It imports torch and numpy, never jax and
nothing of ``ytk_mp4j_tpu``. Entry points run on ``cuda:0`` unless the
caller passes ``device="cpu"``.
"""

from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models.gbdt import (GBDTConfig, GBDTTrainer,
                                            trees_from_numpy)

__all__ = ["GBDTConfig", "GBDTTrainer", "Mp4jError", "trees_from_numpy"]
