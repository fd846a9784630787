"""mp4j-serve: the sharded low-latency inference plane.

A copy of ``ytk_mp4j_tpu/serve/__init__.py``, with its imports re-rooted at
the port; it imports nothing of the JAX package.

The inference workload beside the training substrate: a micro-
batching front end (``batcher``), a hot-key row cache keyed through
the persistent keycodec vocabularies (``cache``), binary
request/response framing (``framing``) and the collective-substrate
dispatch planes (``dispatcher`` — pull rows for the embedding
families, reduce margins for GBDT). See README "Serving".
"""

from ytk_mp4j_tpu_torch.serve.batcher import MicroBatcher, ServeFuture
from ytk_mp4j_tpu_torch.serve.cache import HotKeyCache
from ytk_mp4j_tpu_torch.serve.dispatcher import ServeFrontend, serve_worker
from ytk_mp4j_tpu_torch.serve.framing import (STATUS_DEGRADED,
                                              STATUS_ERROR, STATUS_OK,
                                              decode_request,
                                              decode_response,
                                              encode_request,
                                              encode_response)

__all__ = [
    "MicroBatcher", "ServeFuture", "HotKeyCache", "ServeFrontend",
    "serve_worker", "encode_request", "decode_request",
    "encode_response", "decode_response", "STATUS_OK", "STATUS_ERROR",
    "STATUS_DEGRADED",
]
