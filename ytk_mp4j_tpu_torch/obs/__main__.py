"""``python -m ytk_mp4j_tpu_torch.obs`` — the mp4j-scope CLI.

A copy of ``ytk_mp4j_tpu/obs/__main__.py``, with its imports re-rooted at
the port; it imports nothing of the JAX package.
"""

import sys

from ytk_mp4j_tpu_torch.obs.cli import main

sys.exit(main())
