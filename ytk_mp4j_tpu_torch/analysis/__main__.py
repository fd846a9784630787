"""``python -m ytk_mp4j_tpu_torch.analysis`` — the mp4j-lint CLI."""

import sys

from ytk_mp4j_tpu_torch.analysis.cli import main

sys.exit(main())
