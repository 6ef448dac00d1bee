"""``python -m smore_tpu_torch <model> ...``: see smore_tpu_torch/cli/main.py."""

import sys

from smore_tpu_torch.cli.main import main

sys.exit(main())
