"""python -m quaff_tpu_torch align ... (same as quaff_tpu_torch.cli)."""

import sys

from .cli import main

sys.exit(main())
