"""``python -m entreepy_tpu_torch`` — the entreepy-compatible CLI on the PyTorch port."""

import sys

from .cli import main

sys.exit(main())
