"""``python -m paddle_tpu_torch <job> ...`` — the port's CLI
(``cli.py``; counterpart of ``python -m paddle_tpu``)."""

import sys

from paddle_tpu_torch.cli import main

sys.exit(main())
