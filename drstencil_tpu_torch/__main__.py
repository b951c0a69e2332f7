"""``python -m drstencil_tpu_torch`` — alias for the compiler CLI."""

import sys

from drstencil_tpu_torch.cli import main

sys.exit(main())
