"""`python -m etl_tpu_torch.analysis [paths]` — see `cli`."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
