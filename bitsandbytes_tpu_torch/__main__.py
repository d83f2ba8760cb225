"""``python -m bitsandbytes_tpu_torch``: the environment and a sanity check
(``diagnostics.py``)."""

import sys

from .diagnostics import main

if __name__ == "__main__":
    sys.exit(main())
