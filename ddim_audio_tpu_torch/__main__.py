"""``python -m ddim_audio_tpu_torch``: the sampling CLI (``cli.py``)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
