"""``python -m goworld_tpu_torch`` — the ops CLI (reference
``cmd/goworld``)."""

import sys

from goworld_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
