"""``python -m adam_tpu_torch.staticcheck`` — the checker without the CLI's
shared flags."""

import sys

from adam_tpu_torch.staticcheck.cli import main

if __name__ == "__main__":
    sys.exit(main())
