"""``python -m hymet_tpu_torch <subcommand>``: see :mod:`hymet_tpu_torch.cli`."""

import sys

from hymet_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
