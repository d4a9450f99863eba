"""``python -m repro_torch.analysis`` — same entry point as ``repro-torch-lint``."""
import sys

from repro_torch.analysis.cli import main

try:
    sys.exit(main())
except BrokenPipeError:  # e.g. `repro-torch-lint ... | head`
    sys.exit(0)
