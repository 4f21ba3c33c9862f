"""``python -m repro_torch.analysis`` is
``python -m repro_torch.analysis.lint``."""
import sys

from repro_torch.analysis.lint import main

sys.exit(main())
