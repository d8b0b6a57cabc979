import sys

from quantumcomputer_tpu_torch.cli import main

sys.exit(main())
