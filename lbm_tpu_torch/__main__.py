import sys

from lbm_tpu_torch.cli import main

sys.exit(main())
