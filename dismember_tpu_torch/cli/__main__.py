import sys

from dismember_tpu_torch.cli.main import main

sys.exit(main())
