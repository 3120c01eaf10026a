import sys

from repic_tpu_torch.main import main

sys.exit(main())
