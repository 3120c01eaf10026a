import os
import sys

# LOCKCHECK wraps only the locks created once it is armed: arm it before
# any module of the package, and with it any module-level lock, loads
if os.environ.get("REPIC_TPU_LOCKCHECK", "") == "1":
    from repic_tpu_torch.analysis import lockcheck

    lockcheck.install()

from repic_tpu_torch.main import main  # noqa: E402

sys.exit(main())
