"""``python -m repro_torch.launch.dryrun``: the port's dry-run over every
(arch x shape x mesh) cell (``launch.dryrun_lib.main``'s flags, and
``--device``).  The reference sets XLA's host device count here; the
port's process is one rank of a fake process group instead, and needs no
setting."""
import sys

from repro_torch.launch.dryrun_lib import main

if __name__ == "__main__":
    sys.exit(main())
