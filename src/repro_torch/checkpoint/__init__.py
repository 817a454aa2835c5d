"""The port's fault-tolerant checkpointing
(:mod:`repro_torch.checkpoint.checkpointer`)."""
from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    Checkpointer,
    install_sigterm_handler,
)
