"""The port's optimizer: AdamW with f32 master weights
(:mod:`repro_torch.optim.adamw`)."""
