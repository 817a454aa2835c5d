"""The port's token pipeline (:mod:`repro_torch.data.pipeline`)."""
