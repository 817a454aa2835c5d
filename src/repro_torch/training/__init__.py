"""The port's LM training step (:mod:`repro_torch.training.train_step`)."""
