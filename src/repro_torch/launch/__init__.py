"""Launchers of the port: the mesh (:mod:`.mesh`), the rule half of the
dry-run's cells (:mod:`.specs`), and the train, serve and elastic-restore
entry points (``python -m repro_torch.launch.train`` / ``.serve`` /
``.elastic``)."""
