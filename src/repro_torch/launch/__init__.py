"""Launchers of the port: the mesh (:mod:`.mesh`), the dry-run's cells
(:mod:`.specs`), counts (:mod:`.counts`) and runs (:mod:`.dryrun_lib`,
``python -m repro_torch.launch.dryrun``), and the train, serve and
elastic-restore entry points (``python -m repro_torch.launch.train`` /
``.serve`` / ``.elastic``)."""
