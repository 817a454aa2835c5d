"""Simulation core of the port: cluster build, scenarios, the batched
request loop (``simcore``) and the campaign runner."""
