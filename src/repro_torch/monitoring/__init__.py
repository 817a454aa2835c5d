"""Monitoring helpers the simulation core drives."""
