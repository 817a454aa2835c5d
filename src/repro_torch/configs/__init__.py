"""Model configurations of the port (copies of the reference's)."""
