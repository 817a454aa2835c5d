"""Models of the port: the decoder-only family with its attention kernels."""
