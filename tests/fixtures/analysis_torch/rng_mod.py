"""Analysis-linter fixture for the port: seeded rng-audit violations.

``raw_np``, ``raw_torch``, ``raw_cuda`` and ``raw_bare`` are the four
raw-constructor violations (numpy's and torch's); ``colliding`` uses two
stream names whose crc32 salts coincide (the uniqueness rule must prove
the collision, not pattern-match the names); ``dynamic`` passes a
non-literal name (a warning only).
"""
import numpy as np
import torch
from torch import Generator

from repro_torch.core.rng import rng_seed, rng_stream


def raw_np():
    return np.random.default_rng(0)


def raw_torch():
    return torch.Generator(device="cpu")


def raw_cuda():
    torch.cuda.manual_seed_all(0)


def raw_bare():
    return Generator()


def named():
    return rng_stream(0, "topology"), rng_seed(0, "noise")


def colliding(seed):
    a = rng_stream(seed, "gauge-probe-8")
    b = rng_stream(seed, "wedge-wedge-96")   # same crc32 salt as above
    return a, b


def dynamic(seed, name):
    return rng_stream(seed, name)
