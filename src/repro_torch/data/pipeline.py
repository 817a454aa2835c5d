"""Synthetic token pipeline of the port: deterministic and prefetched.

Translated from the reference's ``data/pipeline.py``.
:class:`SyntheticLMData` is a Zipf-mixture Markov stream with bigram
structure, so a model can learn it; it makes the same numpy draws in the
same order as the reference's, so the two give the same batches bit for
bit from the same seeds.  :func:`make_batch_iterator` draws batches in a
background thread (host sampling overlaps the step) into pinned host
memory when the target is the card, and the consumer's ``next`` copies
them to the device without blocking the host.  The reference's
``sharding`` (placement on a mesh) has no counterpart on one card.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class SyntheticLMData:
    """Deterministic Markov-bigram token source."""

    def __init__(self, vocab_size: int, seed: int = 0, branching: int = 8):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        # each token deterministically prefers `branching` successors
        self.succ = rng.integers(0, vocab_size,
                                 size=(vocab_size, branching))
        self.branching = branching
        self._zipf_p = 1.0 / np.arange(1, vocab_size + 1) ** 1.1
        self._zipf_p /= self._zipf_p.sum()

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> dict:
        """``tokens`` and ``labels`` (batch, seq) int32 numpy arrays, the
        labels the tokens shifted by one."""
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.choice(self.vocab, size=batch, p=self._zipf_p)
        for t in range(seq):
            pick = rng.integers(0, self.branching, size=batch)
            nxt = self.succ[toks[:, t], pick]
            noise = rng.random(batch) < 0.1
            nxt = np.where(noise, rng.integers(0, self.vocab, batch), nxt)
            toks[:, t + 1] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch_iterator(data: SyntheticLMData, batch: int, seq: int,
                        seed: int = 0, device: DeviceLike = None,
                        prefetch: int = 2,
                        extras: Optional[dict] = None) -> Iterator[dict]:
    """Prefetching iterator of batch dicts of tensors on ``device`` (None:
    the CUDA card): ``data.sample`` drawn from ``default_rng(seed)`` in a
    background thread, at most ``prefetch`` ahead; ``extras`` adds
    constant arrays to every batch (e.g. vision embeds or encoder frames
    stubs).  ``close()`` stops the thread."""
    dev = resolve_device(device)
    pin = dev.type == "cuda"
    rng = np.random.default_rng(seed)
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def host(x) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t.pin_memory() if pin else t

    def producer():
        while not stop.is_set():
            b = data.sample(rng, batch, seq)
            if extras:
                b = {**b, **extras}
            q.put({k: host(v) for k, v in b.items()})

    th = threading.Thread(target=producer, daemon=True)
    th.start()

    class _It:
        def __iter__(self):
            return self

        def __next__(self):
            b = q.get()
            return {k: v.to(dev, non_blocking=True) for k, v in b.items()}

        def close(self):
            stop.set()
            try:
                q.get_nowait()
            except queue.Empty:
                pass

    return _It()
