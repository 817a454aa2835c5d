"""Batched serving engine of the port: wave-based prefill + decode.

Translated from the reference's ``serving/engine.py``.  One engine is one
replica.  RTT is gateway-to-gateway (enqueue -> response), queue wait
included.  Each engine exports monitoring metrics (queue depth, active
batch, token rate, slowdown) to its node's :class:`MetricsStore`: the
signals Morpheus predictors learn from.  ``slowdown`` models
heterogeneous or contended nodes.

As in the reference, a wave left-pads its prompts with token 0 and passes
no pad mask: prefill attends causally over the pads and decode's
``kv_len = len + 1`` counts them; a Mamba2 (``ssm``, ``hybrid``) model
scans them like any token.  The reference's Mamba2 prefill takes a padded
length only up to the SSD chunk or as a multiple of it, and at least the
conv history ``d_conv - 1``; a wave outside that raises ``ValueError``.
An ``encdec`` wave's encoder takes zero frames (B, 8, D) in bf16, as the
reference's engine feeds it (so its cross-attention adds exactly zero).
An int8 KV cache (``kv_cache_dtype="int8"``) is refused when the engine
is built: the reference's decode cannot step from its prefill's cache.
The greedy tokens come back to the host after every step, and the card
is synchronised before ``t_done`` is stamped, so an RTT is wall time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.models.attention import check_lowered
from repro_torch.monitoring.metrics import MetricsStore, SimClock

#: the encoder frames of an ``encdec`` wave (zeros), as the reference's
ENC_FRAMES = 8


@dataclass
class Request:
    rid: int
    tokens: np.ndarray              # (prompt_len,)
    max_new_tokens: int = 16
    t_enqueue: float = 0.0
    t_done: Optional[float] = None
    output: Optional[np.ndarray] = None

    @property
    def rtt(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_enqueue


def _to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


class ServingEngine:
    """``device=None`` means the CUDA card (``RuntimeError`` without
    one); ``device="cpu"`` runs the plain kernel versions.  ``params`` are
    moved to the device (a no-op when they are there already)."""

    def __init__(self, cfg, params, *, device: DeviceLike = None,
                 node: str = "node-0", max_batch: int = 4,
                 max_seq: int = 256, slowdown: float = 0.0,
                 clock: Optional[SimClock] = None,
                 store: Optional[MetricsStore] = None, seed: int = 0):
        self.device = resolve_device(device)
        check_lowered(cfg)
        if M.int8_kv(cfg):
            raise ValueError(
                "the serving engine cannot take an int8 KV cache: a wave "
                "decodes from its prefill's cache, which holds no int8 "
                "scales (the reference's decode fails on it with an "
                "IndexError)")
        self.cfg = cfg
        self.params = _to(params, self.device)
        self.node = node
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.slowdown = slowdown       # artificial per-step delay (s)
        self.clock = clock or SimClock(simulated=False)
        self.store = store or MetricsStore(clock=self.clock)
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self.rng = np.random.default_rng(seed)
        self._tok_count = 0
        self._t_last = self.clock.now()
        # capacity plane: an inactive engine takes no NEW work but still
        # drains its queue; busy_s is its replica-seconds busy
        self.active = True
        self.busy_s = 0.0

        self._prefill = lambda p, b: M.prefill(p, cfg, b, cache_len=max_seq)
        self._decode = lambda p, c, t: M.decode_step(p, cfg, c, t)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.t_enqueue = self.clock.now()
        self.queue.append(req)
        self._export()

    def _export(self):
        active = 0
        self.store.scrape({
            "queue_depth": float(len(self.queue)),
            "active_batch": float(active),
            "token_rate": self._rate(),
            "slowdown": self.slowdown,
        })

    def _rate(self) -> float:
        now = self.clock.now()
        dt = max(now - self._t_last, 1e-6)
        return float(self._tok_count / dt)

    def _check_wave(self, plen: int, n_new: int) -> None:
        """Refuse a wave the reference's model cannot take, before it
        leaves the queue."""
        nft = self.cfg.num_frontend_tokens
        if self.cfg.family == "vlm" and plen < nft:
            raise ValueError(f"a wave of prompts at most {plen} tokens long "
                             f"cannot hold the {nft} vision-stub positions")
        if self.cfg.family in ("ssm", "hybrid"):
            chunk, W = self.cfg.ssm.chunk_size, self.cfg.ssm.d_conv
            if plen > chunk and plen % chunk:
                raise ValueError(f"padded prompt length {plen} is longer "
                                 f"than the SSD chunk {chunk} and not a "
                                 f"multiple of it")
            if plen < W - 1:
                raise ValueError(f"padded prompt length {plen} is shorter "
                                 f"than the conv history of {W - 1}")
        if plen + n_new - 1 > self.max_seq:
            raise ValueError(f"prompt length {plen} + {n_new} new tokens - 1 "
                             f"exceeds max_seq={self.max_seq}")

    def _greedy(self, logits: torch.Tensor) -> np.ndarray:
        return logits[:, : self.cfg.vocab_size].argmax(-1).to(
            torch.int32).cpu().numpy()

    # ------------------------------------------------------------------
    def step_wave(self) -> List[Request]:
        """Serve one wave: take up to max_batch queued requests, prefill,
        decode to completion, return finished requests.  A wave that does
        not fit (prompts shorter than the vision stub, longer than
        ``max_seq`` with their new tokens, or of a padded length the SSD
        scan cannot chunk) raises ``ValueError`` and stays queued."""
        if not self.queue:
            return []
        wave = self.queue[: self.max_batch]
        B = len(wave)
        plen = max(len(r.tokens) for r in wave)
        n_new = max(r.max_new_tokens for r in wave)
        self._check_wave(plen, n_new)
        t_wave0 = self.clock.now()
        self.queue = self.queue[self.max_batch:]
        toks = np.zeros((B, plen), np.int32)
        for i, r in enumerate(wave):
            toks[i, -len(r.tokens):] = r.tokens     # left-pad
        batch = {"tokens": torch.as_tensor(toks, device=self.device)}
        if self.cfg.family == "vlm":
            batch["vision_embeds"] = torch.zeros(
                (B, self.cfg.num_frontend_tokens, self.cfg.d_model),
                dtype=torch.bfloat16, device=self.device)
        if self.cfg.family == "encdec":
            batch["enc_frames"] = torch.zeros(
                (B, ENC_FRAMES, self.cfg.d_model), dtype=torch.bfloat16,
                device=self.device)
        logits, cache = self._prefill(self.params, batch)
        outs = [[] for _ in range(B)]
        tok = self._greedy(logits)
        for i in range(B):
            outs[i].append(tok[i])
        for _ in range(n_new - 1):
            logits, cache = self._decode(
                self.params, cache,
                torch.as_tensor(tok[:, None], device=self.device))
            tok = self._greedy(logits)
            for i in range(B):
                outs[i].append(tok[i])
            self._tok_count += B
            if self.slowdown:
                self.clock.advance(self.slowdown)
            self._export()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = self.clock.now()
        self.busy_s += now - t_wave0       # wall/clock time spent serving
        for i, r in enumerate(wave):
            r.t_done = now
            r.output = np.array(outs[i][: r.max_new_tokens])
            self.done.append(r)
        self._export()
        return wave

    def pending(self) -> int:
        return len(self.queue)
