"""The port's arch registry against the JAX package's: the same ten
archs with the same configs, each lowered, and each smoke config's
prefill and one decode step in f32 against the reference model
(``_torch_parity.TOL``), on the CPU."""
import dataclasses

import numpy as np
import pytest

from _torch_parity import batches, configs, models, run_side_by_side, tokens
from repro.configs.base import available_archs as reference_archs
from repro_torch.configs.base import available_archs
from repro_torch.models.attention import check_lowered

ARCHS = reference_archs()


def test_registry_is_the_reference_registry():
    assert available_archs() == ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference_config(arch, smoke):
    theirs, ours = configs(arch, smoke=smoke)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.param_count() == theirs.param_count()
    assert ours.param_count(active_only=True) == \
        theirs.param_count(active_only=True)
    check_lowered(ours)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_prefill_and_decode_match_reference(arch):
    m = models(arch)
    cfg = m[1]
    B, S = 2, 13
    extra = {}
    if cfg.family == "vlm":
        extra["vision_embeds"] = np.zeros((B, cfg.num_frontend_tokens,
                                           cfg.d_model), np.float32)
    if cfg.family == "encdec":
        extra["enc_frames"] = np.random.default_rng(1).standard_normal(
            (B, 8, cfg.d_model)).astype(np.float32)
    jb, tb = batches(tokens(0, B, S, cfg.vocab_size), **extra)
    run_side_by_side(m, jb, tb, cache_len=S + 4, steps=1)
