"""The port's token pipeline (``repro_torch.data.pipeline``) against the
reference's ``repro.data.pipeline`` on the CPU: the same batches bit for
bit from the same seeds, the reference's own data tests replayed, and
the prefetching iterator."""
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLMData as ReferenceData
from repro_torch.data.pipeline import SyntheticLMData, make_batch_iterator


@pytest.mark.parametrize("vocab,branching,seed", [(128, 8, 1), (2048, 8, 0),
                                                  (64, 4, 7)])
def test_batches_match_reference_bit_for_bit(vocab, branching, seed):
    ref = ReferenceData(vocab, seed=seed, branching=branching)
    port = SyntheticLMData(vocab, seed=seed, branching=branching)
    np.testing.assert_array_equal(port.succ, ref.succ)
    r1, r2 = np.random.default_rng(seed + 3), np.random.default_rng(seed + 3)
    for batch, seq in ((4, 16), (3, 7), (8, 32)):
        want, got = ref.sample(r1, batch, seq), port.sample(r2, batch, seq)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_deterministic():
    d = SyntheticLMData(vocab_size=128, seed=1)
    b1 = d.sample(np.random.default_rng(7), 4, 16)
    b2 = d.sample(np.random.default_rng(7), 4, 16)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])


def test_labels_shifted():
    d = SyntheticLMData(vocab_size=64, seed=0)
    b = d.sample(np.random.default_rng(0), 2, 10)
    assert b["tokens"].shape == (2, 10) and b["labels"].shape == (2, 10)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_structure_is_learnable():
    """bigram successors should cover most transitions (10% noise)."""
    d = SyntheticLMData(vocab_size=64, seed=0, branching=4)
    b = d.sample(np.random.default_rng(0), 64, 64)
    tok, lab = b["tokens"], b["labels"]
    hits = np.mean([lab[i, t] in d.succ[tok[i, t]]
                    for i in range(tok.shape[0]) for t in range(tok.shape[1])])
    assert hits > 0.8


def test_prefetch_iterator_gives_the_seeded_stream():
    d = SyntheticLMData(vocab_size=32, seed=0)
    frames = np.ones((2, 3, 4), np.float32)
    it = make_batch_iterator(d, batch=2, seq=8, seed=5, device="cpu",
                             extras={"enc_frames": frames})
    rng = np.random.default_rng(5)
    try:
        for _ in range(4):
            got = next(it)
            want = d.sample(rng, 2, 8)
            assert got["tokens"].device.type == "cpu"
            assert got["tokens"].dtype == torch.int32
            np.testing.assert_array_equal(got["tokens"].numpy(),
                                          want["tokens"])
            np.testing.assert_array_equal(got["labels"].numpy(),
                                          want["labels"])
            np.testing.assert_array_equal(got["enc_frames"].numpy(), frames)
    finally:
        it.close()


def test_prefetch_iterator():
    d = SyntheticLMData(vocab_size=32, seed=0)
    it = make_batch_iterator(d, batch=2, seq=8, seed=0, device="cpu")
    b1 = next(it)
    b2 = next(it)
    assert b1["tokens"].shape == (2, 8)
    assert not torch.equal(b1["tokens"], b2["tokens"])
    it.close()
