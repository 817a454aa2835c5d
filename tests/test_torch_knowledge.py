"""The port's knowledge base (``repro_torch.core.knowledge``) against the
JAX package's (numpy, no jax): the same puts give the same latest,
latest-with-age and history, and the JSON files of the two load into
each other."""
import numpy as np
import pytest

from repro.core.knowledge import KnowledgeBase as RefKB
from repro_torch.core.knowledge import KnowledgeBase


def _fill(kb, rng, n=40):
    for _ in range(n):
        kb.put(f"app{rng.integers(0, 3)}", f"node-{rng.integers(0, 4)}",
               float(rng.uniform(0.0, 100.0)), float(rng.uniform(0.1, 9.0)))


def _same(a, b):
    for app in ("app0", "app1", "app2", "absent"):
        for node in ("node-0", "node-1", "node-2", "node-3", "gone"):
            assert a.latest(app, node) == b.latest(app, node)
            assert a.latest_with_age(app, node, 120.0) \
                == b.latest_with_age(app, node, 120.0)
            assert a.history(app, node) == b.history(app, node)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_puts_match_reference(seed):
    ref, port = RefKB(), KnowledgeBase()
    _fill(ref, np.random.default_rng(seed))
    _fill(port, np.random.default_rng(seed))
    _same(port, ref)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_json_round_trip_across_packages(tmp_path, writer):
    """A file saved by either package loads into both, equal."""
    path = str(tmp_path / "kb.json")
    src = RefKB(path) if writer == "reference" else KnowledgeBase(path)
    _fill(src, np.random.default_rng(7))
    src.save()
    ref, port = RefKB(path), KnowledgeBase(path)
    assert ref.load() and port.load()
    _same(port, ref)
    _same(port, src)


def test_save_load_roundtrip(tmp_path):
    path = str(tmp_path / "kb.json")
    kb = KnowledgeBase(path=path)
    kb.put("upload", "worker-1", 10.0, 8.25)
    kb.put("upload", "worker-1", 20.0, 7.5)
    kb.put("gctf", "worker-2", 15.0, 3.125)
    kb.save()
    kb2 = KnowledgeBase(path=path)
    assert kb2.load()
    assert kb2.latest("upload", "worker-1") == 7.5
    assert kb2.latest("gctf", "worker-2") == 3.125
    assert kb2.history("upload", "worker-1") == [(10.0, 8.25), (20.0, 7.5)]
    v, age = kb2.latest_with_age("upload", "worker-1", now=25.0)
    assert v == 7.5 and age == 5.0
    kb2.put("gctf", "worker-2", 30.0, 3.5)
    kb2.save()
    kb3 = KnowledgeBase(path=path)
    assert kb3.load()
    assert kb3.history("gctf", "worker-2") == [(15.0, 3.125), (30.0, 3.5)]


def test_load_missing_file_or_no_path_is_noop(tmp_path):
    kb = KnowledgeBase()
    kb.put("a", "n", 0.0, 1.0)
    assert not kb.load()
    assert kb.latest("a", "n") == 1.0
    assert not KnowledgeBase(path=str(tmp_path / "absent.json")).load()
