"""The port's synthetic node workload (``repro_torch.core.workload``)
against the JAX package's (numpy, no jax).

Both draw from ``rng_stream(seed, "node-workload")`` in the same order,
so for the same seed, node factor, instance count and noise-metric count
they must scrape identical stores and complete identical tasks, bit for
bit (tolerance 0), with and without the manager's noisy-load injection.
"""
import numpy as np
import pytest

from repro.core.workload import DEFAULT_APPS as REF_APPS
from repro.core.workload import NodeWorkload as RefNode
from repro.monitoring.metrics import SimClock as RefClock
from repro_torch.core.workload import DEFAULT_APPS, NodeWorkload, Task
from repro_torch.monitoring.metrics import SimClock


def _pair(**kw):
    return (RefNode("w", clock=RefClock(), **kw),
            NodeWorkload("w", clock=SimClock(), **kw))


def _assert_same(ref, port):
    assert port.store.names == ref.store.names
    np.testing.assert_array_equal(port.store._data, ref.store._data)
    assert port.store._head == ref.store._head
    assert [(t.app, t.t_submit, t.rtt) for t in port.completed] \
        == [(t.app, t.t_submit, t.rtt) for t in ref.completed]
    for w in (1.0, 5.0, 60.0):
        a, _ = ref.store.query_window(ref.store.names, w, fast=True)
        b, _ = port.store.query_window(port.store.names, w, fast=True)
        np.testing.assert_array_equal(b, a)


def test_apps_match():
    assert [vars(a) for a in DEFAULT_APPS] == [vars(a) for a in REF_APPS]


@pytest.mark.parametrize("seed,factor,inst,noise", [
    (0, 1.0, 1, 24), (3, 0.7, 1, 8), (5, 1.6, 2, 4), (1, 1.2, 1, 0)])
def test_node_scrapes_and_tasks_equal(seed, factor, inst, noise):
    ref, port = _pair(seed=seed, node_factor=factor, instances_per_app=inst,
                      n_noise_metrics=noise)
    seen_ref, seen_port = [], []
    ref.run(150.0, on_complete=seen_ref.append)
    port.run(150.0, on_complete=seen_port.append)
    # the manager's noisy-server injection, then load removed
    ref.extra_load = port.extra_load = 3.0
    ref.run(40.0, on_complete=seen_ref.append)
    port.run(40.0, on_complete=seen_port.append)
    ref.extra_load = port.extra_load = 0.0
    ref.run(30.0)
    port.run(30.0)
    _assert_same(ref, port)
    assert len(port.completed) > 10
    assert [t.rtt for t in seen_port] == [t.rtt for t in seen_ref]
    assert all(isinstance(t, Task) for t in seen_port)
    assert len(port.store.names) == 7 + len(DEFAULT_APPS) + 3 + noise


def test_task_end():
    t = Task("upload", 2.0, 3.5)
    assert t.t_end == 5.5
