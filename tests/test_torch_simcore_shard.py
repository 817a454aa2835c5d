"""The batched core's trial axis split over a process group (gloo on the
CPU), against the single-process run and the reference's serial stepper.

The reference splits the trial axis over a 1-D ``trials`` mesh by
``shard_map`` (``src/repro/core/simcore.py:1850 _execute``); the port
splits it over the ranks of a ``torch.distributed`` group
(``repro_torch.core.simcore._execute``): T padded to a multiple of the
world size by replicating the last trial, each rank's block run, every
per-trial output all-gathered and cut back to T.  Two spawns run at the
same time (``tests/_torch_sim_ranks.py``): world 2 with T = 8 and world
4 with T = 6 (the last rank's block two replicas of trial 5), each rank
pickling its summaries.

Tolerances: every rank's summary against the single-process run of the
same cluster, 1e-12 relative (trials are independent and every step op
is row-wise, so the two agree bit for bit in practice); against the
reference's serial stepper the contract's 1e-5
(``tests/test_torch_simcore.py``).
"""
import pickle

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_sim_ranks as R
from repro_torch.core import simcore
from repro_torch.core.campaign import DEFAULT_POLICIES, run_scenario
from repro_torch.core.scenarios import get_scenario, scenario_names
from repro_torch.core.simulator import _build_cluster
from test_torch_simcore import _assert_summary_close, _serial
from repro.core.scenarios import get_scenario as ref_scenario
from repro.core.simulator import _build_cluster as ref_build
from repro.core.telemetry import TraceConfig as RefTraceConfig

SHARD_RTOL = 1e-12
J = 120
#: world -> T
WORLDS = {2: 8, 4: 6}
#: (label, scenario, policy, config changes): shardable first
CROSSING = dict(arrival_rate=2.0, t_drift=20.0, online_warmup_s=8.0,
                retrain_every_s=6.0)
SHARDED = (("baseline", "baseline", "perf_aware", {}),
           ("baseline-random", "baseline", "random", {}),
           ("stale", "stale-predictions", "perf_aware", {}),
           ("stale-oracle", "stale-predictions", "oracle", {}),
           ("churn", "churn", "perf_aware", {}),
           ("churn-lc", "churn", "least_conn", {}),
           ("retry", "retry-storm", "perf_aware", {}),
           ("retry-rr", "retry-storm", "round_robin", {}),
           ("outage-breakers", "correlated-outage", "perf_aware", {}),
           ("traced", "baseline", "perf_aware", {"trace": 1}))
#: capacity and the closed loop: the whole trial axis on every rank
SINGLE = (("overload", "overload-ramp", "least_conn", {}),
          ("drift-fallback", "drift-fallback", "perf_aware", CROSSING))
CASES = SHARDED + SINGLE
#: the campaign case: (scenario, seeds, trials a seed), 3 x 2 stacked
CAMPAIGN = ("stale-predictions", (0, 1, 2), 2)
#: summary keys that are the run's own, not the result's
RUN_KEYS = ("loop_s", "capture_s", "simcore_backend", "ranks")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run both spawns at once: {world: out_dir}."""
    ctxs, out = [], {}
    for world, T in WORLDS.items():
        d = tmp_path_factory.mktemp(f"shard{world}")
        ctxs.append(mp.start_processes(
            R.sim_cases, nprocs=world, join=False, start_method="spawn",
            args=(world, str(d / "store"), T, J, CASES, CAMPAIGN, str(d))))
        out[world] = d
    for ctx in ctxs:
        while not ctx.join():
            pass
    return out


def _load(d, name, world):
    out = []
    for r in range(world):
        with open(d / f"{name}-r{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


def _assert_same(got, want, path=""):
    """Equal to SHARD_RTOL, recursively (NaN where NaN)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            if k not in RUN_KEYS:
                _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, (str, type(None), bool)):
        assert got == want, path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if w.dtype.kind in "fc":
            np.testing.assert_allclose(g, w, rtol=SHARD_RTOL, atol=0,
                                       equal_nan=True, err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


# ------------------------------------------------------ pad, slice, cut

@pytest.mark.parametrize("T,world", [(6, 4), (8, 4), (8, 2), (2, 4), (1, 3),
                                     (5, 1)])
def test_blocks_pad_by_the_last_trial_and_cut_back(T, world):
    """Every rank's block of a padded (A, T, K) and (T, R) input against
    numpy; the blocks joined in rank order and cut equal the input."""
    Tp = -(-T // world) * world
    rng = np.random.default_rng(T * 10 + world)
    st = simcore._static_for(get_scenario("baseline").compile(
        seed=0, n_trials=T, n_requests=4), "least_conn")
    consts = {"speed": rng.random((3, T, 5)), "node_of": rng.integers(
        0, st.n_nodes, (T, st.n_apps * st.k)), "t": rng.random(4)}
    padded = simcore._take_trials(st, consts, simcore._pad_index(T, Tp))
    want = np.concatenate([consts["speed"], np.repeat(
        consts["speed"][:, -1:], Tp - T, axis=1)], axis=1)
    np.testing.assert_array_equal(padded["speed"], want)
    blocks = []
    for r in range(world):
        idx = simcore._block_index(T, world, r)
        assert len(idx) == Tp // world
        got = simcore._take_trials(st, consts, idx)
        np.testing.assert_array_equal(
            got["speed"], want[:, r * Tp // world:(r + 1) * Tp // world])
        assert got["t"] is consts["t"]
        blocks.append({"busy": torch.as_tensor(got["node_of"]),
                       "ys": {"resp": torch.as_tensor(got["speed"][0].T)},
                       "syncs": r, "trips": None})
    joined = simcore._join_trials(blocks)
    assert joined["syncs"] == 0 and joined["trips"] is None
    cut = simcore._cut_trials(joined, T)
    np.testing.assert_array_equal(cut["busy"].numpy(), consts["node_of"])
    np.testing.assert_array_equal(cut["ys"]["resp"].numpy(),
                                  consts["speed"][0].T)
    np.testing.assert_array_equal(simcore._cut_trials(
        {"busy": joined["busy"].numpy()}, T)["busy"], consts["node_of"])


def test_count_indices_are_rebuilt_for_a_block():
    """The count carry's flat indices encode T: a block's are its own."""
    cfg = get_scenario("churn").compile(seed=0, n_trials=6, n_requests=20)
    st, consts, _ = simcore._lower(_build_cluster(cfg), "perf_aware")
    assert "exp_idx" in consts
    idx = simcore._block_index(6, 4, 3)
    got = simcore._take_trials(st, consts, idx)
    want = simcore._count_index(consts["node_of"][idx], st.n_apps, st.k,
                                st.n_nodes)
    np.testing.assert_array_equal(got["exp_idx"], want[0])
    np.testing.assert_array_equal(got["cnt_base"], want[1])


def test_a_key_missing_from_the_table_raises():
    st = simcore._static_for(get_scenario("baseline").compile(
        seed=0, n_trials=2, n_requests=4), "least_conn")
    with pytest.raises(KeyError, match="unshardable state"):
        simcore._take_trials(st, {"node_of": np.zeros((2, 3)),
                                  "new_state": np.zeros(2)}, np.arange(2))
    with pytest.raises(KeyError, match="unshardable state"):
        simcore._cut_trials({"ys": {"new_output": torch.zeros(3, 2)}}, 1)


@pytest.mark.parametrize("policy", DEFAULT_POLICIES + ("oracle",))
@pytest.mark.parametrize("name", scenario_names())
def test_trial_axis_table_covers_every_key(name, policy):
    """Every key the lowering, the host plan, the carry, the outputs and
    ``finish()`` produce has a table entry, and each per-trial value has
    T along its axis; only unshardable configurations hold a fleet or a
    replica set."""
    T = 3
    cfg = get_scenario(name).compile(seed=0, n_trials=T, n_requests=12)
    st, consts, plan = simcore._lower(_build_cluster(cfg), policy)
    for k, v in consts.items():
        ax = simcore._trial_axis(k)
        if isinstance(ax, int):
            assert v.shape[ax] == T, (k, v.shape)
    for k in plan:
        assert simcore._trial_axis(k) is None, k
    c = {k: torch.as_tensor(v) for k, v in consts.items()}
    s = simcore._new_carry(st, T, cfg.n_requests, torch.device("cpu"))
    block, finish = simcore._step_fn(st, c, plan, s)
    block(0, 2)
    final = finish()
    for tree in (s, s["ys"], final):
        for k, v in tree.items():
            ax = simcore._trial_axis(k)
            if isinstance(ax, int) and v is not None:
                assert v.shape[ax] == T, (k, v.shape)
    assert (final["fleet"] is None and final["elastic"] is None) \
        == simcore._shardable(st)


# ------------------------------------------------------------- on gloo

@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("world", list(WORLDS))
def test_sharded_summary_equals_the_single_process_run(ranks, world, case):
    """Every rank returns the single-process run's summary, to
    SHARD_RTOL; shardable cases report ``"shard"`` over the world, the
    capacity plane and the closed loop ``"single"``."""
    label, name, policy, kw = case
    T = WORLDS[world]
    want = simcore.run_sim_compiled(R.case_config(name, T, J, kw), policy,
                                    device="cpu")
    shard = case in SHARDED
    for got in _load(ranks[world], label, world):
        assert got["simcore_backend"] == ("shard" if shard else "single")
        assert got["ranks"] == (world if shard else 1)
        assert want["simcore_backend"] == "single" and want["ranks"] == 1
        _assert_same(got, want, label)


@pytest.mark.parametrize("case", SHARDED, ids=[c[0] for c in SHARDED])
@pytest.mark.parametrize("world", list(WORLDS))
def test_sharded_summary_matches_the_serial_stepper(ranks, world, case):
    label, name, policy, kw = case
    T = WORLDS[world]
    ref_kw = dict(kw)
    if "trace" in ref_kw:
        ref_kw["trace"] = RefTraceConfig(sample_every=ref_kw["trace"])
    ref = ref_build(ref_scenario(name).compile(seed=0, n_trials=T,
                                               n_requests=J, **ref_kw))
    serial = _serial(ref, policy)
    got = _load(ranks[world], label, world)[-1]
    _assert_summary_close(got, serial, f"{label}/world {world}")
    np.testing.assert_array_equal(got["chosen"], serial["chosen"])


@pytest.mark.parametrize("world", list(WORLDS))
def test_sharded_campaign_equals_the_unsharded_one(ranks, world):
    """``run_scenario`` under a group splits the stacked seeds' trials
    (3 seeds x 2 trials = 6 over the world) to the unsharded cell."""
    name, seeds, trials = CAMPAIGN
    want = run_scenario(name, seeds=seeds, device="cpu", n_trials=trials,
                        n_requests=J)
    for got in _load(ranks[world], "campaign", world):
        assert set(got) == set(want)
        for pol, (per_seed, ineff, backend, n) in got.items():
            assert (backend, n) == ("shard", world)
            assert want[pol].simcore_backend == "single"
            _assert_same(per_seed, want[pol].per_seed, pol)
            _assert_same(ineff, want[pol].inefficiency_pct, pol)


@pytest.mark.parametrize("world", list(WORLDS))
def test_fleet_mode_shards_draw_the_same_noise(ranks, world):
    """By design, as the reference's (ROADMAP Queue 3): every rank seeds
    its generator alike, so each shard draws the same noise for its
    block.  Four trials that are two trials twice over: the second pair
    runs the first pair's inputs under the first pair's noise (at world 2
    one block each; at world 4 every block draws the one trial's), so
    the responses agree bit for bit; on one process the second pair draws
    other noise.  ``fleet_throughput`` under the group reports the shard
    path; its statistics are held by their range only, as on one
    device."""
    got = _load(ranks[world], "fleet-noise", world)
    for out in got:
        resp, backend = out["group"]
        assert backend == "shard"
        single, backend1 = out["single"]
        assert backend1 == "single"
        np.testing.assert_array_equal(resp[:, :2], resp[:, 2:])
        assert not np.array_equal(single[:, :2], single[:, 2:])
        np.testing.assert_array_equal(resp, got[0]["group"][0])
    for stats in _load(ranks[world], "fleet", world):
        assert stats["simcore_backend"] == "shard"
        assert stats["ranks"] == world
        assert np.isfinite(stats["mean_rtt"]) and stats["mean_rtt"] > 0
        assert stats["p99_rtt"] >= stats["mean_rtt"]
