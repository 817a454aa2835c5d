"""The port's configuration and model selection
(``repro_torch.core.selection``, on the CPU) against the JAX package's.

``select_window_metrics`` is host numpy in both: the same correlation
dicts and delay models must give the same (w*, r*, k*) exactly.
``select_model`` fits every Table 2 candidate on the same ``"model-split"``
permutation of the same numpy data: the same pick, and the test RMSE to
rtol 1e-5 (atol 1e-7).  The ``fnn`` and sequential candidates start from
the reference's own initial parameters (the jax PRNG cannot be replayed
in torch).  The inference time is a wall time on each side, so it is
held under the Eq. 6 budget, not to the reference's value; the parity
cases take a budget no predict reaches, and the filter is tested apart.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import selection as ref
from repro.core import zoo as ref_zoo
from repro_torch.core import selection, zoo
from repro_torch.interop import params_from_reference

#: a mean RTT whose Eq. 6 budget (1 s) no candidate's one-sample predict
#: reaches, on a loaded CPU either: the budget's filter is tested apart
MEAN_RTT = 100.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The fits are many small ops: one thread each runs them faster, and
    several test processes share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_constants_match():
    for name in ("WINDOWS_S", "TAU_PREPARE", "TAU_INFERENCE", "K_STEP"):
        assert getattr(selection, name) == getattr(ref, name)


@pytest.mark.parametrize("seed", range(4))
def test_select_window_metrics_matches_reference(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(3, 40))
    corr = {(w, meth): rng.random(m).astype(np.float32)
            for w in ref.WINDOWS_S for meth in ("pearson", "mic", "kendall")}
    corr[(1.0, "pearson")][: m // 2] = 0.0      # ties among the zeros
    per_k = float(rng.uniform(1e-3, 5e-2))

    def state(k, w):
        return per_k * k * (1 + w / 60)

    def feat(k, w):
        return 1e-4 * k
    for mean_rtt in (0.5, 3.0, 50.0):
        want = ref.select_window_metrics(corr, state, feat, mean_rtt)
        got = selection.select_window_metrics(corr, state, feat, mean_rtt)
        if want is None:
            assert got is None
            continue
        assert (got.window_s, got.method, got.total_corr, got.t_state,
                got.t_feature) == (want.window_s, want.method,
                                   want.total_corr, want.t_state,
                                   want.t_feature)
        np.testing.assert_array_equal(got.metric_idx, want.metric_idx)


def _data(n=240, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, d)).astype(np.float32)
    y = (X[:, 0] + 0.5 * np.sin(4 * X[:, 1]) + 0.05
         * rng.standard_normal(n)).astype(np.float32)
    X_seq = rng.uniform(0, 1, (n, 2, 6)).astype(np.float32)
    return X, X_seq, (y - y.min()) / (y.max() - y.min())


@pytest.mark.parametrize("cands", [["lr", "xgb"], ["rf", "xgb", "svm"],
                                   ["xgb"], ["xgb", "fnn"],
                                   ["xgb", "fnn", "rnn", "cnn"]])
def test_select_model_matches_reference(cands):
    X, X_seq, y = _data()
    ref_kw = {f: {"epochs": 20} for f in ("fnn", "rnn", "cnn")}
    port_kw = {f: {"epochs": 20, "init": params_from_reference(
        _init(f, X_seq.shape[1] if f != "fnn" else X.shape[1]), "cpu")}
        for f in ("fnn", "rnn", "cnn")}
    want = ref.select_model(cands, X, X_seq, y, mean_rtt=MEAN_RTT,
                            model_kwargs=ref_kw)
    got = selection.select_model(cands, X, X_seq, y, mean_rtt=MEAN_RTT,
                                 model_kwargs=port_kw, device="cpu")
    assert got.name == want.name
    assert got.model.name == got.name
    assert got.rmse == pytest.approx(want.rmse, rel=1e-5, abs=1e-7)
    assert 0 < got.t_inference <= selection.TAU_INFERENCE * MEAN_RTT
    # each candidate's own test RMSE, fitted alone
    for fam in cands:
        a = ref.select_model([fam], X, X_seq, y, MEAN_RTT,
                             model_kwargs=ref_kw)
        b = selection.select_model([fam], X, X_seq, y, MEAN_RTT,
                                   model_kwargs=port_kw, device="cpu")
        assert b.rmse == pytest.approx(a.rmse, rel=1e-5, abs=1e-7), fam


def _init(fam, d_in):
    model = ref_zoo.ALL_MODELS[fam]()
    key = jax.random.PRNGKey(model.seed)
    if fam == "fnn":
        return ref_zoo._mlp_init(key, (d_in, *model.hidden, 1))
    return model._init(key, d_in)


def test_sequential_candidates_need_windows():
    X, _, y = _data()
    got = selection.select_model(["rnn", "lr"], X, None, y, 10.0,
                                 device="cpu")
    want = ref.select_model(["rnn", "lr"], X, None, y, 10.0)
    assert got.name == want.name == "lr"


def test_inference_budget_filters_every_candidate():
    X, X_seq, y = _data(n=60)
    assert selection.select_model(["lr", "xgb"], X, X_seq, y, 10.0,
                                  tau_inference=1e-12, device="cpu") is None


def test_choice_exposes_the_models_params():
    X, X_seq, y = _data(n=60)
    got = selection.select_model(["lr"], X, X_seq, y, 10.0, device="cpu")
    assert got.params is got.model.w


def test_degenerate_fit_is_skipped_and_counted(monkeypatch):
    X, X_seq, y = _data(n=60)

    def singular(self, X, y):
        raise np.linalg.LinAlgError("Singular matrix")
    monkeypatch.setattr(zoo.LinearRegression, "fit", singular)
    before = selection.select_model.skipped
    got = selection.select_model(["lr", "xgb"], X, X_seq, y, 10.0,
                                 device="cpu")
    assert got.name == "xgb"
    assert selection.select_model.skipped == before + 1


def test_kernel_errors_are_not_skipped(monkeypatch):
    """A failed launch is a RuntimeError from the kernel's wrapper: it
    must reach the caller, not drop the candidate."""
    X, X_seq, y = _data(n=60)

    def failed(*args, **kw):
        raise RuntimeError("segment_sum kernel launch failed: CUDA error 700")
    monkeypatch.setattr(zoo, "segment_sum", failed)
    before = selection.select_model.skipped
    with pytest.raises(RuntimeError, match="launch failed"):
        selection.select_model(["lr", "xgb"], X, X_seq, y, 10.0,
                               device="cpu")
    assert selection.select_model.skipped == before
