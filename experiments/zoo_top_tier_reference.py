"""The reference zoo (``repro.core.zoo``, JAX) at Table 2's top tier, on the
data of ``chip_smoke.py``'s phase 10, part 2: each of the nine families fit
at n = 10,000 samples of d = 120 features (or k = 10 metrics of w = 25
points) with its default hyperparameters, scored on the next 2,000 against
the mean's RMSE.  The families with random initial parameters are fit once
for each seed in ``--seeds``, so their spread over initial draws shows.

The readings set the bars that phase 10 holds the port's fits to on the
card (``chip_smoke.py``: ``ZOO_REF_RMSE``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python experiments/zoo_top_tier_reference.py
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro.core import zoo

N, D, K, W = 10_000, 120, 10, 25
SEEDED = ("fnn", "rnn", "gru", "lstm", "cnn")


def zoo_data(n: int, d: int, k: int, w: int, seed: int = 0):
    """The draw of ``repro_torch.testing.zoo_data``, copied: (n, d) features
    in [0, 1) with a normalized target of three of them, and (n, k, w)
    windows whose target is a mean and a last value; float32."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, d)).astype(np.float32)
    y = (2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.5 * X[:, 2] ** 2
         + 0.05 * rng.standard_normal(n))
    X_seq = rng.uniform(0, 1, (n, k, w)).astype(np.float32)
    y_seq = X_seq[:, 0].mean(-1) + 0.3 * X_seq[:, 1, -1]

    def norm(v):
        return ((v - v.min()) / (v.max() - v.min())).astype(np.float32)
    return X, norm(y), X_seq, norm(y_seq)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5,
                    help="initial draws of each randomly initialised family")
    args = ap.parse_args()
    X, y, Xs, ys = zoo_data(N + N // 5, D, K, W, seed=0)
    families = {**zoo.NONSEQ_MODELS, **zoo.SEQ_MODELS}
    out = {}
    for fam, cls in families.items():
        Xa, ya = (Xs, ys) if cls.sequential else (X, y)
        base = float(np.sqrt(np.mean((ya[N:].mean() - ya[N:]) ** 2)))
        rmses = []
        for seed in range(args.seeds if fam in SEEDED else 1):
            t0 = time.perf_counter()
            model = cls(seed=seed) if fam in SEEDED else cls()
            model.fit(Xa[:N], ya[:N])
            pred = np.asarray(model.predict(Xa[N:]))
            rmses.append(float(np.sqrt(np.mean((pred - ya[N:]) ** 2))))
            print(f"{fam} seed {seed}: RMSE {rmses[-1]:.6f} against the "
                  f"mean's {base:.6f}, fit {time.perf_counter() - t0:.2f} s",
                  flush=True)
        out[fam] = {"rmse": rmses, "mean_rmse": base}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
