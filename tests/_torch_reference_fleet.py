"""Runs the JAX package's ``fleet_throughput`` in a process of its own.

The compiled reference imports ``jax.experimental.enable_x64``, which jax
0.9.0 no longer has; this helper aliases it to ``jax.enable_x64`` before
the import.  It runs in a child process so that the alias, and the
reference's compiled core it lets in, change nothing in the test
process that spawned it (``tests/test_torch_fleet.py``)::

    python tests/_torch_reference_fleet.py CASES.json OUT.npz

``CASES.json`` is a list of ``fleet_throughput`` keyword dicts; a case
may also name ``noise_key``, an integer whose ``jax.random.PRNGKey``
replaces the run's noise key (the cluster stays the one ``seed`` draws).
For case ``i`` the output holds ``i/stats`` (the returned stats as JSON)
and ``i/<name>``, every array the reference hands its compiled loop (its
consts and the request stream ``xs``), captured at ``_execute``.
"""
import json
import sys

import jax
import jax.experimental
import numpy as np

jax.experimental.enable_x64 = jax.enable_x64


def main(cases_path: str, out_path: str) -> None:
    from repro.core import simcore
    cases = json.load(open(cases_path))
    seen = {}
    noise = [None]
    execute = simcore._execute

    def recording(st, consts, xs, carry0, *a, **kw):
        seen.update({k: np.asarray(v) for k, v in consts.items()
                     if k != "key"})
        seen.update({f"xs_{k}": np.asarray(v) for k, v in xs.items()})
        if noise[0] is not None:
            consts = dict(consts, key=jax.random.PRNGKey(noise[0]))
        return execute(st, consts, xs, carry0, *a, **kw)

    simcore._execute = recording
    out = {}
    for i, kw in enumerate(cases):
        seen.clear()
        kw = dict(kw)
        noise[0] = kw.pop("noise_key", None)
        _, stats = simcore.fleet_throughput(**kw)
        out[f"{i}/stats"] = np.array(json.dumps(stats))
        out.update({f"{i}/{k}": v for k, v in seen.items()})
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:3])
