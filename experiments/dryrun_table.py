"""Print the dry-run's artifact as a markdown table, one row a cell.

    python3 experiments/dryrun_table.py [ARTIFACT]

ARTIFACT defaults to ``experiments/artifacts/dryrun_torch.json``
(``python -m repro_torch.launch.dryrun``).  Columns: status; a rank's
argument and temp GB (``memory``); TFLOP and GB accessed a step
(``cost_full``); the collectives' result GB by op type at full depth
(AG all-gather, RS reduce-scatter, AR all-reduce); the L2 - L1 marginal
of one block in TFLOP and collective GB.  A cell that failed gives its
error's first words.
"""
import json
import sys

OPS = (("all-gather", "AG"), ("reduce-scatter", "RS"), ("all-reduce", "AR"),
       ("all-to-all", "A2A"), ("collective-permute", "CP"))


def _coll(c: dict) -> str:
    return " / ".join(f"{k} {c[op] / 1e9:.4g}" for op, k in OPS if c.get(op))


def row(key: str, r: dict) -> str:
    arch, shape, mesh = key.split("|")
    cell = f"{arch} {shape}"
    if r["status"] == "error":
        return f"| {cell} | error: {r['error'][:60]} |  |  |  |  |  |  |"
    m, c = r["memory"], r["cost_full"]
    marg, coll = "", ""
    if "cost_L2" in r:
        flops = (r["cost_L2"]["flops"] - r["cost_L1"]["flops"]) / 1e12
        d = {op: r["collectives_L2"].get(op, 0)
             - r["collectives_L1"].get(op, 0) for op, _ in OPS}
        marg = f"{flops:.4g} TF; {_coll(d)}"
    return (f"| {cell} | ok | {m['argument_size_in_bytes'] / 1e9:.3f} | "
            f"{m['temp_size_in_bytes'] / 1e9:.3f} | {c['flops'] / 1e12:.4g} | "
            f"{c['bytes accessed'] / 1e9:.4g} | "
            f"{_coll(r['collectives_full'])} | {marg} |")


def main(path: str) -> None:
    with open(path) as f:
        art = json.load(f)
    print("| cell | status | arg GB | temp GB | TFLOP | GB accessed | "
          "collective GB (full depth) | L2 - L1 |")
    print("|---|---|---|---|---|---|---|---|")
    for key, r in art.items():
        if r["status"] != "skipped":
            print(row(key, r))
    skipped = sorted(k.split("|")[0] for k, r in art.items()
                     if r["status"] == "skipped")
    if skipped:
        print(f"\nSkipped (long_500k, full attention): {', '.join(skipped)}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1
         else "experiments/artifacts/dryrun_torch.json")
