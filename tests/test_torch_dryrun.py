"""The port's dry-run (``repro_torch.launch``: ``specs.build_cell`` /
``lower_cell``, ``counts``, ``dryrun_lib``) against the reference's, and
the kernels' work formulas (``kernels/*.py::work``).

Every process group lives in a child process, started once for the
module and all at once: the reference's cells on 16 host devices
(``tests/_torch_reference_dryrun.py``), four gloo ranks and a fake
group's rank 0 (``tests/_torch_dist_dryrun.py``) and two runs of
``dryrun_lib.main``.  The port's cells are resolved here on an ``AbstractMesh`` with
``meta`` arguments (shapes only, no process group).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch.counts import Counts, cost_dict, kernel_counts
from repro_torch.launch.dryrun_lib import LONG_SKIP
from repro_torch.launch.specs import build_cell
from repro_torch.configs.base import get_config
from repro_torch.parallel.sharding import AbstractMesh
from repro_torch.tree import keystr, leaves_with_path

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

#: the reference test's mesh and reduced deepseek-67b
#: (tests/test_distributed.py::test_reduced_dryrun_multipod_lowering)
MESH = ((2, 2, 4), ("pod", "data", "model"))
DS_REDUCED = {"num_layers": 2, "d_model": 256, "num_heads": 8,
              "num_kv_heads": 4, "head_dim": 32, "d_ff": 512,
              "vocab_size": 1024}
#: (arch, shape, smoke config, overrides): the reduced deepseek-67b
#: train cell and the smoke configs of one arch of the moe, ssm and
#: encdec families in each kind of cell
CELLS = [("deepseek-67b", "train_4k", False, DS_REDUCED)] + [
    (arch, shape, True, None)
    for arch in ("qwen3-moe-30b-a3b", "mamba2-1.3b", "seamless-m4t-medium")
    for shape in ("train_4k", "prefill_32k", "decode_32k")]
CELL_IDS = [f"{a}-{s}" for a, s, _, _ in CELLS]
#: the dense train cell of the collective and flops counts (the helper's
#: TRAIN_TINY: deepseek-67b's smoke config on (data 2, model 2))
TINY = ["train_tiny", "train", 64, 16]


def _ref_request(arch, shape, smoke, overrides, mesh=MESH, compile=True):
    return {"arch": arch, "shape": shape, "smoke": smoke,
            "overrides": overrides, "mesh": list(mesh[0]),
            "axes": list(mesh[1]), "compile": compile}


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.update(extra)
    return env


class Children:
    """The module's child processes, started together; :meth:`result`
    waits for one and reads what it wrote."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.procs = {}
        helper = os.path.join(ROOT, "tests", "_torch_dist_dryrun.py")
        reqs = (["cell_list"] + [_ref_request(*c) for c in CELLS]
                + [_ref_request("deepseek-67b", TINY, True,
                                {"num_layers": n, "scan_layers": False},
                                mesh=((2, 2), ("data", "model")))
                   for n in (1, 2)])
        self._start("reference", [os.path.join(ROOT, "tests",
                                                "_torch_reference_dryrun.py")],
                    _env(XLA_FLAGS="--xla_force_host_platform_device_count=16",
                         JAX_PLATFORMS="cpu"), json.dumps(reqs))
        store = str(tmp / "store")
        for r in range(4):
            self._start(f"gloo{r}", [helper, "gloo", str(r), store,
                                     str(tmp / f"gloo{r}.json")], _env())
        self._start("fake", [helper, "fake", str(tmp / "fake.json")], _env())
        self._start("main", [helper, "main", str(tmp / "main.json")], _env())
        self.done = {}

    def _start(self, name, args, env, stdin=None):
        p = subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env,
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
        self.procs[name] = (p, stdin)

    def result(self, name):
        if name not in self.done:
            p, stdin = self.procs[name]
            out, err = p.communicate(stdin, timeout=300)
            assert p.returncode == 0, err[-4000:]
            if name == "reference":
                self.done[name] = json.loads(out)
            else:
                with open(self.tmp / f"{name}.json") as f:
                    self.done[name] = json.load(f)
        return self.done[name]

    def close(self):
        for p, _ in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    ch = Children(tmp_path_factory.mktemp("dryrun"))
    yield ch
    ch.close()


def _reference(children, i: int) -> dict:
    return children.result("reference")[1 + i]


def _port_cell(i: int):
    arch, shape, smoke, overrides = CELLS[i]
    mesh = AbstractMesh(*MESH)
    return build_cell(arch, shape, mesh, overrides=overrides,
                      cfg=get_config(arch, smoke=smoke), device="meta")


def _spec(sharding) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in sharding.spec]


def _leaves(trees) -> dict:
    """{"<arg index><key path>": leaf} over a cell's argument trees."""
    return {f"{i}{keystr(p)}": x for i, t in enumerate(trees)
            for p, x in leaves_with_path(t)}


# ----------------------------------------------------------------------
# the kernels' work formulas
def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["flash_fwd", "flash_bwd", "gmm_fwd",
                                  "gmm_bwd", "ssd_bwd"])
def test_kernel_work_matches_the_perf_table(case):
    """Each kernel module's ``work`` gives the figures PERF.md's kernel
    tables print at their shapes: flash forward 57.6 GFLOP at the serving
    path's (8, 1002, 28/4, 128) causal, its backward 86.0 GFLOP at (4,
    1024, 32/4, 128); ``gmm`` 251 GFLOP and 852.5 MB (its 0.2545 ms
    bound) at (128, 624, 2048) x (128, 2048, 768), its backward 257.7
    GFLOP at (128, 320, 2048) x (128, 2048, 768); SSD's backward 174.1 MB and 26.21 GFLOP at (4,
    1024, 64, 64), N 128, chunk 256, bf16, without a final-state
    cotangent."""
    from repro_torch.kernels import flash_attention, gmm, ssd
    if case.startswith("flash"):
        B, S, H, KV = (8, 1002, 28, 4) if case == "flash_fwd" \
            else (4, 1024, 32, 4)
        q, kv = _meta(B, S, H, 128), _meta(B, S, KV, 128)
        nbytes, ops = flash_attention.work(q, kv, kv, True,
                                           backward=case == "flash_bwd")
        assert round(ops / 1e9, 1) == (57.6 if case == "flash_fwd" else 86.0)
    elif case == "gmm_fwd":
        nbytes, ops = gmm.work(_meta(128, 624, 2048), _meta(128, 2048, 768))
        assert (round(ops / 1e9), round(nbytes / 1e6, 1)) == (251, 852.5)
    elif case == "gmm_bwd":
        nbytes, ops = gmm.work(_meta(128, 320, 2048), _meta(128, 2048, 768),
                               backward=True)
        assert round(ops / 1e9, 1) == 257.7
    else:
        nbytes, ops = ssd.work(_meta(4, 1024, 64, 64), _meta(4, 1024, 1, 128),
                               256, backward=True)
        assert (round(nbytes / 1e6, 1), round(ops / 1e9, 2)) == (174.1,
                                                                  26.21)


def _kernel_call(name):
    """(call, expected work) of one small CPU call of kernel ``name``."""
    from repro_torch.kernels import (decode_attention, flash_attention, gmm,
                                     segment_sum, ssd)
    g = torch.Generator().manual_seed(0)

    def rn(*shape, grad=False):
        return torch.randn(shape, generator=g).requires_grad_(grad)

    if name == "segment_sum":
        v, ids = rn(6, 40), torch.randint(-1, 9, (6, 40), generator=g,
                                          dtype=torch.int32)
        return (lambda: segment_sum.segment_sum(v, ids, 8),
                segment_sum.work(v, ids, 8))
    if name.startswith("flash"):
        q, k, v = rn(2, 16, 4, 8), rn(2, 16, 2, 8), rn(2, 16, 2, 8)
        if name == "flash_attention":
            return (lambda: flash_attention.flash_attention(q, k, v),
                    flash_attention.work(q, k, v, True))
        o, lse = flash_attention.flash_attention_plain(q, k, v, True,
                                                       return_lse=True)
        do = rn(2, 16, 4, 8)
        return (lambda: flash_attention.flash_attention_bwd(q, k, v, o, do,
                                                            lse),
                flash_attention.work(q, k, v, True, backward=True))
    if name == "decode_attention":
        q, k, v = rn(3, 1, 4, 8), rn(3, 20, 2, 8), rn(3, 20, 2, 8)
        lens = torch.tensor([5, 20, 30], dtype=torch.int32)
        return (lambda: decode_attention.decode_attention(q, k, v, lens),
                decode_attention.work(q, k, v, 5 + 20 + 20))
    if name.startswith("gmm"):
        x, w = rn(3, 10, 16), rn(3, 16, 32)
        if name == "gmm":
            return lambda: gmm.gmm(x, w), gmm.work(x, w)
        dy = rn(3, 10, 32)
        return (lambda: gmm.gmm_bwd(x, w, dy), gmm.work(x, w, backward=True))
    x, dt, A = rn(2, 32, 4, 8), rn(2, 32, 4).abs() * 0.1, -rn(4).abs()
    Bm, Cm = rn(2, 32, 1, 4), rn(2, 32, 1, 4)
    if name == "ssd":
        return (lambda: ssd.ssd(x, dt, A, Bm, Cm, chunk=16),
                ssd.work(x, Bm, 16))
    _, _, states = ssd.ssd_plain(x, dt, A, Bm, Cm, 16, return_states=True)
    dy = rn(2, 32, 4, 8)
    return (lambda: ssd.ssd_bwd(x, dt, A, Bm, Cm, states, dy, None, 16),
            ssd.work(x, Bm, 16, backward=True))


@pytest.mark.parametrize("name", ["segment_sum", "flash_attention",
                                  "flash_attention_bwd", "decode_attention",
                                  "gmm", "gmm_bwd", "ssd", "ssd_bwd"])
def test_wrapper_records_its_work_in_place_of_the_plain_ops(name):
    """On a CPU tensor each wrapper records one call of its kernel's work
    (its module's ``work``) in the open count and keeps its plain
    version's ops out of it: the count's flops and bytes are the kernel's
    alone."""
    call, (nbytes, ops) = _kernel_call(name)
    with Counts() as c:
        call()
    assert kernel_counts(c) == {name: {"calls": 1, "bytes": nbytes,
                                       "ops": ops}}
    assert cost_dict(c) == {"flops": float(ops),
                            "bytes accessed": float(nbytes)}


# ----------------------------------------------------------------------
# build_cell against the reference's
@pytest.mark.parametrize("i", range(len(CELLS)), ids=CELL_IDS)
def test_cell_resolves_as_the_reference(children, i):
    """The resolved config field by field, the kind, the donation and a
    train cell's TrainConfig (microbatches, master_fp32, moment dtype)."""
    ref, cell = _reference(children, i), _port_cell(i)
    cfg = json.loads(json.dumps(dataclasses.asdict(cell.cfg)))
    assert cfg.keys() == ref["cfg"].keys()
    for k in cfg:
        assert cfg[k] == ref["cfg"][k], k
    assert (cell.kind, list(cell.donate)) == (ref["kind"], ref["donate"])
    if cell.kind == "train":
        t = cell.tcfg
        assert {"microbatches": t.microbatches,
                "master_fp32": t.master_fp32,
                "moment_dtype": t.moment_dtype} == ref["tcfg"]


@pytest.mark.parametrize("i", range(len(CELLS)), ids=CELL_IDS)
def test_in_shardings_equal_the_reference(children, i):
    """Every argument leaf's layout, leaf by leaf: the reference's
    PartitionSpec against the port's Sharding spec, and the reference's
    shard shape against the port's argument (the train batch, which the
    port takes whole, cut by its layout).  The decode cache's ``len``
    splits like the batch's rows where the reference's is replicated
    (ROADMAP Queue 3 item 23)."""
    ref, cell = _reference(children, i), _port_cell(i)
    sh = _leaves(cell.in_shardings)
    args = _leaves(cell.args)
    assert sh.keys() == ref["args"].keys()
    for k, s in sh.items():
        shape = tuple(args[k].shape)
        if _departure(cell.kind, k) == "item 23: the cache's len":
            assert _spec(s) == [list(MESH[1][:2])], k
            assert ref["args"][k]["spec"] == [None], k
            assert shape[0] * 4 == ref["args"][k]["shape"][0], k
            continue
        assert _spec(s) == ref["args"][k]["spec"], k
        if cell.kind == "train" and k.startswith("1"):
            shape = s.shard_shape(shape)
        assert list(shape) == ref["args"][k]["shape"], k


#: the argument leaves a rank holds other than the reference's, by design
#: (ROADMAP Queue 3): the train step takes the global batch on every rank
#: and narrows its rows (item 36), and the serving cache's ``len`` splits
#: like its rows where the reference's is replicated (item 23).  The
#: serving params' layout (item 25) departs only past 64 B parameters,
#: which no reduced cell reaches.
def _departure(kind: str, key: str):
    if kind == "train" and key.startswith("1["):
        return "item 36: the global batch"
    if kind == "decode" and key == "1['len']":
        return "item 23: the cache's len"
    return None


@pytest.mark.parametrize("i", range(len(CELLS)), ids=CELL_IDS)
def test_argument_bytes_equal_the_reference(children, i):
    """Rank 0's argument bytes equal the compiled reference step's
    ``memory_analysis().argument_size_in_bytes`` to the byte, leaf by
    leaf, but for the leaves :func:`_departure` lists, each of which holds
    what its design says (the global batch: dp times the rank's rows;
    ``len``: the rank's rows of a replicated vector), and the leaves the
    reference's ``jax.jit`` drops because its step does not read them
    (seamless-m4t-medium's decode: the encoder's weights and the
    cross-attention's k / v projections, whose rows the cache holds),
    which the port's cell holds as its arguments all the same."""
    ref, cell = _reference(children, i), _port_cell(i)
    dp = 4
    args = _leaves(cell.args)
    nbytes = {k: x.numel() * x.element_size() for k, x in args.items()}
    assert sum(r["bytes"] for r in ref["args"].values() if r["kept"]) == \
        ref["argument_size_in_bytes"]
    moved = sum(r["bytes"] for r in ref["args"].values() if not r["kept"])
    dropped = {k for k, r in ref["args"].items() if not r["kept"]}
    if cell.cfg.family != "encdec" or cell.kind != "decode":
        assert not dropped
    else:
        assert all("enc" in k or "['cross']['wk']" in k
                   or "['cross']['wv']" in k for k in dropped), dropped
    for k, b in nbytes.items():
        want = ref["args"][k]["bytes"]
        why = _departure(cell.kind, k)
        if why is None:
            assert b == want, k
        elif why.startswith("item 36"):
            assert b == dp * want, (k, why)
        else:
            assert b * dp == want, (k, why)
        moved += b - want
    assert sum(nbytes.values()) == ref["argument_size_in_bytes"] + moved


# ----------------------------------------------------------------------
# collectives and flops: gloo ranks, the fake group, the hand counts
@pytest.mark.parametrize("case", ["train", "decode"])
def test_gloo_ranks_count_what_the_fake_rank_counts(children, case):
    """On a (data 2, model 2) gloo group each of the four ranks calls the
    collectives rank 0 of a fake four-rank group calls, op by op, in
    counts and bytes; flops and kernel calls agree too."""
    fake = children.result("fake")[case]
    assert fake["collectives"]["_total"] > 0
    for r in range(4):
        got = children.result(f"gloo{r}")[case]
        assert got["collectives"] == fake["collectives"], r
        assert got["kernels"] == fake["kernels"], r
        assert got["cost"]["flops"] == fake["cost"]["flops"], r


def _marginal(children, key: str) -> dict:
    f = children.result("fake")
    a, b = f["train_L1"][key], f["train_L2"][key]
    return a, b


def test_collective_marginal_of_a_dense_train_layer(children):
    """One more layer of deepseek-67b's smoke config (D 64, 4 heads of 16
    over 2 kv heads, d_ff 128, bf16) on (data 2, model 2), n = 4
    microbatches of b = 16 / (4 x 2) = 2 rows of S = 64 tokens, adds, in
    result bytes:

    - per microbatch, the layer's sequence-parallel collectives
      (``gather_seq`` / ``scatter_seq``): all-gathers of (b, S, D) bf16
      = 16384 B, two in the forward, two in the recompute and two in the
      backward (the scatters' backward): 6; reduce-scatters of (b, S / 2,
      D) = 8192 B, two in the forward, one in the recompute (torch's
      non-reentrant checkpoint stops after the last tensor the backward
      needs: the MLP's output projection and its reduce-scatter are not
      run again) and two in the backward (the gathers'): 5;
    - per microbatch, each weight's f32 gradient reduce-scattered over
      data into the optimizer's layout: wq and wo (D / 2, 2 local heads,
      16) = 4096 B each, wk and wv (D / 2, 2 kv heads, 16) = 4096 B each,
      wi, wg and wo of the MLP (D / 2, 64) = 8192 B each: 40960 B; wk and
      wv (replicated over model) all-reduced over model, 4096 B each, and
      the two norm scales (64 f32) over data and model, 256 B each: 8704
      B;
    - per step, each weight gathered over data from the new master in
      bf16: wq, wk, wv, wo 4096 B each, the MLP's 8192 B each: 40960 B.

    The stacked leaves keep their collectives' number: all-gathers +24,
    reduce-scatters +20, all-reduces +0; all-gather bytes 4 x 6 x 16384 +
    40960 = 434176, reduce-scatter 4 x (5 x 8192 + 40960) = 327680,
    all-reduce 4 x 8704 = 34816."""
    a, b = _marginal(children, "collectives")
    d = {op: b.get(op, 0) - a.get(op, 0)
         for op in ("all-gather", "reduce-scatter", "all-reduce")}
    n = {op: b["_counts"].get(op, 0) - a["_counts"].get(op, 0) for op in d}
    assert n == {"all-gather": 24, "reduce-scatter": 20, "all-reduce": 0}
    assert d == {"all-gather": 4 * 6 * 16384 + 40960,
                 "reduce-scatter": 4 * (5 * 8192 + 40960),
                 "all-reduce": 4 * 8704}


def test_flops_marginal_of_a_dense_train_layer(children, capsys):
    """One more layer of the same cell adds its products and attention,
    the recompute included.  Per microbatch a rank takes t = b S = 128
    tokens on its 2 of 4 heads and 1 of 2 kv heads, d_ff 128 / 2 = 64:
    the forward's products 2 t D (2 x 16 + 16 + 16 + 2 x 16) for q, k, v
    and o plus 3 x 2 t D 64 for the MLP, 4718592; the recompute the same
    but the MLP's output projection (2 t 64 D = 1048576; see the
    collectives' test); the backward twice the forward.  Flash attention
    over b x 2 heads x S (S + 1) / 2 causal pairs (the kernel's own
    count): 2 pairs 2 dh in the forward and again in the recompute, 2
    pairs 5 dh in the backward.  The reference's XLA marginal at the same
    cell counts elementwise ops and its own fusions: printed, not
    asserted."""
    a, b = _marginal(children, "cost")
    t, D, dh, F = 2 * 64, 64, 16, 64
    fwd = 2 * t * D * (2 * dh + dh + dh + 2 * dh) + 3 * 2 * t * D * F
    products = fwd + (fwd - 2 * t * F * D) + 2 * fwd
    pairs = 2 * 2 * 64 * 65 // 2
    attention = 2 * (2 * pairs * 2 * dh) + 2 * pairs * 5 * dh
    want = 4 * (products + attention)
    assert b["flops"] - a["flops"] == want
    ref = children.result("reference")
    xla = ref[-1]["flops"] - ref[-2]["flops"]
    with capsys.disabled():
        print(f"\ndense train layer flops marginal: port {want}, the "
              f"reference's XLA cost analysis {xla:.0f}")


# ----------------------------------------------------------------------
# dryrun_lib
def test_cell_list_equals_the_reference(children):
    from repro_torch.configs.base import available_archs
    from repro_torch.launch.dryrun_lib import cell_list
    ref = children.result("reference")[0]
    assert [list(c) for c in cell_list(available_archs(), None)] == ref


def test_dryrun_main_writes_resumes_and_records_errors(children):
    """``dryrun_lib.main`` over smoke configs on the CPU writes the
    artifact with the reference's record keys, ``run_s`` for
    ``compile_s`` and ``device`` / ``rank``; a cell that raises is
    recorded with its error and trace and the run goes on (return code
    1); a second run runs only the cell that is not ``ok``."""
    got = children.result("main")
    art = got["artifact"]
    assert got["rc"] == [1, 1]
    assert got["again"] == [["mamba2-1.3b", "decode_32k"]]
    ok = art["deepseek-67b|decode_32k|single"]
    assert ok["status"] == "ok"
    for k in ("arch", "shape", "mesh", "chips", "n_blocks", "params",
              "params_active", "memory", "cost_full", "collectives_full",
              "cost_L1", "cost_L2", "collectives_L1", "collectives_L2",
              "run_s", "device", "rank"):
        assert k in ok, k
    assert (ok["mesh"], ok["chips"], ok["device"], ok["rank"]) == \
        ("16x16", 256, "cpu", 0)
    assert sorted(ok["memory"]) == sorted(
        ["argument_size_in_bytes", "output_size_in_bytes",
         "temp_size_in_bytes", "generated_code_size_in_bytes",
         "alias_size_in_bytes"])
    assert ok["memory"]["temp_size_in_bytes"] is None
    assert ok["collectives_full"]["_total"] > 0
    assert ok["kernels_full"]["decode_attention"]["calls"] == 2
    err = art["mamba2-1.3b|decode_32k|single"]
    assert err["status"] == "error"
    assert "do not split over 16 model ranks" in err["error"]
    assert "Traceback" in err["trace"]


def test_long_500k_skip_reason_is_the_reference_text(children):
    art = children.result("main")["artifact"]
    rec = art["deepseek-67b|long_500k|skip"]
    assert rec == {"arch": "deepseek-67b", "shape": "long_500k",
                   "status": "skipped", "reason": LONG_SKIP}
    assert LONG_SKIP == ("full-attention arch: long_500k requires "
                         "sub-quadratic attention (see DESIGN.md)")
