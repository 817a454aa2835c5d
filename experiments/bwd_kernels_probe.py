#!/usr/bin/env python3
"""The flash attention, SSD and ``gmm`` backward kernels on the card,
alone.

A quicker check than ``chip_smoke.py`` for work on these kernels: build
``flash_attention_bwd``, ``ssd_bwd`` and ``gmm_bwd`` (and the flash and
SSD forwards that give their inputs), hold each bf16 call against its
plain version at a set of shapes (the largest difference over the plain
version's largest value, each output; whether the tensor-core kernel
took the call), then time at the training shapes (flash (4, 1024, 32/4,
128) causal; SSD mamba2-1.3b's (4, 1024, 64, 64), N 128, chunk 256;
``gmm`` qwen3-moe-30b-a3b's (128, 320, 2048) x (128, 2048, 768) and its
other orientation (128, 320, 768) x (128, 768, 2048)) by CUDA-graph
replay, in turns: the kernel the tensor-core one replaced (FMA; ``gmm``'s
mma.sync), the tensor-core kernel, and the library calls (SDPA's
backward, eager, CUDA events; two ``torch.bmm``), ``gmm``'s dx and dw
launches each alone, a 403 MB copy (the card's streaming rate), and the
SSD backward's kernels by name under torch.profiler.  ``--only gmm``
runs the ``gmm`` part alone::

    python3 experiments/bwd_kernels_probe.py [--only gmm]

The card's name and power limit are printed first, and the ``gmm_bwd``
library's ptxas report (registers, spills, serialised wgmmas).  Needs a
CUDA card.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from chip_smoke import (_earlier_kernel, _randn, call_ms,  # noqa: E402
                        device_ms)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gmm as gm  # noqa: E402
from repro_torch.kernels import ssd as sd  # noqa: E402


def rel_errs(got, want) -> str:
    """Each output's largest difference over the plain value's largest."""
    out = []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        err = (g - w).abs().max() / w.abs().max().clamp_min(1e-30)
        out.append(f"{float(err):.2e}")
    return " ".join(out)


def flash_case(dev, B, Sq, Skv, H, KV, D, Dv, causal):
    bf16 = torch.bfloat16
    q = _randn((B, Sq, H, D), bf16, dev, 0)
    k = _randn((B, Skv, KV, D), bf16, dev, 1)
    v = _randn((B, Skv, KV, Dv), bf16, dev, 2)
    do = _randn((B, Sq, H, Dv), bf16, dev, 3)
    o, lse = fa._flash_forward(q, k, v, causal, True)
    tc = fa.flash_attention_bwd.tc_launches
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal)
    print(f"flash bwd ({B},{Sq}->{Skv},{H}/{KV},{D}/{Dv}) causal={causal}: "
          f"tc {fa.flash_attention_bwd.tc_launches - tc}, dq dk dv "
          f"{rel_errs(got, want)}", flush=True)
    return q, k, v, o, do, lse


def ssd_case(dev, B, L, H, P, G, N, chunk, final):
    x = _randn((B, L, H, P), torch.bfloat16, dev, 0)
    Bm = _randn((B, L, G, N), torch.bfloat16, dev, 1)
    Cm = _randn((B, L, G, N), torch.bfloat16, dev, 2)
    dt = F.softplus(_randn((B, L, H), torch.float32, dev, 3))
    A = -_randn((H,), torch.float32, dev, 4).exp()
    dy = _randn((B, L, H, P), torch.float32, dev, 5)
    dstate = _randn((B, H, P, N), torch.float32, dev, 6) if final else None
    args = (x, dt, A, Bm, Cm)
    states = sd._ssd_forward(*args, chunk, True)[2]
    tc = sd.ssd_bwd.tc_launches
    got = sd.ssd_bwd(*args, states, dy, dstate, chunk)
    torch.cuda.synchronize()
    want = sd.ssd_bwd_plain(*args, states, dy, dstate, chunk)
    print(f"ssd bwd ({B},{L},{H},{P}) G={G} N={N} chunk {chunk}"
          f"{' dstate' if final else ''}: tc {sd.ssd_bwd.tc_launches - tc}, "
          f"dx ddt dA dB dC {rel_errs(got, want)}", flush=True)
    return args, states, dy


def gmm_case(dev, E, C, D, F):
    bf16 = torch.bfloat16
    x = _randn((E, C, D), bf16, dev, 0) * D ** -0.25
    w = _randn((E, D, F), bf16, dev, 1) * D ** -0.25
    dy = _randn((E, C, F), bf16, dev, 2)
    taken = gm.gmm_bwd.wgmma_launches
    got = gm.gmm_bwd(x, w, dy)
    torch.cuda.synchronize()
    want = gm.gmm_bwd_plain(x, w, dy)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    print(f"gmm bwd ({E},{C},{D})x({D},{F}): wgmma "
          f"{gm.gmm_bwd.wgmma_launches - taken}, finite {finite}, dx dw "
          f"{rel_errs(got, want)}", flush=True)
    return x, w, dy


def gmm_times(x, w, dy) -> None:
    """The wgmma backward, its dx and dw launches alone, the earlier
    mma.sync kernel and two torch.bmm, in turns, at one shape."""
    E, C, D = x.shape
    F = w.shape[2]
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    entry = gm._bwd_entry("wgmma")

    def alone(want_dx):
        stream = torch.cuda.current_stream().cuda_stream
        rc = entry(x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                   dx.data_ptr() if want_dx else None,
                   None if want_dx else dw.data_ptr(), E, C, D, F, stream)
        assert rc == 0, rc

    def wgmma():
        return gm.gmm_bwd(x, w, dy)

    def bmm():
        return (torch.bmm(dy, w.transpose(1, 2)),
                torch.bmm(x.transpose(1, 2), dy))

    ops = 2 * 2 * E * C * D * F
    for _ in range(2):
        ms = {"mma (earlier)": device_ms(_earlier_kernel(gm, wgmma, "mma"),
                                         5, 5),
              "wgmma": device_ms(wgmma, 5, 5),
              "wgmma dx alone": device_ms(lambda: alone(True), 5, 5),
              "wgmma dw alone": device_ms(lambda: alone(False), 5, 5),
              "two torch.bmm": device_ms(bmm, 5, 5)}
        print(f"gmm bwd ({E},{C},{D})x({D},{F}) ms: " + ", ".join(
            f"{k} {v:.4f} ({ops / v / 1e9:.0f} TFLOP/s)"
            for k, v in ms.items()), flush=True)


def gmm_probe(dev) -> None:
    log = build.library_path(build.sources(["gmm_bwd"])["gmm_bwd"]) \
        .with_suffix(".log")
    print(f"ptxas ({log.name}):")
    for line in log.read_text().splitlines():
        if any(k in line for k in ("registers", "spill", "C75", "warning",
                                   "error", "Compiling entry")):
            print("  " + line.strip()[:160])
    for C in (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 320, 624):
        gmm_case(dev, 3, C, 48, 144)
        gmm_case(dev, 3, C, 144, 48)
    gmm_case(dev, 4, 624, 2048, 768)
    for D, F in ((2048, 768), (768, 2048)):
        gmm_times(*gmm_case(dev, 128, 320, D, F))
    # the card's streaming rate for a read + write mix like each product's
    src = torch.empty(128 * 2048 * 768, dtype=torch.bfloat16, device=dev)
    dst = torch.empty_like(src)
    ms = device_ms(lambda: dst.copy_(src), 5, 5)
    print(f"copy of {src.numel() * 2 / 1e6:.0f} MB: {ms:.4f} ms, "
          f"{2 * src.numel() * 2 / ms / 1e9:.3f} TB/s read + write")


def main() -> int:
    if not torch.cuda.is_available():
        print("bwd_kernels_probe: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    only = sys.argv[sys.argv.index("--only") + 1] \
        if "--only" in sys.argv else None
    build.build(["flash_attention", "flash_attention_bwd", "ssd", "ssd_bwd",
                 "gmm_bwd"])
    dev = torch.device("cuda")
    if only in (None, "gmm"):
        gmm_probe(dev)
    if only == "gmm":
        return 0
    for shape in ((2, 32, 32, 4, 2, 16, 16, True),
                  (2, 300, 300, 40, 40, 96, 64, True),
                  (1, 777, 777, 28, 4, 128, 128, True),
                  (1, 65, 65, 2, 1, 160, 160, True),
                  (1, 33, 40, 2, 2, 256, 256, False),
                  (1, 130, 70, 16, 2, 192, 192, False)):
        flash_case(dev, *shape)
    for shape in ((2, 40, 4, 16, 1, 16, 256, True),
                  (2, 200, 4, 64, 2, 128, 100, True),
                  (2, 512, 12, 64, 2, 128, 256, True),
                  (4, 1024, 80, 64, 1, 64, 256, False)):
        ssd_case(dev, *shape)
    q, k, v, o, do, lse = flash_case(dev, 4, 1024, 1024, 32, 4, 128, 128, True)
    args, states, dy = ssd_case(dev, 4, 1024, 64, 64, 1, 128, 256, False)
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                          enable_gqa=True)

    def flash():
        return fa.flash_attention_bwd(q, k, v, o, do, lse, True)

    def library():
        return torch.autograd.grad(sdpa, (qt, kt, vt), do.transpose(1, 2),
                                   retain_graph=True)

    def ssd():
        return sd.ssd_bwd(*args, states, dy, None, 256)

    for _ in range(2):
        print(f"flash bwd ms: FMA "
              f"{device_ms(_earlier_kernel(fa, flash), 5, 5):.4f}, tc "
              f"{device_ms(flash, 5, 5):.4f}, SDPA backward "
              f"{call_ms(library, 5, 10):.4f}")
        print(f"ssd bwd ms: FMA "
              f"{device_ms(_earlier_kernel(sd, ssd), 5, 3):.4f}, tc "
              f"{device_ms(ssd, 5, 3):.4f}", flush=True)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ssd()
        torch.cuda.synchronize()
    events = sorted(prof.key_averages(),
                    key=lambda e: -e.self_device_time_total)
    for e in events[:4]:
        print(f"  ssd bwd by kernel: {e.self_device_time_total / 1e3 / 3:.4f}"
              f" ms a call, {e.key[:70]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
