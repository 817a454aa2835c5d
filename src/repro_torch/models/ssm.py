"""Mamba2 block of the port: depthwise causal conv + the SSD scan.

Translated from the reference's ``models/ssm.py`` (``init_mamba2``,
``causal_conv1d``, ``_project``, ``mamba2_fwd``, ``_conv_step``,
``mamba2_decode``), with its layout: separate projections for z, x, B, C
and dt and one depthwise conv per part (the reference's TP-friendly split
of the packed in_proj).  The parameter leaves keep the reference's names,
shapes and dtypes.

The prefill and training path calls ``kernels.ssd`` where the reference
calls its XLA ``ssd_chunked``: on CUDA tensors the kernel always
launches, on CPU tensors its plain version runs; under grad through the
``SSD`` autograd function, whose backward is the ``ssd_bwd`` kernel (the
reference differentiates ``ssd_chunked``).  The decode path is the O(1)
recurrent step in plain PyTorch ops (the reference has no kernel for it).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ssd
from repro_torch.models.common import dtype_of, normal_init, rmsnorm


def _uniform(n: int, lo: float, hi: float, generator: torch.Generator,
             device) -> torch.Tensor:
    u = torch.empty((n,), dtype=torch.float32, device=generator.device)
    u.uniform_(lo, hi, generator=generator)
    return u.to(device or u.device)


def init_mamba2(cfg, generator: torch.Generator, device=None) -> dict:
    """Draws in order: in_z, in_x, in_B, in_C, in_dt, the three conv
    weights, out_proj, then the dt and A draws.  Projections are in the
    model's dtype; conv weights and biases, ``A_log``, ``Dskip``,
    ``dt_bias`` and ``norm`` in f32."""
    s = cfg.ssm
    dt_ = dtype_of(cfg)
    D = cfg.d_model
    di, nh = s.d_inner(D), s.n_heads(D)
    gn = s.n_groups * s.d_state
    f32 = torch.float32

    def w(shape, std, dtype):
        return normal_init(shape, std, dtype, generator, device)

    p = {"in_z": w((D, di), D ** -0.5, dt_),
         "in_x": w((D, di), D ** -0.5, dt_),
         "in_B": w((D, gn), D ** -0.5, dt_),
         "in_C": w((D, gn), D ** -0.5, dt_),
         "in_dt": w((D, nh), D ** -0.5, dt_),
         "conv_x_w": w((s.d_conv, di), 0.1, f32),
         "conv_B_w": w((s.d_conv, gn), 0.1, f32),
         "conv_C_w": w((s.d_conv, gn), 0.1, f32),
         "out_proj": w((di, D), di ** -0.5, dt_)}
    dev = p["in_z"].device
    p.update({"conv_x_b": torch.zeros((di,), dtype=f32, device=dev),
              "conv_B_b": torch.zeros((gn,), dtype=f32, device=dev),
              "conv_C_b": torch.zeros((gn,), dtype=f32, device=dev),
              "Dskip": torch.ones((nh,), dtype=f32, device=dev),
              "norm": torch.ones((di,), dtype=f32, device=dev)})
    # dt bias such that softplus(dt_bias) is log-uniform in [dt_min, dt_max]
    lo, hi = math.log(s.dt_min), math.log(s.dt_max)
    dt0 = torch.exp(_uniform(nh, 0.0, 1.0, generator, dev) * (hi - lo) + lo)
    p["dt_bias"] = dt0 + torch.log(-torch.expm1(-dt0))        # inv softplus
    p["A_log"] = torch.log(_uniform(nh, *s.a_init_range, generator, dev))
    return p


def mamba2_logical() -> dict:
    return {"in_z": ("embed", "ssm_inner"), "in_x": ("embed", "ssm_inner"),
            "in_B": ("embed", None), "in_C": ("embed", None),
            "in_dt": ("embed", None),
            "conv_x_w": (None, "ssm_inner"), "conv_x_b": ("ssm_inner",),
            "conv_B_w": (None, None), "conv_B_b": (None,),
            "conv_C_w": (None, None), "conv_C_b": (None,),
            "A_log": ("noshard",), "Dskip": ("noshard",),
            "dt_bias": ("noshard",), "norm": ("ssm_inner",),
            "out_proj": ("ssm_inner", "embed")}


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv + silu.  x: (B, L, C); w: (W, C).  The
    shifted sum is taken in f32 and cast back to x's dtype."""
    W, L = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + L, :].float() * w[i] for i in range(W))
    return F.silu(out + b).to(x.dtype)


def _project(p, cfg, x: torch.Tensor):
    """x: (B, L, D) -> z, xr, Br, Cr, dt (pre-conv, pre-softplus)."""
    return (x @ p["in_z"], x @ p["in_x"], x @ p["in_B"], x @ p["in_C"],
            x @ p["in_dt"])


def mamba2_fwd(p, cfg, x: torch.Tensor):
    """Prefill path.  x: (B, L, D).

    Returns (y (B, L, D), (conv_tails, final_state)), where conv_tails =
    (x, B, C) are the raw pre-conv tails of length W-1 and final_state
    (B, H, P, N) f32 is the SSD state after the last position."""
    s = cfg.ssm
    di, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    W = s.d_conv
    z, xr, Br, Cr, dt = _project(p, cfg, x)
    tails = (xr[:, -(W - 1):], Br[:, -(W - 1):], Cr[:, -(W - 1):])
    xc = causal_conv1d(xr, p["conv_x_w"], p["conv_x_b"])
    Bc = causal_conv1d(Br, p["conv_B_w"], p["conv_B_b"])
    Cc = causal_conv1d(Cr, p["conv_C_w"], p["conv_C_b"])
    Bsz, L = x.shape[:2]
    xs = xc.reshape(Bsz, L, nh, s.head_dim)
    Bm = Bc.reshape(Bsz, L, s.n_groups, s.d_state)
    Cm = Cc.reshape(Bsz, L, s.n_groups, s.d_state)
    dtv = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    # the kernel casts x on load, as the reference casts it before the scan
    y, final_state = ssd(xs, dtv, A, Bm, Cm, chunk=s.chunk_size)
    y = y + p["Dskip"][None, None, :, None] * xs.float()
    y = y.reshape(Bsz, L, di)
    y = rmsnorm({"scale": p["norm"]},
                (y * F.silu(z.float())).to(x.dtype), cfg.norm_eps)
    return y @ p["out_proj"], (tails, final_state)


def _conv_step(buf: torch.Tensor, new: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor):
    """buf: (B, W-1, C) raw history; new: (B, C).  Returns (act, full):
    the activation and the history with ``new`` appended, (B, W, C)."""
    full = torch.cat([buf, new[:, None, :].to(buf.dtype)], dim=1)
    out = (full.float() * w).sum(dim=1) + b
    return F.silu(out), full


def mamba2_decode(p, cfg, x: torch.Tensor, conv_state: dict,
                  ssm_state: torch.Tensor):
    """O(1) decode step.  x: (B, 1, D); conv_state: dict of the (x, B, C)
    tails (B, W-1, C); ssm_state (B, H, P, N) f32.

    Updates ``conv_state``'s tensors and ``ssm_state`` in place (the
    reference returns new arrays; writing the layer's slice of the cache
    saves copying it) and returns (y (B, 1, D), conv_state, ssm_state):
    the same tensors."""
    s = cfg.ssm
    di, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    z, xr, Br, Cr, dt = (t[:, 0] for t in _project(p, cfg, x))
    acts = []
    for name, new in (("x", xr), ("B", Br), ("C", Cr)):
        act, full = _conv_step(conv_state[name], new, p[f"conv_{name}_w"],
                               p[f"conv_{name}_b"])
        conv_state[name].copy_(full[:, 1:])
        acts.append(act)
    xc, Bc, Cc = acts
    Bsz = x.shape[0]
    rep = nh // s.n_groups
    xs = xc.reshape(Bsz, nh, s.head_dim)
    Bh = Bc.reshape(Bsz, s.n_groups, 1, s.d_state).expand(
        Bsz, s.n_groups, rep, s.d_state).reshape(Bsz, nh, s.d_state)
    Ch = Cc.reshape(Bsz, s.n_groups, 1, s.d_state).expand(
        Bsz, s.n_groups, rep, s.d_state).reshape(Bsz, nh, s.d_state)
    dtv = F.softplus(dt.float() + p["dt_bias"])                # (B, H)
    dA = torch.exp(dtv * -torch.exp(p["A_log"]))
    ssm_state.mul_(dA[..., None, None]).add_(
        (dtv[..., None] * xs)[..., :, None] * Bh[..., None, :])
    y = (ssm_state @ Ch[..., None])[..., 0]                    # (B, H, P)
    y = y + p["Dskip"][None, :, None] * xs
    y = rmsnorm({"scale": p["norm"]},
                (y.reshape(Bsz, di) * F.silu(z.float())).to(x.dtype),
                cfg.norm_eps)
    return (y @ p["out_proj"])[:, None, :], conv_state, ssm_state
