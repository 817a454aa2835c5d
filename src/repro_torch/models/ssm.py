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

Under tensor parallelism (rules with a model axis, ``ssm_inner ->
model``) a rank runs its block of the heads, the reference's layout:
``in_z``, ``in_x``, ``conv_x_*`` and ``norm`` are the rank's blocks of
the inner channels, ``out_proj`` its rows (its output a partial sum over
the model ranks, which the caller sums); ``in_B``, ``in_C``, ``in_dt``
and ``conv_B_*`` / ``conv_C_*`` are replicated, and ``dt``, ``A_log``,
``Dskip`` and ``dt_bias`` (``("noshard",)``) are cut to the rank's heads
(``parallel.sharding.model_block``).  B and C are the groups the rank's
heads read: every group where there is one, else the rank's whole groups
(:func:`check_tp`).  The gated RMSNorm's mean is over the whole
``d_inner``, so a rank's mean over its channels is summed over the model
ranks (``parallel.sharding.sum_over_model``, whose backward sums too).
The SSD kernel runs on the rank's H / tp heads; in decode the conv
state's ``x`` tail holds the rank's channels, the ``B`` / ``C`` tails are
whole and the SSD state holds the rank's heads.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ssd
from repro_torch.models.common import dtype_of, normal_init
from repro_torch.parallel.sharding import model_block, sum_over_model


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


def check_tp(cfg, tp: int) -> None:
    """``ValueError`` where Mamba2's heads do not split over ``tp`` model
    ranks, or where with more than one group a rank's heads would read
    part of a group (each rank's heads must cover whole groups)."""
    s = cfg.ssm
    H, G = s.n_heads(cfg.d_model), s.n_groups
    if H % tp:
        raise ValueError(f"{cfg.name}: {H} Mamba2 heads do not split over "
                         f"{tp} model ranks")
    if G > 1 and (H // tp) % (H // G):
        raise ValueError(f"{cfg.name}: {H} Mamba2 heads in {G} groups over "
                         f"{tp} model ranks: a rank's {H // tp} heads would "
                         f"read part of a group (each must cover whole "
                         f"groups)")


def _groups(cfg, t: torch.Tensor) -> torch.Tensor:
    """The groups (..., G, N) of B or C that this model rank's heads read:
    the one group, or the rank's block of the groups."""
    return t if cfg.ssm.n_groups == 1 else model_block(t, -2)


def _project(p, cfg, x: torch.Tensor):
    """x: (B, L, D) -> z, xr, Br, Cr, dt (pre-conv, pre-softplus); z, xr
    and dt on this model rank's channels and heads."""
    return (x @ p["in_z"], x @ p["in_x"], x @ p["in_B"], x @ p["in_C"],
            x @ model_block(p["in_dt"], 1))


def _head_params(p):
    """dt_bias, A and Dskip of this model rank's heads."""
    return (model_block(p["dt_bias"]), -torch.exp(model_block(p["A_log"])),
            model_block(p["Dskip"]))


def gated_rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float,
                  d_inner: int) -> torch.Tensor:
    """``common.rmsnorm`` over the whole ``d_inner`` channels, of which
    ``x`` holds this model rank's block: the rank's mean of squares,
    weighed by its share of the channels, summed over the model ranks
    (with one rank the weight is 1 and the sum a copy, so the result is
    ``rmsnorm``'s bit for bit)."""
    xf = x.float()
    var = sum_over_model(xf.square().mean(dim=-1, keepdim=True)
                         * (x.shape[-1] / d_inner))
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def mamba2_fwd(p, cfg, x: torch.Tensor):
    """Prefill path.  x: (B, L, D).

    Returns (y (B, L, D), (conv_tails, final_state)), where conv_tails =
    (x, B, C) are the raw pre-conv tails of length W-1 and final_state
    (B, H, P, N) f32 is the SSD state after the last position."""
    s = cfg.ssm
    W = s.d_conv
    z, xr, Br, Cr, dt = _project(p, cfg, x)
    tails = (xr[:, -(W - 1):], Br[:, -(W - 1):], Cr[:, -(W - 1):])
    xc = causal_conv1d(xr, p["conv_x_w"], p["conv_x_b"])
    Bc = causal_conv1d(Br, p["conv_B_w"], p["conv_B_b"])
    Cc = causal_conv1d(Cr, p["conv_C_w"], p["conv_C_b"])
    Bsz, L, di = xc.shape
    xs = xc.reshape(Bsz, L, di // s.head_dim, s.head_dim)
    Bm = _groups(cfg, Bc.reshape(Bsz, L, s.n_groups, s.d_state))
    Cm = _groups(cfg, Cc.reshape(Bsz, L, s.n_groups, s.d_state))
    dt_bias, A, Dskip = _head_params(p)
    dtv = F.softplus(dt.float() + dt_bias)
    # the kernel casts x on load, as the reference casts it before the scan
    y, final_state = ssd(xs, dtv, A, Bm, Cm, chunk=s.chunk_size)
    y = y + Dskip[None, None, :, None] * xs.float()
    y = y.reshape(Bsz, L, di)
    y = gated_rmsnorm(p["norm"], (y * F.silu(z.float())).to(x.dtype),
                      cfg.norm_eps, s.d_inner(cfg.d_model))
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
    z, xr, Br, Cr, dt = (t[:, 0] for t in _project(p, cfg, x))
    acts = []
    for name, new in (("x", xr), ("B", Br), ("C", Cr)):
        act, full = _conv_step(conv_state[name], new, p[f"conv_{name}_w"],
                               p[f"conv_{name}_b"])
        conv_state[name].copy_(full[:, 1:])
        acts.append(act)
    xc, Bc, Cc = acts
    Bsz, di = xc.shape
    nh = di // s.head_dim
    Bg = _groups(cfg, Bc.reshape(Bsz, s.n_groups, s.d_state))
    Cg = _groups(cfg, Cc.reshape(Bsz, s.n_groups, s.d_state))
    G = Bg.shape[1]
    rep = nh // G
    xs = xc.reshape(Bsz, nh, s.head_dim)
    Bh = Bg.reshape(Bsz, G, 1, s.d_state).expand(
        Bsz, G, rep, s.d_state).reshape(Bsz, nh, s.d_state)
    Ch = Cg.reshape(Bsz, G, 1, s.d_state).expand(
        Bsz, G, rep, s.d_state).reshape(Bsz, nh, s.d_state)
    dt_bias, A, Dskip = _head_params(p)
    dtv = F.softplus(dt.float() + dt_bias)                     # (B, H)
    dA = torch.exp(dtv * A)
    ssm_state.mul_(dA[..., None, None]).add_(
        (dtv[..., None] * xs)[..., :, None] * Bh[..., None, :])
    y = (ssm_state @ Ch[..., None])[..., 0]                    # (B, H, P)
    y = y + Dskip[None, :, None] * xs
    y = gated_rmsnorm(p["norm"],
                      (y.reshape(Bsz, di) * F.silu(z.float())).to(x.dtype),
                      cfg.norm_eps, s.d_inner(cfg.d_model))
    return (y @ p["out_proj"])[:, None, :], conv_state, ssm_state
