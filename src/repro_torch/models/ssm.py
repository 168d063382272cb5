"""Mamba2 (state-space duality) block: chunked SSD scan, conv and decode step.

The port of ``repro.models.ssm``.  ``ssd_chunked`` computes each chunk's
quadratic intra-chunk term, its end-of-chunk state contribution and its
decay with ONE ``kernels.ops.ssd_intra`` call over all chunks of the batch
(the SSD kernel on the card); the inter-chunk recurrence and its output
term stay plain PyTorch.  The intra-chunk term is float32 even in a
bfloat16 model, as in the reference.

``causal_conv1d`` stays shift-and-add in float32 (the reference's form; a
float32 ``F.conv1d`` on the card would go through cuDNN in TF32).  Decode
(``mamba_step``) returns new state tensors; ``mamba_decode_layer`` copies
them into the cache in place.

Under a plan scope the mixer is split over "model" as the reference's
rules place it (``PARAM_RULES``: ``w_z``, ``w_x``, ``ssm_norm`` and
``out_proj`` by heads; ``CACHE_RULES``: the SSM state by heads), where
``mixer_splits`` says so.  A rank projects z and x on its heads' columns,
computes B, C and dt whole from the replicated ``w_B``, ``w_C`` and
``w_dt`` (taking its heads of dt and of ``dt_bias``, ``A_log`` and
``Dskip``), and runs the conv on its x channels and every B and C
channel: ``conv_w``'s rule splits the d_inner + 2·G·N channels evenly,
which does not fall on the heads, so the conv's weights are gathered
whole (``specs.gather_mamba``) and the rank takes its channels by range.
The SSD scan runs on its heads; the gated norm sums its squares over the
ranks (``layers.rms_norm_gated``, ``partition.tp_sum``); ``out_proj``'s
rows end in g (or the reduce-scatter to the rank's rows of the
sequence).  A prefill's conv tail is all-gathered whole; its SSM state
stays the rank's heads.  A decode step reads and writes the rank's heads
of the SSM state in place, reads the conv state whole and writes back its
span.  Where the mixer does not split, every rank computes it whole.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.kernels import ops
from repro_torch.models import partition
from repro_torch.models.layers import (_dense_init, _enter, _exit, _ones,
                                       rms_norm, rms_norm_gated)


# --------------------------------------------------------------------------
# causal depthwise conv1d
# --------------------------------------------------------------------------

def causal_conv1d(x, w, b):
    """x: (B, S, Ch); w: (W, Ch); b: (Ch,).  Shift-and-add (W is tiny)."""
    W = w.shape[0]
    S = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        shift = W - 1 - i
        xi = x if shift == 0 else F.pad(x, (0, 0, shift, 0))[:, :S]
        out = out + xi.to(torch.float32) * w[i].to(torch.float32)
    return (out + b.to(torch.float32)).to(x.dtype)


def conv1d_step(conv_state, x_new, w, b):
    """conv_state: (B, W-1, Ch) raw past inputs; x_new: (B, Ch)."""
    window = torch.cat([conv_state, x_new[:, None]], dim=1)       # (B, W, Ch)
    y = torch.einsum("bwc,wc->bc", window.to(torch.float32),
                     w.to(torch.float32))
    y = (y + b.to(torch.float32)).to(x_new.dtype)
    return y, window[:, 1:]


# --------------------------------------------------------------------------
# SSD scan (chunked state-space dual form)
# --------------------------------------------------------------------------

def _segsum(x):
    """x: (..., Q) -> (..., Q, Q), S[i, j] = sum_{j < k <= i} x[k], -inf
    above the diagonal."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    return d.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """SSD over chunks.

    x: (b, s, h, p); dt: (b, s, h); A: (h,) negative decay rates;
    B, C: (b, s, g, n).  Returns (y (b, s, h, p), final_state (b, h, n, p)).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    pad = (-s) % chunk
    if pad:                               # dt = 0 => identity update
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    S = x.shape[1]
    nc, Q = S // chunk, chunk

    f32 = torch.float32
    xdt = x.to(f32) * dt.to(f32)[..., None]                  # (b, S, h, p)
    da = dt.to(f32) * A.to(f32)                              # (b, S, h)
    Bc = B.to(f32).reshape(b, nc, Q, g, n)
    Cc = C.to(f32).reshape(b, nc, Q, g, n)

    # intra-chunk term, chunk states and chunk decay: one kernel call
    y_intra, states, chunk_decay = ops.ssd_intra(
        xdt.reshape(b * nc, Q, h, p), da.reshape(b * nc, Q, h),
        Bc.reshape(b * nc, Q, g, n), Cc.reshape(b * nc, Q, g, n))
    states = states.reshape(b, nc, g, hg, n, p)
    cdg = chunk_decay.reshape(b, nc, g, hg)

    # inter-chunk recurrence over nc: the state BEFORE each chunk
    if initial_state is None:
        run = torch.zeros((b, g, hg, n, p), dtype=f32, device=x.device)
    else:
        run = initial_state.reshape(b, g, hg, n, p).to(f32)
    prevs = []
    for ci in range(nc):
        prevs.append(run)
        run = run * cdg[:, ci, ..., None, None] + states[:, ci]
    prev_states = torch.stack(prevs, dim=1)                  # (b,nc,g,hg,n,p)

    # inter-chunk output: C_t · (decayed running state)
    A_cs = torch.cumsum(da.reshape(b, nc, Q, h).permute(0, 3, 1, 2), dim=-1)
    state_decay = torch.exp(A_cs).reshape(b, g, hg, nc, Q)
    Y_inter = torch.einsum("bcqgn,bcghnp,bghcq->bcqghp", Cc, prev_states,
                           state_decay)

    y = (y_intra.reshape(b, nc, Q, g, hg, p) + Y_inter).reshape(b, S, h, p)
    return y[:, :s].to(x.dtype), run.reshape(b, h, n, p)


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """Single-token recurrence.  state: (b,h,n,p); x_t: (b,h,p);
    dt_t: (b,h); B_t, C_t: (b,g,n)."""
    h = state.shape[1]
    hg = h // B_t.shape[1]
    f32 = torch.float32
    da = torch.exp(dt_t.to(f32) * A.to(f32))                        # (b,h)
    xdt = x_t.to(f32) * dt_t.to(f32)[..., None]
    Bh = torch.repeat_interleave(B_t.to(f32), hg, dim=1)            # (b,h,n)
    Ch = torch.repeat_interleave(C_t.to(f32), hg, dim=1)
    new_state = state * da[..., None, None] + torch.einsum("bhn,bhp->bhnp",
                                                           Bh, xdt)
    y = torch.einsum("bhn,bhnp->bhp", Ch, new_state)
    return new_state, y.to(x_t.dtype)


# --------------------------------------------------------------------------
# Mamba2 block
# --------------------------------------------------------------------------

def init_mamba_block(gen, cfg: ArchConfig, dtype, device, lead=()):
    """One block's parameters, or ``lead``-stacked blocks."""
    m: SSMConfig = cfg.ssm
    D = cfg.d_model
    di = m.expand * D
    H = di // m.head_dim
    GN = m.n_groups * m.state_dim
    conv_ch = di + 2 * GN
    f32 = torch.float32
    if device.type == "meta":
        dt_bias = torch.empty(lead + (H,), dtype=f32, device=device)
    else:
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand(lead + (H,), generator=gen, dtype=f32, device=device)
        dt = torch.exp(lo + u * (hi - lo))
        dt_bias = torch.log(torch.expm1(dt))
    A_log = torch.log(torch.arange(1, H + 1, dtype=f32, device=device))
    return {
        "ln": _ones(lead + (D,), dtype, device),
        "w_z": _dense_init(gen, lead + (D, di), D, dtype, device),
        "w_x": _dense_init(gen, lead + (D, di), D, dtype, device),
        "w_B": _dense_init(gen, lead + (D, GN), D, dtype, device),
        "w_C": _dense_init(gen, lead + (D, GN), D, dtype, device),
        "w_dt": _dense_init(gen, lead + (D, H), D, dtype, device),
        "dt_bias": dt_bias,
        "A_log": A_log.expand(lead + (H,)).clone(),
        "Dskip": _ones(lead + (H,), f32, device),
        "conv_w": _dense_init(gen, lead + (m.conv_width, conv_ch),
                              m.conv_width, dtype, device),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=device),
        "ssm_norm": _ones(lead + (di,), dtype, device),
        "out_proj": _dense_init(gen, lead + (di, D), di, dtype, device),
    }


def _dims(cfg: ArchConfig) -> tuple:
    """(d_inner, heads, G·N) of the mixer."""
    m = cfg.ssm
    di = m.expand * cfg.d_model
    return di, di // m.head_dim, m.n_groups * m.state_dim


def mixer_splits(cfg: ArchConfig) -> bool:
    """Whether the Mamba mixer runs on this rank's heads under the current
    plan scope: "tp" resolves to an axis of more than one rank that the
    guard keeps on ``d_inner``, the rank's ``d_inner`` columns are whole
    heads (H % tp == 0), and its heads fall inside whole groups of B and C
    (or hold whole groups).  Otherwise every rank computes it whole."""
    m = cfg.ssm
    di, H, _ = _dims(cfg)
    n = partition.tp_ways(di)
    if n == 1 or H % n:
        return False
    Hl, hg = H // n, H // m.n_groups
    return Hl % hg == 0 or hg % Hl == 0


def _rank_heads(p, cfg: ArchConfig) -> tuple:
    """(first head, heads) of this rank: all of them where ``w_x`` is
    whole."""
    di, H, _ = _dims(cfg)
    Hl = H * p["w_x"].shape[-1] // di
    return partition.tp_rank() * Hl if Hl < H else 0, Hl


def _rank_channels(t, cfg: ArchConfig, h0: int, Hl: int):
    """This rank's conv channels (the last dimension) of ``t``, which has
    all d_inner + 2·G·N: its heads' x channels and every B and C
    channel; ``t`` itself where the rank has every head."""
    di, H, _ = _dims(cfg)
    if Hl == H:
        return t
    hd = cfg.ssm.head_dim
    return torch.cat([t[..., h0 * hd:(h0 + Hl) * hd], t[..., di:]], dim=-1)


def _rank_groups(t, cfg: ArchConfig, h0: int, Hl: int):
    """The groups of B or C (dimension -2) that this rank's heads read."""
    G = cfg.ssm.n_groups
    hg = _dims(cfg)[1] // G
    if G == 1 or Hl == G * hg:
        return t
    return t.narrow(-2, h0 // hg, max(1, Hl // hg))


def _heads(t, h0: int, Hl: int):
    """This rank's heads (the last dimension) of a per-head leaf."""
    return t if t.shape[-1] == Hl else t[..., h0:h0 + Hl]


def mamba_apply(p, cfg: ArchConfig, x, initial_state=None, *,
                seq: bool = False, state: bool = True):
    """x: (B, S, D), or with ``seq`` this rank's rows of the sequence (the
    output then the rank's rows too).  Returns (out, (ssm_state,
    conv_tail)): the state on this rank's heads, the tail whole; with
    ``state=False`` (training) None for the pair.  ``initial_state``
    holds every head and channel."""
    m: SSMConfig = cfg.ssm
    di, H, GN = _dims(cfg)
    f32 = torch.float32
    h0, Hl = _rank_heads(p, cfg)
    split = Hl < H
    x = _enter(x, split, seq)
    Bsz, S, _ = x.shape
    z = torch.einsum("bsd,de->bse", x, p["w_z"])
    xx = torch.einsum("bsd,de->bse", x, p["w_x"])
    xB = torch.einsum("bsd,de->bse", x, p["w_B"])
    xC = torch.einsum("bsd,de->bse", x, p["w_C"])
    xBC = torch.cat([xx, xB, xC], dim=-1)
    conv_w = _rank_channels(p["conv_w"], cfg, h0, Hl)
    conv_b = _rank_channels(p["conv_b"], cfg, h0, Hl)
    if initial_state is not None:
        prev_conv = _rank_channels(initial_state[1], cfg, h0, Hl)
        xBC_in = torch.cat([prev_conv, xBC], dim=1)
        conv = causal_conv1d(xBC_in, conv_w, conv_b)[:, m.conv_width - 1:]
    else:
        conv = causal_conv1d(xBC, conv_w, conv_b)
    conv = F.silu(conv.to(f32)).to(x.dtype)
    dl = Hl * m.head_dim
    xs = conv[..., :dl].reshape(Bsz, S, Hl, m.head_dim)
    Bs = _rank_groups(conv[..., dl:dl + GN].reshape(
        Bsz, S, m.n_groups, m.state_dim), cfg, h0, Hl)
    Cs = _rank_groups(conv[..., dl + GN:].reshape(
        Bsz, S, m.n_groups, m.state_dim), cfg, h0, Hl)
    dt = F.softplus(torch.einsum("bsd,dh->bsh", x,
                                 _heads(p["w_dt"], h0, Hl)).to(f32)
                    + _heads(p["dt_bias"], h0, Hl))
    A = -torch.exp(_heads(p["A_log"], h0, Hl))
    ssm_init = None
    if initial_state is not None:
        ssm_init = initial_state[0].narrow(1, h0, Hl) if split \
            else initial_state[0]
    y, fstate = ssd_chunked(xs, dt, A, Bs, Cs, m.chunk, ssm_init)
    y = y + _heads(p["Dskip"], h0, Hl)[None, None, :, None] * xs.to(f32)
    y = y.reshape(Bsz, S, dl).to(x.dtype)
    y = rms_norm_gated(y, z, p["ssm_norm"], cfg.norm_eps, width=di)
    out = _exit(torch.einsum("bse,ed->bsd", y, p["out_proj"]), split, seq)
    if not state:
        return out, None
    # as the reference: a prompt shorter than conv_width - 1 gives a shorter
    # tail (BatchServer._write_rows pads it at the end)
    tail = -(m.conv_width - 1)
    xt = xx[:, tail:]
    conv_tail = torch.cat([partition.tp_gather(xt, 2) if split else xt,
                           xB[:, tail:], xC[:, tail:]], dim=-1)
    return out, (fstate, conv_tail)


def mamba_step(p, cfg: ArchConfig, x, state):
    """Single-token decode.  x: (B, D); state = (ssm_state on this rank's
    heads, conv_state with every channel).  Returns (out (B, D), (new
    ssm_state, new conv_state)), in the same layouts."""
    m: SSMConfig = cfg.ssm
    di, H, GN = _dims(cfg)
    f32 = torch.float32
    h0, Hl = _rank_heads(p, cfg)
    split = Hl < H
    x = _enter(x, split, False)
    Bsz = x.shape[0]
    ssm_state, conv_state = state
    z = torch.einsum("bd,de->be", x, p["w_z"])
    xx = torch.einsum("bd,de->be", x, p["w_x"])
    xB = torch.einsum("bd,de->be", x, p["w_B"])
    xC = torch.einsum("bd,de->be", x, p["w_C"])
    xBC = torch.cat([xx, xB, xC], dim=-1)
    conv, window = conv1d_step(_rank_channels(conv_state, cfg, h0, Hl), xBC,
                               _rank_channels(p["conv_w"], cfg, h0, Hl),
                               _rank_channels(p["conv_b"], cfg, h0, Hl))
    if split:       # the window's new row with every rank's x channels
        row = torch.cat([partition.tp_gather(xx, 1), xB, xC], dim=-1)
        window = torch.cat([conv_state, row[:, None]], dim=1)[:, 1:]
    conv = F.silu(conv.to(f32)).to(x.dtype)
    dl = Hl * m.head_dim
    xs = conv[..., :dl].reshape(Bsz, Hl, m.head_dim)
    Bs = _rank_groups(conv[..., dl:dl + GN].reshape(
        Bsz, m.n_groups, m.state_dim), cfg, h0, Hl)
    Cs = _rank_groups(conv[..., dl + GN:].reshape(
        Bsz, m.n_groups, m.state_dim), cfg, h0, Hl)
    dt = F.softplus(torch.einsum("bd,dh->bh", x,
                                 _heads(p["w_dt"], h0, Hl)).to(f32)
                    + _heads(p["dt_bias"], h0, Hl))
    A = -torch.exp(_heads(p["A_log"], h0, Hl))
    ssm_state, y = ssd_step(ssm_state, xs, dt, A, Bs, Cs)
    y = y + _heads(p["Dskip"], h0, Hl)[None, :, None] * xs.to(f32)
    y = y.reshape(Bsz, dl).to(x.dtype)
    y = rms_norm_gated(y, z, p["ssm_norm"], cfg.norm_eps, width=di)
    out = _exit(torch.einsum("be,ed->bd", y, p["out_proj"]), split, False)
    return out, (ssm_state, window)


def mamba_decode_layer(lp, cfg: ArchConfig, x, ssm_leaf, conv_leaf):
    """``x`` plus one Mamba layer's decode of it, with the layer's weights
    ``lp`` as ``specs.gather_mamba`` gives them and its cache leaves,
    which are written IN PLACE: the SSM state read and written as this
    rank's heads where the mixer is split (no gather), the conv state read
    whole and this rank's span written back."""
    split = lp["w_x"].shape[-1] < _dims(cfg)[0]
    h, (s2, c2) = mamba_step(
        lp, cfg, rms_norm(x, lp["ln"], cfg.norm_eps),
        (partition.rows_of(ssm_leaf, keep_tp=split),
         partition.rows_of(conv_leaf)))
    partition.store_rows(ssm_leaf, s2, keep_tp=split)
    partition.store_rows(conv_leaf, c2)
    return x + h


def init_mamba_state(cfg: ArchConfig, batch: int, dtype=torch.float32, *,
                     device):
    m: SSMConfig = cfg.ssm
    di = m.expand * cfg.d_model
    H = di // m.head_dim
    conv_ch = di + 2 * m.n_groups * m.state_dim
    return (torch.zeros((batch, H, m.state_dim, m.head_dim),
                        dtype=torch.float32, device=device),
            torch.zeros((batch, m.conv_width - 1, conv_ch), dtype=dtype,
                        device=device))
