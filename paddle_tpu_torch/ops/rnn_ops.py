"""Recurrent ops (the JAX package's rnn_ops.py): gru_unit, gru, lstm_unit,
lstm, lstmp (the projection LSTM), cudnn_lstm (stacked, optionally
bidirectional) and row_conv. The JAX package scans the padded time axis
with `lax.scan`; here the whole-sequence ops loop over it in Python, one
step's products a time. Their grads are derived by replay
(ops/registry.py): autograd through the loop, which recomputes the forward
(XLA shares it through CSE).

cudnn_lstm is not a call into `torch.nn.LSTM` / cuDNN: it unpacks the JAX
op's flat weight (per layer and direction Wx [in, 4H], Wh [H, 4H], one
bias [4H], gates i, f, c, o), whose packing and gate order differ from
cuDNN's, and computes with torch ops. Its inter-layer dropout masks come
from the run's generator and are left in the run's stash, so the replay
that differentiates the op applies the same masks.
"""
from __future__ import annotations

import torch

from .registry import ExecContext, register_op

_ACTS = {
    "identity": lambda x: x,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
}


def _act(name):
    try:
        return _ACTS[str(name)]
    except KeyError:
        raise ValueError(f"unsupported activation '{name}'") from None


def _gru_step(x_t, h_prev, weight, bias, act, gate_act, origin_mode):
    """gru_unit_op.h's math: the update and reset gates from x + b +
    h_prev @ W[:, :2H], the candidate c = act(x_c + (r * h_prev) @
    W[:, 2H:]), h = u * (c - h_prev) + h_prev (origin_mode: c + u *
    (h_prev - c)). Gates are laid out (u, r, c). Returns (h, r * h_prev,
    the gates)."""
    H = h_prev.shape[-1]
    g = x_t if bias is None else x_t + bias.reshape(1, 3 * H)
    g_ur = g[:, :2 * H] + h_prev @ weight[:, :2 * H]
    u = gate_act(g_ur[:, :H])
    r = gate_act(g_ur[:, H:])
    r_h = r * h_prev
    c = act(g[:, 2 * H:] + r_h @ weight[:, 2 * H:])
    h = c + u * (h_prev - c) if origin_mode else u * (c - h_prev) + h_prev
    return h, r_h, torch.cat([u, r, c], dim=-1)


@register_op("gru_unit")
def gru_unit(ctx: ExecContext):
    """One GRU step: Input [B, 3H] (x @ W_x), HiddenPrev [B, H], Weight
    [H, 3H], optional Bias [1, 3H] -> Hidden, ResetHiddenPrev, Gate."""
    h, r_h, gates = _gru_step(
        ctx.input("Input"), ctx.input("HiddenPrev"), ctx.input("Weight"),
        ctx.input("Bias"), _act(ctx.attr("activation", "tanh")),
        _act(ctx.attr("gate_activation", "sigmoid")),
        bool(ctx.attr("origin_mode", False)))
    return {"Hidden": h, "ResetHiddenPrev": r_h, "Gate": gates}


def _time_steps(T, reverse):
    return range(T - 1, -1, -1) if reverse else range(T)


@register_op("gru")
def gru(ctx: ExecContext):
    """Whole-sequence GRU: Input [B, T, 3H], optional H0 [B, H], Weight
    [H, 3H], Bias [1, 3H] -> Hidden [B, T, H], step t's state at t
    (is_reverse runs from the last step to the first)."""
    x, w, b = ctx.input("Input"), ctx.input("Weight"), ctx.input("Bias")
    B, T = x.shape[0], x.shape[1]
    h = ctx.input("H0")
    if h is None:
        h = torch.zeros((B, w.shape[0]), dtype=x.dtype, device=x.device)
    act = _act(ctx.attr("activation", "tanh"))
    gate_act = _act(ctx.attr("gate_activation", "sigmoid"))
    origin = bool(ctx.attr("origin_mode", False))
    hs = [None] * T
    for t in _time_steps(T, bool(ctx.attr("is_reverse", False))):
        h, _, _ = _gru_step(x[:, t], h, w, b, act, gate_act, origin)
        hs[t] = h
    return {"Hidden": torch.stack(hs, dim=1)}


@register_op("lstm_unit")
def lstm_unit(ctx: ExecContext):
    """One LSTM step (lstm_unit_op.h): X [B, 4H] pre-projected gates in the
    (i, f, o, g) layout, C_prev [B, H] -> C, H."""
    x, c_prev = ctx.input("X"), ctx.input("C_prev")
    H = c_prev.shape[-1]
    i = torch.sigmoid(x[:, :H])
    f = torch.sigmoid(x[:, H:2 * H] + float(ctx.attr("forget_bias", 0.0)))
    o = torch.sigmoid(x[:, 2 * H:3 * H])
    g = torch.tanh(x[:, 3 * H:])
    c = f * c_prev + i * g
    return {"C": c, "H": o * torch.tanh(c)}


@register_op("lstm")
def lstm(ctx: ExecContext):
    """Whole-sequence LSTM: Input [B, T, 4H] pre-projected, Weight [H, 4H]
    recurrent, Bias [1, 4H], optional H0 / C0 -> Hidden and Cell
    [B, T, H]. Gate order (c_hat, i, f, o), lstm_op.cc's weight layout."""
    x, w, b = ctx.input("Input"), ctx.input("Weight"), ctx.input("Bias")
    H = w.shape[0]
    B, T = x.shape[0], x.shape[1]
    h, c = ctx.input("H0"), ctx.input("C0")
    if h is None:
        h = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    if c is None:
        c = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    cand_act = _act(ctx.attr("candidate_activation", "tanh"))
    gate_act = _act(ctx.attr("gate_activation", "sigmoid"))
    cell_act = _act(ctx.attr("cell_activation", "tanh"))
    hs, cs = [None] * T, [None] * T
    for t in _time_steps(T, bool(ctx.attr("is_reverse", False))):
        g = x[:, t] + h @ w
        if b is not None:
            g = g + b.reshape(1, 4 * H)
        c = (gate_act(g[:, 2 * H:3 * H]) * c
             + gate_act(g[:, H:2 * H]) * cand_act(g[:, :H]))
        h = gate_act(g[:, 3 * H:]) * cell_act(c)
        hs[t], cs[t] = h, c
    return {"Hidden": torch.stack(hs, dim=1), "Cell": torch.stack(cs, dim=1)}


@register_op("lstmp")
def lstmp(ctx: ExecContext):
    """Projection LSTM (rnn_ops.py:156): Input [B, T, 4H] pre-projected,
    Weight [P, 4H] recurrent over the projection r, ProjWeight [H, P],
    optional Bias [1, 4H]; r_t = proj_act(h_t @ ProjWeight). Gates
    (c_hat, i, f, o) as lstm's. -> Projection [B, T, P], Cell [B, T, H]."""
    x, w, pw, b = (ctx.input("Input"), ctx.input("Weight"),
                   ctx.input("ProjWeight"), ctx.input("Bias"))
    H, P = pw.shape
    B, T = x.shape[0], x.shape[1]
    cand_act = _act(ctx.attr("candidate_activation", "tanh"))
    gate_act = _act(ctx.attr("gate_activation", "sigmoid"))
    cell_act = _act(ctx.attr("cell_activation", "tanh"))
    proj_act = _act(ctx.attr("proj_activation", "identity"))
    r = torch.zeros((B, P), dtype=x.dtype, device=x.device)
    c = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    rs, cs = [None] * T, [None] * T
    for t in _time_steps(T, bool(ctx.attr("is_reverse", False))):
        g = x[:, t] + r @ w
        if b is not None:
            g = g + b.reshape(1, -1)[:, :4 * H]
        c = (gate_act(g[:, 2 * H:3 * H]) * c
             + gate_act(g[:, H:2 * H]) * cand_act(g[:, :H]))
        r = proj_act((gate_act(g[:, 3 * H:]) * cell_act(c)) @ pw)
        rs[t], cs[t] = r, c
    return {"Projection": torch.stack(rs, dim=1), "Cell": torch.stack(cs, dim=1)}


def _lstm_dir(inp, wx, wh, bias, h, c, reverse):
    """One direction of cudnn_lstm: gates i, f, c_hat, o from x Wx + h Wh
    + bias. Returns ([B, T, H], last h, last c)."""
    H = h.shape[-1]
    xw = inp @ wx + bias              # all steps' input products at once
    T = inp.shape[1]
    hs = [None] * T
    for t in _time_steps(T, reverse):
        g = xw[:, t] + h @ wh
        c = (torch.sigmoid(g[:, H:2 * H]) * c
             + torch.sigmoid(g[:, :H]) * torch.tanh(g[:, 2 * H:3 * H]))
        h = torch.sigmoid(g[:, 3 * H:]) * torch.tanh(c)
        hs[t] = h
    return torch.stack(hs, dim=1), h, c


@register_op("cudnn_lstm", needs_rng=True)
def cudnn_lstm(ctx: ExecContext):
    """Stacked, optionally bidirectional LSTM (rnn_ops.py:199): Input
    [B, T, D], the flat W, InitH / InitC [L * dirs, B, H] -> Out
    [B, T, H * dirs], LastH, LastC. With dropout_prob > 0 and not is_test,
    dropout between stacked layers, never after the last."""
    x = ctx.input("Input")
    flat = ctx.input("W").reshape(-1)
    init_h, init_c = ctx.input("InitH"), ctx.input("InitC")
    L = int(ctx.attr("num_layers", 1))
    H = int(ctx.attr("hidden_size"))
    dirs = 2 if ctx.attr("is_bidirec", False) else 1
    D = x.shape[-1]
    p = float(ctx.attr("dropout_prob", 0.0))
    masks = None
    if p > 0.0 and not ctx.attr("is_test", False) and L > 1:
        masks = _dropout_masks(ctx, x, L, H * dirs, p)
    off = 0

    def take(n, shape):
        nonlocal off
        v = flat[off:off + n].reshape(shape)
        off += n
        return v

    out, last_h, last_c = x, [], []
    for layer in range(L):
        if masks is not None and layer > 0:
            out = out * masks[layer - 1]
        in_dim = D if layer == 0 else H * dirs
        outs = []
        for d in range(dirs):
            wx = take(in_dim * 4 * H, (in_dim, 4 * H))
            wh = take(H * 4 * H, (H, 4 * H))
            bias = take(4 * H, (4 * H,))
            o, hT, cT = _lstm_dir(out, wx, wh, bias, init_h[layer * dirs + d],
                                  init_c[layer * dirs + d], reverse=d == 1)
            outs.append(o)
            last_h.append(hT)
            last_c.append(cT)
        out = torch.cat(outs, dim=-1) if dirs == 2 else outs[0]
    return {"Out": out, "LastH": torch.stack(last_h),
            "LastC": torch.stack(last_c)}


def _dropout_masks(ctx: ExecContext, x, L, width, p):
    """The L - 1 inter-layer masks of a cudnn_lstm run, keep / (1 - p) or
    0, drawn from the run's generator by the forward and found in the
    run's stash by its replay."""
    replay = getattr(ctx.op, "forward_outputs", None)
    key = ("cudnn_lstm masks",
           (ctx.op.outputs if replay is None else replay)["Out"][0])
    if replay is not None:
        if ctx.stash is None or key not in ctx.stash:
            raise RuntimeError(
                "cudnn_lstm_grad: the forward's dropout masks are not in "
                "this run's stash; run the forward and its grad in one run")
        return ctx.stash[key]
    shape = (x.shape[0], x.shape[1], width)
    masks = [(torch.rand(shape, generator=ctx.generator, device=x.device)
              >= p).to(x.dtype) / (1.0 - p) for _ in range(L - 1)]
    if ctx.stash is not None:
        ctx.stash[key] = masks
    return masks


@register_op("row_conv")
def row_conv(ctx: ExecContext):
    """Lookahead convolution (rnn_ops.py:271): X [B, T, D], Filter
    [k + 1, D]; out[t] = sum_i x[t + i] * filter[i] per feature, zero past
    the end."""
    x, filt = ctx.input("X"), ctx.input("Filter")
    T = x.shape[1]
    t = torch.arange(T, dtype=torch.int32, device=x.device)
    out = torch.zeros_like(x)
    for i in range(filt.shape[0]):
        ok = ((t + i) < T)[None, :, None]
        g = x[:, torch.clamp(t + i, 0, T - 1).long(), :]
        out = out + torch.where(ok, g, torch.zeros_like(g)) * filt[i][None, None, :]
    return {"Out": out}
