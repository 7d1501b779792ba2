"""Recurrent ops (the JAX package's rnn_ops.py): gru_unit, gru, lstm_unit
and lstm. The JAX package scans the padded time axis with `lax.scan`; here
the whole-sequence ops loop over it in Python, one step's products a time.
Their grads are derived by replay (ops/registry.py): autograd through the
loop, which recomputes the forward (XLA shares it through CSE).
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
