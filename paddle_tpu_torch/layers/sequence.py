"""Sequence and beam-search layers on the padding contract (the JAX
package's layers/sequence.py): ragged inputs are [B, T, ...] plus an
explicit `length` tensor. Each appends the same op, slots and attrs as its
namesake there. The other sequence layers (sequence_conv, sequence_slice,
sequence_scatter, sequence_expand_as, sequence_enumerate,
sequence_reshape, sequence_topk_avg_pooling) are not ported yet (ROADMAP
Queue 1, book models, nets, control flow, io and inference)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    "sequence_mask",
    "sequence_pad",
    "sequence_unpad",
    "sequence_pool",
    "sequence_reverse",
    "sequence_expand",
    "sequence_softmax",
    "sequence_concat",
    "sequence_first_step",
    "sequence_last_step",
    "beam_search",
    "beam_search_decode",
    "gru_unit",
    "dynamic_gru",
    "dynamic_lstm",
]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """lengths [B] -> mask [B, maxlen]; maxlen must be a static int."""
    if maxlen is None or (hasattr(maxlen, "shape")):
        raise ValueError(
            "sequence_mask needs a static int maxlen — pass the padded "
            "time extent")
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "sequence_mask", {"X": [x]}, {"Y": [out]},
        {"maxlen": int(maxlen), "out_dtype": dtype})
    return out


def sequence_pad(x, pad_value, maxlen=None, length=None, name=None):
    """Set the tail beyond `length` to pad_value; returns (Out, Length)
    (the input is already the padded dense layout)."""
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    ln = helper.create_variable_for_type_inference("int64")
    ins = {"X": [x], "PadValue": [pad_value]}
    if length is not None:
        ins["Length"] = [length]
    helper.append_op("sequence_pad", ins, {"Out": [out], "Length": [ln]},
                     {"padded_length": -1 if maxlen is None else int(maxlen)})
    return out, ln


def sequence_unpad(x, length, name=None):
    """Canonicalize: zero everything beyond `length` (the padded layout
    stays dense)."""
    helper = LayerHelper("sequence_unpad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "sequence_unpad", {"X": [x], "Length": [length]}, {"Out": [out]}, {})
    return out


def sequence_pool(input, pool_type, length=None, name=None):
    """SUM/AVERAGE/SQRT/MAX/LAST/FIRST over the valid region of [B, T, D]
    given `length` [B] (None = full T)."""
    helper = LayerHelper("sequence_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ins = {"X": [input]}
    if length is not None:
        ins["Length"] = [length]
    helper.append_op("sequence_pool", ins, {"Out": [out]},
                     {"pooltype": str(pool_type).upper()})
    return out


def sequence_first_step(input, length=None):
    return sequence_pool(input, "FIRST", length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "LAST", length)


def sequence_reverse(x, length=None, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    ins = {"X": [x]}
    if length is not None:
        ins["Length"] = [length]
    helper.append_op("sequence_reverse", ins, {"Y": [out]}, {})
    return out


def sequence_expand(x, times, name=None):
    """Repeat each row `times` times along axis 0: the beam layout."""
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sequence_expand", {"X": [x]}, {"Out": [out]},
                     {"times": int(times)})
    return out


def sequence_softmax(input, length=None, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ins = {"X": [input]}
    if length is not None:
        ins["Length"] = [length]
    helper.append_op("sequence_softmax", ins, {"Out": [out]}, {})
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("sequence_concat", {"X": list(input)}, {"Out": [out]}, {})
    return out


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                is_first_step=False, name=None):
    """One beam step. Returns (selected_ids [BW,1], selected_scores [BW,1],
    parent_idx [BW])."""
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_variable_for_type_inference("int64")
    sel_scores = helper.create_variable_for_type_inference(scores.dtype)
    parent = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "beam_search",
        {"pre_ids": [pre_ids], "pre_scores": [pre_scores],
         "ids": [ids], "scores": [scores]},
        {"selected_ids": [sel_ids], "selected_scores": [sel_scores],
         "parent_idx": [parent]},
        {"beam_size": int(beam_size), "end_id": int(end_id),
         "is_first_step": bool(is_first_step)})
    return sel_ids, sel_scores, parent


def beam_search_decode(ids, parent_idx, scores, end_id, name=None):
    """Backtrack stacked per-step (ids, parents) -> full hypotheses.
    ids/parent_idx/scores: [T, BW]."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent = helper.create_variable_for_type_inference("int64")
    sscores = helper.create_variable_for_type_inference(scores.dtype)
    helper.append_op(
        "beam_search_decode",
        {"Ids": [ids], "ParentIdx": [parent_idx], "Scores": [scores]},
        {"SentenceIds": [sent], "SentenceScores": [sscores]},
        {"end_id": int(end_id)})
    return sent, sscores


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, origin_mode=False,
                name=None):
    """Whole-sequence GRU. input: [B, T, 3*size] pre-projected; returns
    hidden [B, T, size]. The weight is [size, 3*size], gates (u, r, c)."""
    helper = LayerHelper("dynamic_gru", name=name)
    dtype = input.dtype
    weight = helper.create_parameter(
        attr=param_attr, shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(
        attr=bias_attr, shape=[1, 3 * size], dtype=dtype, is_bias=True)
    ins = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        ins["H0"] = [h_0]
    hidden = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "gru", ins, {"Hidden": [hidden]},
        {"is_reverse": bool(is_reverse),
         "gate_activation": gate_activation,
         "activation": candidate_activation,
         "origin_mode": bool(origin_mode)})
    return hidden


def dynamic_lstm(input, size, param_attr=None, bias_attr=None,
                 is_reverse=False, gate_activation="sigmoid",
                 cell_activation="tanh", candidate_activation="tanh",
                 h_0=None, c_0=None, name=None):
    """Whole-sequence LSTM. input: [B, T, 4*(size//4)] pre-projected; size
    is 4*hidden. Returns (hidden [B,T,H], cell [B,T,H])."""
    H = size // 4
    helper = LayerHelper("dynamic_lstm", name=name)
    dtype = input.dtype
    weight = helper.create_parameter(
        attr=param_attr, shape=[H, 4 * H], dtype=dtype)
    bias = helper.create_parameter(
        attr=bias_attr, shape=[1, 4 * H], dtype=dtype, is_bias=True)
    ins = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        ins["H0"] = [h_0]
    if c_0 is not None:
        ins["C0"] = [c_0]
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "lstm", ins, {"Hidden": [hidden], "Cell": [cell]},
        {"is_reverse": bool(is_reverse),
         "gate_activation": gate_activation,
         "cell_activation": cell_activation,
         "candidate_activation": candidate_activation})
    return hidden, cell


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid", name=None):
    """One GRU step. input: [B, 3*H] (pre-projected x @ W_x), hidden:
    [B, H]. Returns (new_hidden, reset_hidden_pre, gate)."""
    helper = LayerHelper("gru_unit", name=name)
    H = size // 3
    dtype = input.dtype
    weight = helper.create_parameter(
        attr=param_attr, shape=[H, 3 * H], dtype=dtype)
    inputs = {"Input": [input], "HiddenPrev": [hidden], "Weight": [weight]}
    if bias_attr is not False:
        bias = helper.create_parameter(
            attr=bias_attr, shape=[1, 3 * H], dtype=dtype, is_bias=True)
        inputs["Bias"] = [bias]
    new_hidden = helper.create_variable_for_type_inference(dtype)
    reset_pre = helper.create_variable_for_type_inference(dtype)
    gate = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "gru_unit", inputs,
        {"Hidden": [new_hidden], "ResetHiddenPrev": [reset_pre],
         "Gate": [gate]},
        {"activation": activation, "gate_activation": gate_activation})
    return new_hidden, reset_pre, gate
