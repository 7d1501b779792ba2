"""Attention seq2seq for machine translation, the Fluid book's model (the
JAX package's models/seq2seq.py, same structure and names) on the padding
contract:

  * encoder: embedding -> pre-projection -> the `gru` op (dynamic_gru);
  * train decoder: a StaticRNN stepping the target sequence with dot
    attention over the padded source states, masked by the source lengths
    (sequence_softmax);
  * infer decoder: a While loop over decode steps; each step scores beam
    continuations with the fixed-shape `beam_search` op, gathers the
    decoder state by parent_idx and scatters the step's choices into
    preallocated [T, B*beam] buffers that `beam_search_decode` backtracks.

Batch, beam and the decode length are build-time constants.
"""
from __future__ import annotations

from .. import layers as L
from ..param_attr import ParamAttr

__all__ = ["encoder", "train_model", "infer_model"]


def encoder(src_ids, src_len, dict_size, word_dim=128, hidden_dim=256,
            name="enc"):
    """[B, S] ids + [B] lengths -> [B, S, H] states."""
    emb = L.embedding(src_ids, size=[dict_size, word_dim],
                      param_attr=ParamAttr(name=name + ".emb"))
    proj = L.fc(emb, size=hidden_dim * 3, num_flatten_dims=2,
                param_attr=ParamAttr(name=name + ".proj.w"),
                bias_attr=ParamAttr(name=name + ".proj.b"))
    states = L.dynamic_gru(proj, size=hidden_dim,
                           param_attr=ParamAttr(name=name + ".gru.w"),
                           bias_attr=ParamAttr(name=name + ".gru.b"))
    # zero padded tail so attention sums stay clean
    states = L.sequence_unpad(states, src_len)
    return states


def _attention(h, enc_states, src_len, hidden_dim, name):
    """Dot attention with source-length masking."""
    # h: [B, H]; enc_states: [B, S, H]
    scores = L.reduce_sum(
        L.elementwise_mul(enc_states, L.unsqueeze(h, axes=[1])), dim=-1
    )  # [B, S]
    weights = L.sequence_softmax(scores, length=src_len)
    ctx = L.reduce_sum(
        L.elementwise_mul(enc_states, L.unsqueeze(weights, axes=[2])), dim=1
    )  # [B, H]
    return ctx


def train_model(src_ids, src_len, tgt_in, tgt_out, tgt_len, dict_size,
                word_dim=128, hidden_dim=256, name="s2s"):
    """Teacher-forced training loss.

    tgt_in: [B, T] decoder inputs (<s> w1 ... w_{T-1});
    tgt_out: [B, T] shifted targets; tgt_len: [B] valid lengths.
    """
    enc_states = encoder(src_ids, src_len, dict_size, word_dim, hidden_dim,
                         name=name + ".enc")
    dec_init = L.sequence_last_step(enc_states, length=src_len)  # [B, H]

    emb = L.embedding(tgt_in, size=[dict_size, word_dim],
                      param_attr=ParamAttr(name=name + ".dec.emb"))
    emb_t = L.transpose(emb, perm=[1, 0, 2])  # time-major [T, B, D]

    rnn = L.StaticRNN()
    with rnn.step():
        word = rnn.step_input(emb_t)           # [B, D]
        prev = rnn.memory(init=dec_init)       # [B, H]
        ctx = _attention(prev, enc_states, src_len, hidden_dim,
                         name + ".attn")
        inp = L.concat([word, ctx], axis=1)
        gates = L.fc(inp, size=hidden_dim * 3,
                     param_attr=ParamAttr(name=name + ".dec.in.w"),
                     bias_attr=ParamAttr(name=name + ".dec.in.b"))
        h, _, _ = L.gru_unit(gates, prev, size=hidden_dim * 3,
                             param_attr=ParamAttr(name=name + ".dec.gru.w"),
                             bias_attr=ParamAttr(name=name + ".dec.gru.b"))
        rnn.update_memory(prev, h)
        logits = L.fc(h, size=dict_size,
                      param_attr=ParamAttr(name=name + ".dec.out.w"),
                      bias_attr=ParamAttr(name=name + ".dec.out.b"))
        rnn.step_output(logits)
    logits_t = rnn()                            # [T, B, V]
    logits_bt = L.transpose(logits_t, perm=[1, 0, 2])  # [B, T, V]

    labels = L.unsqueeze(tgt_out, axes=[2])
    loss_bt = L.softmax_with_cross_entropy(logits_bt, labels)  # [B, T, 1]
    loss_bt = L.squeeze(loss_bt, axes=[2])
    mask = L.cast(L.sequence_mask(tgt_len, maxlen=tgt_in.shape[1],
                                  dtype="int64"), "float32")
    denom = L.reduce_sum(mask)
    avg_loss = L.reduce_sum(L.elementwise_mul(loss_bt, mask)) / denom
    return avg_loss


def infer_model(src_ids, src_len, dict_size, word_dim=128, hidden_dim=256,
                beam_size=4, max_len=16, bos_id=0, eos_id=1, name="s2s"):
    """Beam-search decode. Returns
    (sentence_ids [B*beam, max_len], sentence_scores [B*beam])."""
    enc_states = encoder(src_ids, src_len, dict_size, word_dim, hidden_dim,
                         name=name + ".enc")
    dec_init = L.sequence_last_step(enc_states, length=src_len)

    B = src_ids.shape[0]
    if B is None or B < 0:
        raise ValueError("infer_model needs a static batch size")
    BW = B * beam_size

    # beam-expand encoder outputs and state
    enc_beam = L.sequence_expand(enc_states, beam_size)        # [BW, S, H]
    src_len_beam = L.sequence_expand(src_len, beam_size)       # [BW]
    hidden = L.sequence_expand(dec_init, beam_size)            # [BW, H]

    pre_ids = L.fill_constant([BW, 1], "int64", bos_id)
    # first-step trick: every beam of a batch starts identical, so kill all
    # but beam 0 with a -inf initial score (one hypothesis per source)
    live0 = L.fill_constant([B, 1], "float32", 0.0)
    dead = L.fill_constant([B, beam_size - 1], "float32", -1e9)
    pre_scores = L.reshape(L.concat([live0, dead], axis=1), [BW, 1])
    step = L.fill_constant([], "int64", 0)
    ids_buf = L.fill_constant([max_len, BW], "int64", eos_id)
    parent_buf = L.fill_constant([max_len, BW], "int32", 0)
    score_buf = L.fill_constant([max_len, BW], "float32", 0.0)
    max_len_c = L.fill_constant([], "int64", max_len)

    cond = L.less_than(step, max_len_c)
    w = L.While(cond)
    with w.block():
        # lookup_table on [BW, 1] ids yields [BW, D] (fluid's trailing-1
        # LoD convention)
        word = L.embedding(pre_ids, size=[dict_size, word_dim],
                           param_attr=ParamAttr(name=name + ".dec.emb"))
        ctx = _attention(hidden, enc_beam, src_len_beam, hidden_dim,
                         name + ".attn")
        gates = L.fc(L.concat([word, ctx], axis=1), size=hidden_dim * 3,
                     param_attr=ParamAttr(name=name + ".dec.in.w"),
                     bias_attr=ParamAttr(name=name + ".dec.in.b"))
        h, _, _ = L.gru_unit(gates, hidden, size=hidden_dim * 3,
                             param_attr=ParamAttr(name=name + ".dec.gru.w"),
                             bias_attr=ParamAttr(name=name + ".dec.gru.b"))
        logits = L.fc(h, size=dict_size,
                      param_attr=ParamAttr(name=name + ".dec.out.w"),
                      bias_attr=ParamAttr(name=name + ".dec.out.b"))
        logp = L.log(L.softmax(logits))
        top_scores, top_ids = L.topk(logp, k=beam_size)        # [BW, K]

        sel_ids, sel_scores, parent = L.beam_search(
            pre_ids, pre_scores, top_ids, top_scores,
            beam_size=beam_size, end_id=eos_id)
        new_hidden = L.gather(h, parent)                       # [BW, H]

        step_i = L.unsqueeze(L.cast(step, "int32"), axes=[0])  # [1]
        ids_row = L.unsqueeze(L.squeeze(sel_ids, axes=[1]), axes=[0])
        parent_row = L.unsqueeze(parent, axes=[0])
        score_row = L.unsqueeze(L.squeeze(sel_scores, axes=[1]), axes=[0])
        L.assign(L.scatter(ids_buf, step_i, ids_row), ids_buf)
        L.assign(L.scatter(parent_buf, step_i, parent_row), parent_buf)
        L.assign(L.scatter(score_buf, step_i, score_row), score_buf)

        L.assign(sel_ids, pre_ids)
        L.assign(sel_scores, pre_scores)
        L.assign(new_hidden, hidden)
        L.increment(step, value=1)
        L.assign(L.less_than(step, max_len_c), cond)

    sent_ids, sent_scores = L.beam_search_decode(
        ids_buf, parent_buf, score_buf, end_id=eos_id)
    return sent_ids, sent_scores
