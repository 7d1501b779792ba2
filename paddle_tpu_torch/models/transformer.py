"""Transformer encoder and BERT masked-LM pretraining, built with the port's
layers (the JAX package's models/transformer.py :32-237).

Each builder appends the same ops, with the same names, as its namesake in
the JAX package, so `bert_pretrain` plus `Adam.minimize` gives a training
program equal to the JAX package's through `Program.to_dict()`. Tensor
parallelism (`use_tp`) is kept as the `sharding` annotation every
Variable carries: the port runs on one card and never shards, but the
programs stay equal. Attention takes the fused branch only (one
`fused_attention` op: K2 forward, K4 backward). What this slice does not
run raises NotImplementedError naming its ROADMAP item: dropout > 0, an
additive attention bias (`input_mask`), sequence parallelism (`use_sp`)
and the WMT encoder-decoder builders.
"""
from __future__ import annotations

from dataclasses import dataclass

from .. import layers as L
from ..framework import default_main_program
from ..param_attr import ParamAttr

__all__ = ["TransformerConfig", "bert_base", "bert_tiny", "transformer_encoder",
           "bert_pretrain", "multi_head_attention", "positionwise_ffn"]

# the JAX package's mesh-axis names (paddle_tpu/parallel/mesh.py)
MODEL_AXIS = "tp"


@dataclass
class TransformerConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 3072
    max_position: int = 512
    dropout: float = 0.1
    use_tp: bool = True
    use_sp: bool = False
    use_flash_attention: bool = False
    causal: bool = False
    dtype: str = "float32"


def bert_base() -> TransformerConfig:
    return TransformerConfig()


def bert_tiny(use_tp: bool = True, use_sp: bool = False) -> TransformerConfig:
    return TransformerConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                             num_heads=4, ffn_size=128, max_position=64,
                             dropout=0.0, use_tp=use_tp, use_sp=use_sp)


def _check_supported(cfg: TransformerConfig):
    if cfg.dropout:
        raise NotImplementedError(
            f"dropout {cfg.dropout} is not ported yet (ROADMAP Queue 1, "
            f"dropout with a Philox stream); use dropout=0.0")
    if cfg.use_sp:
        raise NotImplementedError(
            "use_sp (sequence parallelism) is not ported yet (ROADMAP Queue "
            "1, parallel and distributed)")


def _annotate(name, spec):
    default_main_program().global_block.var(name).sharding = tuple(spec)


def _fc(x, size, prefix, w_spec=None, b_spec=None, act=None, cfg=None):
    w_name, b_name = prefix + ".w", prefix + ".b"
    out = L.fc(x, size=size, num_flatten_dims=len(x.shape) - 1,
               param_attr=ParamAttr(name=w_name),
               bias_attr=ParamAttr(name=b_name), act=act)
    if cfg is not None and cfg.use_tp:
        if w_spec is not None:
            _annotate(w_name, w_spec)
        if b_spec is not None:
            _annotate(b_name, b_spec)
    return out


def _attn_core(q, k, v, attn_bias, cfg: TransformerConfig, causal, dh):
    """[B,nh,S,dh] x3 -> [B,nh,S,dh] as one fused-attention op."""
    if attn_bias is not None or cfg.dropout:
        raise NotImplementedError(
            "attention with an additive bias or attention-prob dropout is not "
            "ported yet (ROADMAP Queue 1, WMT encoder-decoder / dropout)")
    return L.fused_attention(q, k, v, causal=causal, sm_scale=dh ** -0.5,
                             use_pallas=cfg.use_flash_attention)


def multi_head_attention(x, cfg: TransformerConfig, attn_bias=None,
                         name="attn"):
    """Self-attention with a fused QKV projection, [B,S,H] -> [B,S,H]."""
    S, H = x.shape[-2], cfg.hidden_size
    nh, dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    qkv = _fc(x, 3 * H, name + ".qkv", w_spec=(None, MODEL_AXIS),
              b_spec=(MODEL_AXIS,), cfg=cfg)
    qkv = L.reshape(qkv, shape=[0, S, 3, nh, dh])
    qkv = L.transpose(qkv, perm=[2, 0, 3, 1, 4])  # [3, B, nh, S, dh]
    q = L.squeeze(L.slice(qkv, axes=[0], starts=[0], ends=[1]), axes=[0])
    k = L.squeeze(L.slice(qkv, axes=[0], starts=[1], ends=[2]), axes=[0])
    v = L.squeeze(L.slice(qkv, axes=[0], starts=[2], ends=[3]), axes=[0])
    ctxv = _attn_core(q, k, v, attn_bias, cfg, causal=cfg.causal, dh=dh)
    ctxv = L.transpose(ctxv, perm=[0, 2, 1, 3])
    ctxv = L.reshape(ctxv, shape=[0, S, H])
    return _fc(ctxv, H, name + ".out", w_spec=(MODEL_AXIS, None), cfg=cfg)


def positionwise_ffn(x, cfg: TransformerConfig, name="ffn"):
    h = _fc(x, cfg.ffn_size, name + ".in", w_spec=(None, MODEL_AXIS),
            b_spec=(MODEL_AXIS,), act="gelu", cfg=cfg)
    return _fc(h, cfg.hidden_size, name + ".out", w_spec=(MODEL_AXIS, None),
               cfg=cfg)


def _encoder_layer(x, cfg: TransformerConfig, attn_bias, name):
    # post-LN, as in BERT
    a = multi_head_attention(x, cfg, attn_bias, name=name + ".mha")
    x = L.layer_norm(L.elementwise_add(x, a), begin_norm_axis=2,
                     name=name + ".ln1")
    f = positionwise_ffn(x, cfg, name=name + ".ffn")
    return L.layer_norm(L.elementwise_add(x, f), begin_norm_axis=2,
                        name=name + ".ln2")


def transformer_encoder(src_ids, pos_ids, cfg: TransformerConfig,
                        input_mask=None, name="encoder"):
    """Token + position embedding -> N encoder layers. Returns [B,S,H]."""
    _check_supported(cfg)
    if input_mask is not None:
        raise NotImplementedError(
            "transformer_encoder with input_mask (an additive attention "
            "bias) is not ported yet (ROADMAP Queue 1, WMT encoder-decoder)")
    emb = L.embedding(src_ids, size=[cfg.vocab_size, cfg.hidden_size],
                      param_attr=ParamAttr(name=name + ".word_emb"),
                      dtype=cfg.dtype)
    pos = L.embedding(pos_ids, size=[cfg.max_position, cfg.hidden_size],
                      param_attr=ParamAttr(name=name + ".pos_emb"),
                      dtype=cfg.dtype)
    x = L.layer_norm(L.elementwise_add(emb, pos), begin_norm_axis=2,
                     name=name + ".emb_ln")
    for i in range(cfg.num_layers):
        x = _encoder_layer(x, cfg, None, name=f"{name}.layer{i}")
    return x


def bert_pretrain(cfg: TransformerConfig, seq_len: int = 128):
    """Masked-LM pretraining program: returns (avg_loss, feeds dict).

    Feeds: src_ids, pos_ids, lm_label [B,S] int64; lm_weight [B,S] float32
    (the loss is the lm_weight-weighted mean of the per-token losses)."""
    _check_supported(cfg)
    src_ids = L.data(name="src_ids", shape=[seq_len], dtype="int64")
    pos_ids = L.data(name="pos_ids", shape=[seq_len], dtype="int64")
    lm_label = L.data(name="lm_label", shape=[seq_len], dtype="int64")
    lm_weight = L.data(name="lm_weight", shape=[seq_len], dtype="float32")

    enc = transformer_encoder(src_ids, pos_ids, cfg)            # [B,S,H]
    logits = _fc(enc, cfg.vocab_size, "lm_head", w_spec=(None, MODEL_AXIS),
                 b_spec=(MODEL_AXIS,), cfg=cfg)                 # [B,S,V]
    label = L.unsqueeze(lm_label, axes=[2])
    loss = L.softmax_with_cross_entropy(logits, label)          # [B,S,1]
    loss = L.squeeze(loss, axes=[2])
    weighted = L.elementwise_mul(loss, lm_weight)
    denom = L.elementwise_add(L.reduce_sum(lm_weight),
                              L.fill_constant(shape=[], dtype="float32",
                                              value=1e-6))
    avg_loss = L.elementwise_div(L.reduce_sum(weighted), denom)
    feeds = {"src_ids": src_ids, "pos_ids": pos_ids,
             "lm_label": lm_label, "lm_weight": lm_weight}
    return avg_loss, feeds
