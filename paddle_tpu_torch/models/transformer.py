"""Transformer encoder, BERT masked-LM pretraining and the WMT
encoder-decoder, built with the port's layers (the JAX package's
models/transformer.py).

Each builder appends the same ops, with the same names, as its namesake in
the JAX package, so `bert_pretrain` or `transformer_wmt` plus
`Adam.minimize` gives a training program equal to the JAX package's
through `Program.to_dict()`. Tensor parallelism (`use_tp`) is kept as the
`sharding` annotation every Variable carries, which the tensor-parallel
rewrite reads under `with_data_parallel` (parallel/tensor_parallel.py).
Attention without an additive bias or attention-prob dropout is one
`fused_attention` op (K2 forward, K4 backward); with either it is the
unfused matmul, softmax and dropout ops, as in the JAX package.
Sequence parallelism (`use_sp`) annotates `bert_pretrain`'s four feeds on
(`dp`, `sp`), as the JAX package does: under `with_data_parallel` over a
mesh with an `sp` axis each rank holds its share of every sequence
(parallel/spatial.py).
"""
from __future__ import annotations

import dataclasses

from .. import layers as L
from ..framework import default_main_program
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["TransformerConfig", "bert_base", "bert_tiny", "transformer_encoder",
           "bert_pretrain", "multi_head_attention", "positionwise_ffn",
           "wmt_base", "transformer_wmt", "cross_attention"]

# the JAX package's mesh-axis names (paddle_tpu/parallel/mesh.py)
DATA_AXIS, MODEL_AXIS, SEQ_AXIS = "dp", "tp", "sp"


@dataclasses.dataclass
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
    """[B,nh,Sq,dh] x [B,nh,Sk,dh] x2 -> [B,nh,Sq,dh]: one fused-attention
    op without an additive bias or attention-prob dropout; else scores by
    matmul, the bias added, the causal fused softmax or softmax, dropout,
    and the product with V."""
    if attn_bias is None and not cfg.dropout:
        return L.fused_attention(q, k, v, causal=causal, sm_scale=dh ** -0.5,
                                 use_pallas=cfg.use_flash_attention)
    scores = L.matmul(q, k, transpose_y=True, alpha=dh ** -0.5)
    if attn_bias is not None:
        scores = L.elementwise_add(scores, attn_bias)
    if causal:
        helper = LayerHelper("causal_softmax")
        probs = helper.create_variable_for_type_inference(scores.dtype)
        helper.append_op("softmax_mask_fuse_upper_triangle",
                         {"X": [scores.name]}, {"Out": [probs.name]}, {})
    else:
        probs = L.softmax(scores)
    probs = _dropout(probs, cfg)
    return L.matmul(probs, v)


def _dropout(x, cfg: TransformerConfig):
    if not cfg.dropout:
        return x
    return L.dropout(x, dropout_prob=cfg.dropout,
                     dropout_implementation="upscale_in_train")


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
    h = _dropout(h, cfg)
    return _fc(h, cfg.hidden_size, name + ".out", w_spec=(MODEL_AXIS, None),
               cfg=cfg)


def _encoder_layer(x, cfg: TransformerConfig, attn_bias, name):
    # post-LN, as in BERT
    a = _dropout(multi_head_attention(x, cfg, attn_bias, name=name + ".mha"),
                 cfg)
    x = L.layer_norm(L.elementwise_add(x, a), begin_norm_axis=2,
                     name=name + ".ln1")
    f = _dropout(positionwise_ffn(x, cfg, name=name + ".ffn"), cfg)
    return L.layer_norm(L.elementwise_add(x, f), begin_norm_axis=2,
                        name=name + ".ln2")


# the per-layer outputs of the most recent transformer_encoder build: the
# checkpoint set for RecomputeOptimizer._set_checkpoints. Snapshot it
# (list(...)) right after the build; a second encoder build overwrites it.
last_layer_outputs: list = []


def transformer_encoder(src_ids, pos_ids, cfg: TransformerConfig,
                        input_mask=None, name="encoder"):
    """Token + position embedding -> N encoder layers. Returns [B,S,H]."""
    emb = L.embedding(src_ids, size=[cfg.vocab_size, cfg.hidden_size],
                      param_attr=ParamAttr(name=name + ".word_emb"),
                      dtype=cfg.dtype)
    pos = L.embedding(pos_ids, size=[cfg.max_position, cfg.hidden_size],
                      param_attr=ParamAttr(name=name + ".pos_emb"),
                      dtype=cfg.dtype)
    x = L.layer_norm(L.elementwise_add(emb, pos), begin_norm_axis=2,
                     name=name + ".emb_ln")
    x = _dropout(x, cfg)
    attn_bias = None if input_mask is None else _mask_bias(input_mask)
    last_layer_outputs.clear()
    for i in range(cfg.num_layers):
        x = _encoder_layer(x, cfg, attn_bias, name=f"{name}.layer{i}")
        last_layer_outputs.append(x)
    return x


def _mask_bias(mask):
    """A [B, S] 1/0 mask -> the additive bias [B, 1, 1, S] (-1e9 at 0)."""
    neg = L.scale(L.scale(mask, scale=-1.0, bias=1.0), scale=-1e9)
    return L.unsqueeze(L.unsqueeze(neg, axes=[1]), axes=[1])


def bert_pretrain(cfg: TransformerConfig, seq_len: int = 128):
    """Masked-LM pretraining program: returns (avg_loss, feeds dict).

    Feeds: src_ids, pos_ids, lm_label [B,S] int64; lm_weight [B,S] float32
    (the loss is the lm_weight-weighted mean of the per-token losses)."""
    src_ids = L.data(name="src_ids", shape=[seq_len], dtype="int64")
    pos_ids = L.data(name="pos_ids", shape=[seq_len], dtype="int64")
    lm_label = L.data(name="lm_label", shape=[seq_len], dtype="int64")
    lm_weight = L.data(name="lm_weight", shape=[seq_len], dtype="float32")
    if cfg.use_sp:
        for n in ("src_ids", "pos_ids", "lm_label", "lm_weight"):
            _annotate(n, (DATA_AXIS, SEQ_AXIS))

    enc = transformer_encoder(src_ids, pos_ids, cfg)            # [B,S,H]
    logits = _fc(enc, cfg.vocab_size, "lm_head", w_spec=(None, MODEL_AXIS),
                 b_spec=(MODEL_AXIS,), cfg=cfg)                 # [B,S,V]
    label = L.unsqueeze(lm_label, axes=[2])
    loss = L.softmax_with_cross_entropy(logits, label)          # [B,S,1]
    avg_loss = _weighted_mean(L.squeeze(loss, axes=[2]), lm_weight)
    feeds = {"src_ids": src_ids, "pos_ids": pos_ids,
             "lm_label": lm_label, "lm_weight": lm_weight}
    return avg_loss, feeds


def _weighted_mean(loss, weight):
    """sum(loss * weight) / (sum(weight) + 1e-6)."""
    weighted = L.elementwise_mul(loss, weight)
    denom = L.elementwise_add(L.reduce_sum(weight),
                              L.fill_constant(shape=[], dtype="float32",
                                              value=1e-6))
    return L.elementwise_div(L.reduce_sum(weighted), denom)


# ---------------------------------------------------------------------------
# The encoder-decoder Transformer (WMT en-de)
# ---------------------------------------------------------------------------


def wmt_base() -> TransformerConfig:
    """Transformer-base: 6 + 6 layers, d_model 512, 8 heads, ffn 2048, a
    joint 37k BPE vocab (Vaswani et al., table 3, "base")."""
    return TransformerConfig(vocab_size=37000, hidden_size=512, num_layers=6,
                             num_heads=8, ffn_size=2048, max_position=256,
                             dropout=0.1, use_tp=False)


def cross_attention(x, mem, cfg: TransformerConfig, attn_bias=None,
                    name="xattn"):
    """Encoder-decoder attention: queries from the decoder stream `x`
    [B,St,H], keys and values from the encoder memory `mem` [B,Ss,H]."""
    St, Ss, H = x.shape[-2], mem.shape[-2], cfg.hidden_size
    nh, dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    q = _fc(x, H, name + ".q", w_spec=(None, MODEL_AXIS),
            b_spec=(MODEL_AXIS,), cfg=cfg)
    kv = _fc(mem, 2 * H, name + ".kv", w_spec=(None, MODEL_AXIS),
             b_spec=(MODEL_AXIS,), cfg=cfg)
    q = L.transpose(L.reshape(q, shape=[0, St, nh, dh]), perm=[0, 2, 1, 3])
    kv = L.transpose(L.reshape(kv, shape=[0, Ss, 2, nh, dh]),
                     perm=[2, 0, 3, 1, 4])
    k = L.squeeze(L.slice(kv, axes=[0], starts=[0], ends=[1]), axes=[0])
    v = L.squeeze(L.slice(kv, axes=[0], starts=[1], ends=[2]), axes=[0])
    ctxv = _attn_core(q, k, v, attn_bias, cfg, causal=False, dh=dh)
    ctxv = L.reshape(L.transpose(ctxv, perm=[0, 2, 1, 3]), shape=[0, St, H])
    return _fc(ctxv, H, name + ".out", w_spec=(MODEL_AXIS, None), cfg=cfg)


def _decoder_layer(x, mem, cfg: TransformerConfig, self_bias, cross_bias,
                   name):
    causal_cfg = dataclasses.replace(cfg, causal=True)
    a = _dropout(multi_head_attention(x, causal_cfg, self_bias,
                                      name=name + ".self"), cfg)
    x = L.layer_norm(L.elementwise_add(x, a), begin_norm_axis=2,
                     name=name + ".ln1")
    c = _dropout(cross_attention(x, mem, cfg, cross_bias,
                                 name=name + ".cross"), cfg)
    x = L.layer_norm(L.elementwise_add(x, c), begin_norm_axis=2,
                     name=name + ".ln2")
    f = _dropout(positionwise_ffn(x, cfg, name=name + ".ffn"), cfg)
    return L.layer_norm(L.elementwise_add(x, f), begin_norm_axis=2,
                        name=name + ".ln3")


def _embed_stream(ids, pos_ids, cfg, name, word_emb_name=None):
    """sqrt(H) x the word embedding + the position embedding."""
    emb = L.embedding(ids, size=[cfg.vocab_size, cfg.hidden_size],
                      param_attr=ParamAttr(name=word_emb_name or
                                           name + ".word_emb"),
                      dtype=cfg.dtype)
    pos = L.embedding(pos_ids, size=[cfg.max_position, cfg.hidden_size],
                      param_attr=ParamAttr(name=name + ".pos_emb"),
                      dtype=cfg.dtype)
    x = L.elementwise_add(L.scale(emb, scale=cfg.hidden_size ** 0.5), pos)
    return _dropout(x, cfg)


def transformer_wmt(cfg: TransformerConfig, src_len: int = 128,
                    tgt_len: int = 128, label_smooth_eps: float = 0.1,
                    use_src_mask: bool = False):
    """Training program for WMT translation: returns (avg_loss, feeds).

    Feeds (all [B, len]): src_ids/src_pos int64, tgt_ids/tgt_pos int64 (the
    shifted-right decoder input), tgt_label int64, tgt_weight float32 (0 on
    padding); with `use_src_mask` also src_mask [B, src_len] float32 (1 a
    token, 0 padding), which masks the encoder's self-attention and the
    decoder's cross-attention. The loss is the label-smoothed cross entropy
    (a hard-label one at label_smooth_eps=0) averaged over the tokens
    tgt_weight keeps. Source and target share the word embedding table."""
    src_ids = L.data(name="src_ids", shape=[src_len], dtype="int64")
    src_pos = L.data(name="src_pos", shape=[src_len], dtype="int64")
    tgt_ids = L.data(name="tgt_ids", shape=[tgt_len], dtype="int64")
    tgt_pos = L.data(name="tgt_pos", shape=[tgt_len], dtype="int64")
    tgt_label = L.data(name="tgt_label", shape=[tgt_len], dtype="int64")
    tgt_weight = L.data(name="tgt_weight", shape=[tgt_len], dtype="float32")
    src_bias, extra_feeds = None, []
    if use_src_mask:
        src_mask = L.data(name="src_mask", shape=[src_len], dtype="float32")
        extra_feeds.append(src_mask)
        src_bias = _mask_bias(src_mask)

    mem = _embed_stream(src_ids, src_pos, cfg, "enc", word_emb_name="word_emb")
    for i in range(cfg.num_layers):
        mem = _encoder_layer(mem, cfg, src_bias, name=f"enc.layer{i}")
    x = _embed_stream(tgt_ids, tgt_pos, cfg, "dec", word_emb_name="word_emb")
    for i in range(cfg.num_layers):
        x = _decoder_layer(x, mem, cfg, None, src_bias, name=f"dec.layer{i}")

    logits = _fc(x, cfg.vocab_size, "proj", w_spec=(None, MODEL_AXIS),
                 b_spec=(MODEL_AXIS,), cfg=cfg)                 # [B,St,V]
    if label_smooth_eps:
        soft = L.label_smooth(L.one_hot(tgt_label, cfg.vocab_size),
                              epsilon=label_smooth_eps)
        loss = L.softmax_with_cross_entropy(logits, soft, soft_label=True)
    else:
        loss = L.softmax_with_cross_entropy(
            logits, L.unsqueeze(tgt_label, axes=[2]))
    avg_loss = _weighted_mean(L.squeeze(loss, axes=[2]), tgt_weight)
    feeds = {v.name: v for v in (src_ids, src_pos, tgt_ids, tgt_pos,
                                 tgt_label, tgt_weight, *extra_feeds)}
    return avg_loss, feeds
