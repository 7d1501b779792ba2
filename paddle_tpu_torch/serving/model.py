"""Serving program builders: a decoder-only transformer (BERT-base
geometry, causal masking) expressed over ONE weight namespace, op for op as
the JAX package's serving/model.py builds it:

  * `build_prefill_program` — whole-prompt forward (dense causal attention;
    bucket padding on the right is never attended by a real position) that
    also writes each layer's K/V into the paged pool
    (`kv_cache_prefill_write`) and emits the greedy next token of the last
    real position.
  * `build_decode_program` — one ragged decode step: one query token per
    request row, `kv_cache_append` writes its K/V into the row's current
    page slot, `paged_decode_attention` attends over the row's page table,
    argmax emits the next token; padded rows ride the `batch_mask` row mask.
  * `build_window_program` — a window of S query tokens a row whose context
    lives in the pool: its K/V is written at slots Start + s
    (`kv_cache_prefill_write` with Start) and it attends over the pool
    (`paged_prefill_attention`). The suffix prefill past a prefix-cache hit
    and the speculative verify step (S = draft k + 1) share it.
  * `build_cow_program` — copy-on-write: one `kv_cache_copy_page` a layer.
  * `build_full_forward_program` — the dense oracle (no cache, logits at
    every position) that generation is replayed against.

Every parameter name is explicit, so the three programs resolve the SAME
scope entries.
"""
from __future__ import annotations

from dataclasses import dataclass

from .. import layers as L
from ..framework import default_main_program
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .kv_cache import declare_pool_vars, pool_var_names

__all__ = ["DecoderConfig", "decoder_tiny", "build_prefill_program",
           "build_decode_program", "build_window_program",
           "build_cow_program", "build_full_forward_program",
           "apply_tp_annotations"]

# feed names shared by the engine and the programs
TOK_FEED = "sv_tok"
POS_FEED = "sv_pos"
PAGES_FEED = "sv_pages"
LEN_FEED = "sv_len"
START_FEED = "sv_start"      # first global slot of a prefill/verify window
MASK_FEED = "batch_mask"
COW_SRC_FEED = "sv_cow_src"  # copy-on-write: source page id
COW_DST_FEED = "sv_cow_dst"  # copy-on-write: destination page id


@dataclass
class DecoderConfig:
    """Geometry of the served decoder (BERT-base shaped by default)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 3072
    max_position: int = 512
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def decoder_tiny() -> DecoderConfig:
    return DecoderConfig(vocab_size=97, hidden_size=32, num_layers=2,
                         num_heads=2, ffn_size=64, max_position=64)


def _proj(x, size, name, act=None):
    return L.fc(x, size=size, num_flatten_dims=len(x.shape) - 1,
                param_attr=ParamAttr(name=name + ".w"),
                bias_attr=ParamAttr(name=name + ".b"), act=act)


def _ln(x, name):
    return L.layer_norm(x, begin_norm_axis=2,
                        param_attr=ParamAttr(name=name + ".scale"),
                        bias_attr=ParamAttr(name=name + ".bias"))


def _embed(tok, pos, cfg: DecoderConfig):
    emb = L.embedding(tok, size=[cfg.vocab_size, cfg.hidden_size],
                      param_attr=ParamAttr(name="dec.word_emb"),
                      dtype=cfg.dtype)
    pe = L.embedding(pos, size=[cfg.max_position, cfg.hidden_size],
                     param_attr=ParamAttr(name="dec.pos_emb"),
                     dtype=cfg.dtype)
    return _ln(L.elementwise_add(emb, pe), "dec.emb_ln")


def _ffn_block(x, cfg: DecoderConfig, name):
    h = _proj(x, cfg.ffn_size, name + ".ffn.in", act="gelu")
    f = _proj(h, cfg.hidden_size, name + ".ffn.out")
    return _ln(L.elementwise_add(x, f), name + ".ln2")


def _qkv_heads_seq(x, cfg: DecoderConfig, name):
    """[B, S, H] -> q, k, v each [B, nh, S, dh]."""
    nh, dh = cfg.num_heads, cfg.head_dim
    qkv = _proj(x, 3 * cfg.hidden_size, name + ".qkv")
    qkv = L.reshape(qkv, shape=[0, 0, 3, nh, dh])
    qkv = L.transpose(qkv, perm=[2, 0, 3, 1, 4])       # [3, B, nh, S, dh]
    q = L.squeeze(L.slice(qkv, axes=[0], starts=[0], ends=[1]), axes=[0])
    k = L.squeeze(L.slice(qkv, axes=[0], starts=[1], ends=[2]), axes=[0])
    v = L.squeeze(L.slice(qkv, axes=[0], starts=[2], ends=[3]), axes=[0])
    return q, k, v


def _head(x, cfg: DecoderConfig):
    return _proj(x, cfg.vocab_size, "dec.lm_head")


def _greedy(logits_2d):
    return L.argmax(logits_2d, axis=1)


def _layer_names(i: int) -> str:
    return f"dec.layer{i}"


def _prefill_layer(x, i, cfg: DecoderConfig, pages, lens, write_cache: bool):
    name = _layer_names(i)
    q, k, v = _qkv_heads_seq(x, cfg, name + ".mha")
    if write_cache:
        kn, vn = pool_var_names(cfg.num_layers)[i]
        helper = LayerHelper("kv_cache_prefill_write")
        helper.append_op(
            "kv_cache_prefill_write",
            {"KPool": [kn], "VPool": [vn], "K": [k], "V": [v],
             "PageTable": [pages], "Lens": [lens]},
            {"KPoolOut": [kn], "VPoolOut": [vn]}, {})
    ctxv = L.fused_attention(q, k, v, causal=True,
                             sm_scale=cfg.head_dim ** -0.5)
    ctxv = L.reshape(L.transpose(ctxv, perm=[0, 2, 1, 3]),
                     shape=[0, 0, cfg.hidden_size])
    a = _proj(ctxv, cfg.hidden_size, name + ".mha.out")
    x = _ln(L.elementwise_add(x, a), name + ".ln1")
    return _ffn_block(x, cfg, name)


def build_prefill_program(cfg: DecoderConfig, num_pages: int, page_size: int):
    """Build (in the current default main program) the bucketed prefill.

    Feeds: sv_tok/sv_pos [B, S_bucket] int32, sv_pages [B, P] int32,
    sv_len [B] int32 (real prompt lengths; bucket padding past them is never
    written to the cache). Fetches: next token ids [B] (greedy) and the last
    real position's logits [B, V]."""
    tok = L.data(name=TOK_FEED, shape=[cfg.max_position], dtype="int32")
    pos = L.data(name=POS_FEED, shape=[cfg.max_position], dtype="int32")
    pages = L.data(name=PAGES_FEED, shape=[1], dtype="int32")
    lens = L.data(name=LEN_FEED, shape=[], dtype="int32")
    declare_pool_vars(default_main_program().global_block, cfg.num_layers,
                      num_pages, page_size, cfg.num_heads, cfg.head_dim,
                      cfg.dtype)
    x = _embed(tok, pos, cfg)
    for i in range(cfg.num_layers):
        x = _prefill_layer(x, i, cfg, pages, lens, write_cache=True)
    logits = _head(x, cfg)                             # [B, S, V]
    helper = LayerHelper("gather_token_logits")
    last = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op("gather_token_logits",
                     {"X": [logits], "Lens": [lens]}, {"Out": [last]}, {})
    return {"feeds": [TOK_FEED, POS_FEED, PAGES_FEED, LEN_FEED],
            "next_token": _greedy(last), "last_logits": last}


def _window_layer(x, i, cfg: DecoderConfig, pages, start, lens, tp: int):
    """One decoder layer over a window of S query tokens whose context lives
    in the pool: write the window's K/V at slots start + s (s < lens), then
    attend over the pool (cached prefix and fresh window alike)."""
    name = _layer_names(i)
    dh = cfg.head_dim
    q, k, v = _qkv_heads_seq(x, cfg, name + ".mha")
    kn, vn = pool_var_names(cfg.num_layers)[i]
    helper = LayerHelper("kv_cache_prefill_write")
    helper.append_op(
        "kv_cache_prefill_write",
        {"KPool": [kn], "VPool": [vn], "K": [k], "V": [v],
         "PageTable": [pages], "Lens": [lens], "Start": [start]},
        {"KPoolOut": [kn], "VPoolOut": [vn]}, {})
    helper = LayerHelper("paged_prefill_attention")
    att = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "paged_prefill_attention",
        {"Q": [q], "KPool": [kn], "VPool": [vn],
         "PageTable": [pages], "Start": [start]},
        {"Out": [att]}, {"sm_scale": dh ** -0.5, "tp_degree": tp})
    ctxv = L.reshape(L.transpose(att, perm=[0, 2, 1, 3]),
                     shape=[0, 0, cfg.hidden_size])
    a = _proj(ctxv, cfg.hidden_size, name + ".mha.out")
    x = _ln(L.elementwise_add(x, a), name + ".ln1")
    return _ffn_block(x, cfg, name)


def build_window_program(cfg: DecoderConfig, num_pages: int, page_size: int,
                         tp: int = 1):
    """Build (in the current default main program) the windowed forward:
    a suffix prefill past a prefix-cache hit (only the uncached suffix runs
    through the model) and the speculative verify step (S = k + 1 query
    tokens a row, [last token, draft 1..k]).

    Feeds: sv_tok/sv_pos [B, S] int32, sv_pages [B, P] int32, sv_start [B]
    int32 (global slot of window position 0), sv_len [B] int32 (valid local
    window positions; 0 = padded row, writes nothing). Fetches:
    `next_token` [B] (greedy token after local position Lens - 1),
    `last_logits` [B, V], `tokens` [B, S] (greedy token after every window
    position) and `logits` [B, S, V]."""
    tok = L.data(name=TOK_FEED, shape=[cfg.max_position], dtype="int32")
    pos = L.data(name=POS_FEED, shape=[cfg.max_position], dtype="int32")
    pages = L.data(name=PAGES_FEED, shape=[1], dtype="int32")
    start = L.data(name=START_FEED, shape=[], dtype="int32")
    lens = L.data(name=LEN_FEED, shape=[], dtype="int32")
    declare_pool_vars(default_main_program().global_block, cfg.num_layers,
                      num_pages, page_size, cfg.num_heads, cfg.head_dim,
                      cfg.dtype)
    x = _embed(tok, pos, cfg)
    for i in range(cfg.num_layers):
        x = _window_layer(x, i, cfg, pages, start, lens, tp)
    logits = _head(x, cfg)                             # [B, S, V]
    helper = LayerHelper("gather_token_logits")
    last = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op("gather_token_logits",
                     {"X": [logits], "Lens": [lens]}, {"Out": [last]}, {})
    return {"feeds": [TOK_FEED, POS_FEED, PAGES_FEED, START_FEED, LEN_FEED],
            "next_token": _greedy(last),
            "last_logits": last,
            "tokens": L.argmax(logits, axis=2),
            "logits": logits}


def build_cow_program(cfg: DecoderConfig, num_pages: int, page_size: int):
    """Build (in the current default main program) the copy-on-write step:
    one `kv_cache_copy_page` a layer, pool[Dst] := pool[Src] for K and V in
    place. Feeds sv_cow_src/sv_cow_dst [1] int32; fetches nothing (the
    pools are the output)."""
    src = L.data(name=COW_SRC_FEED, shape=[], dtype="int32")
    dst = L.data(name=COW_DST_FEED, shape=[], dtype="int32")
    declare_pool_vars(default_main_program().global_block, cfg.num_layers,
                      num_pages, page_size, cfg.num_heads, cfg.head_dim,
                      cfg.dtype)
    for kn, vn in pool_var_names(cfg.num_layers):
        helper = LayerHelper("kv_cache_copy_page")
        helper.append_op(
            "kv_cache_copy_page",
            {"KPool": [kn], "VPool": [vn], "Src": [src], "Dst": [dst]},
            {"KPoolOut": [kn], "VPoolOut": [vn]}, {})
    return {"feeds": [COW_SRC_FEED, COW_DST_FEED]}


def build_decode_program(cfg: DecoderConfig, num_pages: int, page_size: int,
                         tp: int = 1):
    """Build (in the current default main program) the ragged decode step.

    Feeds: sv_tok [B, 1] int32 (each row's latest token), sv_pos [B] int32
    (the slot that token occupies), sv_pages [B, P] int32, batch_mask [B, 1]
    float32 (0 rows are scheduler padding: their KV write is dropped and
    their token ignored). Fetches: next token ids [B], logits [B, V]."""
    tok = L.data(name=TOK_FEED, shape=[], dtype="int32")
    pos = L.data(name=POS_FEED, shape=[], dtype="int32")
    pages = L.data(name=PAGES_FEED, shape=[1], dtype="int32")
    mask = L.data(name=MASK_FEED, shape=[1], dtype="float32")
    declare_pool_vars(default_main_program().global_block, cfg.num_layers,
                      num_pages, page_size, cfg.num_heads, cfg.head_dim,
                      cfg.dtype)
    nh, dh = cfg.num_heads, cfg.head_dim
    # ids are declared flat [B]; the [B, 1] feed goes through lookup_table's
    # trailing-1 squeeze to [B] ids and a [B, H] embedding; the singleton
    # seq dim reappears after
    emb = L.embedding(tok, size=[cfg.vocab_size, cfg.hidden_size],
                      param_attr=ParamAttr(name="dec.word_emb"),
                      dtype=cfg.dtype)                 # [B, H]
    pe = L.embedding(pos, size=[cfg.max_position, cfg.hidden_size],
                     param_attr=ParamAttr(name="dec.pos_emb"),
                     dtype=cfg.dtype)
    x = L.unsqueeze(L.elementwise_add(emb, pe), axes=[1])   # [B, 1, H]
    x = _ln(x, "dec.emb_ln")
    for i in range(cfg.num_layers):
        name = _layer_names(i)
        qkv = _proj(x, 3 * cfg.hidden_size, name + ".mha.qkv")  # [B, 1, 3H]
        qkv = L.reshape(qkv, shape=[0, 3, nh, dh])
        q = L.squeeze(L.slice(qkv, axes=[1], starts=[0], ends=[1]), axes=[1])
        k = L.squeeze(L.slice(qkv, axes=[1], starts=[1], ends=[2]), axes=[1])
        v = L.squeeze(L.slice(qkv, axes=[1], starts=[2], ends=[3]), axes=[1])
        kn, vn = pool_var_names(cfg.num_layers)[i]
        helper = LayerHelper("kv_cache_append")
        helper.append_op(
            "kv_cache_append",
            {"KPool": [kn], "VPool": [vn], "K": [k], "V": [v],
             "PageTable": [pages], "Positions": [pos], "Mask": [mask]},
            {"KPoolOut": [kn], "VPoolOut": [vn]}, {})
        helper = LayerHelper("paged_decode_attention")
        att = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(
            "paged_decode_attention",
            {"Q": [q], "KPool": [kn], "VPool": [vn],
             "PageTable": [pages], "Positions": [pos]},
            {"Out": [att]}, {"sm_scale": dh ** -0.5, "tp_degree": tp})
        a = _proj(L.reshape(att, shape=[0, 1, cfg.hidden_size]),
                  cfg.hidden_size, name + ".mha.out")
        x = _ln(L.elementwise_add(x, a), name + ".ln1")
        x = _ffn_block(x, cfg, name)
    logits = L.squeeze(_head(x, cfg), axes=[1])        # [B, V]
    return {"feeds": [TOK_FEED, POS_FEED, PAGES_FEED, MASK_FEED],
            "next_token": _greedy(logits), "logits": logits}


def build_full_forward_program(cfg: DecoderConfig):
    """The dense no-cache oracle: feeds sv_tok/sv_pos [B, S], fetches the
    logits at every position [B, S, V]. Same weight names as the serving
    programs, so running it in the engine's scope replays generation."""
    tok = L.data(name=TOK_FEED, shape=[cfg.max_position], dtype="int32")
    pos = L.data(name=POS_FEED, shape=[cfg.max_position], dtype="int32")
    x = _embed(tok, pos, cfg)
    for i in range(cfg.num_layers):
        x = _prefill_layer(x, i, cfg, None, None, write_cache=False)
    return {"feeds": [TOK_FEED, POS_FEED], "logits": _head(x, cfg)}


# per-dim mesh-axis layout of the decoder's tp-sharded parameters (the JAX
# package's serving/model.py:328): qkv and ffn-in split their output
# features, the projections back to hidden their input features
_TP_PARAM_LAYOUT = [
    (".mha.qkv.w", (None, "{tp}")), (".mha.qkv.b", ("{tp}",)),
    (".mha.out.w", ("{tp}", None)),
    (".ffn.in.w", (None, "{tp}")), (".ffn.in.b", ("{tp}",)),
    (".ffn.out.w", ("{tp}", None)),
]


def apply_tp_annotations(program, cfg: DecoderConfig, tp: int) -> int:
    """Annotate a built serving program's vars for tensor parallelism over
    the `tp` mesh axis, as the JAX package's serving/model.py:337 does:
    the weights per _TP_PARAM_LAYOUT and the KV pool vars on their heads
    dim. Returns how many vars were annotated. Dims that `tp` does not
    divide are left replicated. The tensor-parallel rewrite
    (parallel/tensor_parallel.py) reads the annotations."""
    from ..parallel.mesh import MODEL_AXIS

    done = 0
    for name, var in program.global_block.vars.items():
        for suffix, spec in _TP_PARAM_LAYOUT:
            if not name.endswith(suffix):
                continue
            axes = tuple(MODEL_AXIS if a == "{tp}" else a for a in spec)
            if all(a is None or (var.shape[d] % tp == 0)
                   for d, a in enumerate(axes)):
                var.sharding = axes
                done += 1
        if name.startswith("kv_cache.") and cfg.num_heads % tp == 0:
            var.sharding = (None, None, MODEL_AXIS, None)
            done += 1
    return done
