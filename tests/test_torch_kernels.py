"""The port's kernels (paddle_tpu_torch/ops/cuda_kernels) held against the
JAX package's functions they replace: K1-K3 of the serving path, K4-K7 of
the BERT training path against jax.vjp of the Pallas kernels' custom
gradients (and the xent kernels against their forward and grad calls), and
K8/K9, the batch-norm apply epilogue of the ResNet training path, against
`bn_apply_act` in both layouts and its six gradients through jax.grad; K2-K9
again on bf16 inputs, as the AMP training steps run them; and #15, the fused
bf16 bottleneck block, against the tool's own kernel body in interpret mode
and its XLA chain.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the JAX reference and against the Pallas kernel run
through the Pallas interpreter (as the JAX package's own tests run it). The
CUDA kernels themselves are held against the plain versions by
tests/test_torch_cuda.py and chip_smoke.py on the card.

Inputs come from numpy seeds. Tolerances: fp32 on both sides with sums
taken in different orders, rtol/atol 2e-5 (the JAX package's own
paged-attention tolerance) unless stated.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import attention_ops as ao
from paddle_tpu.ops.pallas_kernels import attention as psa
from paddle_tpu.ops.pallas_kernels import epilogue as ep
from paddle_tpu.ops.pallas_kernels import paged_attention as ppa
from paddle_tpu.ops.pallas_kernels import short_attention as s128
from paddle_tpu.ops.pallas_kernels import xent as px
from paddle_tpu_torch.ops import attention_ops as tao
from paddle_tpu_torch.ops import cuda_kernels as ck

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _paged_case(lens, ps=4, nh=2, dh=8, num_pages=16, seed=0):
    """A pool filled with noise plus a shuffled page table for `lens`
    (padded table entries 0, as the engine pads them)."""
    B = len(lens)
    P = max(1, max(-(-n // ps) for n in lens))
    rng = np.random.default_rng(seed)
    perm = iter(rng.permutation(num_pages))
    table = np.zeros((B, P), np.int32)
    for b, n in enumerate(lens):
        for p in range(-(-n // ps)):
            table[b, p] = next(perm)
    kp = _rand((num_pages, ps, nh, dh), seed + 1)
    vp = _rand((num_pages, ps, nh, dh), seed + 2)
    q = _rand((B, nh, dh), seed + 3)
    return q, kp, vp, table, np.asarray(lens, np.int32)


# -- K1: paged decode attention ------------------------------------------------

@pytest.mark.parametrize("lens", [[7, 12, 3, 1], [16, 17, 4, 5], [1]])
def test_paged_decode_plain_matches_jax_reference(lens):
    q, kp, vp, table, kl = _paged_case(lens)
    ref = ao._paged_attention_reference(jnp.asarray(q), jnp.asarray(kp),
                                        jnp.asarray(vp), jnp.asarray(table),
                                        jnp.asarray(kl), sm_scale=8 ** -0.5)
    got = ck.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table), _t(kl),
                                    sm_scale=8 ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_paged_decode_plain_matches_pallas_interpret(monkeypatch):
    monkeypatch.setattr(ppa, "INTERPRET", True)
    q, kp, vp, table, kl = _paged_case([7, 12, 3, 1], seed=3)
    ref = ppa.paged_decode_attention(jnp.asarray(q), jnp.asarray(kp),
                                     jnp.asarray(vp), jnp.asarray(table),
                                     jnp.asarray(kl), sm_scale=8 ** -0.5)
    got = ck.paged_decode_attention_plain(_t(q), _t(kp), _t(vp), _t(table),
                                          _t(kl), sm_scale=8 ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_paged_decode_live_rows_ignore_padded_table_entries():
    """Entries past a row's live pages (0 or garbage) never change it."""
    q, kp, vp, table, kl = _paged_case([5, 2], seed=5)
    base = ck.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table), _t(kl))
    wide = np.concatenate([table, np.full((2, 3), 9, np.int32)], axis=1)
    got = ck.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(wide), _t(kl))
    np.testing.assert_allclose(got.numpy(), base.numpy(), **TOL)


# -- K2: causal prefill attention ---------------------------------------------

def _qkv(B, nh, S, dh, seed):
    return tuple(_rand((B, nh, S, dh), seed + i) for i in range(3))


@pytest.mark.parametrize("S", [1, 5, 8, 13, 32, 64])
def test_prefill_plain_matches_short128_interpret(monkeypatch, S):
    monkeypatch.setattr(s128, "INTERPRET", True)
    q, k, v = _qkv(2, 2, S, 8, S)
    ref = s128.short128_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, sm_scale=0.3)
    got = ck.causal_prefill_attention(_t(q), _t(k), _t(v), True, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_prefill_plain_ragged_matches_short128_interpret(monkeypatch):
    """Ragged kv_lens, a fully masked row (kv_len 0) emitting zeros."""
    monkeypatch.setattr(s128, "INTERPRET", True)
    q, k, v = _qkv(3, 2, 16, 8, 11)
    lens = np.asarray([16, 5, 0], np.int32)
    ref = s128.short128_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, sm_scale=0.4,
                                  kv_lens=jnp.asarray(lens))
    got = ck.causal_prefill_attention(_t(q), _t(k), _t(v), True, 0.4,
                                      _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert np.all(got.numpy()[2] == 0)


def test_prefill_plain_matches_short_seq_interpret(monkeypatch):
    monkeypatch.setattr(psa, "INTERPRET", True)
    q, k, v = _qkv(1, 2, 128, 8, 21)
    ref = psa.short_seq_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, sm_scale=0.35)
    got = ck.causal_prefill_attention(_t(q), _t(k), _t(v), True, 0.35)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# the widths the fp32 kernels run: BERT-base's dh 64 at S = 128, and dh 40,
# which they zero-fill to 64; dh 40 also ragged, with a kv_len 0 row
WIDE_CASES = [(1, 64, 128, False, None), (1, 64, 128, True, None),
              (2, 40, 77, True, None), (3, 40, 100, False, [100, 5, 0])]


@pytest.mark.parametrize("B,dh,S,causal,lens", WIDE_CASES)
def test_prefill_plain_matches_short128_interpret_wide(monkeypatch, B, dh, S,
                                                       causal, lens):
    monkeypatch.setattr(s128, "INTERPRET", True)
    q, k, v = _qkv(B, 2, S, dh, 70 + dh)
    kl = None if lens is None else np.asarray(lens, np.int32)
    ref = s128.short128_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        sm_scale=dh ** -0.5, kv_lens=None if kl is None else jnp.asarray(kl))
    got = ck.causal_prefill_attention(_t(q), _t(k), _t(v), causal, dh ** -0.5,
                                      None if kl is None else _t(kl))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("S,causal", [(100, True), (37, False)])
def test_prefill_plain_matches_jax_reference_any_length(S, causal):
    """Lengths outside both TPU kernels' gates (the dense oracle's)."""
    q, k, v = _qkv(1, 2, S, 16, S)
    ref = ao._reference_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, sm_scale=0.25)
    got = ck.causal_prefill_attention(_t(q), _t(k), _t(v), causal, 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# -- K3: layer norm -------------------------------------------------------------

# [R, K] of the layer-norm parity cases: the first keeps its id (the act
# alone); then the widths the CUDA kernels' buckets and vector paths split
# on: BERT's 768, 100 (not a multiple of 8: the scalar path), MAX_K 2048
# and a single column
LN_SHAPES = [(24, 64), (96, 768), (7, 100), (5, 2048), (3, 1)]
LN_CASES = [pytest.param(act, R, K, id=act if (R, K) == LN_SHAPES[0]
                         else f"{act}-{R}x{K}")
            for R, K in LN_SHAPES for act in ("identity", "relu")]


@pytest.mark.parametrize("act,R,K", LN_CASES)
def test_layer_norm_plain_matches_pallas_interpret(monkeypatch, act, R, K):
    monkeypatch.setattr(ep, "INTERPRET", True)
    x, s, b = _rand((R, K), 1), _rand((K,), 2), _rand((K,), 3)
    ref = ep.layer_norm_act(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                            eps=1e-5, act=act)
    y, mean, var = ck.layer_norm_act(_t(x), _t(s), _t(b), 1e-5, act)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), x.mean(-1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), x.var(-1), rtol=1e-4, atol=1e-6)


def test_layer_norm_rejects_unknown_act():
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="act"):
        ck.layer_norm_act(x, torch.ones(4), torch.zeros(4), act="gelu")


def test_wrappers_give_shapes_only_on_meta_tensors():
    """Build-time shape inference runs the ops on meta tensors: the
    wrappers return the output shapes without computing anything."""
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
    out = ck.paged_decode_attention(m(3, 2, 8), m(16, 4, 2, 8), m(16, 4, 2, 8),
                                    m(3, 2, dt=torch.int32), m(3, dt=torch.int32))
    assert out.is_meta and tuple(out.shape) == (3, 2, 8)
    out = ck.causal_prefill_attention(m(1, 2, 5, 8), m(1, 2, 5, 8), m(1, 2, 5, 8))
    assert out.is_meta and tuple(out.shape) == (1, 2, 5, 8)
    y, mean, var = ck.layer_norm_act(m(6, 32), m(32), m(32))
    assert y.is_meta and tuple(mean.shape) == (6,) and tuple(var.shape) == (6,)
    assert all(w.launches == 0 for w in ck.WRAPPERS)


# -- K4: attention backward ------------------------------------------------------

def _vjp(fn, primals, cot):
    _, pull = jax.vjp(fn, *(jnp.asarray(p) for p in primals))
    return [np.asarray(g) for g in pull(jnp.asarray(cot))]


@pytest.mark.parametrize("S,causal", [(8, True), (100, False), (128, True)])
def test_attention_backward_plain_matches_short128_vjp(monkeypatch, S, causal):
    monkeypatch.setattr(s128, "INTERPRET", True)
    q, k, v = _qkv(2, 2, S, 8, 40 + S)
    do = _rand((2, 2, S, 8), 39)
    ref = _vjp(lambda q, k, v: s128.short128_attention(
        q, k, v, causal=causal, sm_scale=0.3), (q, k, v), do)
    got = ck.attention_backward(_t(q), _t(k), _t(v), _t(do), causal, 0.3)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, **TOL)


def test_attention_backward_plain_ragged_matches_short128_vjp(monkeypatch):
    """Ragged kv_lens with a kv_len 0 row: its gradients are all zero."""
    monkeypatch.setattr(s128, "INTERPRET", True)
    q, k, v = _qkv(3, 2, 16, 8, 51)
    do = _rand((3, 2, 16, 8), 50)
    lens = np.asarray([16, 5, 0], np.int32)
    ref = _vjp(lambda q, k, v: s128.short128_attention(
        q, k, v, causal=True, sm_scale=0.4, kv_lens=jnp.asarray(lens)),
        (q, k, v), do)
    got = ck.attention_backward(_t(q), _t(k), _t(v), _t(do), True, 0.4,
                                _t(lens))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, **TOL)
        assert np.all(g.numpy()[2] == 0)


@pytest.mark.parametrize("B,dh,S,causal,lens", WIDE_CASES)
def test_attention_backward_plain_matches_short128_vjp_wide(monkeypatch, B, dh,
                                                            S, causal, lens):
    monkeypatch.setattr(s128, "INTERPRET", True)
    q, k, v = _qkv(B, 2, S, dh, 80 + dh)
    do = _rand((B, 2, S, dh), 79)
    if lens is None:
        fn = lambda q, k, v: s128.short128_attention(  # noqa: E731
            q, k, v, causal=causal, sm_scale=dh ** -0.5)
    else:
        fn = lambda q, k, v: s128.short128_attention(  # noqa: E731
            q, k, v, causal=causal, sm_scale=dh ** -0.5,
            kv_lens=jnp.asarray(lens, jnp.int32))
    ref = _vjp(fn, (q, k, v), do)
    got = ck.attention_backward(_t(q), _t(k), _t(v), _t(do), causal,
                                dh ** -0.5, None if lens is None
                                else torch.tensor(lens, dtype=torch.int32))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, **TOL)
        if lens is not None:
            assert np.all(g.numpy()[2] == 0)


@pytest.mark.parametrize("S", [128, 256])
def test_attention_backward_plain_matches_short_seq_vjp(monkeypatch, S):
    monkeypatch.setattr(psa, "INTERPRET", True)
    q, k, v = _qkv(1, 2, S, 8, 60 + S)
    do = _rand((1, 2, S, 8), 59)
    ref = _vjp(lambda q, k, v: psa.short_seq_attention(
        q, k, v, causal=False, sm_scale=0.35), (q, k, v), do)
    got = ck.attention_backward(_t(q), _t(k), _t(v), _t(do), False, 0.35)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, **TOL)


# -- K5: layer norm backward ------------------------------------------------------

@pytest.mark.parametrize("act,R,K", LN_CASES)
def test_layer_norm_backward_plain_matches_pallas_vjp(monkeypatch, act, R, K):
    """dscale/dbias sum over the R rows: tolerance 1e-4."""
    monkeypatch.setattr(ep, "INTERPRET", True)
    x, s, b = _rand((R, K), 71), 1 + 0.1 * _rand((K,), 72), _rand((K,), 73)
    dy = _rand((R, K), 74)
    ref = _vjp(lambda x, s, b: ep.layer_norm_act(x, s, b, eps=1e-5, act=act),
               (x, s, b), dy)
    got = ck.layer_norm_act_backward(_t(x), _t(s), _t(b), _t(dy), 1e-5, act)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.reshape(g.shape), rtol=1e-4,
                                   atol=1e-4)


# -- K6, K7: softmax cross-entropy ------------------------------------------------

def _xent_case(seed=80, N=64, V=1000):
    """V = 1000 is not a multiple of 128: the TPU kernels pad it to 1024."""
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((N, V))).astype(np.float32)
    lab = rng.integers(0, V, N).astype(np.int32)
    return x, lab, rng.standard_normal(N).astype(np.float32)


def test_softmax_xent_fwd_plain_matches_pallas_and_reference(monkeypatch):
    monkeypatch.setattr(px, "INTERPRET", True)
    x, lab, _ = _xent_case()
    loss, m, lse = ck.softmax_xent_fwd(_t(x), _t(lab))
    for ref in (px.softmax_xent_rows(jnp.asarray(x), jnp.asarray(lab)),
                px.xent_loss_fwd(jnp.asarray(x), jnp.asarray(lab)),
                px.xent_reference(jnp.asarray(x), jnp.asarray(lab))):
        np.testing.assert_allclose(loss.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose((m + lse).numpy(),
                               np.asarray(jax.nn.logsumexp(x, axis=-1)), **TOL)


def _bf16_ulp_of_larger(a, b):
    """One unit in the last place of bf16 (8 significant bits) at the larger
    magnitude of a and b, elementwise."""
    _, e = np.frexp(np.maximum(np.abs(a), np.abs(b)))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("V", [512, 1000, 4097])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_xent_bwd_plain_both_modes_match_pallas(monkeypatch, dtype, V):
    """Without stats: xent_grad (the program path). With the forward's
    saved m/lse: the backward of softmax_xent_rows. V = 512 fills the TPU
    kernels' lanes, 1000 and 4097 are padded (4097 past one 2048-lane
    chunk). fp32 within 2e-5; a bf16 dx is one rounding of fp32 values
    whose exponentials run in another order: within one bf16 unit of the
    larger of the two."""
    monkeypatch.setattr(px, "INTERPRET", True)
    x, lab, g = _xent_case(81, V=V)
    if dtype == "float32":
        xt, xj = _t(x), jnp.asarray(x)
    else:
        xt, xj = _bf(x)
    _, m, lse = ck.softmax_xent_fwd(xt, _t(lab))
    refs = (px.xent_grad(xj, jnp.asarray(lab), jnp.asarray(g)),
            _vjp(lambda x: px.softmax_xent_rows(x, jnp.asarray(lab)),
                 (xj,), g)[0])
    gots = (ck.softmax_xent_bwd(xt, _t(lab), _t(g)),
            ck.softmax_xent_bwd(xt, _t(lab), _t(g), m, lse))
    for got, ref in zip(gots, refs):
        assert got.dtype == xt.dtype and tuple(got.shape) == (64, V)
        ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, **TOL)
        else:
            assert (np.abs(got - ref) <= _bf16_ulp_of_larger(got, ref)).all()
    with pytest.raises(ValueError, match="both"):
        ck.softmax_xent_bwd(xt, _t(lab), _t(g), m)


def test_training_wrappers_give_shapes_only_on_meta_tensors():
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
    dq, dk, dv = ck.attention_backward(*(m(1, 2, 5, 8) for _ in range(4)))
    assert dq.is_meta and tuple(dv.shape) == (1, 2, 5, 8)
    dx, ds, db = ck.layer_norm_act_backward(m(6, 32), m(32), m(32), m(6, 32))
    assert dx.is_meta and tuple(ds.shape) == (32,) == tuple(db.shape)
    loss, mx, lse = ck.softmax_xent_fwd(m(4, 9), m(4, dt=torch.int32))
    assert loss.is_meta and tuple(lse.shape) == (4,)
    assert tuple(ck.softmax_xent_bwd(m(4, 9), m(4, dt=torch.int32),
                                     m(4)).shape) == (4, 9)
    assert all(w.launches == 0 for w in ck.WRAPPERS)


# -- K8/K9: batch-norm apply epilogue, forward and backward --------------------

BN_CASES = [  # (shape, channel_last, act, residual)
    ((2, 3, 4, 16), True, "identity", False),
    ((2, 3, 4, 16), True, "relu", True),
    ((3, 5, 2, 7), True, "relu", False),          # odd C
    ((3, 5, 2, 7), True, "identity", True),
    ((2, 6, 4, 8), False, "identity", False),
    ((2, 6, 4, 8), False, "relu", True),
    ((3, 7, 3, 3), False, "relu", False),         # odd C, rows of 9
    ((3, 7, 3, 3), False, "identity", True),
]


def _bn_case(shape, channel_last, residual, seed=70):
    C = shape[-1] if channel_last else shape[1]
    x = _rand(shape, seed) * 1.5 + 0.3
    scale = 1 + 0.2 * _rand((C,), seed + 1)
    bias = 0.2 * _rand((C,), seed + 2)
    mean = 0.3 * _rand((C,), seed + 3)
    inv = 1.0 / np.sqrt(0.5 + np.abs(_rand((C,), seed + 4)))
    res = _rand(shape, seed + 5) if residual else None
    return x, scale, bias, mean, inv, res, C


def _bn_2d(a, channel_last, C):
    """A 4-D array as the port's kernels take it: [N*H*W, C] or [N*C, H*W]."""
    t = _t(a)
    return t.reshape(-1, C) if channel_last else t.reshape(a.shape[0] * C, -1)


@pytest.mark.parametrize("shape,channel_last,act,residual", BN_CASES)
def test_bn_apply_plain_matches_pallas_interpret(monkeypatch, shape,
                                                 channel_last, act, residual):
    """K8's plain version (through the wrapper, on CPU tensors) against the
    Pallas kernel in interpret mode and against bn_apply_act_reference."""
    monkeypatch.setattr(ep, "INTERPRET", True)
    x, scale, bias, mean, inv, res, C = _bn_case(shape, channel_last, residual)
    mode = "cl" if channel_last else "cr"
    got = ck.bn_apply_act(
        _bn_2d(x, channel_last, C), _t(scale), _t(bias), _t(mean), _t(inv),
        act, None if res is None else _bn_2d(res, channel_last, C), mode)
    got = got.numpy().reshape(shape)
    args = tuple(jnp.asarray(a) for a in (x, scale, bias, mean, inv))
    jres = None if res is None else jnp.asarray(res)
    kern = ep.bn_apply_act(*args, act=act, residual=jres,
                           channel_last=channel_last)
    ref = ep.bn_apply_act_reference(*args, act=act, residual=jres,
                                    channel_last=channel_last)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    if act == "relu":
        assert (got == 0).any() and (got > 0).any()


@pytest.mark.parametrize("shape,channel_last,act,residual", BN_CASES)
def test_bn_apply_backward_plain_matches_pallas_grad(monkeypatch, shape,
                                                     channel_last, act,
                                                     residual):
    """K9's plain version plus `bn_param_grads`: the six gradients (x,
    scale, bias, mean, inv, residual) against jax.grad through the Pallas
    kernel's custom vjp in interpret mode. Sums over up to 45 rows in
    another order: rtol/atol 1e-4."""
    monkeypatch.setattr(ep, "INTERPRET", True)
    x, scale, bias, mean, inv, res, C = _bn_case(shape, channel_last, residual)
    dy = _rand(shape, 80)
    mode = "cl" if channel_last else "cr"
    dx, dres, p1, p2, dscale, dbias = ck.bn_apply_act_backward(
        _bn_2d(x, channel_last, C), _t(scale), _t(bias), _t(mean), _t(inv),
        _bn_2d(dy, channel_last, C), act,
        None if res is None else _bn_2d(res, channel_last, C), mode)
    got = [dx.numpy().reshape(shape),
           *(g.numpy() for g in ck.bn_param_grads(p1, p2, _t(scale), _t(inv)))]
    assert torch.equal(dscale, p2 * _t(inv)) and torch.equal(dbias, p1)
    if residual:
        got.append(dres.numpy().reshape(shape))
    else:
        assert dres is None

    def loss(*a):
        y = ep.bn_apply_act(*a[:5], act=act,
                            residual=a[5] if residual else None,
                            channel_last=channel_last)
        return jnp.sum(y * jnp.asarray(dy))

    args = [jnp.asarray(a) for a in (x, scale, bias, mean, inv)]
    if residual:
        args.append(jnp.asarray(res))
    want = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    assert len(got) == len(want) == (6 if residual else 5)
    for name, g, w in zip(("x", "scale", "bias", "mean", "inv", "residual"),
                          got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_bn_apply_wrappers_check_names_and_give_meta_shapes():
    x = torch.empty((12, 8), device="meta")
    p = torch.empty((8,), device="meta")
    assert ck.bn_apply_act(x, p, p, p, p, "relu", x, "cl").shape == (12, 8)
    dx, dres, *sums = ck.bn_apply_act_backward(x, p, p, p, p, x, "relu", x, "cl",
                                               count=12)
    assert dx.shape == dres.shape == (12, 8) and len(sums) == 4
    assert all(t.shape == (8,) for t in sums)
    c = torch.zeros((12, 8))
    with pytest.raises(ValueError, match="act"):
        ck.bn_apply_act(c, c[0], c[0], c[0], c[0], "gelu")
    with pytest.raises(ValueError, match="mode"):
        ck.bn_apply_act_backward(c, c[0], c[0], c[0], c[0], c, mode="nhwc")



# -- bf16: K2-K9 as the AMP training steps run them -------------------------------
#
# The same JAX functions on bf16 inputs (the Pallas kernels in interpret
# mode, their backwards through jax.vjp) against the port's plain versions
# on bf16 CPU tensors. Both widen to fp32, compute in fp32 and round to bf16
# at the same places; their fp32 sums run in other orders, so a value near
# a rounding boundary may round one bf16 unit (2^-8 relative) apart, and a
# rounded intermediate (P, dS) carries that into the next sum. Tolerances:
# outputs rounded once, 2 bf16 units (rtol 8e-3) plus an absolute floor of
# 1e-2 of the output's max-abs; gradients through rounded intermediates,
# 2e-2 of their max-abs; fp32 outputs from bf16 inputs (the row
# statistics, the loss), fp32 sums of the same values, 1e-5.

BF = jnp.bfloat16


def _bf(a):
    """A numpy array rounded to bf16, as (torch tensor, jax array)."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(a, jnp.float32).astype(BF)


def _close_bf16(got, want, rtol=8e-3, floor=1e-2):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor * scale)


@pytest.mark.parametrize("kernel,S,causal", [("short128", 32, True),
                                             ("short_seq", 128, False)])
def test_bf16_prefill_plain_matches_pallas_interpret(monkeypatch, kernel, S,
                                                     causal):
    mod = s128 if kernel == "short128" else psa
    fn = s128.short128_attention if kernel == "short128" else psa.short_seq_attention
    monkeypatch.setattr(mod, "INTERPRET", True)
    (qt, qj), (kt, kj), (vt, vj) = (_bf(a) for a in _qkv(2, 2, S, 8, 90 + S))
    ref = fn(qj, kj, vj, causal=causal, sm_scale=0.3)
    got = ck.causal_prefill_attention(qt, kt, vt, causal, 0.3)
    assert got.dtype == torch.bfloat16 and ref.dtype == BF
    _close_bf16(got, ref)


@pytest.mark.parametrize("kernel,S,causal", [("short128", 32, True),
                                             ("short_seq", 128, False)])
def test_bf16_attention_backward_plain_matches_pallas_vjp(monkeypatch, kernel,
                                                          S, causal):
    mod = s128 if kernel == "short128" else psa
    fn = s128.short128_attention if kernel == "short128" else psa.short_seq_attention
    monkeypatch.setattr(mod, "INTERPRET", True)
    (qt, qj), (kt, kj), (vt, vj) = (_bf(a) for a in _qkv(2, 2, S, 8, 95 + S))
    dot, doj = _bf(_rand((2, 2, S, 8), 94))
    _, pull = jax.vjp(lambda q, k, v: fn(q, k, v, causal=causal, sm_scale=0.3),
                      qj, kj, vj)
    ref = pull(doj)
    got = ck.attention_backward(qt, kt, vt, dot, causal, 0.3)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16 and r.dtype == BF
        _close_bf16(g, r, rtol=2e-2, floor=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_ragged_short128_plain_matches_pallas_interpret_and_vjp(
        monkeypatch, causal):
    """The masked route in bf16: ragged kv_lens with a kv_len 0 row (zeros
    out, zero gradients) and keys past kv_len (zero dK, dV), forward and
    backward, the oracle bf16 K2/K4 are held to on the card."""
    monkeypatch.setattr(s128, "INTERPRET", True)
    S = 24
    (qt, qj), (kt, kj), (vt, vj) = (_bf(a) for a in _qkv(3, 2, S, 8, 120))
    dot, doj = _bf(_rand((3, 2, S, 8), 119))
    lens = np.asarray([S, 7, 0], np.int32)
    out, pull = jax.vjp(lambda q, k, v: s128.short128_attention(
        q, k, v, causal=causal, sm_scale=0.3, kv_lens=jnp.asarray(lens)),
        qj, kj, vj)
    got = ck.causal_prefill_attention(qt, kt, vt, causal, 0.3, _t(lens))
    _close_bf16(got, out)
    assert np.all(got.float().numpy()[2] == 0)
    grads = ck.attention_backward(qt, kt, vt, dot, causal, 0.3, _t(lens))
    for g, r in zip(grads, pull(doj)):
        assert g.dtype == torch.bfloat16 and r.dtype == BF
        _close_bf16(g, r, rtol=2e-2, floor=2e-2)
        assert np.all(g.float().numpy()[2] == 0)
    for g in grads[1:]:
        assert np.all(g.float().numpy()[1, :, 7:] == 0)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_short_seq_512_plain_matches_pallas_interpret_and_vjp(
        monkeypatch, causal):
    """S = 512, the top of K2/K4's domain, where the CUDA kernels stream
    key tiles, in bf16 through short_seq_attention forward and backward."""
    monkeypatch.setattr(psa, "INTERPRET", True)
    (qt, qj), (kt, kj), (vt, vj) = (_bf(a) for a in _qkv(1, 2, 512, 8, 130))
    dot, doj = _bf(_rand((1, 2, 512, 8), 129))
    out, pull = jax.vjp(lambda q, k, v: psa.short_seq_attention(
        q, k, v, causal=causal, sm_scale=0.35), qj, kj, vj)
    _close_bf16(ck.causal_prefill_attention(qt, kt, vt, causal, 0.35), out)
    grads = ck.attention_backward(qt, kt, vt, dot, causal, 0.35)
    for g, r in zip(grads, pull(doj)):
        assert g.dtype == torch.bfloat16 and r.dtype == BF
        _close_bf16(g, r, rtol=2e-2, floor=2e-2)


@pytest.mark.parametrize("act,R,K", LN_CASES)
def test_bf16_layer_norm_plain_matches_pallas_interpret(monkeypatch, act, R, K):
    monkeypatch.setattr(ep, "INTERPRET", True)
    (xt, xj) = _bf(_rand((R, K), 101))
    s, b = 1 + 0.1 * _rand((K,), 102), 0.1 * _rand((K,), 103)
    ref = ep.layer_norm_act(xj, jnp.asarray(s), jnp.asarray(b), eps=1e-5,
                            act=act)
    y, mean, var = ck.layer_norm_act(xt, _t(s), _t(b), 1e-5, act)
    assert y.dtype == torch.bfloat16 and mean.dtype == torch.float32
    _close_bf16(y, ref)
    xf = np.asarray(xj.astype(jnp.float32))
    np.testing.assert_allclose(mean.numpy(), xf.mean(-1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), xf.var(-1), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("act,R,K", LN_CASES)
def test_bf16_layer_norm_backward_plain_matches_pallas_vjp(monkeypatch, act, R,
                                                          K):
    """dx bf16; dscale/dbias fp32 sums over R rows of fp32 products of the
    same bf16 values: 1e-4."""
    monkeypatch.setattr(ep, "INTERPRET", True)
    (xt, xj), (dyt, dyj) = _bf(_rand((R, K), 104)), _bf(_rand((R, K), 105))
    s, b = 1 + 0.1 * _rand((K,), 106), 0.1 * _rand((K,), 107)
    _, pull = jax.vjp(lambda x, s, b: ep.layer_norm_act(x, s, b, eps=1e-5,
                                                        act=act),
                      xj, jnp.asarray(s), jnp.asarray(b))
    rdx, rds, rdb = pull(dyj)
    dx, ds, db = ck.layer_norm_act_backward(xt, _t(s), _t(b), dyt, 1e-5, act)
    assert dx.dtype == torch.bfloat16 and ds.dtype == torch.float32
    _close_bf16(dx, rdx)
    np.testing.assert_allclose(ds.numpy(), np.asarray(rds).reshape(-1),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(rdb).reshape(-1),
                               rtol=1e-4, atol=1e-4)


def test_bf16_softmax_xent_plain_matches_pallas(monkeypatch):
    """bf16 logits: the loss and statistics are fp32 from the widened
    logits (1e-5); dx is bf16, rounded once (2 bf16 units)."""
    monkeypatch.setattr(px, "INTERPRET", True)
    x, lab, g = _xent_case(82)
    xt, xj = _bf(x)
    loss, m, lse = ck.softmax_xent_fwd(xt, _t(lab))
    ref = px.xent_loss_fwd(xj, jnp.asarray(lab))
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    dx = ck.softmax_xent_bwd(xt, _t(lab), _t(g))
    rdx = px.xent_grad(xj, jnp.asarray(lab), jnp.asarray(g))
    assert dx.dtype == torch.bfloat16 and rdx.dtype == BF
    _close_bf16(dx, rdx)


@pytest.mark.parametrize("shape,channel_last,act,residual",
                         [((2, 3, 4, 16), True, "relu", True),
                          ((3, 5, 2, 7), True, "identity", False),
                          ((2, 6, 4, 8), False, "relu", True)])
def test_bf16_bn_apply_plain_matches_pallas(monkeypatch, shape, channel_last,
                                            act, residual):
    """bf16 x, residual, dy; fp32 parameters. y, dx and dres bf16 (rounded
    once); the parameter gradients fp32 sums over up to 30 rows of the
    same values (1e-4)."""
    monkeypatch.setattr(ep, "INTERPRET", True)
    x, scale, bias, mean, inv, res, C = _bn_case(shape, channel_last, residual,
                                                 seed=110)
    dy = _rand(shape, 111)
    mode = "cl" if channel_last else "cr"
    (xt, xj), (dyt, dyj) = _bf(x), _bf(dy)
    rt, rj = _bf(res) if residual else (None, None)
    two_d = lambda t: (t.reshape(-1, C) if channel_last  # noqa: E731
                       else t.reshape(shape[0] * C, -1))
    params = [jnp.asarray(a) for a in (scale, bias, mean, inv)]
    y = ck.bn_apply_act(two_d(xt), _t(scale), _t(bias), _t(mean), _t(inv),
                        act, None if rt is None else two_d(rt), mode)
    ref = ep.bn_apply_act(xj, *params, act=act, residual=rj,
                          channel_last=channel_last)
    assert y.dtype == torch.bfloat16 and ref.dtype == BF
    _close_bf16(y.reshape(shape), ref)
    dx, dres, p1, p2, _, _ = ck.bn_apply_act_backward(
        two_d(xt), _t(scale), _t(bias), _t(mean), _t(inv), two_d(dyt), act,
        None if rt is None else two_d(rt), mode)

    def f(x, *a):
        return ep.bn_apply_act(x, *a[:4], act=act,
                               residual=a[4] if residual else None,
                               channel_last=channel_last)

    _, pull = jax.vjp(f, xj, *params, *([rj] if residual else []))
    want = pull(dyj)
    _close_bf16(dx.reshape(shape), want[0])
    for g, w in zip(ck.bn_param_grads(p1, p2, _t(scale), _t(inv)), want[1:5]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    if residual:
        assert dres.dtype == torch.bfloat16
        _close_bf16(dres.reshape(shape), want[5])


def test_bf16_wrappers_give_bf16_shapes_on_meta_tensors():
    m = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device="meta")
    assert ck.causal_prefill_attention(*(m(1, 2, 5, 8) for _ in range(3))
                                       ).dtype == torch.bfloat16
    y, mean, _ = ck.layer_norm_act(m(6, 32), m(32, dt=torch.float32),
                                   m(32, dt=torch.float32))
    assert y.dtype == torch.bfloat16 and mean.dtype == torch.float32
    assert ck.bn_apply_act(m(12, 8), *(m(8, dt=torch.float32),) * 4
                           ).dtype == torch.bfloat16
    assert all(w.launches == 0 for w in ck.WRAPPERS)


# -- #15: the fused bottleneck block ---------------------------------------------

def _tool_case(monkeypatch, Bt=2, Ht=8):
    """The tool module with its H and W cut to Ht (its C = 256, M = 64
    kept) and its inputs at B = Bt, as the tool makes them."""
    import tools._rn_pallas_block as tool

    monkeypatch.setattr(tool, "H", Ht)
    monkeypatch.setattr(tool, "W", Ht)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((Bt, Ht, Ht, tool.C), dtype=np.float32) * .01
    w1 = rng.standard_normal((tool.C, tool.M), dtype=np.float32) * .02
    w2 = rng.standard_normal((3, 3, tool.M, tool.M), dtype=np.float32) * .02
    w3 = rng.standard_normal((tool.M, tool.C), dtype=np.float32) * .02
    return tool, [_bf(a) for a in (x, w1, w2, w3)]


def test_bottleneck_plain_matches_the_tools_kernel_in_interpret_mode(
        monkeypatch):
    """The tool's own `kernel` body through pl.pallas_call(interpret=True)
    at B=2, H=W=8: the same bf16 roundings of y1 and y2, fp32 sums in
    another order; 2 bf16 units plus 1e-2 of the max-abs."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    tool, args = _tool_case(monkeypatch)
    Bt, Ht, C, M = 2, 8, tool.C, tool.M
    out = pl.pallas_call(
        tool.kernel, grid=(Bt,),
        in_specs=[pl.BlockSpec((1, Ht, Ht, C), lambda b: (b, 0, 0, 0)),
                  pl.BlockSpec((C, M), lambda b: (0, 0)),
                  pl.BlockSpec((3, 3, M, M), lambda b: (0, 0, 0, 0)),
                  pl.BlockSpec((M, C), lambda b: (0, 0))],
        out_specs=pl.BlockSpec((1, Ht, Ht, C), lambda b: (b, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((Bt, Ht, Ht, C), tool.DT),
        scratch_shapes=[pltpu.VMEM((Ht + 2, Ht + 2, M), tool.DT)],
        interpret=True)(*(j for _, j in args))
    got = ck.bottleneck_block(*(t for t, _ in args))
    assert got.dtype == torch.bfloat16 and got.shape == (Bt, Ht, Ht, C)
    _close_bf16(got, out)
    assert (got.float() > 0).any() and (got.float() == 0).any()


def test_bottleneck_plain_matches_the_tools_xla_block(monkeypatch):
    """The tool's `xla_block` (three bf16 convolutions, whose bf16 outputs
    are rounded before relu as the kernel rounds after it, and whose sums
    run in XLA's order): within 1e-2 of the max-abs, about two bf16 units
    of the largest output (measured 6.0e-3, one unit; the tool's kernel
    itself is 4.5e-3 from it here)."""
    tool, args = _tool_case(monkeypatch)
    ref = np.asarray(tool.xla_block(*(j for _, j in args)).astype(jnp.float32))
    got = ck.bottleneck_block(*(t for t, _ in args)).float().numpy()
    assert float(np.abs(got - ref).max()) <= 1e-2 * float(np.abs(ref).max())


# -- cache writes ---------------------------------------------------------------

def test_kv_cache_append_page_boundary_and_mask_match_jax():
    ps, nh, dh = 4, 2, 8
    table = np.asarray([[5, 2], [3, 6], [1, 7]], np.int32)
    k, v = _rand((3, nh, dh), 0), _rand((3, nh, dh), 1)
    live = np.asarray([[1.0], [0.0], [1.0]], np.float32)
    kp0 = _rand((8, ps, nh, dh), 2)
    vp0 = _rand((8, ps, nh, dh), 3)
    for positions in ([3, 3, 0], [4, 4, 7]):          # slot 4 = next page
        pos = np.asarray(positions, np.int32)
        jk, jv = ao.kv_cache_append_fn(jnp.asarray(kp0), jnp.asarray(vp0),
                                       jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(table), jnp.asarray(pos),
                                       jnp.asarray(live))
        tk, tv = _t(kp0), _t(vp0)
        rk, rv = tao.kv_cache_append_(tk, tv, _t(k), _t(v), _t(table),
                                      _t(pos), _t(live))
        assert rk is tk and rv is tv, "the pools must be updated in place"
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_kv_cache_prefill_write_matches_jax():
    """Page boundaries crossed, bucket padding past each row's length and a
    zero-length row dropped."""
    ps, nh, dh, S = 4, 2, 8, 11
    table = np.asarray([[3, 0, 5], [6, 2, 0], [4, 0, 0]], np.int32)
    lens = np.asarray([11, 6, 0], np.int32)
    k, v = _rand((3, nh, S, dh), 4), _rand((3, nh, S, dh), 5)
    kp0, vp0 = _rand((8, ps, nh, dh), 6), _rand((8, ps, nh, dh), 7)
    jk, jv = ao.kv_cache_prefill_write_fn(
        jnp.asarray(kp0), jnp.asarray(vp0), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(table), jnp.asarray(lens))
    tk, tv = _t(kp0), _t(vp0)
    tao.kv_cache_prefill_write_(tk, tv, _t(k), _t(v), _t(table), _t(lens))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
