"""The port's kernels (paddle_tpu_torch/ops/cuda_kernels) held against the
JAX package's functions they replace: K1-K3 of the serving path, and K4-K7
of the training path against jax.vjp of the Pallas kernels' custom
gradients (and the xent kernels against their forward and grad calls).

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


@pytest.mark.parametrize("S,causal", [(100, True), (37, False)])
def test_prefill_plain_matches_jax_reference_any_length(S, causal):
    """Lengths outside both TPU kernels' gates (the dense oracle's)."""
    q, k, v = _qkv(1, 2, S, 16, S)
    ref = ao._reference_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, sm_scale=0.25)
    got = ck.causal_prefill_attention(_t(q), _t(k), _t(v), causal, 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# -- K3: layer norm -------------------------------------------------------------

@pytest.mark.parametrize("act", ["identity", "relu"])
def test_layer_norm_plain_matches_pallas_interpret(monkeypatch, act):
    monkeypatch.setattr(ep, "INTERPRET", True)
    x, s, b = _rand((24, 64), 1), _rand((64,), 2), _rand((64,), 3)
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

@pytest.mark.parametrize("act", ["identity", "relu"])
def test_layer_norm_backward_plain_matches_pallas_vjp(monkeypatch, act):
    """dscale/dbias sum over the 24 rows: tolerance 1e-4."""
    monkeypatch.setattr(ep, "INTERPRET", True)
    x, s, b = _rand((24, 64), 71), 1 + 0.1 * _rand((64,), 72), _rand((64,), 73)
    dy = _rand((24, 64), 74)
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


def test_softmax_xent_bwd_plain_both_modes_match_pallas(monkeypatch):
    """Without stats: xent_grad (the program path). With the forward's
    saved m/lse: the backward of softmax_xent_rows."""
    monkeypatch.setattr(px, "INTERPRET", True)
    x, lab, g = _xent_case(81)
    _, m, lse = ck.softmax_xent_fwd(_t(x), _t(lab))
    ref = np.asarray(px.xent_grad(jnp.asarray(x), jnp.asarray(lab),
                                  jnp.asarray(g)))
    got = ck.softmax_xent_bwd(_t(x), _t(lab), _t(g))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    ref_rows = _vjp(lambda x: px.softmax_xent_rows(x, jnp.asarray(lab)),
                    (x,), g)[0]
    got = ck.softmax_xent_bwd(_t(x), _t(lab), _t(g), m, lse)
    np.testing.assert_allclose(got.numpy(), ref_rows, **TOL)
    with pytest.raises(ValueError, match="both"):
        ck.softmax_xent_bwd(_t(x), _t(lab), _t(g), m)


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
