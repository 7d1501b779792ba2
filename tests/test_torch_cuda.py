"""The port's CUDA kernels on the card, each held against its plain PyTorch
version (K1-K11 in fp32 and bf16, #15, K12 and K13 in bf16), plus the
wrappers' input checks, the serving engine against its dense oracle and
(prefix cache, copy-on-write and speculation, fp32 and bf16) against the
same engine on the CPU, a
fused_attention past S = 512 on K10/K11 against the CPU, and a bert_tiny
training step (fp32 and AMP) and two resnet_cifar10 training steps against
the same steps run on the CPU (the kernels' plain versions). Every test
needs an NVIDIA GPU and skips without one. The file imports neither jax
nor paddle_tpu, so it also runs on a machine with only PyTorch:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Tolerance: |kernel - plain| <= 1e-5 + 1e-4 |plain| (fp32, TF32 off, sums
in another order); in bf16, two units of the last place (2^-7 relative)
plus a hundredth of the output's max-abs, since a value near a rounding
boundary rounds one unit apart after sums in another order."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import cuda_kernels as ck

# chip_smoke's gates (the bf16 serving gate, bf16 units) are held here too
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(shape, seed, dev):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(dev)


def _paged(dev, lens, ps, nh, dh, num_pages, seed=0):
    rng = np.random.default_rng(seed)
    perm = iter(rng.permutation(num_pages))
    P = max(-(-n // ps) for n in lens)
    table = np.zeros((len(lens), P), np.int32)
    for b, n in enumerate(lens):
        for p in range(-(-n // ps)):
            table[b, p] = next(perm)
    return (_randn((len(lens), nh, dh), seed + 1, dev),
            _randn((num_pages, ps, nh, dh), seed + 2, dev),
            _randn((num_pages, ps, nh, dh), seed + 3, dev),
            torch.from_numpy(table).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("ps,nh,dh", [(16, 12, 64), (4, 2, 8), (8, 3, 40)])
def test_paged_decode_matches_plain(dev, ps, nh, dh):
    args = _paged(dev, [1, ps, ps + 1, 5 * ps + 3, 0, 2], ps, nh, dh, 64)
    got = ck.paged_decode_attention(*args, sm_scale=dh ** -0.5)
    ref = ck.paged_decode_attention_plain(*args, sm_scale=dh ** -0.5)
    live = args[4] > 0
    torch.testing.assert_close(got[live], ref[live], **TOL)
    assert bool((got[~live] == 0).all()), "a kv_len 0 row must emit zeros"


def _paged_spans(dev, ps, nh, dh, num_pages=256, seed=7):
    """Rows of 0, 1, span - 1, span, span + 1 and 5 span + 3 live slots,
    span the kernel's own for this shape, in a table 768 slots wide whose
    padded entries point outside the pool; the first live entry of one row
    is past the pool's end and of another below 0 (both clamp)."""
    from paddle_tpu_torch.ops.cuda_kernels import paged_attention as k1

    P = -(-768 // ps)
    span = k1._plan(6, nh, dh, ps, P)[1]
    lens = [0, 1, span - 1, span, span + 1, 5 * span + 3]
    rng = np.random.default_rng(seed)
    perm = iter(rng.permutation(num_pages))
    table = np.where(rng.random((len(lens), P)) < 0.5, -7, num_pages + 9)
    for b, n in enumerate(lens):
        for p in range(-(-n // ps)):
            table[b, p] = next(perm)
    table[3, 0], table[5, 0] = num_pages + 3, -2
    return span, (_randn((len(lens), nh, dh), seed + 1, dev),
                  _randn((num_pages, ps, nh, dh), seed + 2, dev),
                  _randn((num_pages, ps, nh, dh), seed + 3, dev),
                  torch.from_numpy(table.astype(np.int32)).to(dev),
                  torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("nh,dh", [(12, 64), (2, 8), (3, 40), (4, 128),
                                   (5, 9), (1, 100)])
def test_paged_decode_spans_match_plain_and_repeat(dev, ps, nh, dh):
    """Rows of 0, 1, span - 1, span, span + 1 and more than 4 spans (the
    split-KV items and their merge), padded and out-of-range table
    entries; two calls give the same bits."""
    span, args = _paged_spans(dev, ps, nh, dh)
    got = ck.paged_decode_attention(*args, sm_scale=dh ** -0.5)
    ref = ck.paged_decode_attention_plain(*args, sm_scale=dh ** -0.5)
    torch.testing.assert_close(got[1:], ref[1:], **TOL)
    assert bool((got[0] == 0).all()), "a kv_len 0 row must emit zeros"
    assert torch.equal(got, ck.paged_decode_attention(*args,
                                                      sm_scale=dh ** -0.5))


@pytest.mark.parametrize("nh,dh", [(12, 64), (64, 128), (65, 128),
                                   (96, 128), (1000, 9)])
def test_paged_decode_wide_rows_split_heads(dev, nh, dh):
    """Rows up to nh * dh = 12288: a slot's row wider than shared memory
    holds at a chunk of 4 slots is taken in head groups (the last one
    short; 16-byte copies, and 4-byte ones at dh 9), each against the plain
    version and repeating bit for bit; BERT-base width keeps whole rows."""
    from paddle_tpu_torch.ops.cuda_kernels import paged_attention as k1

    span, args = _paged_spans(dev, 16, nh, dh)
    hg = k1._plan(6, nh, dh, 16, -(-768 // 16))[4]
    assert hg == nh if nh * dh <= 768 else 1 <= hg < nh
    got = ck.paged_decode_attention(*args, sm_scale=dh ** -0.5)
    ref = ck.paged_decode_attention_plain(*args, sm_scale=dh ** -0.5)
    torch.testing.assert_close(got[1:], ref[1:], **TOL)
    assert bool((got[0] == 0).all()), "a kv_len 0 row must emit zeros"
    assert torch.equal(got, ck.paged_decode_attention(*args,
                                                      sm_scale=dh ** -0.5))


def test_paged_decode_one_long_row(dev):
    """chip_smoke's one-long-row case: B=1, 500 slots, BERT-base width."""
    args = _paged(dev, [500], 16, 12, 64, 64)
    torch.testing.assert_close(ck.paged_decode_attention(*args, sm_scale=0.125),
                               ck.paged_decode_attention_plain(*args,
                                                               sm_scale=0.125),
                               **TOL)


# fp32 K2: the serving and training shapes, then the edges of the 64-row
# tiles at padded widths (dh 40 runs on D = 64, dh 100 on D = 128); each
# causal and not, dense and with kv_lens [S, 5, 0] (a kv_len 0 row)
PREFILL_CASES = [(1, 64), (8, 64), (100, 64), (512, 64), (77, 8), (33, 40),
                 (130, 128)]
PREFILL_CASES += [(S, dh) for S in (63, 64, 65, 127, 128, 129, 512)
                  for dh in (40, 64, 128) if (S, dh) not in PREFILL_CASES]


@pytest.mark.parametrize("S,dh", PREFILL_CASES)
def test_prefill_matches_plain(dev, S, dh):
    q, k, v = (_randn((3, 2, S, dh), S + i, dev) for i in range(3))
    lens = torch.tensor([S, min(5, S), 0], dtype=torch.int32, device=dev)
    for causal in (True, False):
        for kl in (None, lens):
            got = ck.causal_prefill_attention(q, k, v, causal, dh ** -0.5, kl)
            ref = ck.causal_prefill_attention_plain(q, k, v, causal,
                                                    dh ** -0.5, kl)
            torch.testing.assert_close(got, ref, **TOL)
            if kl is not None:
                assert bool((got[2] == 0).all()), "a kv_len 0 row emits zeros"


def test_prefill_f32_repeats_bit_for_bit(dev):
    """No atomics: two launches of fp32 K2 on the same inputs agree."""
    q, k, v = (_randn((2, 3, 200, 64), 60 + i, dev) for i in range(3))
    lens = torch.tensor([200, 77], dtype=torch.int32, device=dev)
    for causal in (False, True):
        a = ck.causal_prefill_attention(q, k, v, causal, 0.125, lens)
        b = ck.causal_prefill_attention(q, k, v, causal, 0.125, lens)
        assert torch.equal(a, b)


def test_prefill_ragged_matches_plain(dev):
    q, k, v = (_randn((3, 2, 64, 64), 7 + i, dev) for i in range(3))
    lens = torch.tensor([64, 17, 0], dtype=torch.int32, device=dev)
    got = ck.causal_prefill_attention(q, k, v, True, 0.125, lens)
    ref = ck.causal_prefill_attention_plain(q, k, v, True, 0.125, lens)
    torch.testing.assert_close(got, ref, **TOL)
    assert bool((got[2] == 0).all())


@pytest.mark.parametrize("R,K,act", [(1, 768, "identity"), (512, 768, "relu"),
                                     (7, 100, "identity"), (3, 2048, "identity")])
def test_layer_norm_matches_plain(dev, R, K, act):
    x = _randn((R, K), 1, dev)
    s, b = _randn((K,), 2, dev), _randn((K,), 3, dev)
    for got, ref in zip(ck.layer_norm_act(x, s, b, 1e-5, act),
                        ck.layer_norm_act_plain(x, s, b, 1e-5, act)):
        torch.testing.assert_close(got, ref, **TOL)


# fp32 K4: the training shape, the head kernel (S <= 128, dh <= 64) and the
# query/key pair past it, then the edges of both at padded widths; the
# causal edge cases carry kv_lens [S, 5, 0] (a kv_len 0 row) on either route
BWD_CASES = [(32, 12, 128, 64, False, None), (1, 2, 512, 64, False, None),
             (2, 3, 100, 64, True, None), (3, 2, 77, 40, True, [77, 5, 0]),
             (2, 2, 130, 128, True, None), (2, 2, 1, 8, False, None)]
BWD_IDS = ["32-12-128-64-False-None", "1-2-512-64-False-None",
           "2-3-100-64-True-None", "3-2-77-40-True-lens3",
           "2-2-130-128-True-None", "2-2-1-8-False-None"]
for _S in (63, 64, 65, 127, 128, 129, 512):
    for _dh in (40, 64, 128):
        for _causal in (False, True):
            BWD_CASES.append((3, 2, _S, _dh, _causal,
                              [_S, 5, 0] if _causal else None))
            BWD_IDS.append(f"3-2-{_S}-{_dh}-{_causal}-"
                           f"{'lens' if _causal else 'None'}")


def _backward_case(dev, B, nh, S, dh, lens):
    q, k, v, do = (_randn((B, nh, S, dh), S + i, dev) for i in range(4))
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    return q, k, v, do, kl


@pytest.mark.parametrize("B,nh,S,dh,causal,lens", BWD_CASES, ids=BWD_IDS)
def test_attention_backward_matches_plain(dev, B, nh, S, dh, causal, lens):
    q, k, v, do, kl = _backward_case(dev, B, nh, S, dh, lens)
    got = ck.attention_backward(q, k, v, do, causal, dh ** -0.5, kl)
    ref = ck.attention_backward_plain(q, k, v, do, causal, dh ** -0.5, kl)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **TOL)
    if lens is not None:
        assert all(bool((g[2] == 0).all()) for g in got)


@pytest.mark.parametrize("B,nh,S,dh,causal,lens", [
    (32, 12, 128, 64, False, None), (3, 2, 128, 64, True, [128, 5, 0]),
    (3, 2, 77, 40, True, [77, 5, 0]), (2, 2, 1, 8, False, None)])
def test_attention_backward_pair_matches_plain(dev, B, nh, S, dh, causal,
                                               lens):
    """fp32 K4's query/key pair at shapes the head kernel takes."""
    q, k, v, do, kl = _backward_case(dev, B, nh, S, dh, lens)
    got = ck.attention_backward_pair(q, k, v, do, causal, dh ** -0.5, kl)
    ref = ck.attention_backward_plain(q, k, v, do, causal, dh ** -0.5, kl)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **TOL)
    if lens is not None:
        assert all(bool((g[2] == 0).all()) for g in got)


@pytest.mark.parametrize("S,dh,causal", [(128, 64, False), (512, 128, True)])
def test_attention_backward_f32_repeats_bit_for_bit(dev, S, dh, causal):
    """No atomics: two launches of fp32 K4 (the head kernel and the pair at
    S = 128, the pair at S = 512) on the same inputs agree."""
    q, k, v, do, kl = _backward_case(dev, 2, 3, S, dh, [S, 77])
    for fn in (ck.attention_backward, ck.attention_backward_pair):
        a = fn(q, k, v, do, causal, dh ** -0.5, kl)
        b = fn(q, k, v, do, causal, dh ** -0.5, kl)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("R,K,act", [(4096, 768, "identity"), (37, 768, "relu"),
                                     (7, 100, "identity"), (3, 2048, "relu")])
def test_layer_norm_backward_matches_plain(dev, R, K, act):
    """dscale/dbias sum over R rows in another order: atol 1e-4 at R=4096."""
    x, dy = _randn((R, K), 1, dev), _randn((R, K), 2, dev)
    s, b = 1 + 0.1 * _randn((K,), 3, dev), 0.1 * _randn((K,), 4, dev)
    for got, ref in zip(ck.layer_norm_act_backward(x, s, b, dy, 1e-5, act),
                        ck.layer_norm_act_backward_plain(x, s, b, dy, 1e-5, act)):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("N,V", [(4096, 30522), (64, 1000), (3, 7)])
def test_softmax_xent_matches_plain(dev, N, V):
    x = 3 * _randn((N, V), 5, dev)
    lab = torch.from_numpy(np.random.default_rng(6).integers(
        0, V, N).astype(np.int32)).to(dev)
    g = _randn((N,), 7, dev)
    fwd = ck.softmax_xent_fwd(x, lab)
    for got, ref in zip(fwd, ck.softmax_xent_fwd_plain(x, lab)):
        torch.testing.assert_close(got, ref, **TOL)
    _xent_close(ck.softmax_xent_bwd(x, lab, g),
                ck.softmax_xent_bwd_plain(x, lab, g))
    _xent_close(ck.softmax_xent_bwd(x, lab, g, fwd[1], fwd[2]),
                ck.softmax_xent_bwd_plain(x, lab, g, fwd[1], fwd[2]))


def _xent_close(got, want):
    """K7's dx element by element: its typical element (g / V or less) is
    a thousandth of the one-hot entry that sets the max-abs. fp32 to 1e-4
    relative, bf16 to one unit of its last place (2^-7 |want|), both with a
    floor of a thousandth of the median |want|."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if not want.numel():
        return
    w = want.float()
    a = w.abs()
    typical = float(a.flatten()[::max(1, a.numel() >> 20)].median())
    rtol = 2.0 ** -7 if want.dtype == torch.bfloat16 else 1e-4
    err = (got.float() - w).abs()
    bad = err > rtol * a + 1e-3 * typical
    assert not bool(bad.any()), (int(bad.sum()), float(err.max()), typical)


def _bn_operands(dev, mode, R, row, C, has_res, seed=30):
    x = 1.5 * _randn((R, row), seed, dev) + 0.3
    p = (1 + 0.2 * _randn((C,), seed + 1, dev), 0.2 * _randn((C,), seed + 2, dev),
         0.3 * _randn((C,), seed + 3, dev),
         torch.rsqrt(0.5 + _randn((C,), seed + 4, dev).abs()))
    res = _randn((R, row), seed + 5, dev) if has_res else None
    return x, p, res, _randn((R, row), seed + 6, dev)


# ResNet-50's batch-norm shapes at batch 4 in both layouts, rows that are
# not a multiple of 4 or of the block's strip, and tiny extents
BN_SHAPES = [("cl", 4 * 112 * 112, 64, 64), ("cl", 4 * 56 * 56, 256, 256),
             ("cl", 4 * 7 * 7, 2048, 2048), ("cr", 4 * 256, 3136, 256),
             ("cr", 4 * 2048, 49, 2048), ("cl", 1009, 37, 37),
             ("cl", 5, 16, 16), ("cl", 300, 3, 3), ("cr", 3 * 7, 9, 7),
             ("cr", 6, 1, 3), ("cl", 33, 4100, 4100)]


@pytest.mark.parametrize("act,has_res", [("identity", False), ("relu", False),
                                         ("relu", True), ("identity", True)])
@pytest.mark.parametrize("mode,R,row,C", BN_SHAPES)
def test_bn_apply_matches_plain(dev, mode, R, row, C, act, has_res):
    x, p, res, _ = _bn_operands(dev, mode, R, row, C, has_res)
    torch.testing.assert_close(ck.bn_apply_act(x, *p, act, res, mode),
                               ck.bn_apply_act_plain(x, *p, act, res, mode),
                               **TOL)


@pytest.mark.parametrize("act,has_res", [("identity", False), ("relu", False),
                                         ("relu", True), ("identity", True)])
@pytest.mark.parametrize("mode,R,row,C", BN_SHAPES)
def test_bn_apply_backward_matches_plain(dev, mode, R, row, C, act, has_res):
    """dx and dres elementwise; the two per-channel sums within 1e-4 of
    their max-abs (up to 50176 rows added in another order)."""
    x, p, res, dy = _bn_operands(dev, mode, R, row, C, has_res)
    got = ck.bn_apply_act_backward(x, *p, dy, act, res, mode)
    ref = ck.bn_apply_act_backward_plain(x, *p, dy, act, res, mode)
    torch.testing.assert_close(got[0], ref[0], **TOL)
    if has_res:
        torch.testing.assert_close(got[1], ref[1], **TOL)
    else:
        assert got[1] is None and ref[1] is None
    for g, r in zip(got[2:], ref[2:]):
        assert g.shape == r.shape == (C,)
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,R,row,C,chain", [
    ("cl", 4 * 56 * 56, 256, 256, False), ("cl", 4 * 56 * 56, 256, 256, True),
    ("cl", 4 * 7 * 7, 2048, 2048, True), ("cr", 4 * 256, 3136, 256, True)])
def test_bn_apply_backward_repeats_bit_for_bit(dev, dt, mode, R, row, C,
                                               chain):
    """No atomics: two runs give identical dx, dres, P1, P2, dscale and
    dbias, in the one pass and in the chain mode."""
    x, p, res, dy = _bn_operands(dev, mode, R, row, C, True)
    x, dy, res = x.to(dt), dy.to(dt), res.to(dt)
    count = R * row // C if chain else None
    a = ck.bn_apply_act_backward(x, *p, dy, "relu", res, mode, count)
    b = ck.bn_apply_act_backward(x, *p, dy, "relu", res, mode, count)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_bn_apply_takes_an_unaligned_view(dev):
    """A tensor that starts off 16 bytes takes the one-float path."""
    R, C = 64, 8
    x, p, res, dy = _bn_operands(dev, "cl", R, C, C, True)
    buf = torch.empty(R * C + 1, device=dev)
    xo = buf[1:].view(R, C).copy_(x)
    assert xo.data_ptr() % 16 and xo.is_contiguous()
    torch.testing.assert_close(ck.bn_apply_act(xo, *p, "relu", res, "cl"),
                               ck.bn_apply_act_plain(x, *p, "relu", res, "cl"),
                               **TOL)
    got = ck.bn_apply_act_backward(xo, *p, dy, "relu", res, "cl")
    ref = ck.bn_apply_act_backward_plain(x, *p, dy, "relu", res, "cl")
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


def test_bn_apply_wrappers_reject_what_the_kernels_do_not_take(dev):
    x, p, res, dy = _bn_operands(dev, "cl", 32, 8, 8, True)
    with pytest.raises(ValueError, match="contiguous"):
        ck.bn_apply_act(x.t().contiguous().t(), *p)
    with pytest.raises(TypeError, match="float32"):
        ck.bn_apply_act(x.double(), *p)
    with pytest.raises(TypeError, match="float32"):
        ck.bn_apply_act_backward(x, *p, dy.half())
    with pytest.raises(ValueError, match="residual must have x's shape"):
        ck.bn_apply_act(x, *p, "relu", res[:4])
    with pytest.raises(ValueError, match="dy must have x's shape"):
        ck.bn_apply_act_backward(x, *p, dy[:, :4].contiguous())
    with pytest.raises(ValueError, match="channels do not fit"):
        ck.bn_apply_act(x, *(t[:5].contiguous() for t in p))
    with pytest.raises(ValueError, match="channels do not fit"):
        ck.bn_apply_act(x[:30], *(t[:7].contiguous() for t in p), mode="cr")
    with pytest.raises(ValueError, match="scale's length"):
        ck.bn_apply_act(x, p[0], p[1][:4].contiguous(), p[2], p[3])
    with pytest.raises(ValueError, match="on"):
        ck.bn_apply_act(x, p[0].cpu(), *p[1:])
    with pytest.raises(ValueError, match="rank"):
        ck.bn_apply_act(x[None], *p)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = _randn((4, 8, 64), 0, dev)
    with pytest.raises(ValueError, match="contiguous"):
        ck.causal_prefill_attention(x.transpose(1, 2)[None], x.transpose(1, 2)[None],
                                    x.transpose(1, 2)[None])
    with pytest.raises(TypeError, match="float32"):
        ck.layer_norm_act(x[0].double(), x[0, 0].double(), x[0, 0].double())
    big = _randn((1, 1, 513, 64), 1, dev)
    with pytest.raises(ValueError, match="S <= 512"):
        ck.causal_prefill_attention(big, big, big)
    odd = torch.empty(1 + 8 * 64, device=dev)[1:].view(1, 1, 8, 64)
    with pytest.raises(ValueError, match="16-byte"):
        ck.causal_prefill_attention(odd, odd, odd)
    with pytest.raises(ValueError, match="on"):
        ck.layer_norm_act(x[0], x[0, 0].cpu(), x[0, 0])
    with pytest.raises(ValueError, match="one shape"):
        ck.attention_backward(x[None], x[None], x[None], x[None, :2])
    with pytest.raises(ValueError, match="S <= 512"):
        ck.attention_backward(big, big, big, big)
    with pytest.raises(TypeError, match="int32"):
        ck.softmax_xent_fwd(x[0], torch.zeros(8, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="dy"):
        ck.layer_norm_act_backward(x[0], x[0, 0], x[0, 0], x[0, :4])


def test_launch_counts_move_only_on_launch(dev):
    ck.reset_launch_counts()
    x = _randn((4, 32), 0, dev)
    ck.layer_norm_act(x, x[0], x[1])
    ck.layer_norm_act_plain(x, x[0], x[1])
    ck.layer_norm_act(x.cpu(), x[0].cpu(), x[1].cpu())
    ck.layer_norm_act_backward(x, x[0], x[1], x)
    ck.layer_norm_act_backward_plain(x, x[0], x[1], x)
    assert ck.launch_counts() == {"paged_decode_attention": 0,
                                  "causal_prefill_attention": 0,
                                  "layer_norm_act": 1,
                                  "attention_backward": 0,
                                  "layer_norm_act_backward": 1,
                                  "softmax_xent_fwd": 0,
                                  "softmax_xent_bwd": 0,
                                  "bn_apply_act": 0,
                                  "bn_apply_act_backward": 0,
                                  "bottleneck_block": 0,
                                  "flash_attention_fwd": 0,
                                  "flash_attention_backward": 0,
                                  "attention_probe": 0,
                                  "dma_copy": 0}
    p = (x[0], x[1], x[2], x[3].abs() + 1)
    ck.bn_apply_act(x, *p)
    ck.bn_apply_act_plain(x, *p)
    ck.bn_apply_act(x.cpu(), *(t.cpu() for t in p))
    ck.bn_apply_act_backward(x, *p, x)
    ck.bn_apply_act_backward_plain(x, *p, x)
    counts = ck.launch_counts()
    assert counts["bn_apply_act"] == counts["bn_apply_act_backward"] == 1
    # the chain mode: the sums, the fold and dx in one launch
    ck.bn_apply_act_backward(x, *p, x, count=4)
    ck.bn_apply_act_backward_plain(x, *p, x, count=4)
    assert ck.launch_counts()["bn_apply_act_backward"] == 2
    ck.paged_decode_attention(*_paged(dev, [3, 40], 16, 2, 8, 8))
    ck.paged_decode_attention_plain(*_paged(dev, [3, 40], 16, 2, 8, 8))
    assert ck.launch_counts()["paged_decode_attention"] == 1


def test_engine_matches_dense_oracle_on_gpu(dev):
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.framework import Program, program_guard
    from paddle_tpu_torch.serving import (ServingEngine,
                                          build_full_forward_program,
                                          decoder_tiny)
    from paddle_tpu_torch.serving import model as sv_model

    eng = ServingEngine(decoder_tiny(), page_size=4, pool_pages=64,
                        max_inflight=4)
    assert eng.device.type == "cuda"
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(1, 97, n)] for n in (3, 9, 17)]
    ck.reset_launch_counts()
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run_until_drained()
    counts = ck.launch_counts()
    assert min(counts[k] for k in ("paged_decode_attention",
                                   "causal_prefill_attention",
                                   "layer_norm_act")) > 0
    full = Program()
    with program_guard(full, Program()), unique_name.guard():
        io = build_full_forward_program(eng.cfg)
    for p, rid in zip(prompts, rids):
        seq = list(p)
        for _ in range(6):
            (lg,) = eng._exe.run(
                full, scope=eng._scope, fetch_list=[io["logits"]],
                feed={sv_model.TOK_FEED: np.asarray(seq, np.int32)[None, :],
                      sv_model.POS_FEED: np.arange(len(seq), dtype=np.int32)[None, :]})
            seq.append(int(np.argmax(lg[0, -1])))
        assert eng.result(rid) == seq[len(p):]
    assert eng.leaked_pages() == 0


def test_bert_tiny_step_on_gpu_matches_cpu(dev):
    """One Adam step of bert_tiny through the kernels on the card and
    through their plain versions on the CPU, from the same weights: losses
    before and after the step rtol 1e-4, gradients within 1e-4 of their
    max-abs, and the updated parameters within a hundredth of a step
    (1e-2 lr) wherever the gradient's sign is sure; elsewhere Adam's
    sign-like first step may differ by 2 lr."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import transformer

    lr = 1e-3
    cfg = transformer.bert_tiny(use_tp=False)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        loss, _ = transformer.bert_pretrain(cfg, seq_len=32)
        pt.optimizer.Adam(learning_rate=lr).minimize(loss)
    rng = np.random.default_rng(0)
    feed = {"src_ids": rng.integers(0, cfg.vocab_size, (4, 32)),
            "pos_ids": np.tile(np.arange(32), (4, 1)),
            "lm_label": rng.integers(0, cfg.vocab_size, (4, 32)),
            "lm_weight": np.ones((4, 32), np.float32)}
    names = [p.name for p in main.all_parameters()]
    fetch = [loss.name] + [n + "@GRAD" for n in names]
    gpu, cpu = pt.Scope(), pt.Scope()
    exe_g, exe_c = pt.Executor(), pt.Executor(place="cpu")
    exe_g.run(startup, scope=gpu)
    exe_c.run(startup, scope=cpu)
    for n in names:
        cpu.find_var(n).copy_(gpu.find_var(n).cpu())
    ck.reset_launch_counts()
    got = exe_g.run(main, feed=feed, fetch_list=fetch, scope=gpu)
    counts = ck.launch_counts()
    assert counts["causal_prefill_attention"] == cfg.num_layers
    assert counts["attention_backward"] == cfg.num_layers
    assert counts["layer_norm_act_backward"] == 2 * cfg.num_layers + 1
    assert counts["softmax_xent_fwd"] == counts["softmax_xent_bwd"] == 1
    want = exe_c.run(main, feed=feed, fetch_list=fetch, scope=cpu)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    for n, g, w in zip(names, got[1:], want[1:]):
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, n
        p_g, p_c = gpu.find_var(n).cpu(), cpu.find_var(n)
        diff = (p_g - p_c).abs()
        assert float(diff.max()) <= 2 * lr * 1.01, n
        sure = torch.from_numpy(np.abs(w) > max(2e-4 * scale, 1e-5))
        if bool(sure.any()):
            assert float(diff[sure].max()) <= 1e-2 * lr, n
    (lg,) = exe_g.run(main, feed=feed, fetch_list=[loss], scope=gpu)
    (lc,) = exe_c.run(main, feed=feed, fetch_list=[loss], scope=cpu)
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    assert float(lg) < float(got[0])


def test_resnet_cifar10_two_steps_on_gpu_match_cpu(dev):
    """Two Momentum steps of resnet_cifar10 (the fused program: conv2d_bn
    with act and Residual) through K8/K9 and cuDNN on the card and through
    the plain versions on the CPU, from the same weights, at batch 64.
    Losses rtol 1e-4 and running statistics rtol 1e-4. A relu input within
    rounding of zero is on in one run and off in the other, and every such
    element moves the gradients upstream of it (about ten of twelve million
    do at this size; they moved the stem's gradient by 2.7e-3 of its
    max-abs), so step-1 gradients are held to 1e-2 in relative L2 norm, and
    each parameter's total update over the two steps to 5e-2 in relative L2
    norm (step 2's masks flip too) plus the parameter's own fp32 spacing."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import resnet

    lr = 0.01
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        loss, acc, _ = resnet.resnet_cifar10()
        pt.optimizer.Momentum(lr, 0.9).minimize(loss)
    ops = [op.type for op in main.global_block.ops]
    n_bn = ops.count("conv2d_bn") + ops.count("batch_norm")
    assert n_bn == 21 and "relu" not in ops
    rng = np.random.default_rng(0)
    feed = {"img": rng.standard_normal((64, 3, 32, 32)).astype(np.float32),
            "label": rng.integers(0, 10, (64, 1))}
    names = [p.name for p in main.all_parameters()]
    state = [v.name for v in main.global_block.vars.values()
             if v.persistable and v.name not in names]
    fetch = [loss.name] + [n + "@GRAD" for n in names]
    gpu, cpu = pt.Scope(), pt.Scope()
    exe_g, exe_c = pt.Executor(), pt.Executor(place="cpu")
    exe_g.run(startup, scope=gpu)
    exe_c.run(startup, scope=cpu)
    p0 = {n: gpu.find_var(n).cpu().clone() for n in names}
    for n in names:
        cpu.find_var(n).copy_(p0[n])
    ck.reset_launch_counts()
    got = exe_g.run(main, feed=feed, fetch_list=fetch, scope=gpu)
    counts = ck.launch_counts()
    # K9 runs its chain mode in training: one launch a batch norm
    assert counts["bn_apply_act"] == n_bn
    assert counts["bn_apply_act_backward"] == n_bn
    assert counts["softmax_xent_fwd"] == counts["softmax_xent_bwd"] == 1
    want = exe_c.run(main, feed=feed, fetch_list=fetch, scope=cpu)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    for n, g, w in zip(names, got[1:], want[1:]):
        assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w), n
    (lg,) = exe_g.run(main, feed=feed, fetch_list=[loss], scope=gpu)
    (lc,) = exe_c.run(main, feed=feed, fetch_list=[loss], scope=cpu)
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    assert float(lg) != float(got[0])
    for n in names:
        up_g, up_c = gpu.find_var(n).cpu() - p0[n], cpu.find_var(n) - p0[n]
        spacing = 2.4e-7 * float(p0[n].abs().max()) * up_c.numel() ** 0.5
        assert float(up_c.norm()) > 0, n
        assert float((up_g - up_c).norm()) <= 5e-2 * float(up_c.norm()) + spacing, n
    for n in state:
        if n.endswith(".mean") or n.endswith(".var"):
            torch.testing.assert_close(gpu.find_var(n).cpu(), cpu.find_var(n),
                                       rtol=1e-4, atol=1e-5)


# -- bf16 -----------------------------------------------------------------------

BF = torch.bfloat16


def _close16(got, want, floor=1e-2):
    assert got.dtype == want.dtype == BF
    g, w = got.float(), want.float()
    bound = 2.0 ** -7 * w.abs() + floor * w.abs().max()
    assert bool(((g - w).abs() <= bound).all()), float((g - w).abs().max())


@pytest.mark.parametrize("S,causal,dh,lens", [
    (128, False, 64, None), (100, True, 64, None), (512, False, 64, None),
    (128, True, 64, [100, 0]), (300, False, 64, [250, 0]),
    (77, True, 40, None), (300, False, 40, [170, 300]),
    (128, False, 128, None), (512, True, 128, None),
    (1, False, 64, None), (130, False, 64, None), (130, True, 12, [129, 60])])
def test_bf16_attention_forward_and_backward_match_plain(dev, S, causal, dh,
                                                         lens):
    """Every route of bf16 K2/K4: one block a head (S <= 128) and streamed
    key tiles past it, causal, kv_lens with a kv_len 0 row (zeros out, zero
    gradients), head widths padded to a multiple of 16 (40, 12) and 128."""
    q, k, v, do = (_randn((2, 12, S, dh), i, dev).to(BF) for i in range(4))
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    sc = dh ** -0.5
    out = ck.causal_prefill_attention(q, k, v, causal, sc, kl)
    _close16(out, ck.causal_prefill_attention_plain(q, k, v, causal, sc, kl))
    got = ck.attention_backward(q, k, v, do, causal, sc, kl)
    ref = ck.attention_backward_plain(q, k, v, do, causal, sc, kl)
    for g, r in zip(got, ref):
        _close16(g, r, floor=2e-2)
    if lens is not None and 0 in lens:
        b = lens.index(0)
        assert not out[b].any() and not any(g[b].any() for g in got)


@pytest.mark.parametrize("R,K,act", [(4096, 768, "identity"), (37, 768, "relu")])
def test_bf16_layer_norm_forward_and_backward_match_plain(dev, R, K, act):
    x, dy = _randn((R, K), 5, dev).to(BF), _randn((R, K), 6, dev).to(BF)
    s, b = 1 + 0.1 * _randn((K,), 7, dev), 0.1 * _randn((K,), 8, dev)
    y, m, v = ck.layer_norm_act(x, s, b, 1e-5, act)
    ry, rm, rv = ck.layer_norm_act_plain(x, s, b, 1e-5, act)
    _close16(y, ry)
    torch.testing.assert_close(m, rm, **TOL)
    torch.testing.assert_close(v, rv, **TOL)
    dx, ds, db = ck.layer_norm_act_backward(x, s, b, dy, 1e-5, act)
    rdx, rds, rdb = ck.layer_norm_act_backward_plain(x, s, b, dy, 1e-5, act)
    _close16(dx, rdx)
    torch.testing.assert_close(ds, rds, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(db, rdb, rtol=1e-4, atol=1e-4)


# K3/K5 across their buckets: both sides of K = 256 and 1024, K = 2048 (a
# row over two or four warps), K = 100 (the scalar path); one row, R not a
# multiple of a block's rows, and R past the rows the resident warps hold at
# once (the grid-stride turns, with their barriers past K = 1024); the BERT
# shapes; both dtypes
LN_EDGES = [(R, K, act) for K in (256, 257, 1024, 1025, 2048, 100)
            for R, act in ((1, "identity"), (37, "relu"), (3000, "identity"))]
LN_EDGES += [(4096, 768, "identity"), (16384, 768, "identity")]


def _ln_operands(dev, R, K, dt, seed=40):
    x, dy = _randn((R, K), seed, dev).to(dt), _randn((R, K), seed + 1, dev).to(dt)
    s, b = 1 + 0.1 * _randn((K,), seed + 2, dev), 0.1 * _randn((K,), seed + 3, dev)
    return x, s, b, dy


def _ln_hold(dt, x, s, b, dy, act, ref_x=None):
    """K3 and K5 on x against their plain versions on ref_x (x's values)."""
    ref_x = x if ref_x is None else ref_x
    y, m, v = ck.layer_norm_act(x, s, b, 1e-5, act)
    ry, rm, rv = ck.layer_norm_act_plain(ref_x, s, b, 1e-5, act)
    if dt == BF:
        _close16(y, ry)
    else:
        torch.testing.assert_close(y, ry, **TOL)
    torch.testing.assert_close(m, rm, **TOL)
    torch.testing.assert_close(v, rv, **TOL)
    dx, ds, db = ck.layer_norm_act_backward(x, s, b, dy, 1e-5, act)
    rdx, rds, rdb = ck.layer_norm_act_backward_plain(ref_x, s, b, dy, 1e-5, act)
    if dt == BF:
        _close16(dx, rdx)
    else:
        torch.testing.assert_close(dx, rdx, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ds, rds, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(db, rdb, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("R,K,act", LN_EDGES)
def test_layer_norm_edges_match_plain(dev, R, K, act, dt):
    """dscale/dbias sum R rows in another order: 1e-4."""
    _ln_hold(dt, *_ln_operands(dev, R, K, dt), act)


@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
def test_layer_norm_takes_an_unaligned_view(dev, dt):
    """Rows that start off 16 bytes (a view at an odd storage offset) take
    the scalar instantiation."""
    R, K = 37, 768
    x, s, b, dy = _ln_operands(dev, R, K, dt)
    xo = torch.empty(R * K + 1, dtype=dt, device=dev)[1:].view(R, K).copy_(x)
    assert xo.data_ptr() % 16 and xo.is_contiguous()
    _ln_hold(dt, xo, s, b, dy, "identity", ref_x=x)


@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("R,K,act", [(4096, 768, "identity"), (3000, 2048, "relu"),
                                     (37, 100, "identity")])
def test_layer_norm_backward_repeats_bit_for_bit(dev, R, K, act, dt):
    """dscale/dbias come out of a fixed grid and fixed-order sums, with no
    atomics: two launches give the same bits."""
    x, s, b, _ = _ln_operands(dev, R, K, dt)
    dy = _randn((R, K), 9, dev).to(dt)
    first = ck.layer_norm_act_backward(x, s, b, dy, 1e-5, act)
    again = ck.layer_norm_act_backward(x, s, b, dy, 1e-5, act)
    assert all(torch.equal(u, v) for u, v in zip(first, again))


@pytest.mark.parametrize("N,V", [(4096, 30522), (3, 7)])
def test_bf16_softmax_xent_matches_plain(dev, N, V):
    x = (3 * _randn((N, V), 9, dev)).to(BF)
    lab = torch.randint(0, V, (N,), device=dev, dtype=torch.int32)
    g = _randn((N,), 10, dev)
    for o, r in zip(ck.softmax_xent_fwd(x, lab), ck.softmax_xent_fwd_plain(x, lab)):
        torch.testing.assert_close(o, r, **TOL)
    _xent_close(ck.softmax_xent_bwd(x, lab, g),
                ck.softmax_xent_bwd_plain(x, lab, g))



# K7 at the widths of its designs: one block a row (V <= 8193, and bf16
# 30522), clusters of 2-8 (fp32 30522, 50257, a Llama-3 vocabulary of
# 128256, 262144), the widest staged rows (fp32 458748, bf16 917496: 8
# blocks of 224 KB when a row starts off the 16-byte grid), and past the
# largest cluster's 8 x 224 KB, where a row streams twice (fp32 917496)
XENT_WIDTHS = [1, 7, 1000, 8193, 30522, 50257, 128256, 262144, 458748,
               917496]
XENT_STREAMED = {torch.float32: 458749, BF: 917497}


def _xent_operands(dev, N, V, dt, off=0, seed=60):
    """x [N, V] of dtype dt at element offset `off` of its buffer (a row
    start at each address phase), labels with some outside [0, V), and g
    with a zero."""
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy((3 * rng.standard_normal(N * V + off)).astype(
        np.float32)).to(dev, dt)
    lab = torch.from_numpy(rng.integers(-2, V + 2, N).astype(np.int32)).to(dev)
    g = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev)
    if N:
        g[0] = 0.0
    return buf[off:].view(N, V), lab, g


def _xent_hold(x, lab, g):
    """K7 in both modes against its plain version, and again bit for bit."""
    m = x.float().amax(-1)
    lse = torch.logsumexp(x.float() - m[:, None], -1)
    for stats in ((), (m, lse)):
        got = ck.softmax_xent_bwd(x, lab, g, *stats)
        want = ck.softmax_xent_bwd_plain(x, lab, g, *stats)
        _xent_close(got, want)
        assert torch.equal(got, ck.softmax_xent_bwd(x, lab, g, *stats))


@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("V", XENT_WIDTHS)
def test_softmax_xent_bwd_widths_match_plain_and_repeat(dev, V, dt):
    """Rows past 128256 start at an element offset of 1, off the 16-byte
    grid: the window and so each block's share is then the widest."""
    _xent_hold(*_xent_operands(dev, 33 if V <= 8193 else 8, V, dt,
                               1 if V > 128256 else 0))


@pytest.mark.parametrize("dt,off", [(torch.float32, o) for o in range(4)]
                         + [(BF, o) for o in range(8)],
                         ids=[f"fp32-{o}" for o in range(4)]
                         + [f"bf16-{o}" for o in range(8)])
def test_softmax_xent_bwd_row_phases(dev, dt, off):
    """V = 1001: row starts cycle through every element phase of 16
    bytes, from each phase of the buffer's start."""
    _xent_hold(*_xent_operands(dev, 16, 1001, dt, off))


@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
def test_softmax_xent_bwd_streams_past_the_largest_cluster(dev, dt):
    _xent_hold(*_xent_operands(dev, 2, XENT_STREAMED[dt], dt, 1))


def test_softmax_xent_bwd_takes_no_rows(dev):
    x, lab, g = _xent_operands(dev, 0, 1000, torch.float32)
    before = ck.softmax_xent_bwd.launches
    assert ck.softmax_xent_bwd(x, lab, g).shape == (0, 1000)
    assert ck.softmax_xent_bwd.launches == before


@pytest.mark.parametrize("act,has_res", [("identity", False), ("relu", True)])
@pytest.mark.parametrize("mode,R,row,C", BN_SHAPES)
def test_bf16_bn_apply_forward_and_backward_match_plain(dev, mode, R, row, C,
                                                        act, has_res):
    x, p, res, dy = _bn_operands(dev, mode, R, row, C, has_res)
    x, dy = x.to(BF), dy.to(BF)
    res = None if res is None else res.to(BF)
    _close16(ck.bn_apply_act(x, *p, act, res, mode),
             ck.bn_apply_act_plain(x, *p, act, res, mode))
    got = ck.bn_apply_act_backward(x, *p, dy, act, res, mode)
    ref = ck.bn_apply_act_backward_plain(x, *p, dy, act, res, mode)
    _close16(got[0], ref[0])
    if has_res:
        _close16(got[1], ref[1])
    for g, r in zip(got[2:], ref[2:]):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))


@pytest.mark.parametrize("act,has_res", [("identity", False), ("relu", True)])
@pytest.mark.parametrize("mode,R,row,C", BN_SHAPES)
def test_bn_apply_backward_chain_mode_matches_plain(dev, mode, R, row, C, act,
                                                    has_res):
    """The training backward's statistics chain, its coefficients folded
    on the device from the count M and added in the kernel, in fp32 and
    bf16, against the plain version's; P1, P2, dscale and dbias too. The
    shapes hold a ragged last strip, C % 8 != 0 (the one-element path),
    "cr" mode and fewer rows than the grid's blocks."""
    x, p, res, dy = _bn_operands(dev, mode, R, row, C, has_res)
    M = R * row // C
    for dt in (torch.float32, BF):
        xd, dyd = x.to(dt), dy.to(dt)
        rd = None if res is None else res.to(dt)
        got = ck.bn_apply_act_backward(xd, *p, dyd, act, rd, mode, M)
        ref = ck.bn_apply_act_backward_plain(xd, *p, dyd, act, rd, mode, M)
        if dt == BF:
            _close16(got[0], ref[0])
        else:
            torch.testing.assert_close(got[0], ref[0], rtol=1e-4, atol=1e-4)
        for g, r in zip(got[2:], ref[2:]):
            torch.testing.assert_close(g, r, rtol=1e-4,
                                       atol=1e-4 * float(r.abs().max()))


# #15's shapes: the three the wrapper took before on its one kernel, then
# the wgmma kernel's persistent walk at 147 tiles (not a multiple of the
# card's 132 SMs), at B = 1 with H = 4 (4 tiles) and at C = 128 and 192
# and 64, and the mma.sync kernel past the wgmma kernel's W and C
B15_SHAPES = [(2, 56, 56, 256, 64), (3, 8, 16, 32, 16), (1, 4, 8, 48, 32),
              (3, 56, 56, 256, 64), (1, 4, 56, 256, 64), (5, 12, 40, 128, 64),
              (7, 4, 8, 192, 64), (3, 8, 56, 64, 64), (2, 8, 64, 256, 64),
              (1, 8, 8, 320, 64)]


@pytest.mark.parametrize("scale", ["tool", "unit"])
@pytest.mark.parametrize("shape", B15_SHAPES)
def test_bottleneck_block_matches_plain(dev, shape, scale):
    """The kernel `plan` names (launches counted by route) against the
    plain version, at the tool's inputs and at the unit set (where the
    chain, not the residual, sets the output), and against the library
    chain; two calls give the same bits."""
    from paddle_tpu_torch.ops.cuda_kernels import bottleneck as bb

    x, w1, w2, w3 = bb.inputs(dev, 3, shape, scale)
    ck.reset_launch_counts()
    got = ck.bottleneck_block(x, w1, w2, w3)
    route = bb.plan(shape, bb._sms(dev))["route"]
    assert ck.launch_counts_by_dtype()["bottleneck_block"] == {"bfloat16": 1}
    assert bb.bottleneck_block.launches_by_route == {route: 1}
    _close16(got, ck.bottleneck_block_plain(x, w1, w2, w3))
    assert torch.equal(got, ck.bottleneck_block(x, w1, w2, w3))
    lib = bb.library_chain(x, w1, w2, w3).contiguous()
    torch.cuda.synchronize()
    if scale == "unit":
        _close16(got, lib)
    else:
        assert float((got.float() - lib.float()).abs().max()) \
            <= 2e-2 * float(lib.float().abs().max())


def test_bottleneck_block_past_65535_images(dev):
    """B = 65536 at a narrow shape (the mma.sync kernel, whose grid's y
    stops at 65535 and whose blocks loop over the images past it)."""
    from paddle_tpu_torch.ops.cuda_kernels import bottleneck as bb

    x, w1, w2, w3 = bb.inputs(dev, 4, (65536, 4, 8, 32, 16), "unit")
    got = ck.bottleneck_block(x, w1, w2, w3)
    _close16(got, ck.bottleneck_block_plain(x, w1, w2, w3))


def test_bottleneck_plan_matches_the_library(dev):
    """`plan`'s shared memory of the mma.sync kernel is the C library's."""
    import ctypes
    from paddle_tpu_torch.ops.cuda_kernels import _build
    from paddle_tpu_torch.ops.cuda_kernels import bottleneck as bb

    smem = _build.bind(_build.library("bottleneck_block"),
                       "bottleneck_block_smem_bytes", [ctypes.c_int] * 3)
    wg = _build.bind(_build.library("bottleneck_block"),
                     "bottleneck_block_wg_smem_bytes", [ctypes.c_int])
    for shape in B15_SHAPES + [(1, 4, 200, 512, 128)]:
        p = bb.plan(shape, 132)
        W, C, M = shape[2:]
        if p is not None and p["route"] == "wgmma":
            assert p["smem"] == wg(C // 64)
        else:
            assert (p["smem"] if p else 0) == smem(W, C, M)


def test_bottleneck_block_rejects_what_the_kernel_does_not_take(dev):
    from paddle_tpu_torch.ops.cuda_kernels import bottleneck as bb

    x, w1, w2, w3 = bb.inputs(dev, 0, (1, 8, 8, 32, 16))
    with pytest.raises(TypeError, match="bfloat16"):
        ck.bottleneck_block(x.float(), w1, w2, w3)
    with pytest.raises(ValueError, match="H % 4"):
        ck.bottleneck_block(x[:, :6].contiguous(), w1, w2, w3)
    with pytest.raises(ValueError, match="w1"):
        ck.bottleneck_block(x, w1[:16].contiguous(), w2, w3)
    with pytest.raises(ValueError, match="contiguous"):
        ck.bottleneck_block(x.transpose(1, 2), w1, w2, w3)
    off = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):
        ck.bottleneck_block(off.view(x.shape), w1, w2, w3)
    big = bb.inputs(dev, 0, (1, 4, 200, 512, 128))
    with pytest.raises(ValueError, match="shared memory"):
        ck.bottleneck_block(*big)


def test_launch_counts_by_dtype(dev):
    ck.reset_launch_counts()
    x = _randn((4, 32), 0, dev)
    ck.layer_norm_act(x, x[0], x[1])
    ck.layer_norm_act(x.to(BF), x[0], x[1])
    ck.layer_norm_act(x.to(BF), x[0], x[1])
    ck.layer_norm_act_plain(x.to(BF), x[0], x[1])
    assert ck.launch_counts()["layer_norm_act"] == 3
    assert ck.launch_counts_by_dtype()["layer_norm_act"] == {"float32": 1,
                                                             "bfloat16": 2}
    ck.reset_launch_counts()
    assert all(v == {} for v in ck.launch_counts_by_dtype().values())


def test_bert_tiny_amp_step_on_gpu_matches_cpu(dev):
    """One step of bert_tiny under decorate(Adam) through the bf16 kernels
    on the card and their plain versions on the CPU, from the same weights:
    the loss within 1e-2 relative, every gradient within 5e-2 in relative
    L2 (bf16 products on cuBLAS and on the CPU round their sums apart),
    launches by dtype as the program's var dtypes say, fp32 master weights
    and gradients."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.models import transformer

    cfg = transformer.bert_tiny(use_tp=False)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        loss, _ = transformer.bert_pretrain(cfg, seq_len=32)
        amp.decorate(pt.optimizer.Adam(learning_rate=1e-3)).minimize(loss)
    rng = np.random.default_rng(0)
    feed = {"src_ids": rng.integers(0, cfg.vocab_size, (4, 32)),
            "pos_ids": np.tile(np.arange(32), (4, 1)),
            "lm_label": rng.integers(0, cfg.vocab_size, (4, 32)),
            "lm_weight": np.ones((4, 32), np.float32)}
    names = [p.name for p in main.all_parameters()]
    fetch = [loss.name] + [n + "@GRAD" for n in names]
    gpu, cpu = pt.Scope(), pt.Scope()
    exe_g, exe_c = pt.Executor(), pt.Executor(place="cpu")
    exe_g.run(startup, scope=gpu)
    exe_c.run(startup, scope=cpu)
    for n in names:
        cpu.find_var(n).copy_(gpu.find_var(n).cpu())
    ck.reset_launch_counts()
    got = exe_g.run(main, feed=feed, fetch_list=fetch, scope=gpu)
    counts = ck.launch_counts_by_dtype()
    L = cfg.num_layers
    assert counts["causal_prefill_attention"] == {"bfloat16": L}
    assert counts["attention_backward"] == {"bfloat16": L}
    assert counts["layer_norm_act"] == {"float32": 1, "bfloat16": 2 * L}
    assert counts["layer_norm_act_backward"] == {"float32": 1, "bfloat16": 2 * L}
    assert counts["softmax_xent_fwd"] == counts["softmax_xent_bwd"] == {"bfloat16": 1}
    want = exe_c.run(main, feed=feed, fetch_list=fetch, scope=cpu)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-2)
    for n, g, w in zip(names, got[1:], want[1:]):
        assert g.dtype == np.float32 and gpu.find_var(n).dtype == torch.float32
        assert np.linalg.norm(g - w) <= 5e-2 * np.linalg.norm(w), n


WMT_TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                ffn_size=128, max_position=64, dropout=0.0, use_tp=False)


@pytest.mark.parametrize("amp_on,src_len", [(False, 16), (True, 16),
                                            (True, 24)],
                         ids=["fp32", "amp", "amp_src24"])
def test_wmt_tiny_step_on_gpu_matches_cpu(dev, amp_on, src_len):
    """One step of transformer_wmt at bench_wmt's CPU widths (label
    smoothing 0.1) on the card and on the CPU from the same weights: K2/K4
    three times a layer pair (twice when src_len != tgt_len: the
    cross-attention then takes the composed arm), K3/K5 five times, no
    cross entropy kernel (soft labels); the loss and every gradient as the
    bert_tiny step holds them (fp32: 1e-4; AMP: 1e-2 and 5e-2 in relative
    L2)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig(**WMT_TINY)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        loss, _ = transformer.transformer_wmt(cfg, src_len=src_len,
                                              tgt_len=16)
        opt = pt.optimizer.Adam(learning_rate=1e-3)
        (amp.decorate(opt) if amp_on else opt).minimize(loss)
    rng = np.random.default_rng(0)
    feed = {"src_ids": rng.integers(0, 256, (4, src_len)),
            "src_pos": np.tile(np.arange(src_len), (4, 1)),
            "tgt_ids": rng.integers(0, 256, (4, 16)),
            "tgt_pos": np.tile(np.arange(16), (4, 1)),
            "tgt_label": rng.integers(0, 256, (4, 16)),
            "tgt_weight": np.ones((4, 16), np.float32)}
    names = [p.name for p in main.all_parameters()]
    fetch = [loss.name] + [n + "@GRAD" for n in names]
    gpu, cpu = pt.Scope(), pt.Scope()
    exe_g, exe_c = pt.Executor(), pt.Executor(place="cpu")
    exe_g.run(startup, scope=gpu)
    exe_c.run(startup, scope=cpu)
    for n in names:
        cpu.find_var(n).copy_(gpu.find_var(n).cpu())
    ck.reset_launch_counts()
    got = exe_g.run(main, feed=feed, fetch_list=fetch, scope=gpu)
    counts = {k: sum(v.values()) for k, v in ck.launch_counts_by_dtype().items()
              if v}
    L, att = cfg.num_layers, (3 if src_len == 16 else 2) * cfg.num_layers
    assert counts == {"causal_prefill_attention": att,
                      "attention_backward": att, "layer_norm_act": 5 * L,
                      "layer_norm_act_backward": 5 * L}
    want = exe_c.run(main, feed=feed, fetch_list=fetch, scope=cpu)
    rtol, l2 = (1e-2, 5e-2) if amp_on else (1e-4, 1e-4)
    np.testing.assert_allclose(got[0], want[0], rtol=rtol)
    for n, g, w in zip(names, got[1:], want[1:]):
        assert np.linalg.norm(g - w) <= l2 * np.linalg.norm(w), n


def test_dropout_on_gpu_draws_from_the_run_generator(dev):
    """dropout on the card: the keep rate within 5 binomial sigmas of 0.9
    over 4M elements, Out = X * Mask, the same (seed, counter) repeats the
    mask bit for bit and a new counter draws another; torch's global CUDA
    stream is not read or moved."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name

    main = pt.Program()
    with pt.program_guard(main, pt.Program()), unique_name.guard():
        x = pt.layers.data(name="x", shape=[2048], dtype="bfloat16")
        out = pt.layers.dropout(x, 0.1,
                                dropout_implementation="upscale_in_train")
    mask = next(op.outputs["Mask"][0] for op in main.global_block.ops
                if op.type == "dropout")
    xv = torch.randn((2048, 2048), device=dev).to(BF)
    exe, scope = pt.Executor(), pt.Scope()
    state = torch.cuda.get_rng_state()
    m1, o1 = exe.run(main, feed={"x": xv}, fetch_list=[mask, out],
                     scope=scope, return_numpy=False, rng_counter=3)
    assert torch.equal(torch.cuda.get_rng_state(), state)
    n, kept = m1.numel(), int((m1 != 0).sum())
    assert abs(kept - 0.9 * n) <= 5 * (n * 0.09) ** 0.5
    assert torch.equal(o1, xv * m1)
    (m2,) = exe.run(main, feed={"x": xv}, fetch_list=[mask], scope=scope,
                    return_numpy=False, rng_counter=3)
    (m3,) = exe.run(main, feed={"x": xv}, fetch_list=[mask], scope=scope,
                    return_numpy=False, rng_counter=4)
    assert torch.equal(m2, m1) and float((m3 != m1).float().mean()) > 0.1


# -- K10/K11: flash attention (S > 512), K12/K13: the attention probes ----------

# every shape in fp32 and bf16; then fp32 at the edges of the fp32 kernels'
# 64-row tiles (K10 and K11's query pass take 64 and 128 rows a block, the
# key pass 128 keys at dh = 64), and bf16 at the edges of the bf16 kernels'
# tiles (K10: 192 query rows a block at dh = 64, 128 at dh = 128, 128-key
# tiles; K11's query pass: 128 rows, key tiles of 128 at dh = 64 and 64 at
# dh = 128; its key pass: 128 keys, query tiles of 64 and 32)
FLASH_CASES = [(S, dh, causal, dt) for S, dh, causal in (
    (2, 64, False), (100, 64, True), (640, 64, False), (1000, 64, True),
    (1000, 128, False), (513, 128, True)) for dt in (torch.float32, BF)]
FLASH_CASES += [(S, dh, causal, torch.float32)
                for S in (1, 63, 64, 65, 127, 129, 1000) for dh in (64, 128)
                for causal in (False, True)
                if (S, dh, causal, torch.float32) not in FLASH_CASES]
FLASH_CASES += [(S, dh, causal, BF)
                for S in (1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 1000)
                for dh in (64, 128) for causal in (False, True)
                if (S, dh, causal, BF) not in FLASH_CASES]


@pytest.mark.parametrize("S,dh,causal,dt", FLASH_CASES, ids=[
    f"{S}-{dh}-{c}-{'bf16' if dt == BF else 'fp32'}"
    for S, dh, c, dt in FLASH_CASES])
def test_flash_attention_forward_and_backward_match_plain(dev, S, dh, causal,
                                                          dt):
    q, k, v, do = (_randn((2, 3, S, dh), S + i, dev).to(dt) for i in range(4))
    sm = dh ** -0.5
    out, lse = ck.flash_attention_fwd(q, k, v, causal, sm)
    ref, ref_lse = ck.flash_attention_fwd_plain(q, k, v, causal, sm)
    torch.testing.assert_close(lse, ref_lse, **TOL)
    got = ck.flash_attention_backward(q, k, v, ref, ref_lse, do, causal, sm)
    want = ck.flash_attention_backward_plain(q, k, v, ref, ref_lse, do,
                                             causal, sm)
    if dt == torch.float32:
        torch.testing.assert_close(out, ref, **TOL)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)
    else:
        _close16(out, ref)
        for n, g, w in zip("qkv", got, want):
            if S == 1 and n != "v":
                # one key: P = 1, so dS = (dP - di) P is zero but for the
                # rounding of dP - di, and both sides hold noise of ~1e-7
                torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                           atol=1e-5)
            else:
                _close16(g, w, floor=2e-2)


@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("dh,causal", [(64, False), (128, True)])
def test_flash_attention_f32_repeats_bit_for_bit(dev, dh, causal, dt):
    """No atomics: two launches of K10 and of K11 on the same inputs give
    identical outputs, in fp32 and in bf16."""
    q, k, v, do = (_randn((2, 3, 1000, dh), 40 + i, dev).to(dt)
                   for i in range(4))
    sm = dh ** -0.5
    a = ck.flash_attention_fwd(q, k, v, causal, sm)
    b = ck.flash_attention_fwd(q, k, v, causal, sm)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    a = ck.flash_attention_backward(q, k, v, *b, do, causal, sm)
    b = ck.flash_attention_backward(q, k, v, *b, do, causal, sm)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_attention_rejects_what_the_kernels_do_not_take(dev):
    q = _randn((1, 2, 600, 64), 0, dev)
    with pytest.raises(ValueError, match="dh in"):
        ck.flash_attention_fwd(*(_randn((1, 2, 600, 32), 0, dev),) * 3)
    with pytest.raises(ValueError, match="one shape"):
        ck.flash_attention_fwd(q, q, q[:, :, :300].contiguous())
    out, lse = ck.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="lse"):
        ck.flash_attention_backward(q, q, q, out, lse[:, :1].contiguous(), q)
    with pytest.raises(TypeError, match="float32"):
        ck.flash_attention_backward(q, q, q, out, lse.to(BF), q)


def test_fused_attention_past_512_launches_flash_and_matches_cpu(dev):
    """A fused_attention op at S = 640 and its grad op on the card: one
    K10 and one K11 launch (the grad op reads the forward's output and lse
    from the stash), the grads equal the CPU run's (the plain versions)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import backward, layers, unique_name

    B, nh, S, dh = 2, 2, 640, 64
    main = pt.Program()
    with pt.program_guard(main, pt.Program()), unique_name.guard():
        block = main.global_block
        ins = [block.create_var(name=n, shape=(B, nh, S, dh), dtype="float32",
                                stop_gradient=False) for n in "qkv"]
        out = layers.fused_attention(*ins, causal=True, use_pallas=True)
        cot = block.create_var(name="cot", shape=(B, nh, S, dh),
                               dtype="float32")
        grads = backward.gradients([out], ins, [cot])
    feed = {n: _randn((B, nh, S, dh), i, torch.device("cpu")).numpy()
            for i, n in enumerate(("q", "k", "v", "cot"))}
    ck.reset_launch_counts()
    got = pt.Executor().run(main, feed=feed, fetch_list=[out] + grads,
                            scope=pt.Scope())
    counts = {n: c for n, c in ck.launch_counts().items() if c}
    assert counts == {"flash_attention_fwd": 1, "flash_attention_backward": 1}
    want = pt.Executor(place="cpu").run(main, feed=feed,
                                        fetch_list=[out] + grads,
                                        scope=pt.Scope())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("gh", [1, 3, 12])
@pytest.mark.parametrize("S", [64, 128, 200, 384])
def test_attention_probe_shapes_and_head_groups_match_plain(dev, S, gh):
    """Every variant at one key tile (S <= 128) and two passes over two or
    three (200: a ragged last tile), with 1, 3 and 12 heads a block; at
    B = 32 one head a block gives 384 blocks, past two an SM, where the
    kernel takes one consumer warpgroup a block (two otherwise)."""
    q, k, v = (_randn((32, 12, S, 64), 60 + i, dev).to(BF) for i in range(3))
    for variant in ck.attn_probe.VARIANTS:
        got = ck.attention_probe(variant, q, k, v, 0.125, gh)
        want = ck.attention_probe_plain(variant, q, k, v, 0.125)
        if variant == "copy":
            assert torch.equal(got, want)
        else:
            _close16(got, want)


@pytest.mark.parametrize("variant", list(ck.attn_probe.VARIANTS))
def test_attention_probe_matches_plain(dev, variant):
    q, k, v = (_randn((4, 12, 128, 64), 50 + i, dev).to(BF) for i in range(3))
    got = ck.attention_probe(variant, q, k, v, 0.125)
    want = ck.attention_probe_plain(variant, q, k, v, 0.125)
    if variant == "copy":
        assert torch.equal(got, want)
    else:
        _close16(got, want)


@pytest.mark.parametrize("bb", [1, 4, 16])
@pytest.mark.parametrize("shape", [(16, 12, 128, 64), (16, 128, 768)])
def test_dma_copy_matches_plain_exactly(dev, shape, bb):
    x = _randn(shape, bb, dev).to(BF)
    assert torch.equal(ck.dma_copy(x, bb), ck.dma_copy_plain(x))
    with pytest.raises(ValueError, match="divide"):
        ck.dma_copy(x[:3].contiguous(), 2)


@pytest.mark.parametrize("bb", [1, 2, 4])
@pytest.mark.parametrize("shape", [(16, 3, 7, 8), (32, 5, 104), (4, 1001, 8),
                                   (8, 3, 24, 1)])
def test_dma_copy_ragged_items_exactly(dev, shape, bb):
    """Items whose bytes are not whole stages (168, 520, 8008 and 72
    elements, multiples of 8): the last stage of each block's run is short."""
    x = _randn(shape, 7 + bb, dev).to(BF)
    assert torch.equal(ck.dma_copy(x, bb), ck.dma_copy_plain(x))


# -- K1 in bf16, and the serving engine's prefix cache and speculation --------

@pytest.mark.parametrize("nh,dh", [(12, 64), (2, 8), (3, 40), (64, 128),
                                   (1000, 16)])
def test_bf16_paged_decode_matches_plain(dev, nh, dh):
    """K1 bf16 at page-boundary lens (0, 1, 15, 16, 17 and 4000 slots,
    pages of 16): within the bf16 band of the plain version (which rounds
    the probabilities to bf16), within one bf16 unit of the plain version
    run in fp32 on the same bf16 inputs (plus 2^-20 of the row's max-abs
    for fp32 sums in another order), zeros for the kv_len 0 row, the same
    bits from a second call; rows of 8192 and 16000 are taken in head
    groups, BERT-base width keeps whole rows."""
    import chip_smoke
    from paddle_tpu_torch.ops.cuda_kernels import paged_attention as k1

    lens = [0, 1, 15, 16, 17, 4000]
    q, kp, vp, table, kv = _paged(dev, lens, 16, nh, dh, 300)
    args = (q.to(BF), kp.to(BF), vp.to(BF), table, kv)
    hg = k1._plan(len(lens), nh, dh, 16, table.shape[1], "bf16")[4]
    assert hg == nh if nh * dh <= 768 else 1 <= hg < nh
    ck.reset_launch_counts()
    got = ck.paged_decode_attention(*args, sm_scale=dh ** -0.5)
    assert ck.paged_decode_attention.launches_by_dtype == {"bfloat16": 1}
    ref = ck.paged_decode_attention_plain(*args, sm_scale=dh ** -0.5)
    assert got.dtype == BF
    _close16(got[1:], ref[1:])
    r32 = ck.paged_decode_attention_plain(*(t.float() for t in args[:3]),
                                          table, kv, sm_scale=dh ** -0.5)[1:]
    tol = (chip_smoke._ulp16(r32)
           + 2.0 ** -20 * r32.abs().amax(dim=-1, keepdim=True))
    assert bool(((got[1:].float() - r32).abs() <= tol).all())
    assert bool((got[0] == 0).all()), "a kv_len 0 row must emit zeros"
    assert torch.equal(got, ck.paged_decode_attention(*args,
                                                      sm_scale=dh ** -0.5))


def test_paged_decode_refuses_fp16(dev):
    """fp16 pools raise (ROADMAP Queue 2, domain item 1); they never take
    the plain version."""
    q, kp, vp, table, kv = _paged(dev, [3, 40], 16, 2, 8, 8)
    with pytest.raises(TypeError, match="float16"):
        ck.paged_decode_attention(q.half(), kp.half(), vp.half(), table, kv)
    with pytest.raises(TypeError, match="float16"):
        ck.paged_decode_attention(q.to(BF), kp.half(), vp.half(), table, kv)
    with pytest.raises(TypeError, match="bfloat16"):
        ck.paged_decode_attention(q, kp.to(BF), vp.to(BF), table, kv)


@pytest.mark.parametrize("draft_k", [0, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefix_cache_engine_on_gpu_matches_cpu(dev, dtype, draft_k):
    """decoder_tiny with the prefix cache on (shared-prefix requests, then a
    page-aligned prompt twice: full hits and copy-on-write) on the card and
    on the CPU from the same weights. fp32: the same tokens and the same
    prefix, copy-on-write and speculation counts; bf16: the card's tokens
    pass chip_smoke's teacher-forced gate against the CPU engine's dense
    oracle. Plain decode launches K1 in the engine's dtype."""
    import dataclasses

    import chip_smoke
    from paddle_tpu_torch.serving import ServingEngine, decoder_tiny

    cfg = dataclasses.replace(decoder_tiny(), dtype=dtype)
    kw = dict(page_size=4, pool_pages=64, max_inflight=4, prefix_cache=True,
              draft_k=draft_k)
    gpu = ServingEngine(cfg, **kw)
    cpu = ServingEngine(cfg, device="cpu", **kw)
    with torch.no_grad():
        for n in gpu.parameter_names():
            cpu._scope.find_var(n).copy_(gpu._scope.find_var(n).cpu())
    rng = np.random.default_rng(5)
    sysp = [int(t) for t in rng.integers(1, 97, 12)]
    prompts = [sysp + [int(t) for t in rng.integers(1, 97, n)]
               for n in (3, 6)] + [sysp[:8], sysp[:8]]
    outs = []
    for eng in (gpu, cpu):
        ck.reset_launch_counts()
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts[:2]]
        eng.run_until_drained()
        rids += [eng.submit(p, max_new_tokens=6) for p in prompts[2:]]
        eng.run_until_drained()
        outs.append([eng.result(r) for r in rids])
        if eng is gpu and not draft_k:
            assert ck.paged_decode_attention.launches_by_dtype.get(dtype)
        assert eng.stats["prefix_full_hits"] == 2
        assert eng.stats["cow_copies"] >= 1
        assert eng.leaked_pages() == 0
        eng.flush_prefix_cache()
        assert eng.pool.free_count == eng.pool.num_pages
    keys = ("prefix_hit_tokens", "prefix_full_hits", "cow_copies",
            "prefill_tokens_computed", "spec_steps", "spec_proposed")
    if dtype == "float32":
        assert outs[0] == outs[1]
        assert ({k: gpu.stats[k] for k in keys}
                == {k: cpu.stats[k] for k in keys})
    else:
        chip_smoke._hold_delta("bf16 engine", cpu, prompts, outs[0])


def _arr(shape, seed, lo=None):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.abs(a) + lo if lo is not None else a


P2 = (64, 32)


def _one(v):
    return np.asarray([v], np.float32)


def _update(slots, seed=0):
    """Param, Grad, LearningRate and the named accumulator slots (moments
    kept positive where the op takes a square root of them)."""
    ins = {"Param": _arr(P2, seed), "Grad": _arr(P2, seed + 1) * 0.1,
           "LearningRate": _one(1e-2)}
    for i, (slot, pos) in enumerate(slots):
        ins[slot] = _arr(P2, seed + 2 + i, 1e-3 if pos else None)
    return ins


# (op, inputs, attrs): each new update op and each schedule op of the
# optimizer slice, on inputs from numpy seeds
SLICE_OPS = [
    ("adamax", dict(_update([("Moment", False), ("InfNorm", True)]),
                    Beta1Pow=_one(0.9 ** 3)), {}),
    ("adagrad", _update([("Moment", True)]), {}),
    ("decayed_adagrad", _update([("Moment", True)]), {"decay": 0.9}),
    ("adadelta", _update([("AvgSquaredGrad", True),
                          ("AvgSquaredUpdate", True)]), {}),
    # a running mean of g^2 is at least the square of g's running mean
    ("rmsprop", dict(_update([("Moment", False), ("MeanSquare", True)]),
                     MeanGrad=_arr(P2, 9) * 0.01), {"momentum": 0.9}),
    ("rmsprop", dict(_update([("Moment", False), ("MeanSquare", True)]),
                     MeanGrad=_arr(P2, 9) * 0.01),
     {"momentum": 0.9, "centered": True}),
    # FTRL at its first step, the accumulators at zero as the optimizer
    # starts them: later, sigma = (sqrt(sq + g^2) - sqrt(sq)) / lr cancels
    # where sq >> g^2, and new_lin = lin + g - sigma p where its terms
    # cancel, so one fp32 evaluation lies up to 12x this test's tolerance
    # from a float64 one (at sq ~ |N(0, 1)|, g ~ 0.1 N(0, 1)); at the first
    # step within 0.14 of it
    ("ftrl", dict(_update([]), SquaredAccumulator=np.zeros(P2, np.float32),
                  LinearAccumulator=np.zeros(P2, np.float32)),
     {"l1": 1e-3, "l2": 1e-3}),
    ("ftrl", dict(_update([]), SquaredAccumulator=np.zeros(P2, np.float32),
                  LinearAccumulator=np.zeros(P2, np.float32)),
     {"l1": 1e-3, "l2": 1e-3, "lr_power": -0.6}),
    ("lamb", dict(_update([("Moment1", False), ("Moment2", True)]),
                  Beta1Pow=_one(0.9 ** 2), Beta2Pow=_one(0.999 ** 2)), {}),
    ("lars_momentum", _update([("Velocity", False)]), {"mu": 0.9}),
    ("dgc", {"Grad": _arr(P2, 1), "U": _arr(P2, 2), "V": _arr(P2, 3),
             "CurrentStep": _one(3.0)},
     {"momentum": 0.9, "sparsity_ramp": [0.5, 0.9], "rampup_begin_step": 1,
      "rampup_step": 4}),
    ("model_average_accum", {"Param": _arr(P2, 1), "Sum": _arr(P2, 2),
                             "Cnt": _one(3.0), "TotalUpdates": _one(30.0)},
     {"min_average_window": 3.0, "max_average_window": 5.0}),
    ("lookahead", {"Param": _arr(P2, 1), "SlowParam": _arr(P2, 2),
                   "Step": _one(4.0)}, {"alpha": 0.5, "k": 2.0}),
    ("increment", {"X": _one(4.0)}, {"step": 1.0}),
    ("floor", {"X": _arr(P2, 1) * 4}, {}),
    ("ceil", {"X": _arr(P2, 1) * 4}, {}),
    ("cos", {"X": _arr(P2, 1) * 4}, {}),
    ("pow", {"X": _arr(P2, 1, 1e-3)}, {"factor": -0.5}),
    ("elementwise_pow", {"X": _arr(P2, 1, 0.5), "Y": _arr((32,), 2)},
     {"axis": -1}),
    ("elementwise_min", {"X": _arr(P2, 1), "Y": _arr((32,), 2)}, {"axis": -1}),
    ("less_than", {"X": _arr(P2, 1), "Y": _arr(P2, 2)}, {}),
    ("piecewise_decay", {"Step": _one(5.0)},
     {"boundaries": [2.0, 5.0, 9.0], "values": [0.1, 0.05, 0.01, 0.001]}),
]


def _run_slice_op(op_type, ins, attrs, device):
    """The op's outputs on `device`; its inputs are copied there first,
    and only its compute runs under the sync debug mode "error" (a host
    array's copy to the card is itself a sync)."""
    from paddle_tpu_torch.ops.registry import ExecContext, get_op_def

    class Op:
        type = op_type
        inputs = {s: [s.lower()] for s in ins}
        # increment writes its X in place, as the counters' programs do
        outputs = {"Out": ["x"]} if op_type == "increment" else {}

    Op.attrs = attrs
    env = {s.lower(): torch.from_numpy(a.copy()).to(device)
           for s, a in ins.items()}
    if device.type != "cuda":
        return get_op_def(op_type).compute(ExecContext(Op, env, device))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return get_op_def(op_type).compute(ExecContext(Op, env, device))
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("op_type,ins,attrs", SLICE_OPS,
                         ids=[o + ("_centered" if a.get("centered") else "")
                              + ("_lr_power" if "lr_power" in a else "")
                              for o, _, a in SLICE_OPS])
def test_optimizer_and_schedule_ops_on_gpu_match_cpu_without_a_sync(
        dev, op_type, ins, attrs):
    """Each update op and schedule op of the optimizer slice on the card
    against the CPU (fp32 within 1e-5 relative, 1e-7 absolute; dgc's
    released set exactly), its dispatch under the sync debug mode "error":
    no .item(), no bool() of a device tensor, no host quantile check."""
    want = _run_slice_op(op_type, ins, attrs, torch.device("cpu"))
    got = _run_slice_op(op_type, ins, attrs, dev)
    assert sorted(got) == sorted(want)
    for slot in want:
        g, w = got[slot].cpu(), want[slot]
        assert g.dtype == w.dtype and g.shape == w.shape, slot
        if g.dtype == torch.bool:
            assert torch.equal(g, w), slot
        else:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7,
                                       msg=lambda m: f"{slot}: {m}")


def test_dgc_on_gpu_past_two_to_the_24_elements_matches_cpu(dev):
    """dgc on BERT-base's word embedding gradient (23.4 M elements, past
    torch.quantile's 2^24) releases the same entries on the card as on the
    CPU, with no host sync."""
    ins = {"Grad": _arr((30522, 768), 7), "U": np.zeros((30522, 768),
                                                        np.float32),
           "V": np.zeros((30522, 768), np.float32)}
    attrs = {"momentum": 0.9, "sparsity": 0.999}
    want = _run_slice_op("dgc", ins, attrs, torch.device("cpu"))
    got = _run_slice_op("dgc", ins, attrs, dev)
    for slot in ("GradOut", "UOut", "VOut", "Sparsity"):
        assert torch.equal(got[slot].cpu(), want[slot]), slot
    a = np.sort(np.abs(ins["Grad"]).reshape(-1)).astype(np.float64)
    pos = float(np.float32(0.999)) * (a.size - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    thr = np.float32(a[lo] * (1 - (pos - lo)) + a[hi] * (pos - lo))
    assert int((want["GradOut"] != 0).sum()) == int(
        (np.abs(ins["Grad"]) >= thr).sum())


def _run_op(op_type, ins, outs, attrs, device):
    """The registered compute of `op_type` on tensors `ins` ({slot:
    tensor}), each slot's var named after the slot; `outs` the grad op's
    output slots."""
    from paddle_tpu_torch.ops.registry import ExecContext, get_op_def

    class Op:
        type = op_type
        inputs = {s: [s] for s in ins}
        outputs = {s: [s] for s in outs}

    Op.attrs = attrs
    return get_op_def(op_type).compute(ExecContext(Op, dict(ins), device))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("S", [128, 640], ids=["K2-K4", "K10-K11"])
def test_attention_function_grads_equal_the_registered_grad(dev, S, dt):
    """Inside a replayed grad fused_attention runs _AttentionFn: its
    forward is the op's kernel (K2, or K10 past S = 512), bit for bit the
    op's output outside autograd, and its backward gives the registered
    grad compute's gradients (K4, or K11) bit for bit."""
    qkv = [_randn((2, 3, S, 64), 60 + i, dev).to(dt) for i in range(3)]
    do = _randn((2, 3, S, 64), 63, dev).to(dt)
    attrs = {"causal": S > 512, "sm_scale": 0.125}
    ins = dict(zip(("Q", "K", "V"), qkv))
    plain_out = _run_op("fused_attention", ins, (), attrs, dev)["Out"]
    leaves = {s: t.clone().requires_grad_() for s, t in ins.items()}
    ck.reset_launch_counts()
    with torch.enable_grad():
        out = _run_op("fused_attention", leaves, (), attrs, dev)["Out"]
        got = torch.autograd.grad(out, list(leaves.values()), do)
    counts = ck.launch_counts()
    fwd, bwd = (("flash_attention_fwd", "flash_attention_backward") if S > 512
                else ("causal_prefill_attention", "attention_backward"))
    assert counts[fwd] == 1 and counts[bwd] == 1
    assert torch.equal(out.detach(), plain_out)
    want = _run_op("fused_attention_grad", dict(ins, **{"Out@GRAD": do}),
                   ("Q@GRAD", "K@GRAD", "V@GRAD"), attrs, dev)
    for s, g in zip(("Q", "K", "V"), got):
        assert torch.equal(g, want[s + "@GRAD"]), s


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("act", ["identity", "relu"])
def test_layer_norm_function_grads_equal_the_registered_grad(dev, act, dt):
    """Inside a replayed grad layer_norm runs _LayerNormFn: K3 forward, bit
    for bit the op's output, and K5 backward, the registered grad
    compute's X/Scale/Bias gradients bit for bit."""
    x = _randn((4, 32, 768), 70, dev).to(dt)
    scale = (1 + 0.1 * _randn((768,), 71, dev)).to(dt)
    bias = (0.1 * _randn((768,), 72, dev)).to(dt)
    dy = _randn((4, 32, 768), 73, dev).to(dt)
    attrs = {"begin_norm_axis": 2, "epsilon": 1e-5, "act": act}
    ins = {"X": x, "Scale": scale, "Bias": bias}
    plain_y = _run_op("layer_norm", ins, (), attrs, dev)["Y"]
    leaves = {s: t.clone().requires_grad_() for s, t in ins.items()}
    ck.reset_launch_counts()
    with torch.enable_grad():
        y = _run_op("layer_norm", leaves, (), attrs, dev)["Y"]
        got = torch.autograd.grad(y, list(leaves.values()), dy)
    counts = ck.launch_counts()
    assert counts["layer_norm_act"] == 1
    assert counts["layer_norm_act_backward"] == 1
    assert torch.equal(y.detach(), plain_y)
    want = _run_op("layer_norm_grad", dict(ins, **{"Y@GRAD": dy}),
                   ("X@GRAD", "Scale@GRAD", "Bias@GRAD"), attrs, dev)
    for s, g in zip(("X", "Scale", "Bias"), got):
        assert torch.equal(g, want[s + "@GRAD"]), s


def _run_with_stash(op_type, ins, outs, attrs, device, stash):
    """As _run_op, with the executor's per-run stash the batch norms leave
    their statistics in for their grad op."""
    from paddle_tpu_torch.ops.registry import ExecContext, get_op_def

    class Op:
        type = op_type
        inputs = {s: [s] for s in ins}
        outputs = {s: [s] for s in outs}

    Op.attrs = attrs
    return get_op_def(op_type).compute(ExecContext(Op, dict(ins), device,
                                                   stash=stash))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_xent_function_grads_match_the_registered_grad(dev, dt):
    """Inside a replayed grad softmax_with_cross_entropy runs _XentFn: K6
    forward, Loss and Softmax bit for bit the op's outside autograd, and K7
    from K6's saved statistics, within _xent_close of the registered grad
    (K7 recomputing them)."""
    logits = _randn((64, 30522), 80, dev).to(dt)
    label = torch.from_numpy(np.random.default_rng(81).integers(
        0, 30522, (64, 1)).astype(np.int32)).to(dev)
    dloss = _randn((64, 1), 82, dev).to(dt)
    ins = {"Logits": logits, "Label": label}
    plain = _run_op("softmax_with_cross_entropy", ins, (), {}, dev)
    leaf = logits.clone().requires_grad_()
    ck.reset_launch_counts()
    with torch.enable_grad():
        out = _run_op("softmax_with_cross_entropy",
                      {"Logits": leaf, "Label": label}, (), {}, dev)
        (got,) = torch.autograd.grad(out["Loss"], [leaf], dloss)
    counts = ck.launch_counts()
    assert counts["softmax_xent_fwd"] == 1 and counts["softmax_xent_bwd"] == 1
    for s in ("Loss", "Softmax"):
        assert torch.equal(out[s].detach(), plain[s]), s
    want = _run_op("softmax_with_cross_entropy_grad",
                   dict(ins, **{"Softmax": plain["Softmax"],
                                "Loss@GRAD": dloss}),
                   ("Logits@GRAD",), {}, dev)["Logits@GRAD"]
    _xent_close(got, want)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("is_test", [False, True], ids=["train", "test"])
def test_batch_norm_function_grads_equal_the_registered_grad(dev, is_test,
                                                             dt):
    """Inside a replayed grad batch_norm runs _BatchNormFn: K8 forward, Y
    bit for bit the op's outside autograd, and K9 backward (its chain mode
    in training), the registered grad's X/Scale/Bias/Residual gradients
    bit for bit."""
    x = (1.5 * _randn((8, 14, 14, 256), 90, dev) + 0.3).to(dt)
    res = _randn((8, 14, 14, 256), 91, dev).to(dt)
    dy = _randn((8, 14, 14, 256), 92, dev).to(dt)
    ins = {"X": x, "Scale": 1 + 0.2 * _randn((256,), 93, dev),
           "Bias": 0.2 * _randn((256,), 94, dev),
           "Mean": 0.3 * _randn((256,), 95, dev),
           "Variance": 0.5 + _randn((256,), 96, dev).abs(), "Residual": res}
    attrs = {"is_test": is_test, "data_layout": "NHWC", "act": "relu",
             "epsilon": 1e-5, "momentum": 0.9}
    outs = ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance")
    stash = {}
    plain = _run_with_stash("batch_norm", ins, outs, attrs, dev, stash)
    diff = ("X", "Scale", "Bias", "Residual")
    leaves = {s: t.clone().requires_grad_() if s in diff else t
              for s, t in ins.items()}
    ck.reset_launch_counts()
    with torch.enable_grad():
        y = _run_op("batch_norm", leaves, outs, attrs, dev)["Y"]
        got = torch.autograd.grad(y, [leaves[s] for s in diff], dy)
    counts = ck.launch_counts()
    assert counts["bn_apply_act"] == 1 and counts["bn_apply_act_backward"] == 1
    assert torch.equal(y.detach(), plain["Y"])
    want = _run_with_stash("batch_norm_grad", dict(ins, **{"Y@GRAD": dy}),
                           tuple(s + "@GRAD" for s in diff), attrs, dev, stash)
    for s, g in zip(diff, got):
        assert torch.equal(g, want[s + "@GRAD"]), s


# -- the data pipeline and sparse updates on the card ------------------------


def test_device_loader_stages_on_a_side_stream(dev):
    """The placement copies from pinned memory on a stream of its own and
    records an event the consumer's stream waits on; the feeds equal the
    host arrays bit for bit."""
    from paddle_tpu_torch.pipeline import DeviceLoader
    from paddle_tpu_torch.pipeline.device_loader import placement

    rng = np.random.default_rng(0)
    batches = [{"x": rng.standard_normal((256, 64)).astype(np.float32),
                "ids": rng.integers(0, 100, (256, 26)).astype(np.int64)}
               for _ in range(6)]
    place = placement({"ids": np.int32}.get, dev)
    staged = place(batches[0])
    assert staged.stream is not None and staged.event is not None
    assert staged.stream != torch.cuda.current_stream()
    got = [staged.ready()] + list(DeviceLoader(
        lambda: iter(batches[1:]), depth=2, placement=place))
    assert len(got) == 6
    for feed, host in zip(got, batches):
        assert feed["x"].is_cuda and feed["ids"].dtype == torch.int32
        assert torch.equal(feed["x"].cpu(), torch.from_numpy(host["x"]))
        assert torch.equal(feed["ids"].cpu(),
                           torch.from_numpy(host["ids"].astype(np.int32)))


@pytest.mark.parametrize("op_type", ["sgd", "adam"])
def test_sparse_update_ops_are_sync_free_and_match_the_cpu(dev, op_type):
    """sgd's row update and adam's lazy update on a SelectedRows grad with
    repeated rows: no host sync (sync debug mode "error"), within 1e-6 of
    the same op on the CPU (repeated rows add in another order), rows no
    id names bit for bit."""
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    from paddle_tpu_torch.ops.registry import ExecContext, get_op_def

    rng = np.random.default_rng(1)
    V, W, K = 5000, 16, 4096
    host = {"param": rng.standard_normal((V, W)).astype(np.float32),
            "m1": np.zeros((V, W), np.float32),
            "m2": np.zeros((V, W), np.float32),
            "b1p": np.array([0.9], np.float32),
            "b2p": np.array([0.999], np.float32),
            "lr": np.array([1e-2], np.float32)}
    rows = rng.integers(0, V // 2, K).astype(np.int32)
    vals = rng.standard_normal((K, W)).astype(np.float32)

    class Op:
        type, outputs, attrs = op_type, {}, {}
        inputs = {"Param": ["param"], "Grad": ["grad"],
                  "LearningRate": ["lr"], "Moment1": ["m1"],
                  "Moment2": ["m2"], "Beta1Pow": ["b1p"], "Beta2Pow": ["b2p"]}

    out = {}
    for d in (dev, torch.device("cpu")):
        env = {k: torch.from_numpy(v).to(d) for k, v in host.items()}
        env["grad"] = SelectedRows(torch.from_numpy(rows).to(d),
                                   torch.from_numpy(vals).to(d), V)
        if d.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            out[d.type] = get_op_def(op_type).compute(ExecContext(Op, env, d))
        finally:
            if d.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
    for slot, t in out["cuda"].items():
        torch.testing.assert_close(t.cpu(), out["cpu"][slot], rtol=1e-6,
                                   atol=1e-7)
    p = out["cuda"]["ParamOut"].cpu()
    assert torch.equal(p[V // 2:], torch.from_numpy(host["param"][V // 2:]))


def _tiered_env(d, slots=300, dim=16, cap=64, seed=3):
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((slots + 1, dim)).astype(np.float32)
    cache[slots] = 0
    install = rng.permutation(slots)[:cap - 5].astype(np.int32)
    slot_buf = np.concatenate([install, np.full(5, slots, np.int32)])
    rows = np.zeros((cap, dim), np.float32)
    rows[:cap - 5] = rng.standard_normal((cap - 5, dim))
    ids = rng.integers(0, slots + 1, (32, 6)).astype(np.int32)
    og = rng.standard_normal((32, 6, dim)).astype(np.float32)
    return {k: torch.from_numpy(v).to(d) for k, v in (
        ("cache", cache), ("rows", rows), ("slots", slot_buf),
        ("ids", ids), ("og", og))}


@pytest.mark.parametrize("op_type", ["emb_cache_install", "tiered_lookup",
                                     "tiered_lookup_grad"])
def test_tiered_ops_are_sync_free_and_match_the_cpu(dev, op_type):
    """The tiered embeddings' ops on the card under the sync debug mode
    "error", against the CPU: the install and the lookup bit for bit, the
    cache gradient (index_add_ of repeated slots, in another order on the
    card) within 1e-6; Evicted is a fresh tensor, not a view of the
    cache."""
    from paddle_tpu_torch.ops.registry import ExecContext, get_op_def

    ins = {"emb_cache_install": {"Cache": "cache", "Rows": "rows",
                                 "Slots": "slots"},
           "tiered_lookup": {"Cache": "cache", "SlotIds": "ids"},
           "tiered_lookup_grad": {"Cache": "cache", "SlotIds": "ids",
                                  "Out@GRAD": "og"}}[op_type]

    class Op:
        type, outputs = op_type, {}
        inputs = {s: [n] for s, n in ins.items()}
        attrs = {"scratch_slot": 300, "table": "t"}

    out = {}
    for d in (dev, torch.device("cpu")):
        env = _tiered_env(d)
        if d.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            out[d.type] = get_op_def(op_type).compute(ExecContext(Op, env, d))
        finally:
            if d.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        if op_type == "emb_cache_install":
            ev, cache = out[d.type]["Evicted"], env["cache"]
            assert ev.data_ptr() != cache.data_ptr()
            assert ev.untyped_storage().data_ptr() != \
                cache.untyped_storage().data_ptr()
    for slot, t in out["cuda"].items():
        if slot == "Cache@GRAD":
            torch.testing.assert_close(t.cpu(), out["cpu"][slot], rtol=1e-6,
                                       atol=1e-6)
        else:
            assert torch.equal(t.cpu(), out["cpu"][slot]), slot


def _tiered_program(slots=256):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import flags, layers as L, unique_name
    from paddle_tpu_torch.param_attr import ParamAttr

    flags.set_flags({"emb_hbm_budget_mb": 0.001, "emb_cache_slots": slots})
    try:
        m, st = pt.Program(), pt.Program()
        m.random_seed = st.random_seed = 7
        with pt.program_guard(m, st), unique_name.guard():
            ids = L.data(name="ids", shape=[6], dtype="int64")
            label = L.data(name="label", shape=[1], dtype="float32")
            emb = L.embedding(ids, size=[512, 8], is_sparse=True,
                              param_attr=ParamAttr(name="tbl"))
            logit = L.fc(L.reduce_sum(emb, dim=1), size=1)
            loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
            pt.optimizer.SGD(0.1).minimize(loss)
    finally:
        flags.set_flags({"emb_hbm_budget_mb": 0.0, "emb_cache_slots": 0})
    return m, st, loss


def _tiered_feeds(n):
    out = []
    for s in range(n):
        rng = np.random.default_rng(40 + s)
        out.append({"ids": rng.integers(0, 512, (32, 6)).astype(np.int64),
                    "label": rng.integers(0, 2, (32, 1)).astype(np.float32)})
    return out


def test_tiered_training_on_gpu_matches_cpu_through_the_loader(dev):
    """Eight tiered steps on the card (feeds resolved and staged by the
    DeviceLoader, dispatched by run_async, write-backs landing from CUDA
    events) against the same steps on the CPU: the exported table within
    1e-6, every eviction written back; run_async's tokens are CUDA
    events."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.pipeline import DeviceLoader

    feeds = _tiered_feeds(8)
    tables = {}
    for d in (dev, torch.device("cpu")):
        main, startup, loss = _tiered_program()
        eng = main._tiered_engine
        exe, scope, init = pt.Executor(place=d), pt.Scope(), pt.Scope()
        # one set of initial values for both devices (the RNG is each
        # device's own; the host tier is numpy's, the same on both)
        pt.Executor(place="cpu").run(startup, scope=init)
        for n in init.var_names():
            scope.set_var(n, init.find_var(n).to(d))
        for feed in DeviceLoader(lambda: iter(feeds), depth=2,
                                 placement=exe.feed_placer(main)):
            if d.type == "cuda":
                assert feed["tbl@PREFETCH_ROWS"].is_cuda
            exe.run_async(main, feed=feed, fetch_list=[loss], scope=scope)
            tok = exe._inflight[-1][1]
            assert (tok is None) == (d.type == "cpu")
            assert tok is None or isinstance(tok, torch.cuda.Event)
        exe.wait()
        eng.flush_all()
        st = eng.stats("tbl")
        assert st["evictions"] > 0 and st["writebacks"] == st["evictions"]
        tables[d.type] = eng.export_dense("tbl", scope)
    np.testing.assert_allclose(tables["cuda"], tables["cpu"], rtol=0,
                               atol=1e-6)


def test_write_back_landing_waits_for_its_step_only(dev):
    """A _Landing's host copy runs on the engine's side stream after its
    step's event: it does not wait on work queued later on the current
    stream."""
    import time

    from paddle_tpu_torch.embedding.engine import _Landing

    rows = torch.arange(64, dtype=torch.float32, device=dev).reshape(8, 8)
    # the caching host allocator's first pinned block is a cudaHostAlloc
    torch.empty(rows.shape, pin_memory=True)
    torch.cuda.synchronize()
    land = _Landing(rows)
    torch.cuda._sleep(200_000_000)   # later work on the current stream
    t0 = time.perf_counter()
    got = land.host({})
    waited = time.perf_counter() - t0
    assert np.array_equal(got, np.arange(64, dtype=np.float32).reshape(8, 8))
    assert land.ready()
    torch.cuda.synchronize()
    assert waited < 0.05, waited
