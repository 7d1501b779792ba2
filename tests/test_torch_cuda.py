"""The port's CUDA kernels on the card, each held against its plain PyTorch
version (K1-K11 in fp32 and bf16, #15, K12 and K13 in bf16), plus the
wrappers' input checks, the serving engine against its dense oracle and
(prefix cache, copy-on-write and speculation, fp32 and bf16) against the
same engine on the CPU, a
fused_attention past S = 512 on K10/K11 against the CPU, and a bert_tiny
training step (fp32 and AMP) and two resnet_cifar10 training steps against
the same steps run on the CPU (the kernels' plain versions), the op sweeps
of chip_smoke (the long tail, vision and detection, crf, ctc and quant
ops) and its SRL and CRNN-CTC phases at small sizes. Every test
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
# not a multiple of 4 or of the block's strip, and tiny extents; "cr" rows
# of 2, 5 and 7, whose 16-byte vectors (4 fp32, 8 bf16) span 2 or 3 rows;
# MobileNetV3's 14 x 14 and 7 x 7 maps at batch 2; and flat lengths one
# short of and one past what a block of K8 takes at a time (kUnroll x 128
# threads x 16 bytes: "cl" 1024 fp32 or 4096 bf16 elements, by the element
# and by the vector)
BN_SHAPES = [("cl", 4 * 112 * 112, 64, 64), ("cl", 4 * 56 * 56, 256, 256),
             ("cl", 4 * 7 * 7, 2048, 2048), ("cr", 4 * 256, 3136, 256),
             ("cr", 4 * 2048, 49, 2048), ("cl", 1009, 37, 37),
             ("cl", 5, 16, 16), ("cl", 300, 3, 3), ("cr", 3 * 7, 9, 7),
             ("cr", 6, 1, 3), ("cl", 33, 4100, 4100),
             ("cr", 4 * 5, 2, 5), ("cr", 3 * 7, 5, 7), ("cr", 2 * 9, 7, 9),
             ("cr", 2 * 672, 196, 672), ("cr", 2 * 960, 49, 960),
             ("cr", 33, 31, 3), ("cr", 205, 5, 5), ("cl", 255, 4, 4),
             ("cl", 257, 4, 4), ("cr", 45, 91, 9), ("cr", 17, 241, 17),
             ("cl", 511, 8, 8), ("cl", 513, 8, 8)]


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


def _at_offset(t, off):
    """A contiguous copy of t starting `off` elements past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    return buf[off:].view(t.shape).copy_(t)


def _bn_apply_entry(x, p, res, y, mode, act):
    """K8's C entry on operands the wrapper would not give it: y (which the
    wrapper allocates, 16-byte aligned) at x's offset."""
    from paddle_tpu_torch.ops.cuda_kernels import _build, bn_apply

    R, row = x.shape
    _build.launch("bn_apply_act", bn_apply._fn(_build.ELEM[x.dtype]),
                  x.data_ptr(), *(t.data_ptr() for t in p),
                  None if res is None else res.data_ptr(), y.data_ptr(), R,
                  row, p[0].shape[0], bn_apply.MODES.index(mode),
                  bn_apply.ACTS.index(act), _build.stream_of(x))


def test_bn_apply_takes_an_unaligned_view(dev):
    """x at each offset off 16 bytes (fp32 4, 8 and 12 bytes, bf16 2 to 14)
    in both layouts: through the wrapper (a fresh y is aligned, so no common
    aligned body: the one-element instantiation), and x, the residual and y
    all at that offset through the C entry (the head element by element,
    then 16-byte vectors and the tail); both bit for bit the aligned call's.
    Then K9 on an fp32 view one float off."""
    for dt in (torch.float32, torch.bfloat16):
        for mode, R, row, C in (("cl", 64, 8, 8), ("cr", 24, 49, 8)):
            x, p, res, _ = _bn_operands(dev, mode, R, row, C, True)
            x, res = x.to(dt), res.to(dt)
            want = ck.bn_apply_act(x, *p, "relu", res, mode)
            plain = ck.bn_apply_act_plain(x, *p, "relu", res, mode)
            if dt == torch.float32:
                torch.testing.assert_close(want, plain, **TOL)
            else:
                _close16(want, plain)
            for off in range(1, 16 // x.element_size()):
                xo, ro, yo = (_at_offset(t, off)
                              for t in (x, res, torch.zeros_like(x)))
                assert xo.data_ptr() % 16 and xo.is_contiguous()
                got = ck.bn_apply_act(xo, *p, "relu", ro, mode)
                assert torch.equal(got, want), (dt, mode, off)
                _bn_apply_entry(xo, p, ro, yo, mode, "relu")
                assert torch.equal(yo, want), (dt, mode, off)
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


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode,R,row,C", [
    ("cl", 4 * 56 * 56, 256, 256), ("cr", 4 * 960, 49, 960),
    ("cr", 2 * 9, 7, 9), ("cl", 1009, 37, 37)])
def test_bn_apply_repeats_bit_for_bit(dev, dt, mode, R, row, C):
    """Two calls of K8 on one input give the same bits."""
    x, p, res, _ = _bn_operands(dev, mode, R, row, C, True)
    x, res = x.to(dt), res.to(dt)
    a = ck.bn_apply_act(x, *p, "relu", res, mode)
    b = ck.bn_apply_act(x, *p, "relu", res, mode)
    assert torch.equal(a, b)


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
                                  "bn_apply_act_backward_sums": 0,
                                  "bn_apply_act_backward_chain": 0,
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


@pytest.mark.parametrize("act,has_res", [("identity", False), ("relu", True)])
@pytest.mark.parametrize("mode,R,row,C", BN_SHAPES)
def test_bn_apply_backward_split_mode_is_the_one_launch(dev, mode, R, row, C,
                                                        act, has_res):
    """K9's split mode (a sync batch norm's): the sums launch, then the
    chain from those sums with M, give the one launch's dx, dres, P1, P2,
    dscale and dbias bit for bit (a world of one rank), in fp32 and bf16;
    the sums launch writes P1, P2, dscale and dbias only and is counted
    apart; and two halves' sums added and chained with the global M give
    the whole batch's dx within the chain mode's bounds."""
    x, p, res, dy = _bn_operands(dev, mode, R, row, C, has_res)
    M = R * row // C
    for dt in (torch.float32, BF):
        xd, dyd = x.to(dt), dy.to(dt)
        rd = None if res is None else res.to(dt)
        one = ck.bn_apply_act_backward(xd, *p, dyd, act, rd, mode, M)
        ck.reset_launch_counts()
        sums = ck.bn_apply_act_backward_sums(xd, *p, dyd, act, rd, mode)
        split = ck.bn_apply_act_backward_chain(xd, *p, dyd,
                                               sums[:2].contiguous(), M, act,
                                               rd, mode)
        counts = ck.launch_counts()
        assert counts["bn_apply_act_backward_sums"] == 1
        assert counts["bn_apply_act_backward_chain"] == 1
        assert counts["bn_apply_act_backward"] == 0
        for a, b in zip(one, split):
            assert (a is None and b is None) or torch.equal(a, b)
        assert torch.equal(sums[0], one[2]) and torch.equal(sums[1], one[3])
        plain = ck.bn_apply_act_backward_sums_plain(xd, *p, dyd, act, rd, mode)
        torch.testing.assert_close(sums[:4], plain[:4], rtol=1e-4,
                                   atol=1e-4 * float(plain[:4].abs().max()))
        if R % 2 or (mode == "cr" and (R // 2) % C):
            continue
        h = R // 2
        halves = [(xd[i:i + h], dyd[i:i + h],
                   None if rd is None else rd[i:i + h]) for i in (0, h)]
        total = sum(ck.bn_apply_act_backward_sums(hx, *p, hy, act, hr,
                                                  mode)[:2]
                    for hx, hy, hr in halves).contiguous()
        dx = torch.cat([ck.bn_apply_act_backward_chain(
            hx, *p, hy, total, M, act, hr, mode)[0] for hx, hy, hr in halves])
        ref = ck.bn_apply_act_backward_plain(xd, *p, dyd, act, rd, mode, M)
        if dt == BF:
            _close16(dx, ref[0])
        else:
            torch.testing.assert_close(dx, ref[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode,R,row,C", [("cl", 4 * 14 * 14, 256, 256),
                                          ("cr", 4 * 64, 49, 64)])
def test_bn_apply_backward_takes_statistics_cotangents(dev, mode, R, row, C):
    """`extra` (the [2, C] of stat_cotangents) joins dmean and dvar in the
    kernel's fold, one launch and split mode alike, as in the plain
    version."""
    x, p, res, dy = _bn_operands(dev, mode, R, row, C, False)
    M = R * row // C
    g = _randn((4, C), 77, dev)
    extra = ck.stat_cotangents(p[3], 0.9, *g)
    got = ck.bn_apply_act_backward(x, *p, dy, "identity", None, mode, M,
                                   extra=extra)
    ref = ck.bn_apply_act_backward_plain(x, *p, dy, "identity", None, mode,
                                         M, extra)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-4, atol=1e-4)
    without = ck.bn_apply_act_backward(x, *p, dy, "identity", None, mode, M)
    assert not torch.equal(got[0], without[0])
    sums = ck.bn_apply_act_backward_sums(x, *p, dy, "identity", None, mode)
    split = ck.bn_apply_act_backward_chain(x, *p, dy, sums[:2].contiguous(), M,
                                           "identity", None, mode, extra)
    assert torch.equal(split[0], got[0])


def test_bn_apply_backward_split_mode_refuses_bad_sums(dev):
    x, p, res, dy = _bn_operands(dev, "cl", 64, 16, 16, False)
    with pytest.raises(ValueError, match="sums"):
        ck.bn_apply_act_backward_chain(x, *p, dy, torch.ones(3, 16,
                                                             device=dev), 64)
    with pytest.raises(ValueError, match="count"):
        ck.bn_apply_act_backward_chain(x, *p, dy, torch.ones(2, 16,
                                                             device=dev), 0)


def test_pipeline_schedules_give_the_same_bits_on_the_card(dev):
    """A 3-stage PipelineOptimizer MLP on the card: GPipe and 1F1B give
    the same parameters after 2 steps, and the losses follow the unsplit
    program's within fp32 reordering."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import layers as L

    rng = np.random.default_rng(0)
    feed = {"x": rng.standard_normal((32, 16)).astype(np.float32),
            "y": rng.standard_normal((32, 1)).astype(np.float32)}
    out = {}
    for schedule in ("gpipe", "1f1b", None):
        main, startup = tpt.Program(), tpt.Program()
        main.random_seed = startup.random_seed = 11
        with tpt.program_guard(main, startup), tpt.unique_name.guard():
            x = L.data(name="x", shape=[16], dtype="float32")
            y = L.data(name="y", shape=[1], dtype="float32")
            h1 = L.fc(x, size=16, act="relu")
            h2 = L.fc(h1, size=16, act="relu")
            loss = L.mean(L.square_error_cost(L.fc(h2, size=1), y))
            opt = tpt.optimizer.SGD(0.05)
            if schedule is not None:
                opt = tpt.optimizer.PipelineOptimizer(
                    opt, cut_list=[[h1], [h2]], num_microbatches=4,
                    schedule=schedule)
            opt.minimize(loss)
        exe, scope = tpt.Executor(dev), tpt.Scope()
        exe.run(startup, scope=scope)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0]) for _ in range(2)]
        out[schedule] = (losses, {p.name: scope.find_var(p.name)
                                  for p in main.all_parameters()})
    assert out["gpipe"][0] == out["1f1b"][0]
    for n, t in out["gpipe"][1].items():
        assert t.device.type == "cuda" and torch.equal(t, out["1f1b"][1][n])
    np.testing.assert_allclose(out["1f1b"][0], out[None][0], rtol=1e-5)


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


# -- the numeric guard on the card ------------------------------------------

def _guarded_program(make_opt):
    """A two-layer regression under FLAGS_guard_numerics: its gradients go
    through the health sentinel before `make_opt(pt)`'s update ops."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import flags
    from paddle_tpu_torch import layers as L

    saved = flags.get_flag("guard_numerics")
    flags.set_flags({"guard_numerics": True})
    try:
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), pt.unique_name.guard():
            x = L.data(name="x", shape=[16], dtype="float32")
            y = L.data(name="y", shape=[1], dtype="float32")
            h = L.fc(x, size=32, act="relu")
            loss = L.mean(L.square_error_cost(L.fc(h, size=1), y))
            make_opt(pt).minimize(loss)
    finally:
        flags.set_flags({"guard_numerics": saved})
    startup.random_seed = 0
    return main, startup, loss


def _guard_feed(d, nan=False):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    if nan:
        x[0, 0] = float("nan")
    return {"x": x.to(d), "y": torch.ones((64, 1), device=d)}


def test_health_sentinel_gates_without_a_host_sync(dev):
    """A guarded step dispatched through run_async under the sync debug
    mode "error" (the sentinel, its gates and the pinned copy of Health
    included); the StepGuard reads the verdict at the drain. Health and
    State match the same steps on the CPU from the same weights within
    1e-5 relative (fp32 sums in another order)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.resilience import StepGuard
    from paddle_tpu_torch.resilience.guardrails import (GUARD_HEALTH_NAME,
                                                        GUARD_STATE_NAME)

    main, startup, _ = _guarded_program(
        lambda pt: pt.optimizer.Momentum(0.1, 0.9))
    vecs = {}
    init = None
    for d in (dev, torch.device("cpu")):
        exe, scope = pt.Executor(place=d), pt.Scope()
        exe.run(startup, scope=scope)
        if init is None:
            init = {n: scope.find_var(n).cpu() for n in scope.var_names()}
        else:
            for n, v in init.items():
                scope.set_var(n, v.clone())
        guard = StepGuard(budget=10)
        exe.set_step_guard(guard)
        exe.run_async(main, feed=_guard_feed(d), fetch_list=[], scope=scope)
        exe.wait()
        bad = _guard_feed(d, nan=True)
        if d.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            exe.run_async(main, feed=bad, fetch_list=[], scope=scope)
        finally:
            if d.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        exe.wait()
        assert guard.skips == 1 and guard.events[-1]["reason"] == "nonfinite"
        vecs[d.type] = [scope.find_var(n).cpu().numpy()
                        for n in (GUARD_HEALTH_NAME, GUARD_STATE_NAME)]
    for got, want in zip(vecs["cuda"], vecs["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, equal_nan=True)


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(-1).view(torch.uint8),
        b.contiguous().view(-1).view(torch.uint8))


@pytest.mark.parametrize("which", ["momentum", "adam"])
def test_skipped_step_is_the_zero_gradient_update(dev, which):
    """A NaN step's gated gradients are zeros, not a frozen state: Momentum
    still moves the parameters by lr mu v and Adam decays its moments and
    advances its beta powers. Every parameter and accumulator after the
    skipped step equals the plain formula on zero gradients from the
    pre-step state, bit for bit."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.resilience.guardrails import GUARD_HEALTH_NAME

    make = {"momentum": lambda pt: pt.optimizer.Momentum(0.1, 0.9),
            "adam": lambda pt: pt.optimizer.Adam(1e-2)}[which]
    main, startup, _ = _guarded_program(make)
    exe, scope = pt.Executor(place=dev), pt.Scope()
    exe.run(startup, scope=scope)
    for _ in range(2):
        exe.run(main, feed=_guard_feed(dev), scope=scope)
    ops = [op for op in main.global_block.ops if op.type == which]
    assert len(ops) == 4
    pre = {n: scope.find_var(n).clone() for n in scope.var_names()}
    exe.run(main, feed=_guard_feed(dev, nan=True), scope=scope)
    assert float(scope.find_var(GUARD_HEALTH_NAME)[3]) == 1.0
    moved = 0
    for op in ops:
        (p,), (lr,) = op.inputs["Param"], op.inputs["LearningRate"]
        p0, lr = pre[p], pre[lr].reshape(())
        if which == "momentum":
            (v,) = op.inputs["Velocity"]
            mu = op.attr("mu")
            v1 = mu * pre[v] + torch.zeros_like(pre[v])
            want = {v: v1, p: p0 - lr * v1}
        else:
            (m1,), (m2,) = op.inputs["Moment1"], op.inputs["Moment2"]
            (b1p,), (b2p,) = op.inputs["Beta1Pow"], op.inputs["Beta2Pow"]
            b1, b2 = op.attr("beta1", 0.9), op.attr("beta2", 0.999)
            eps = op.attr("epsilon", 1e-8)
            g = torch.zeros_like(p0)
            m1n = b1 * pre[m1] + (1 - b1) * g
            m2n = b2 * pre[m2] + (1 - b2) * torch.square(g)
            step = lr * torch.sqrt(1 - pre[b2p].reshape(())) / (
                1 - pre[b1p].reshape(()))
            want = {m1: m1n, m2: m2n,
                    p: p0 - step * (m1n / (torch.sqrt(m2n) + eps)),
                    b1p: pre[b1p] * b1, b2p: pre[b2p] * b2}
        for n, w in want.items():
            assert _same_bits(scope.find_var(n), w), (which, n)
        moved += int(not _same_bits(scope.find_var(p), p0))
    assert moved == len(ops)   # zeroed gradients, not a frozen state


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,R,row,C", [("cl", 4 * 56 * 56, 256, 256),
                                          ("cr", 4 * 256, 3136, 256)])
def test_relu_epilogues_keep_a_nan(dev, dt, mode, R, row, C):
    """K8's and K3's relu keep a NaN, as torch.relu (their plain versions)
    and the TPU kernels' jnp.maximum do: fmaxf(NaN, 0) would give 0 and
    hide a non-finite batch from everything downstream (the numeric
    guard's sentinel among them)."""
    x, p, res, _ = _bn_operands(dev, mode, R, row, C, True)
    x = x.to(dt)
    x.view(-1)[:: 9973] = float("nan")
    res = res.to(dt)
    got = ck.bn_apply_act(x, *p, "relu", res, mode)
    ref = ck.bn_apply_act_plain(x, *p, "relu", res, mode)
    assert int(torch.isnan(ref).sum()) > 0
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    if dt == torch.float32:
        torch.testing.assert_close(got, ref, equal_nan=True, **TOL)
    xl = _randn((37, 768), 1, dev).to(dt)
    xl[5, 17] = float("nan")
    s, b = _randn((768,), 2, dev), _randn((768,), 3, dev)
    got = ck.layer_norm_act(xl, s, b, 1e-5, "relu")[0]
    ref = ck.layer_norm_act_plain(xl, s, b, 1e-5, "relu")[0]
    assert bool(torch.isnan(got[5]).all()) and torch.equal(
        torch.isnan(got), torch.isnan(ref))


# MobileNetV3's batch norms in NCHW at batch 4: 16 channels at 112 x 112
# and 960 at 7 x 7 (chip_smoke.BN_MBV3 at batch 128)
@pytest.mark.parametrize("mode,R,row,C,act", [
    ("cr", 4 * 16, 112 * 112, 16, "relu"), ("cr", 4 * 960, 49, 960, "identity")])
def test_bn_apply_at_mobilenet_v3_rows(dev, mode, R, row, C, act):
    """K8, and K9 in the chain mode the training step runs, against their
    plain versions at MobileNetV3's extreme "cr" rows."""
    x, p, _, dy = _bn_operands(dev, mode, R, row, C, False)
    torch.testing.assert_close(ck.bn_apply_act(x, *p, act, None, mode),
                               ck.bn_apply_act_plain(x, *p, act, None, mode),
                               **TOL)
    count = R * row // C
    got = ck.bn_apply_act_backward(x, *p, dy, act, None, mode, count)
    ref = ck.bn_apply_act_backward_plain(x, *p, dy, act, None, mode, count)
    torch.testing.assert_close(got[0], ref[0], **TOL)
    for g, r in zip(got[4:], ref[4:]):
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())


LONGTAIL_TINY = dict(
    act=(2, 3, 4, 4), red=(2, 6, 3, 3), bert=(2, 4, 8, 50), mlm_rows=6,
    ctr=(16, 3), kl=(4, 10), seg=(2, 4, 8), gn=(2, 64, 3, 3),
    inorm=(1, 4, 4, 4), prelu=(2, 3, 4, 4), sn=(4, 3, 2, 2), tree=(2, 7, 4, 3),
    hs=(8, 5, 40), face=(6, 4, 9), gnd=(3, 5), nce=(16, 5, 300),
    sampled=(8, 200, 40), draws=(6000, 8))
LONGTAIL_OPS = [
    "abs", "logsigmoid", "round", "sin", "softplus", "softsign", "square",
    "relu6", "leaky_relu", "elu", "hard_sigmoid", "swish", "brelu",
    "soft_relu", "thresholded_relu", "hard_swish", "stanh", "selu", "rsqrt",
    "elementwise_floordiv", "elementwise_mod", "reduce_max", "reduce_min",
    "reduce_prod", "reduce_all", "reduce_any", "dot", "norm", "cos_sim",
    "isfinite", "mean_iou", "log_loss", "huber_loss", "kldiv_loss",
    "rank_loss", "margin_rank_loss", "bpr_loss", "center_loss",
    "teacher_student_sigmoid_loss", "fill_zeros_like", "shape", "flatten2",
    "strided_slice", "stack", "unstack", "expand", "gather_nd",
    "scatter_nd_add", "scatter_nd", "cum", "arg_min", "pad2d", "pad",
    "argsort", "linspace", "assign_value", "fill_constant_batch_size_like",
    "hash", "cvm", "log_softmax", "smooth_l1_loss", "group_norm",
    "instance_norm", "lookup_table_v2", "prelu", "data_norm",
    "spectral_norm", "tree_conv", "hierarchical_sigmoid"]


@pytest.mark.parametrize("op", LONGTAIL_OPS)
def test_longtail_op_is_sync_free_and_matches_the_cpu(dev, op, monkeypatch):
    """chip_smoke's long-tail case of `op` at a few elements: forward and
    grads on the card with every op compute under the sync debug mode
    "error", against the CPU (within 1e-5 relative L2, integers bit for
    bit)."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "LT_DIMS", LONGTAIL_TINY)
    case = [c for c in chip_smoke._longtail_cases() if c[0] == op]
    assert len(case) == 1
    _, ins, outs, attrs, cot_shapes, nograd = case[0]
    main, fetch = chip_smoke._seq_program(op, ins, outs, attrs, cot_shapes,
                                          nograd)
    rng = np.random.default_rng(0)
    feed = {n: a for d in ins.values() for n, a in d.items()}
    feed.update({n + "_cot": np.asarray(rng.standard_normal(s), np.float32)
                 for n, s in cot_shapes.items()})
    got, want, seen = chip_smoke._lt_run(dev, main, fetch, feed)
    assert seen.get(op)
    chip_smoke._lt_hold(op, fetch, got, want)


def test_longtail_random_ops_and_draws_on_the_card(dev, monkeypatch):
    """The random creation ops by their laws, nce and the sampled softmax
    by their saved draws, nce under the sync debug mode "error"."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "LT_DIMS", LONGTAIL_TINY)
    rows = []
    counts = chip_smoke._lt_random(dev, "card", rows)
    assert len(rows) == 5
    assert counts == {"softmax_xent_fwd": {"float32": 1},
                      "softmax_xent_bwd": {"float32": 1}}


# YOLOv3's batch norms in NCHW at batch 2: 32 channels at 608 x 608 and 1024
# at 19 x 19 (chip_smoke.BN_YOLO at batch 8); the act identity (the
# leaky_relu is an op of its own)
@pytest.mark.parametrize("mode,R,row,C,act", [
    ("cr", 2 * 32, 608 * 608, 32, "identity"),
    ("cr", 2 * 1024, 19 * 19, 1024, "identity")])
def test_bn_apply_at_yolov3_rows(dev, mode, R, row, C, act):
    """K8, and K9 in chain mode, against their plain versions at YOLOv3's
    longest and shortest "cr" rows."""
    test_bn_apply_at_mobilenet_v3_rows(dev, mode, R, row, C, act)


VISION_TINY = dict(
    bilinear=(2, 3, 5, 11), nearest=(2, 3, 4, 8), trilinear=(1, 2, 3, 5),
    pool3d=(2, 3, 4, 6), conv3d=(1, 3, 4, 5, 4), adaptive2d=(2, 6, 4),
    pixel=(2, 8, 3, 2), shuffle=(2, 6, 3, 2), tsm=(8, 8, 3, 4),
    maxout=(2, 6, 3, 2), lrn=(2, 7, 4), affine=(2, 3, 4, 5),
    multiplex=(3, 6, 5), crop=(1, 3, 9, 5), padlike=(2, 3, 4),
    unfold=(2, 3, 5), grid=(2, 3, 5), btp=(6, 4, 3), shard=(20, 100, 4),
    im2seq=(2, 3, 4, 5), conv3dt=(1, 3, 3, 2), adaptive3d=(2, 4, 2, 3),
    deform=(1, 4, 5, 6), ssd=(2, 5, 3), ssd_scale=4,
    roi_align=(2, 3, 20, 24, 6, 3), roi_pool=(2, 3, 8, 9, 6, 2),
    yolo=(2, 4, 3, 5), anchor=(1, 4, 3, 5), density=(1, 4, 4, 64),
    proposals=(1, 4, 5, 40, 12), psroi=(1, 2, 2, 8, 9, 5),
    sampling=(6000, 5), random_crop=(40, 2, 8, 5))


def _vision_case_names():
    import chip_smoke

    saved = chip_smoke.VI_DIMS
    chip_smoke.VI_DIMS = VISION_TINY
    try:
        return [f"{c[0]}:{i}" for i, c in enumerate(chip_smoke._vision_cases())]
    finally:
        chip_smoke.VI_DIMS = saved


@pytest.mark.parametrize("case", _vision_case_names())
def test_vision_op_is_sync_free_and_matches_the_cpu(dev, case, monkeypatch):
    """chip_smoke's vision or detection case at a few elements: forward and
    grads on the card with every op compute under the sync debug mode
    "error", against the CPU (within 1e-5 relative L2, integers bit for
    bit)."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "VI_DIMS", VISION_TINY)
    op, ins, outs, attrs, cot_shapes, nograd, _ = chip_smoke._vision_cases()[
        int(case.split(":")[1])]
    main, fetch = chip_smoke._seq_program(op, ins, outs, attrs, cot_shapes,
                                          nograd)
    rng = np.random.default_rng(0)
    feed = {n: a for d in ins.values() for n, a in d.items()}
    feed.update({n + "_cot": np.asarray(rng.standard_normal(s), np.float32)
                 for n, s in cot_shapes.items()})
    got, want, seen = chip_smoke._lt_run(dev, main, fetch, feed)
    assert seen.get(op)
    chip_smoke._lt_hold(op, fetch, got, want)


def test_vision_random_ops_on_the_card(dev, monkeypatch):
    """sampling_id and random_crop by their laws, under the sync debug mode
    "error"."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "VI_DIMS", VISION_TINY)
    rows = []
    chip_smoke._vision_random(dev, "card", rows)
    assert len(rows) == 2


def test_resize_nearest_grad_repeats_bit_for_bit_on_the_card(dev):
    """The 2x upsample's grad on the card (a fixed-order gather sum, no
    atomics) is the same bits run after run."""
    import chip_smoke

    x = np.random.default_rng(1).standard_normal((4, 64, 19, 19)).astype(np.float32)
    main, fetch = chip_smoke._seq_program(
        "nearest_interp", {"X": {"x": x}}, {"Out": ["o"]},
        {"out_h": 38, "out_w": 38, "align_corners": True}, {"o": (4, 64, 38, 38)})
    cot = np.random.default_rng(2).standard_normal((4, 64, 38, 38)).astype(np.float32)
    import paddle_tpu_torch as pt

    runs = [pt.Executor(place=dev).run(main, feed=chip_smoke._on(dev, {"x": x, "o_cot": cot}),
                                       fetch_list=fetch, scope=pt.Scope(),
                                       return_numpy=False)[1] for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


# CRNN's batch norms in NCHW at batch 2: 16 channels at 48 x 512 and 128 at
# 6 x 64 (chip_smoke.BN_CRNN at batch 32), relu folded into the norm
@pytest.mark.parametrize("mode,R,row,C,act", [
    ("cr", 2 * 16, 48 * 512, 16, "relu"),
    ("cr", 2 * 128, 6 * 64, 128, "relu")])
def test_bn_apply_at_crnn_rows(dev, mode, R, row, C, act):
    """K8, and K9 in chain mode, against their plain versions at CRNN's
    longest and shortest "cr" rows."""
    test_bn_apply_at_mobilenet_v3_rows(dev, mode, R, row, C, act)


# chip_smoke's crf/ctc/quant cases at SRL_B = 4 and CRNN_B = 3 (the tiny
# rehearsal's batches; the other extents as chip_smoke runs them)
CRF_CTC_TINY = dict(SRL_B=4, CRNN_B=3)


def _crf_ctc_case_names():
    import chip_smoke

    saved = {k: getattr(chip_smoke, k) for k in CRF_CTC_TINY}
    for k, v in CRF_CTC_TINY.items():
        setattr(chip_smoke, k, v)
    try:
        return [f"{c[0]}:{i}" for i, c in enumerate(chip_smoke._crf_ctc_cases())]
    finally:
        for k, v in saved.items():
            setattr(chip_smoke, k, v)


@pytest.mark.parametrize("case", _crf_ctc_case_names())
def test_crf_ctc_op_matches_the_cpu(dev, case, monkeypatch):
    """chip_smoke's crf, ctc or quant case: forward and grads on the card
    against the CPU (within 1e-5 relative L2, integers bit for bit), every
    op but the host op chunk_eval under the sync debug mode "error"."""
    import chip_smoke

    for k, v in CRF_CTC_TINY.items():
        monkeypatch.setattr(chip_smoke, k, v)
    c = chip_smoke._crf_ctc_cases()[int(case.split(":")[1])]
    op, ins, outs, attrs, cot_shapes, nograd, _ = c
    main, fetch = chip_smoke._seq_program(op, ins, outs, attrs, cot_shapes,
                                          nograd)
    rng = np.random.default_rng(0)
    feed = {n: a for d in ins.values() for n, a in d.items()}
    feed.update({n + "_cot": np.asarray(rng.standard_normal(s), np.float32)
                 for n, s in cot_shapes.items()})
    got, want, seen = chip_smoke._lt_run(dev, main, fetch, feed,
                                         sync_free=op != "chunk_eval")
    assert bool(seen.get(op)) == (op != "chunk_eval")
    chip_smoke._lt_hold(op, fetch, got, want)
    if op == "warpctc":
        assert "F.ctc_loss" in chip_smoke._ctc_loss_oracle(dev, c)


SMOKE_CRF_CTC_TINY = dict(
    SRL_DEPTH=2, SRL_HIDDEN=32, SRL_B=4, SRL_STEPS=3, SRL_EVAL_BATCHES=2,
    CRNN_SHAPE=(1, 16, 64), CRNN_CHANNELS=(16, 32), CRNN_HIDDEN=16, CRNN_B=3,
    CRNN_STEPS=2, CRNN_EVAL=2, CRNN_QAT_STEPS=2)


def test_srl_held_step_on_the_card(dev, monkeypatch):
    """chip_smoke's train_srl at depth 2, hidden 32, B = 4: step 1 against
    the CPU, a step under the sync debug mode "error", the decode clone
    with the ChunkEvaluator (chunk_eval's syncs counted)."""
    import chip_smoke

    for k, v in SMOKE_CRF_CTC_TINY.items():
        monkeypatch.setattr(chip_smoke, k, v)
    assert chip_smoke.train_srl(dev, "card") == {}


def test_crnn_ctc_held_step_and_qat_on_the_card(dev, monkeypatch):
    """chip_smoke's train_crnn_ctc at 16 x 64, two conv groups, B = 3: step
    1 against the CPU with K8/K9 once a batch norm, a step under the sync
    debug mode "error", the eval clone, and the QAT arm's freeze and int8
    clones."""
    import chip_smoke

    for k, v in SMOKE_CRF_CTC_TINY.items():
        monkeypatch.setattr(chip_smoke, k, v)
    counts = chip_smoke.train_crnn_ctc(dev, "card")
    assert counts[0] == {"bn_apply_act": {"float32": 4},
                         "bn_apply_act_backward": {"float32": 4}}


# -- the tuner's attention route on the card -----------------------------------

TUNER_FLAGS = ("tuning_mode", "tuning_db", "tuning_measurements",
               "tuning_model", "attention_force_backend")
PAIRS = {"pallas_short": ("causal_prefill_attention", "attention_backward"),
         "flash_bundled": ("flash_attention_fwd", "flash_attention_backward")}


@pytest.fixture
def tuner(tmp_path):
    """The port's tuner on a scratch DB, store and (absent) model; flags
    and caches restored after."""
    from paddle_tpu_torch import flags, tuning

    saved = {k: flags.get_flag(k) for k in TUNER_FLAGS}
    paths = {k: str(tmp_path / k) for k in ("db.json", "meas.jsonl")}
    flags.set_flags({"tuning_db": paths["db.json"],
                     "tuning_measurements": paths["meas.jsonl"],
                     "tuning_model": str(tmp_path / "absent.json")})

    def reset():
        tuning.invalidate_db_cache()
        tuning.reset_provenance()
        tuning.learned.invalidate_model_cache()
        tuning.learned.explore.reset_state()

    reset()
    yield paths
    flags.set_flags(saved)
    reset()


def test_forced_attention_routes_agree_at_s512_bf16(dev, tuner):
    """bench.py:137's attention at B = 2, [2, 12, 512, 64] bf16, under
    FLAGS_attention_force_backend: each route launches its own pair (K10
    twice: the grad op without the forward's stash runs it again) and not
    the other's, and the two agree in forward and backward within bf16
    rounding (`_close16`, the backward with the 2e-2 floor of K4's bf16
    hold: dQ, dK, dV sum 512 terms rounded on both routes)."""
    from paddle_tpu_torch import flags

    ins = {s: _randn((2, 12, 512, 64), 80 + i, dev).to(BF)
           for i, s in enumerate("QKV")}
    do = _randn((2, 12, 512, 64), 83, dev).to(BF)
    attrs = {"causal": False, "sm_scale": 0.125}
    res = {}
    for route, pair in PAIRS.items():
        flags.set_flags({"attention_force_backend": route})
        ck.reset_launch_counts()
        out = _run_op("fused_attention", ins, (), attrs, dev)["Out"]
        grads = _run_op("fused_attention_grad", dict(ins, **{"Out@GRAD": do}),
                        ("Q@GRAD", "K@GRAD", "V@GRAD"), attrs, dev)
        counts = {k: v for k, v in ck.launch_counts().items() if v}
        assert set(counts) == set(pair) and counts[pair[1]] == 1, counts
        res[route] = (out, [grads[s + "@GRAD"] for s in "QKV"])
    _close16(res["flash_bundled"][0], res["pallas_short"][0])
    for a, b in zip(res["flash_bundled"][1], res["pallas_short"][1]):
        _close16(a, b, floor=2e-2)


def test_explore_probe_times_both_routes_on_the_card(dev, tuner):
    """A real probe of one attention candidate ([2, 12, 512, 64] bf16,
    keyed under the card's name): both arms timed forward + backward on
    their kernels, a verdict, both arms' evidence in the DB entry and two
    store rows from "explore"."""
    from paddle_tpu_torch import flags, tuning

    flags.set_flags({"tuning_mode": "explore"})
    kind = tuning.device_kind(dev)
    assert kind == torch.cuda.get_device_name(0)
    key = tuning.canonical_key("attention", tuning.attention_key(
        2, 12, 512, 512, 64, False), "bfloat16", kind)
    db = tuning.TuningDB(tuner["db.json"])
    db.put(key, {"backend": "pallas_short"}, source="candidate")
    db.save()
    tuning.invalidate_db_cache()
    ck.reset_launch_counts()
    out = tuning.learned.explore.explore_one()
    assert out["key"] == key and out["verdict"] in ("keep", "tie", "retire")
    entry = tuning.TuningDB(tuner["db.json"]).lookup(key)
    assert set(entry["measured"]) == set(PAIRS)
    assert all(e["median_s"] > 0 for e in entry["measured"].values())
    rows = list(tuning.learned.iter_records(tuner["meas.jsonl"]))
    assert {(r["arm"], r["source"], r["device_kind"]) for r in rows} == {
        (arm, "explore", kind) for arm in PAIRS}
    counts = ck.launch_counts_by_dtype()
    for pair in PAIRS.values():
        assert all(counts[w].get("bfloat16") for w in pair), counts


# -- tensor parallelism: the kernels at the shard shapes -------------------------

@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
def test_xent_at_a_vocab_shard_with_labels_outside(dev, dt):
    """K6 and K7 on one rank's slice of BERT-base's vocabulary (15261 of
    30522 classes) with a third of the labels outside [0, V) (the other
    ranks' classes: K6 picks 0, K7 subtracts nothing), K7 in its
    saved-stats mode with the whole row's (M, lse), as the vocab-parallel
    grad runs it."""
    N, V = 4096, 15261
    rng = np.random.default_rng(70)
    full = torch.from_numpy((3 * rng.standard_normal((N, 2 * V))).astype(
        np.float32)).to(dev, dt)
    x = full[:, :V].contiguous()
    lab = torch.from_numpy(rng.integers(0, 2 * V, N).astype(np.int32)).to(dev)
    lab[::3] = -5
    assert int(((lab < 0) | (lab >= V)).sum()) > N // 3
    g = _randn((N,), 71, dev)
    for got, ref in zip(ck.softmax_xent_fwd(x, lab),
                        ck.softmax_xent_fwd_plain(x, lab)):
        torch.testing.assert_close(got, ref, **TOL)
    m = full.float().amax(-1)
    lse = torch.logsumexp(full.float() - m[:, None], -1)
    _xent_close(ck.softmax_xent_bwd(x, lab, g, m, lse),
                ck.softmax_xent_bwd_plain(x, lab, g, m, lse))


class _OneRank:
    """A tp group of one rank: the vocab-parallel path's reductions over
    it are the identity."""
    size, index, pg, backend, ranks = 1, 0, None, "", [0]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_vocab_parallel_xent_on_one_rank_is_unsharded_k6(dev, dt):
    """The vocab-parallel forward and grad (the rewrite's `tp_vocab` mark)
    over a one-rank group: the loss and the logits gradient of K6/K7 on
    the unsharded logits."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.ops.collective_ops import AXIS_ENV_KEY, TP_RING
    from paddle_tpu_torch.ops.registry import run_block

    N, V = 512, 30522
    main = pt.Program()
    with pt.program_guard(main, pt.Program()), pt.unique_name.guard():
        x = L.data(name="x", shape=[V], dtype=dt)
        x.stop_gradient = False
        lab = L.data(name="lab", shape=[1], dtype="int64")
        loss = L.reduce_sum(L.softmax_with_cross_entropy(x, lab))
        pt.backward.append_backward(loss)
    rng = np.random.default_rng(72)
    feed = {"x": (3 * _randn((N, V), 73, dev)).to(
        BF if dt == "bfloat16" else torch.float32),
        "lab": torch.from_numpy(rng.integers(0, V, (N, 1)).astype(
            np.int32)).to(dev)}
    outs = {}
    for marked in (False, True):
        for op in main.global_block.ops:
            if op.type.startswith("softmax_with_cross_entropy"):
                if marked:
                    op.tp_vocab = TP_RING
                elif hasattr(op, "tp_vocab"):
                    del op.tp_vocab
        env = dict(feed, **{AXIS_ENV_KEY: {TP_RING: _OneRank()}})
        env = run_block(main.global_block, env, dev)
        outs[marked] = (env[loss.name], env["x@GRAD"])
    torch.testing.assert_close(outs[True][0].float(), outs[False][0].float(),
                               rtol=1e-4, atol=1e-3)
    _xent_close(outs[True][1], outs[False][1])


def test_paged_decode_at_a_tp_shards_heads(dev):
    """K1 at 6 of the serving model's 12 heads (a tp = 2 rank's pools)."""
    args = _paged(dev, [1, 16, 17, 83, 0, 2], 16, 6, 64, 64)
    got = ck.paged_decode_attention(*args, sm_scale=0.125)
    ref = ck.paged_decode_attention_plain(*args, sm_scale=0.125)
    live = args[4] > 0
    torch.testing.assert_close(got[live], ref[live], **TOL)
    assert bool((got[~live] == 0).all())


def _sp_one_rank(main, startup, feed, fetch, dev, feeds_sharded):
    """`main` run plainly and as the sequence-parallel rewrite's clone over
    a one-rank `sp` group (the halo exchanges, gathers and slices of a
    group of one are the identity), from one startup: both runs' `fetch`
    and the clone's op types."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.collective_ops import AXIS_ENV_KEY, SP_RING
    from paddle_tpu_torch.ops.registry import run_block
    from paddle_tpu_torch.parallel.spatial import sequence_parallel_rewrite

    scope = pt.Scope()
    pt.Executor(place=dev).run(startup, scope=scope)
    state = {n: scope.find_var(n) for n, v in main.global_block.vars.items()
             if v.persistable and scope.find_var(n) is not None}
    clone, _ = sequence_parallel_rewrite(main, _OneRank(), SP_RING,
                                         feeds_sharded)
    outs = []
    bound = {AXIS_ENV_KEY: {SP_RING: _OneRank()}}
    for prog, env in ((main, {}), (clone, bound)):
        env = run_block(prog.global_block, dict(state, **feed, **env), dev)
        outs.append([env[n] for n in fetch])
    return outs, [op.type for op in clone.global_block.ops]


def test_halo_conv_pool_and_bn_on_one_sp_rank_are_the_plain_ops(dev):
    """The spatial partition's window ops and synced batch norm on a
    one-rank sp group: the s2d stem's 4 x 4 conv with padding [2, 1, 2, 1]
    (the H padding applied by the halo path, only at the global edges), a
    3 x 3 stride-2 max pool, a 3 x 3 stride-2 conv, a training batch norm
    on K8 / K9's split mode, a global average pool, NHWC fp32: the loss
    and every gradient of the plain ops, and K8 and K9's split mode ran."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 3
    with pt.program_guard(main, startup), pt.unique_name.guard():
        img = L.data(name="img", shape=[28, 28, 3], dtype="float32")
        img.stop_gradient = False
        img.sharding = ("dp", "sp", None, None)
        x = L.conv2d(img, num_filters=8, filter_size=4, padding=[2, 1, 2, 1],
                     bias_attr=False, data_format="NHWC")
        x = L.pool2d(x, pool_size=3, pool_type="max", pool_stride=2,
                     pool_padding=1, data_format="NHWC")
        x = L.conv2d(x, num_filters=16, filter_size=3, stride=2, padding=1,
                     bias_attr=False, data_format="NHWC")
        x = L.batch_norm(x, act="relu", data_layout="NHWC")
        x = L.pool2d(x, pool_type="avg", global_pooling=True,
                     data_format="NHWC")
        loss = L.reduce_sum(L.square(x))
        grads = pt.backward.append_backward(loss)
    fetch = [loss.name, "img@GRAD"] + [g.name for _, g in grads]
    ck.reset_launch_counts()
    (plain, split), types = _sp_one_rank(
        main, startup, {"img": _randn((4, 28, 28, 3), 91, dev)}, fetch, dev,
        ["img"])
    for a, b in zip(split, plain):
        torch.testing.assert_close(a, b, **TOL)
    counts = ck.launch_counts()
    assert counts["bn_apply_act_backward_sums"] == 1
    assert counts["bn_apply_act_backward_chain"] == 1
    assert counts["bn_apply_act"] == 2
    assert "tp_gather" not in types


def test_gathered_attention_on_one_sp_rank_is_the_plain_op(dev):
    """bert_tiny(use_sp=True)'s forward and backward as the rewrite's clone
    over a one-rank sp group: Q, K and V gathered on S (the identity here),
    K2 and K4 at the full S, this rank's rows of Out, dQ, dK, dV kept: the
    loss and every parameter gradient of the plain program, fp32."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer as tr

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 5
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = tr.bert_pretrain(tr.bert_tiny(use_tp=False, use_sp=True),
                                   seq_len=64)
        grads = pt.backward.append_backward(loss)
    rng = np.random.default_rng(92)
    B, S = 4, 64
    feed = {"src_ids": rng.integers(0, 1024, (B, S)),
            "pos_ids": np.tile(np.arange(S), (B, 1)),
            "lm_label": rng.integers(0, 1024, (B, S)),
            "lm_weight": (rng.random((B, S)) < 0.5).astype(np.float32)}
    feed = {n: torch.from_numpy(np.asarray(a)).to(dev)
            for n, a in feed.items()}
    fetch = [loss.name] + [g.name for _, g in grads]
    ck.reset_launch_counts()
    (plain, split), types = _sp_one_rank(main, startup, feed, fetch, dev,
                                         list(feed))
    for a, b in zip(split, plain):
        torch.testing.assert_close(a, b, **TOL)
    counts = ck.launch_counts()
    assert counts["causal_prefill_attention"] == 2 * 2
    assert counts["attention_backward"] == 2 * 2
    assert types.count("tp_gather") == 2 * 3 + 2
