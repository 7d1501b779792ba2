"""The port's CUDA kernels on the card, each held against its plain PyTorch
version, plus the wrappers' input checks, the serving engine against its
dense oracle and a bert_tiny training step against the same step run on
the CPU (the kernels' plain versions) on the GPU. Every test needs an NVIDIA GPU and skips without
one. The file imports neither jax nor paddle_tpu, so it also runs on a
machine with only PyTorch:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Tolerance: |kernel - plain| <= 1e-5 + 1e-4 |plain| (fp32, TF32 off, sums
in another order)."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import cuda_kernels as ck

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


@pytest.mark.parametrize("S,dh", [(1, 64), (8, 64), (100, 64), (512, 64),
                                  (77, 8), (33, 40), (130, 128)])
def test_prefill_matches_plain(dev, S, dh):
    q, k, v = (_randn((2, 3, S, dh), S + i, dev) for i in range(3))
    for causal in (True, False):
        got = ck.causal_prefill_attention(q, k, v, causal, dh ** -0.5)
        ref = ck.causal_prefill_attention_plain(q, k, v, causal, dh ** -0.5)
        torch.testing.assert_close(got, ref, **TOL)


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


@pytest.mark.parametrize("B,nh,S,dh,causal,lens", [
    (32, 12, 128, 64, False, None), (1, 2, 512, 64, False, None),
    (2, 3, 100, 64, True, None), (3, 2, 77, 40, True, [77, 5, 0]),
    (2, 2, 130, 128, True, None), (2, 2, 1, 8, False, None)])
def test_attention_backward_matches_plain(dev, B, nh, S, dh, causal, lens):
    q, k, v, do = (_randn((B, nh, S, dh), S + i, dev) for i in range(4))
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    got = ck.attention_backward(q, k, v, do, causal, dh ** -0.5, kl)
    ref = ck.attention_backward_plain(q, k, v, do, causal, dh ** -0.5, kl)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **TOL)
    if lens is not None:
        assert all(bool((g[2] == 0).all()) for g in got)


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
    torch.testing.assert_close(ck.softmax_xent_bwd(x, lab, g),
                               ck.softmax_xent_bwd_plain(x, lab, g), **TOL)
    torch.testing.assert_close(ck.softmax_xent_bwd(x, lab, g, fwd[1], fwd[2]),
                               ck.softmax_xent_bwd_plain(x, lab, g, fwd[1],
                                                         fwd[2]), **TOL)


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
                                  "softmax_xent_bwd": 0}


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
