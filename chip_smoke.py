#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) end to end on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit, no result line):
  1. build  — compile every CUDA kernel of the port from the sources in
              this checkout (one nvcc per source, in parallel);
  2. kernel checks — call each kernel at its main path's shapes and hold
              it against its plain PyTorch version on the same inputs
              (fp32, TF32 off; |kernel - plain| <= ATOL + RTOL * |plain|),
              and time kernel, plain version and a one-call PyTorch
              yardstick with CUDA events, L2 flushed before every call:
              K1-K3 at the serving shapes, K4-K7 at the training shapes;
  3. serving — ServingEngine(DecoderConfig()) (BERT-base width, 12 layers,
              random weights from seed 0) serves 6 requests with prompts of
              5..400 tokens; every request must finish with zero leaked
              pages, the serving kernels' launch counts must have moved,
              and the greedy tokens must equal the port's own dense
              full-forward replay on the same scope;
  4. training — bert_pretrain(BERT-base, seq 128) + Adam(1e-4) through
              Program/Executor, B=32, fp32, random weights from seed 0:
              step 1's loss, every parameter gradient and the updated
              parameters must agree with a plain-torch autograd oracle on
              the same weights and batch, each training kernel must launch
              its expected count in the step, and the loss must fall over
              5 more steps (timed: steps/s, tokens/s, model FLOP/s);
  5. output — the `kernels` JSON line, the card line (nvidia-smi name and
              power limit), and last the `ok` JSON line.
Needs one CUDA device; exits non-zero without one.

    python3 chip_smoke.py --profile

also traces one more serving pass and one more training step with
torch.profiler and prints where the device time went (per kernel, and the
device's busy share of the wall time).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

RTOL, ATOL = 1e-4, 1e-5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, fp32 outside tensor cores
SEED = 0
SERVE_KERNELS = ("paged_decode_attention", "causal_prefill_attention",
                 "layer_norm_act")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


class _Timer:
    """Median device time of one call, each call timed alone with CUDA
    events after a write that evicts the 50 MB L2 (the serving path finds
    every layer's weights and KV pool cold). A spin of about a millisecond
    on the device before the start event lets the host enqueue the whole
    call first, so the time is the device's, not the Python wrapper's."""

    def __init__(self, device):
        self.flush = torch.empty(96 * 2**20 // 4, dtype=torch.float32,
                                 device=device)

    def __call__(self, fn, reps: int = 15) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def _agree(name: str, out: torch.Tensor, ref: torch.Tensor,
           atol: float = ATOL) -> float:
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"{name}: shape {tuple(out.shape)} vs "
                           f"{tuple(ref.shape)} or non-finite output")
    err = (out - ref).abs()
    if not bool((err <= atol + RTOL * ref.abs()).all()):
        raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                           f"(max abs err {err.max().item():.3e})")
    return float(err.max().item())


def _row(name, shape, ms, plain_ms, lib_ms, bound_ms, bound_by, err, card):
    lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
    print(f"{name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {lib} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"max_abs_err {err:.3e} [{card}]")


def check_paged_decode(dev, timer, card):
    from paddle_tpu_torch.ops.cuda_kernels import paged_attention as K

    g = torch.Generator(device="cpu").manual_seed(SEED)
    B, nh, dh, ps, P, pages = 8, 12, 64, 16, 32, 512
    lens = torch.tensor([1, 16, 17, 500, 0, 33, 257, 64], dtype=torch.int32)
    perm = torch.randperm(pages, generator=g)
    table = torch.zeros((B, P), dtype=torch.int32)
    used = 0
    for b in range(B):
        n = -(-int(lens[b]) // ps)
        table[b, :n] = perm[used:used + n]
        used += n
    q = torch.randn((B, nh, dh), generator=g).to(dev)
    kp = torch.randn((pages, ps, nh, dh), generator=g).to(dev)
    vp = torch.randn((pages, ps, nh, dh), generator=g).to(dev)
    table, lens_d = table.to(dev), lens.to(dev)
    scale = dh ** -0.5
    out = K.paged_decode_attention(q, kp, vp, table, lens_d, scale)
    ref = K.paged_decode_attention_plain(q, kp, vp, table, lens_d, scale)
    live = lens_d > 0
    err = _agree("paged_decode_attention", out[live], ref[live])
    if not bool((out[~live] == 0).all()):
        raise RuntimeError("paged_decode_attention: kv_len 0 row not zero")
    ms = timer(lambda: K.paged_decode_attention(q, kp, vp, table, lens_d, scale))
    plain_ms = timer(lambda: K.paged_decode_attention_plain(
        q, kp, vp, table, lens_d, scale))
    # the live slots' K and V (what this data needs), q, out, table, lens
    nbytes = (2 * int(lens.sum()) * nh * dh * 4 + 2 * q.numel() * 4
              + table.numel() * 4 + B * 4)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    _row("K1 paged_decode_attention", f"B={B} nh={nh} dh={dh} ps={ps} P={P} "
         f"lens={lens.tolist()}", ms, plain_ms, None, bound, "bytes", err, card)
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "paddle_tpu_torch/ops/cuda_kernels/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels/paged_attention.py:164",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None}


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _attn_bound(B, nh, S, dh, causal, lens=None, products=2, tensors=4):
    """The (query, key) pairs this data leaves live, 2 flops a pair and dim
    for each of `products` products; `tensors` [B, nh, S, dh] tensors moved
    once (forward: 2 products, q, k, v, out; backward: 5 products, q, k, v,
    dO, dq, dk, dv)."""
    pairs = 0
    for b in range(B):
        L = S if lens is None else int(lens[b])
        pairs += sum(min(i + 1, L) if causal else L for i in range(S))
    return _bound(2 * products * pairs * dh * nh, tensors * B * nh * S * dh * 4)


def check_prefill(dev, timer, card):
    from paddle_tpu_torch.ops.cuda_kernels import prefill_attention as K
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    nh, dh = 12, 64
    scale = dh ** -0.5
    entry = None
    # the serving prefill buckets (causal), a ragged batch, and the
    # training step's shape (B=32, S=128, not causal)
    cases = [(1, S, None, True) for S in (8, 100, 128, 256, 512)]
    cases.append((2, 128, torch.tensor([100, 0], dtype=torch.int32), True))
    cases.append((32, 128, None, False))
    for B, S, lens, causal in cases:
        q, k, v = (torch.randn((B, nh, S, dh), generator=g).to(dev)
                   for _ in range(3))
        kl = None if lens is None else lens.to(dev)
        out = K.causal_prefill_attention(q, k, v, causal, scale, kl)
        ref = K.causal_prefill_attention_plain(q, k, v, causal, scale, kl)
        err = _agree(f"causal_prefill_attention B={B} S={S}", out, ref)
        ms = timer(lambda: K.causal_prefill_attention(q, k, v, causal, scale, kl))
        plain_ms = timer(lambda: K.causal_prefill_attention_plain(
            q, k, v, causal, scale, kl))
        lib_ms = None
        if kl is None:
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=scale))
        bound, by = _attn_bound(B, nh, S, dh, causal,
                                None if lens is None else lens.tolist())
        _row("K2 causal_prefill_attention",
             f"B={B} nh={nh} S={S} dh={dh} causal={causal}"
             + ("" if lens is None else f" kv_lens={lens.tolist()}"),
             ms, plain_ms, lib_ms, bound, by, err, card)
        if S == 512:
            entry = {"name": "causal_prefill_attention", "route": "cuda",
                     "source": "paddle_tpu_torch/ops/cuda_kernels/csrc/prefill_attention.cu",
                     "replaces": "paddle_tpu/ops/pallas_kernels/short_attention.py:248 "
                                 "+ paddle_tpu/ops/pallas_kernels/attention.py:211",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
    return entry


def check_layer_norm(dev, timer, card):
    from paddle_tpu_torch.ops.cuda_kernels import layer_norm as K
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    K_ = 768
    entry = None
    # decode rows, a prefill bucket, and the training step's 4096 rows
    for R, act in ((1, "identity"), (8, "identity"), (8, "relu"),
                   (512, "identity"), (4096, "identity")):
        x = torch.randn((R, K_), generator=g).to(dev)
        s = (1 + 0.1 * torch.randn((K_,), generator=g)).to(dev)
        b = (0.1 * torch.randn((K_,), generator=g)).to(dev)
        out = K.layer_norm_act(x, s, b, 1e-5, act)
        ref = K.layer_norm_act_plain(x, s, b, 1e-5, act)
        err = max(_agree(f"layer_norm_act R={R} {act} {part}", o, r)
                  for part, o, r in zip(("y", "mean", "var"), out, ref))
        ms = timer(lambda: K.layer_norm_act(x, s, b, 1e-5, act))
        plain_ms = timer(lambda: K.layer_norm_act_plain(x, s, b, 1e-5, act))
        lib_ms = None
        if act == "identity":
            lib_ms = timer(lambda: F.layer_norm(x, (K_,), s, b, 1e-5))
        nbytes = (2 * R * K_ + 2 * K_ + 2 * R) * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        _row("K3 layer_norm_act", f"R={R} K={K_} act={act}", ms, plain_ms,
             lib_ms, bound, "bytes", err, card)
        if R == 512:
            entry = {"name": "layer_norm_act", "route": "cuda",
                     "source": "paddle_tpu_torch/ops/cuda_kernels/csrc/layer_norm.cu",
                     "replaces": "paddle_tpu/ops/pallas_kernels/epilogue.py:421",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": "bytes",
                     "library_ms": lib_ms}
    return entry


def _autograd_lib(fn, inputs, cot):
    """A one-call PyTorch yardstick for a backward: fn's graph built once,
    the timed call is torch.autograd.grad of it."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True)


def check_attention_backward(dev, timer, card):
    from paddle_tpu_torch.ops.cuda_kernels import attention_bwd as K
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(SEED + 3)
    nh, dh = 12, 64
    scale = dh ** -0.5
    entry = None
    # the training shape, #5's domain at S=512, and #3's ragged causal case
    for B, S, causal, lens in ((32, 128, False, None), (4, 512, False, None),
                               (2, 128, True, torch.tensor([100, 0],
                                                          dtype=torch.int32))):
        q, k, v, do = (torch.randn((B, nh, S, dh), generator=g).to(dev)
                       for _ in range(4))
        kl = None if lens is None else lens.to(dev)
        got = K.attention_backward(q, k, v, do, causal, scale, kl)
        ref = K.attention_backward_plain(q, k, v, do, causal, scale, kl)
        err = max(_agree(f"attention_backward S={S} d{n}", o, r)
                  for n, o, r in zip("qkv", got, ref))
        ms = timer(lambda: K.attention_backward(q, k, v, do, causal, scale, kl))
        plain_ms = timer(lambda: K.attention_backward_plain(
            q, k, v, do, causal, scale, kl))
        lib_ms = None
        if kl is None:
            lib_ms = timer(_autograd_lib(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, scale=scale), (q, k, v), do))
        bound, by = _attn_bound(B, nh, S, dh, causal,
                                None if lens is None else lens.tolist(),
                                products=5, tensors=7)
        _row("K4 attention_backward",
             f"B={B} nh={nh} S={S} dh={dh} causal={causal}"
             + ("" if lens is None else f" kv_lens={lens.tolist()}"),
             ms, plain_ms, lib_ms, bound, by, err, card)
        if entry is None:
            entry = {"name": "attention_backward", "route": "cuda",
                     "source": "paddle_tpu_torch/ops/cuda_kernels/csrc/attention_backward.cu",
                     "replaces": "paddle_tpu/ops/pallas_kernels/short_attention.py:164 "
                                 "+ paddle_tpu/ops/pallas_kernels/attention.py:154",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
    return entry


def check_layer_norm_backward(dev, timer, card):
    from paddle_tpu_torch.ops.cuda_kernels import layer_norm_bwd as K
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(SEED + 4)
    R, K_ = 4096, 768
    x, dy = (torch.randn((R, K_), generator=g).to(dev) for _ in range(2))
    s = (1 + 0.1 * torch.randn((K_,), generator=g)).to(dev)
    b = (0.1 * torch.randn((K_,), generator=g)).to(dev)
    got = K.layer_norm_act_backward(x, s, b, dy, 1e-5, "identity")
    ref = K.layer_norm_act_backward_plain(x, s, b, dy, 1e-5, "identity")
    # dscale/dbias sum 4096 rows: an absolute floor of 1e-4 for that order
    err = max(_agree(f"layer_norm_act_backward {n}", o, r, atol=1e-4)
              for n, o, r in zip(("dx", "dscale", "dbias"), got, ref))
    ms = timer(lambda: K.layer_norm_act_backward(x, s, b, dy, 1e-5, "identity"))
    plain_ms = timer(lambda: K.layer_norm_act_backward_plain(
        x, s, b, dy, 1e-5, "identity"))
    lib_ms = timer(_autograd_lib(lambda x, s, b: F.layer_norm(
        x, (K_,), s, b, 1e-5), (x, s, b), dy))
    bound, by = _bound(0, (3 * R * K_ + 4 * K_) * 4)
    _row("K5 layer_norm_act_backward", f"R={R} K={K_} act=identity", ms,
         plain_ms, lib_ms, bound, by, err, card)
    return {"name": "layer_norm_act_backward", "route": "cuda",
            "source": "paddle_tpu_torch/ops/cuda_kernels/csrc/layer_norm_backward.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels/epilogue.py:373",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


def check_softmax_xent(dev, timer, card):
    from paddle_tpu_torch.ops.cuda_kernels import xent_bwd as KB
    from paddle_tpu_torch.ops.cuda_kernels import xent_fwd as KF
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(SEED + 5)
    N, V = 4096, 30522          # the BERT-base lm head at B=32, S=128
    x = (3 * torch.randn((N, V), generator=g)).to(dev)
    lab = torch.randint(0, V, (N,), generator=g, dtype=torch.int32).to(dev)
    gl = torch.randn((N,), generator=g).to(dev)
    lab64 = lab.long()

    fwd = KF.softmax_xent_fwd(x, lab)
    err = max(_agree(f"softmax_xent_fwd {n}", o, r) for n, o, r in zip(
        ("loss", "m", "lse"), fwd, KF.softmax_xent_fwd_plain(x, lab)))
    ms = timer(lambda: KF.softmax_xent_fwd(x, lab))
    plain_ms = timer(lambda: KF.softmax_xent_fwd_plain(x, lab))
    lib_ms = timer(lambda: F.cross_entropy(x, lab64, reduction="none"))
    bound, by = _bound(0, N * V * 4 + 4 * N * 4)
    _row("K6 softmax_xent_fwd", f"N={N} V={V}", ms, plain_ms, lib_ms, bound,
         by, err, card)
    k6 = {"name": "softmax_xent_fwd", "route": "cuda",
          "source": "paddle_tpu_torch/ops/cuda_kernels/csrc/softmax_xent_fwd.cu",
          "replaces": "paddle_tpu/ops/pallas_kernels/xent.py:221",
          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}

    lib_bwd = timer(_autograd_lib(lambda x: F.cross_entropy(
        x, lab64, reduction="none"), (x,), gl))
    k7 = None
    for mode, stats in (("recomputed stats (program path, #12)", ()),
                        ("saved stats (#11)", fwd[1:])):
        got = KB.softmax_xent_bwd(x, lab, gl, *stats)
        e = _agree(f"softmax_xent_bwd {mode}", got,
                   KB.softmax_xent_bwd_plain(x, lab, gl, *stats))
        ms = timer(lambda: KB.softmax_xent_bwd(x, lab, gl, *stats))
        plain_ms = timer(lambda: KB.softmax_xent_bwd_plain(x, lab, gl, *stats))
        bound, by = _bound(0, 2 * N * V * 4 + (2 + len(stats)) * N * 4)
        _row("K7 softmax_xent_bwd", f"N={N} V={V} {mode}", ms, plain_ms,
             lib_bwd, bound, by, e, card)
        if k7 is None:
            k7 = {"name": "softmax_xent_bwd", "route": "cuda",
                  "source": "paddle_tpu_torch/ops/cuda_kernels/csrc/softmax_xent_bwd.cu",
                  "replaces": "paddle_tpu/ops/pallas_kernels/xent.py:228 "
                              "+ paddle_tpu/ops/pallas_kernels/xent.py:139",
                  "max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound, "bound_by": by, "library_ms": lib_bwd}
    return [k6, k7]


def serve(dev, card):
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.framework import Program, program_guard
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import (DecoderConfig, ServingEngine,
                                          build_full_forward_program)
    from paddle_tpu_torch.serving import model as sv_model

    cfg = DecoderConfig()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    names = eng.parameter_names()
    n_elems = sum(eng._scope.find_var(n).numel() for n in names)
    print(f"engine built in {time.perf_counter() - t0:.2f} s ({len(names)} "
          f"parameters, {n_elems} elements; ops a run: prefill "
          f"{len(eng._prefill_prog.global_block.ops)}, decode "
          f"{len(eng._decode_prog.global_block.ops)}; pool "
          f"{eng.pool_pages}x{eng.page_size}) [{card}]")
    # one short request first: CUDA context, cuBLAS handles, allocator
    eng.submit([1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=2)
    eng.run_until_drained()

    rng = np.random.default_rng(SEED)
    lens, new = (5, 17, 64, 130, 257, 400), 16
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)] for n in lens]
    steps0 = eng.stats["decode_steps"]
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ck.launch_counts()

    for rid in rids:
        if eng.requests[rid].state != "finished":
            raise RuntimeError(f"request {rid} ended {eng.requests[rid].state}")
    if eng.leaked_pages():
        raise RuntimeError(f"{eng.leaked_pages()} leaked pages")
    if min(counts[k] for k in SERVE_KERNELS) <= 0:
        raise RuntimeError(f"a kernel never launched on the serving path: {counts}")
    def report(what, rids, wall):
        ttft = [eng.requests[r].t_first_token - eng.requests[r].arrival_t
                for r in rids]
        n_tok = sum(len(eng.result(r)) for r in rids)
        print(f"{what}: {len(rids)} requests (prompts {list(lens)}, {new} new "
              f"tokens each) in {wall:.3f} s: {n_tok / wall:.1f} tokens/s, "
              f"p50 TTFT {statistics.median(ttft) * 1e3:.1f} ms [{card}]")

    report("served (first pass, every bucket's GEMM shapes new)", rids, wall)
    print(f"  {eng.stats['decode_steps'] - steps0} decode steps, prefill buckets "
          f"{sorted(eng.stats['prefill_signatures'])}, launches {counts}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = [eng.submit(p, max_new_tokens=new) for p in prompts]
    eng.run_until_drained()
    torch.cuda.synchronize()
    report("served (second pass, same requests)", again,
           time.perf_counter() - t0)

    full = Program()
    with program_guard(full, Program()), unique_name.guard():
        io = build_full_forward_program(cfg)
    for p, rid in zip(prompts, rids):
        seq = list(p)
        for _ in range(new):
            (lg,) = eng._exe.run(
                full, scope=eng._scope, fetch_list=[io["logits"]],
                return_numpy=False,
                feed={sv_model.TOK_FEED: np.asarray(seq, np.int32)[None, :],
                      sv_model.POS_FEED: np.arange(len(seq), dtype=np.int32)[None, :]})
            if tuple(lg.shape) != (1, len(seq), cfg.vocab_size) \
                    or not bool(torch.isfinite(lg).all()):
                raise RuntimeError("dense oracle logits malformed")
            seq.append(int(torch.argmax(lg[0, -1]).item()))
        if eng.result(rid) != seq[len(p):]:
            raise RuntimeError(f"request {rid} (prompt {len(p)}) diverged from "
                               f"the dense oracle: {eng.result(rid)} vs "
                               f"{seq[len(p):]}")
    print("greedy tokens equal the dense full-forward replay for every request")
    return eng, prompts, counts


# bench.py:107 BERT_BASE: the published BERT-base widths, dropout off
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_size=3072, max_position=512,
                 dropout=0.0, use_tp=False)
TRAIN_B, TRAIN_S, TRAIN_LR, TRAIN_STEPS = 32, 128, 1e-4, 5
# per-step launches of each training kernel at 12 layers: one attention
# per layer, layer norm after the embeddings and twice per layer, one
# cross entropy over the lm head
TRAIN_LAUNCHES = {"causal_prefill_attention": 12, "layer_norm_act": 25,
                  "attention_backward": 12, "layer_norm_act_backward": 25,
                  "softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
                  "paged_decode_attention": 0}
GRAD_RTOL = 1e-3   # of each gradient's max-abs: fp32 sums reordered, 12 layers


def _bert_oracle(P, feed, cfg, ln_names):
    """The BERT pretrain loss in plain torch (F.linear, the plain
    attention, F.layer_norm, log_softmax) over the parameter tensors P."""
    import torch.nn.functional as F

    H, nh = cfg.hidden_size, cfg.num_heads
    dh = H // nh
    lns = iter(ln_names)

    def fc(x, pre):
        return F.linear(x, P[pre + ".w"].t(), P[pre + ".b"])

    def ln(x):
        sn, bn = next(lns)
        return F.layer_norm(x, (H,), P[sn], P[bn], 1e-5)

    ids, pos = feed["src_ids"].long(), feed["pos_ids"].long()
    x = ln(P["encoder.word_emb"][ids] + P["encoder.pos_emb"][pos])
    B, S = ids.shape
    for i in range(cfg.num_layers):
        pre = f"encoder.layer{i}"
        qkv = fc(x, pre + ".mha.qkv").reshape(B, S, 3, nh, dh)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        p = torch.softmax(q @ k.transpose(-1, -2) * dh ** -0.5, dim=-1)
        a = (p @ v).transpose(1, 2).reshape(B, S, H)
        x = ln(x + fc(a, pre + ".mha.out"))
        f = fc(F.gelu(fc(x, pre + ".ffn.in")), pre + ".ffn.out")
        x = ln(x + f)
    logp = torch.log_softmax(fc(x, "lm_head"), dim=-1)
    tok = -logp.gather(-1, feed["lm_label"].long()[..., None])[..., 0]
    w = feed["lm_weight"]
    return (tok * w).sum() / (w.sum() + 1e-6)


def train(dev, card):
    """The BERT-base pretrain step through the port's entry points: step 1
    held against the plain-torch autograd oracle (loss, every gradient, the
    updated parameters by the JAX package's Adam formula), launches per
    step counted, then TRAIN_STEPS timed steps on the same batch."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck

    cfg = transformer.TransformerConfig(**BERT_BASE)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        avg_loss, _ = transformer.bert_pretrain(cfg, seq_len=TRAIN_S)
        pt.optimizer.Adam(learning_rate=TRAIN_LR).minimize(avg_loss)
    startup.random_seed = SEED
    exe, scope = pt.Executor(), pt.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    names = [p.name for p in main.all_parameters()]
    n_elems = sum(scope.find_var(n).numel() for n in names)
    print(f"trainer built in {time.perf_counter() - t0:.2f} s: BERT-base "
          f"B={TRAIN_B} S={TRAIN_S} fp32, {len(names)} parameters, "
          f"{n_elems} elements, {len(main.global_block.ops)} ops a step "
          f"[{card}]")
    rng = np.random.default_rng(SEED)     # __graft_entry__._example_feed's form
    feed = {"src_ids": rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)).astype(np.int32),
            "pos_ids": np.tile(np.arange(TRAIN_S, dtype=np.int32), (TRAIN_B, 1)),
            "lm_label": rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)).astype(np.int32),
            "lm_weight": np.ones((TRAIN_B, TRAIN_S), np.float32)}
    p0 = {n: scope.find_var(n).clone() for n in names}

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[avg_loss] + [n + "@GRAD" for n in names])
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = ck.launch_counts()
    if counts != TRAIN_LAUNCHES:
        raise RuntimeError(f"launches in one step {counts}, expected "
                           f"{TRAIN_LAUNCHES}")
    loss1, grads = out[0], dict(zip(names, out[1:]))

    ln_names = [(op.inputs["Scale"][0], op.inputs["Bias"][0])
                for op in main.global_block.ops if op.type == "layer_norm"]
    P = {n: t.clone().requires_grad_() for n, t in p0.items()}
    fd = {k: torch.from_numpy(v).to(dev) for k, v in feed.items()}
    ref_loss = _bert_oracle(P, fd, cfg, ln_names)
    ref_grads = torch.autograd.grad(ref_loss, [P[n] for n in names])
    ref_loss = ref_loss.detach()
    if not abs(float(loss1) - float(ref_loss)) <= 1e-4 * abs(float(ref_loss)):
        raise RuntimeError(f"step-1 loss {float(loss1)} vs oracle "
                           f"{float(ref_loss)}")
    worst = 0.0
    lr_t = TRAIN_LR * (1 - 0.999) ** 0.5 / (1 - 0.9)

    def adam_step1(g):     # the JAX package's Adam, first step (moments from zero)
        return lr_t * (0.1 * g / (torch.sqrt(0.001 * g * g) + 1e-8))

    # The first step moves a weight by about lr whatever its gradient, so
    # both limits are a hundredth of a step: the port's update against the
    # formula on its own gradients (every element), and against the formula
    # on the oracle's (elements whose sign the gradient check makes sure of,
    # above the epsilon's reach).
    own_err = ref_err = 0.0
    n_sure = 0
    for n, rg in zip(names, ref_grads):
        scale = float(rg.abs().max())
        e = float((grads[n] - rg).abs().max()) / max(scale, 1e-30)
        if not e <= GRAD_RTOL:
            raise RuntimeError(f"{n}@GRAD differs from the oracle by {e:.3e} "
                               f"of its max-abs {scale:.3e}")
        worst = max(worst, e)
        p1 = scope.find_var(n)
        own_err = max(own_err, float((p1 - (p0[n] - adam_step1(grads[n])))
                                     .abs().max()))
        sure = rg.abs() > max(2 * GRAD_RTOL * scale, 1e-5)
        n_sure += int(sure.sum())
        if bool(sure.any()):
            d = (p1 - (p0[n] - adam_step1(rg)))[sure]
            ref_err = max(ref_err, float(d.abs().max()))
    if not max(own_err, ref_err) <= 1e-2 * TRAIN_LR:
        raise RuntimeError(f"step-1 parameters differ from the JAX Adam step "
                           f"by {own_err:.3e} on the port's gradients and "
                           f"{ref_err:.3e} on the oracle's (limit 1e-2 lr)")
    print(f"step 1 ({first:.3f} s, first use of every GEMM shape): loss "
          f"{float(loss1):.6f}, oracle {float(ref_loss):.6f}; worst gradient "
          f"error {worst:.3e} of its max-abs (limit {GRAD_RTOL}); updated "
          f"parameters within {own_err:.3e} of the JAX Adam step on the "
          f"port's gradients and {ref_err:.3e} on the oracle's ({n_sure} of "
          f"{n_elems} elements of sure sign; limit 1e-2 lr = "
          f"{1e-2 * TRAIN_LR:.1e}); launches {counts}")
    del P, ref_grads, ref_loss, grads, out

    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        (lv,) = exe.run(main, feed=feed, scope=scope, fetch_list=[avg_loss],
                        return_numpy=False)
        losses.append(lv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(lv) for lv in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < float(loss1):
        raise RuntimeError(f"the loss did not fall: step 1 {float(loss1)}, "
                           f"then {losses}")
    H, L, F_, V = cfg.hidden_size, cfg.num_layers, cfg.ffn_size, cfg.vocab_size
    tokens = TRAIN_B * TRAIN_S
    # bench.py:130-133: 6 N T over the matmul parameters plus attention
    step_flops = (6 * (L * (4 * H * H + 2 * H * F_) + H * V) * tokens
                  + 12 * L * H * TRAIN_S * tokens)
    print(f"trained {TRAIN_STEPS} steps in {wall:.3f} s: "
          f"{TRAIN_STEPS / wall:.3f} steps/s, {TRAIN_STEPS * tokens / wall:.1f} "
          f"tokens/s, {TRAIN_STEPS * step_flops / wall / 1e12:.2f} model "
          f"TFLOP/s ({step_flops / 1e12:.3f} TFLOP a step); losses "
          f"{[round(x, 5) for x in losses]} [{card}]")
    return exe, main, scope, feed, avg_loss, counts


def _profile(run, card, what):
    """Trace `run` with torch.profiler: the device's busy share of its wall
    time, and device time by kernel (single stream, so kernel times add up
    without overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        print(f"profile {what}: torch.profiler saw no device time (not "
              f"measured) [{card}]")
        return
    print(f"profile {what}: wall {wall_us / 1e3:.1f} ms (traced), device busy "
          f"{busy / 1e3:.1f} ms = {100 * busy / wall_us:.1f}% [{card}]")
    for us, n, key in sorted(rows, reverse=True)[:12]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / busy:5.1f}%  x{n:<6d} {key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a serving pass and a training step "
                         "with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops.cuda_kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = _card()
    secs = _build.build_all()
    print(f"built {len(_build.SOURCES)} kernels in {secs:.2f} s [{card}]")
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    timer = _Timer(dev)
    entries = [check_paged_decode(dev, timer, card),
               check_prefill(dev, timer, card),
               check_layer_norm(dev, timer, card),
               check_attention_backward(dev, timer, card),
               check_layer_norm_backward(dev, timer, card),
               *check_softmax_xent(dev, timer, card)]
    del timer
    eng, prompts, serve_counts = serve(dev, card)
    if args.profile:
        def serve_pass():
            for p in prompts:
                eng.submit(p, max_new_tokens=16)
            eng.run_until_drained()
        _profile(serve_pass, card, "serving pass")
    del eng
    exe, main_p, scope, feed, avg_loss, train_counts = train(dev, card)
    if args.profile:
        _profile(lambda: exe.run(main_p, feed=feed, scope=scope,
                                 fetch_list=[avg_loss], return_numpy=False),
                 card, "training step")
    # launches on the main paths: serving (K1-K3) and one training step
    # (K2-K7), each counted from 0 just before its run
    for e in entries:
        e["launches"] = serve_counts[e["name"]] + train_counts[e["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
