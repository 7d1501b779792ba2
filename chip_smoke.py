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
              K1-K3 at the serving shapes (K1 also at one long row),
              K4-K7 at the BERT training
              shapes, K8/K9 at ResNet-50's batch-norm shapes for B=32;
              fp32 K2 and K4 (both of K4's routes: its head kernel and
              its query/key pair, timed side by side at the training
              shape) also at S 1..512 and dh 8..128 across the edges of
              their tiles, causal and not, with a kv_len 0 row; K5 again
              on the same inputs, which must give the same bits; the
              registers, spills and shared memory of every kernel, from
              nvcc's -Xptxas -v report; K1 and K9's chain mode must repeat
              bit for bit too, and K9's chain time is split into its sums,
              fold and dx phases by the kernel's own clock;
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
  5. ResNet-50 training — models.resnet.resnet50 (s2d stem, NHWC,
              224x224, 1000 classes) + Momentum(0.1, 0.9) through
              Program/Executor, B=32, fp32, random weights from seed 0:
              step 1's loss, every parameter gradient, the momentum update
              and the running statistics must agree with a plain-torch
              autograd oracle on the same weights and batch, K8 must launch
              once per batch-norm op of the program (53), K9 once (its
              chain mode: the sums, their fold and dx in one launch) and
              K6/K7 once; then, from the same initial state at lr 0.01, the
              loss must fall over 5 more steps (timed: images/s, step
              ms, peak device memory);
  6. bf16 kernel checks — K2-K9 in bf16 against their plain versions in
              bf16 at the AMP steps' shapes (BERT-base and ResNet-50 at
              B=128; K9 also in its chain mode, timed against training
              batch norm's backward, its one pass against inference batch
              norm's; K2/K4 also at B=64, S=512
              and at one case of each of their other routes: causal, kv_lens
              with a kv_len 0 row, dh 40 and 128), and #15, the fused bf16
              bottleneck block, at the tool's shape: its path (one block,
              then a chain of 10) with launches counted, against its plain
              version, and the tool's A/B against the library chain;
              K3/K5 in fp32 and bf16 across their buckets (K 256 | 257,
              1024 | 1025, 2048, 100; R 1, 37 and 3000) and on a view at an
              odd storage offset; K7 in fp32 and bf16, both modes, at V =
              1000, 50257 and 128256 (clusters of 4 or 8 blocks a row), at the
              first width that streams, and at V = 1001 from every element
              phase of 16 bytes (rows at every phase), each repeated bit for
              bit;
  7. AMP training — bert_pretrain(BERT-base) + decorate(Adam(1e-4)) and
              resnet50 (s2d stem, NHWC) + decorate(Momentum(0.1, 0.9)) at
              B=128, bf16: step 1 against bf16 autograd oracles of the same
              cast scheme (ResNet-50's reads the port's input to each
              layer), each gradient, the loss and the running statistics
              within twice the bf16 oracle's own distance from an fp32
              oracle plus a floor, under a cap that a planted zeroed or
              negated gradient must fail, the fp32 master weights' update
              exact, launches by dtype as the program's var dtypes say;
              then 5 timed steps whose loss must fall;
     flash and probe checks — K10/K11 (flash attention, S > 512) in fp32
              and bf16 against their plain versions at the long-context
              steps' shapes, causal and not, at a ragged S = 1000 with
              dh = 128, beside scaled_dot_product_attention; K12 and K13
              through their tools' tables (launches counted), each variant,
              layout and block size against its plain version (K12's seven
              also at S = 200: two passes over a ragged last key tile);
  8. long-context training — tools/_sweep.py's `8 2048 1`: bert_pretrain
              (BERT-base, S=2048, max_position 2048, use_flash_attention) +
              decorate(Adam(1e-4)), B=8, through K10/K11 in bf16, held as
              the AMP step of phase 7 (oracles with each layer's attention
              checkpointed, peak memory printed); then an fp32 step at
              B=4, S=1024 (K10/K11 in fp32) held as phase 4;
  9. output — the `kernels` JSON line (fp32 and bf16 entries, #15, K12
              and K13, each with its dtype), the card line (nvidia-smi name
              and power limit), and last the `ok` JSON line.
Needs one CUDA device; exits non-zero without one.

    python3 chip_smoke.py --profile

also traces one more serving pass and one more training step of each
configuration (the long-context fp32 one included) with torch.profiler
and prints where the device time went (per kernel, and the device's busy
share of the wall time; in the fp32 BERT step, K2's and K4's time and
launches; in the BERT steps, K3's and K5's; in the ResNet-50 AMP step, the
kernels launched inside the batch-norm grad ops, K9's and torch's).
"""
from __future__ import annotations

import argparse
import json
import re
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


def _paged_case(K, dev, timer, card, g, lens, P, pages=512):
    """K1 at B = len(lens) rows of nh=12, dh=64, ps=16 (the serving
    model's widths) over a table P pages wide, against its plain version;
    returns (max_abs_err, ms, plain_ms, bound_ms)."""
    B, nh, dh, ps = len(lens), 12, 64, 16
    lens = torch.tensor(lens, dtype=torch.int32)
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
    _repeats("paged_decode_attention", [out],
             [K.paged_decode_attention(q, kp, vp, table, lens_d, scale)])
    ms = timer(lambda: K.paged_decode_attention(q, kp, vp, table, lens_d, scale))
    plain_ms = timer(lambda: K.paged_decode_attention_plain(
        q, kp, vp, table, lens_d, scale))
    # the live slots' K and V (what this data needs), q, out, table, lens
    nbytes = (2 * int(lens.sum()) * nh * dh * 4 + 2 * q.numel() * 4
              + table.numel() * 4 + B * 4)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    chunk, span, grid = K._plan(B, nh, dh, ps, P)[:3]
    _row("K1 paged_decode_attention", f"B={B} nh={nh} dh={dh} ps={ps} P={P} "
         f"lens={lens.tolist()} (spans of {span} slots, {grid} blocks)", ms,
         plain_ms, None, bound, "bytes", err, card)
    return err, ms, plain_ms, bound


def check_paged_decode(dev, timer, card):
    from paddle_tpu_torch.ops.cuda_kernels import paged_attention as K

    g = torch.Generator(device="cpu").manual_seed(SEED)
    err, ms, plain_ms, bound = _paged_case(
        K, dev, timer, card, g, [1, 16, 17, 500, 0, 33, 257, 64], 32)
    # one long row alone: its spans spread over the card
    _paged_case(K, dev, timer, card, g, [500], 32)
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "paddle_tpu_torch/ops/cuda_kernels/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels/paged_attention.py:164",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None}


def _bound(flops, nbytes, flops_per_s=FP32_FLOPS_PER_S):
    """The larger of bytes over the HBM rate and operations over the peak
    rate of their type (fp32 outside the tensor cores unless given)."""
    t_ops, t_bytes = flops / flops_per_s, nbytes / HBM_BYTES_PER_S
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


# fp32 K2/K4 cases at the edges of the 64-row tiles and of K4's head kernel
# (S <= 128, dh <= 64), at head widths the kernels zero-fill (dh 8 and 40
# run on D = 64, dh 100 on D = 128), causal and not, dense and with kv_lens
# [S, min(5, S), 0] (a kv_len 0 row); B = 3, nh = 2
EDGE_S = (1, 63, 64, 65, 127, 128, 129, 512)
EDGE_DH = (8, 40, 64, 100, 128)


def _edge_cases(g, dev, tensors):
    for S in EDGE_S:
        for dh in EDGE_DH:
            xs = [torch.randn((3, 2, S, dh), generator=g).to(dev)
                  for _ in range(tensors)]
            lens = torch.tensor([S, min(5, S), 0], dtype=torch.int32).to(dev)
            for causal in (False, True):
                for kl in (None, lens):
                    yield f"S={S} dh={dh} causal={causal} " + (
                        "dense" if kl is None else "kv_lens"), xs, causal, \
                        dh ** -0.5, kl


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
    n, worst = 0, 0.0
    for what, (q, k, v), causal, sc, kl in _edge_cases(g, dev, 3):
        out = K.causal_prefill_attention(q, k, v, causal, sc, kl)
        ref = K.causal_prefill_attention_plain(q, k, v, causal, sc, kl)
        worst = max(worst, _agree(f"causal_prefill_attention {what}", out, ref))
        if kl is not None and not bool((out[2] == 0).all()):
            raise RuntimeError(f"causal_prefill_attention {what}: the kv_len 0 "
                               f"row is not zero")
        n += 1
    print(f"K2 causal_prefill_attention fp32 edges: {n} cases agree (S in "
          f"{EDGE_S}, dh in {EDGE_DH}), max_abs_err {worst:.3e} [{card}]")
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
        if kl is None:
            lib = lambda q, k, v: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal, scale=scale)
        else:
            # kv_lens and the causal bound as one boolean mask: the same
            # function in one call (its kv_len 0 row comes out NaN where
            # the kernel gives zeros; the yardstick is its time)
            key = torch.arange(S, device=dev)
            mask = key[None, None, None, :] < kl[:, None, None, None]
            if causal:
                mask = mask & (key[None, None, None, :]
                               <= key[None, None, :, None])
            lib = lambda q, k, v: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, scale=scale)
        lib_ms = timer(_autograd_lib(lib, (q, k, v), do))
        bound, by = _attn_bound(B, nh, S, dh, causal,
                                None if lens is None else lens.tolist(),
                                products=5, tensors=7)
        _row("K4 attention_backward",
             f"B={B} nh={nh} S={S} dh={dh} causal={causal}"
             + ("" if lens is None else f" kv_lens={lens.tolist()}"),
             ms, plain_ms, lib_ms, bound, by, err, card)
        if entry is None:     # the head kernel's shape: its rival route too
            pair_ms = timer(lambda: K.attention_backward_pair(
                q, k, v, do, causal, scale, kl))
            print(f"K4 attention_backward B={B} nh={nh} S={S} dh={dh}: head "
                  f"kernel {ms:.4f} ms, query/key pair {pair_ms:.4f} ms "
                  f"[{card}]")
            entry = {"name": "attention_backward", "route": "cuda",
                     "source": "paddle_tpu_torch/ops/cuda_kernels/csrc/attention_backward.cu",
                     "replaces": "paddle_tpu/ops/pallas_kernels/short_attention.py:164 "
                                 "+ paddle_tpu/ops/pallas_kernels/attention.py:154",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
    n, worst = 0, 0.0
    for what, (q, k, v, do), causal, sc, kl in _edge_cases(g, dev, 4):
        ref = K.attention_backward_plain(q, k, v, do, causal, sc, kl)
        for fn in (K.attention_backward, K.attention_backward_pair):
            got = fn(q, k, v, do, causal, sc, kl)
            worst = max([worst] + [_agree(f"{fn.__name__} {what} d{c}", o, r)
                                   for c, o, r in zip("qkv", got, ref)])
            if kl is not None and not all(bool((o[2] == 0).all()) for o in got):
                raise RuntimeError(f"{fn.__name__} {what}: the kv_len 0 row's "
                                   f"gradients are not zero")
            n += 1
    print(f"K4 attention_backward fp32 edges: {n} cases agree on the head "
          f"kernel's and the pair's routes (S in {EDGE_S}, dh in {EDGE_DH}), "
          f"max_abs_err {worst:.3e} [{card}]")
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
    _repeats("layer_norm_act_backward fp32", got,
             K.layer_norm_act_backward(x, s, b, dy, 1e-5, "identity"))
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


def _repeats(name, first, again):
    """A kernel without atomics (K1, K5, K9): a second launch on the same
    inputs gives the same bits, output for output (None for none)."""
    torch.cuda.synchronize()
    if not all(u is v or torch.equal(u, v) for u, v in zip(first, again)):
        raise RuntimeError(f"{name}: a second launch gave other bits")


# K7 past the main path's width: ResNet's head (V = 1000, one block a row),
# GPT-2's vocabulary (50257), Llama-3's (128256: a cluster of 4 (bf16) or
# 8 (fp32) blocks a row) and 262144 (8 blocks of 128 KB (fp32) or 64 KB);
# the widest staged rows (a cluster of 8 blocks of 224 KB, rows starting
# off the 16-byte grid) and the first widths that stream past them; and
# V = 1001 (rows at every element phase of 16 bytes) from every phase of
# the buffer's start
XENT_EDGE_V = (1000, 50257, 128256, 262144)
XENT_LAST_STAGED = {torch.float32: 458748, torch.bfloat16: 917496}
XENT_STREAMED = {torch.float32: 458749, torch.bfloat16: 917497}


def check_xent_edges(dev, card):
    from paddle_tpu_torch.ops.cuda_kernels import xent_bwd as K7

    g = torch.Generator(device="cpu").manual_seed(SEED + 12)
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        esz = torch.empty((), dtype=dt).element_size()
        cases = [(16, V, 0) for V in XENT_EDGE_V]
        cases += [(4, XENT_LAST_STAGED[dt], 1), (2, XENT_STREAMED[dt], 1)]
        cases += [(16, 1001, off) for off in range(16 // esz)]
        for N, V, off in cases:
            buf = (3 * torch.randn((N * V + off,), generator=g)).to(dev, dt)
            x = buf[off:].view(N, V)
            lab = torch.randint(-1, V + 1, (N,), generator=g,
                                dtype=torch.int32).to(dev)
            gl = torch.randn((N,), generator=g).to(dev)
            m = x.float().amax(-1)
            lse = torch.logsumexp(x.float() - m[:, None], -1)
            for stats in ((), (m, lse)):
                name = (f"softmax_xent_bwd {str(dt)[6:]} N={N} V={V} offset "
                        f"{off} {'saved' if stats else 'recomputed'} stats")
                got = K7.softmax_xent_bwd(x, lab, gl, *stats)
                ref = K7.softmax_xent_bwd_plain(x, lab, gl, *stats)
                err = _agree_xent(name, got, ref)
                _repeats(name, [got], [K7.softmax_xent_bwd(x, lab, gl, *stats)])
                worst[dt] = max(worst.get(dt, 0.0), err)
            del buf, x
    print(f"K7 softmax_xent_bwd edges (V {XENT_EDGE_V}, widest staged "
          f"{list(XENT_LAST_STAGED.values())}, streamed "
          f"{list(XENT_STREAMED.values())}, V=1001 at every phase; both modes, "
          f"labels outside [0, V), repeated bit for bit): max_abs_err fp32 "
          f"{worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e} [{card}]")


# K3/K5 across their buckets (layer_norm_rows.cuh): both sides of K = 256
# and 1024, K = 2048 (a row over two or four warps), K = 100 (the scalar
# path); one row, R not a multiple of a block's rows, and R past what the
# resident warps hold at once (grid-stride turns, with their barriers past
# K = 1024); then a bf16 view at an odd storage offset (the scalar path)
LN_EDGE_K = (256, 257, 1024, 1025, 2048, 100)
LN_EDGE_R = ((1, "identity"), (37, "relu"), (3000, "identity"))


def check_layer_norm_edges(dev, card):
    from paddle_tpu_torch.ops.cuda_kernels import layer_norm as K3
    from paddle_tpu_torch.ops.cuda_kernels import layer_norm_bwd as K5

    g = torch.Generator(device="cpu").manual_seed(SEED + 5)
    n, worst = 0, 0.0

    def hold(what, x, s, b, dy, act, ref_x):
        bf = x.dtype == torch.bfloat16
        out = K3.layer_norm_act(x, s, b, 1e-5, act)
        ref = K3.layer_norm_act_plain(ref_x, s, b, 1e-5, act)
        errs = [(_agree16 if bf else _agree)(f"layer_norm_act {what} y",
                                              out[0], ref[0])]
        errs += [_agree(f"layer_norm_act {what} {p}", o, r)
                 for p, o, r in zip(("mean", "var"), out[1:], ref[1:])]
        got = K5.layer_norm_act_backward(x, s, b, dy, 1e-5, act)
        ref = K5.layer_norm_act_backward_plain(ref_x, s, b, dy, 1e-5, act)
        errs.append(_agree16(f"layer_norm_act_backward {what} dx", got[0],
                             ref[0]) if bf else
                    _agree(f"layer_norm_act_backward {what} dx", got[0],
                           ref[0], atol=1e-4))
        # dscale/dbias sum R rows in another order: an absolute floor 1e-4
        errs += [_agree(f"layer_norm_act_backward {what} {p}", o, r, atol=1e-4)
                 for p, o, r in zip(("dscale", "dbias"), got[1:], ref[1:])]
        return max(errs)

    for dt in (torch.float32, torch.bfloat16):
        for Kd in LN_EDGE_K:
            for R, act in LN_EDGE_R:
                x, dy = (torch.randn((R, Kd), generator=g).to(dev, dt)
                         for _ in range(2))
                s = (1 + 0.1 * torch.randn((Kd,), generator=g)).to(dev)
                b = (0.1 * torch.randn((Kd,), generator=g)).to(dev)
                worst = max(worst, hold(f"{dt} R={R} K={Kd} {act}", x, s, b,
                                        dy, act, x))
                n += 1
        R, Kd = 37, 768
        x, dy = (torch.randn((R, Kd), generator=g).to(dev, dt) for _ in range(2))
        xo = torch.empty(R * Kd + 1, dtype=dt, device=dev)[1:].view(R, Kd)
        xo.copy_(x)
        if not xo.data_ptr() % 16:
            raise RuntimeError("layer norm edges: the offset view is aligned")
        worst = max(worst, hold(f"{dt} R={R} K={Kd} unaligned view", xo,
                                torch.ones(Kd, device=dev),
                                torch.zeros(Kd, device=dev), dy, "identity", x))
        n += 1
    print(f"K3/K5 layer_norm_act edges: {n} cases agree (fp32 and bf16, K in "
          f"{LN_EDGE_K}, R and act in {LN_EDGE_R}, an unaligned bf16/fp32 "
          f"view), max_abs_err {worst:.3e} [{card}]")


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
        e = _agree_xent(f"softmax_xent_bwd {mode}", got,
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


# ResNet-50's batch-norm applies at B=32 (NHWC main path: "cl"; the NCHW
# layout's "cr" at the first and last bottleneck widths), and a ragged one
BN_B = 32
BN_SHAPES = (  # (mode, R, row, C, act, residual, on the main path)
    ("cl", BN_B * 56 * 56, 256, 256, "identity", False, True),
    ("cl", BN_B * 112 * 112, 64, 64, "relu", False, True),
    ("cl", BN_B * 56 * 56, 256, 256, "relu", True, True),
    ("cl", BN_B * 7 * 7, 2048, 2048, "relu", True, True),
    ("cr", BN_B * 256, 3136, 256, "relu", True, False),
    ("cr", BN_B * 2048, 49, 2048, "relu", True, False),
    ("cl", 1009, 37, 37, "relu", True, False),
)


def _sums_agree(name, out, ref, slack=None):
    """K9's per-channel sums: within 1e-4 of the sum's max-abs (hundreds of
    thousands of rows added in another order), beyond `slack` (per channel:
    what the elements left out of a comparison can move a sum by)."""
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    if slack is not None:
        diff = (diff - slack).clamp_min(0.0)
    err = float(diff.max()) / max(float(ref.abs().max()), 1e-30)
    if out.shape != ref.shape or not err <= 1e-4:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                           f"({err:.3e} of the max-abs)")
    return err


def _bn_train_backward(x4, dy4, scale, mean, inv):
    """The yardstick of K9's chain mode: training batch norm's backward in
    one library call, with K9's own saved mean and inverse deviation (dx
    through the statistics, dscale, dbias)."""
    return lambda: torch.ops.aten.native_batch_norm_backward(
        dy4, x4, scale, None, None, mean, inv, True, 1e-5, [True, True, True])


def _ms(t):
    return "n/a" if t is None else f"{t:.4f}"


def _k9_phases(KB, args, ms):
    """Pass 1 (the sums), the fold and pass 2 (dx) of one chain-mode K9
    call, in ms: the kernel's own clock readings in block 0 (at its start,
    after the sums, after the fold, at its end) as shares of `ms`."""
    stamps = torch.zeros(4, dtype=torch.int64, device=args[0].device)
    KB.bn_apply_act_backward(*args, stamps=stamps)
    c = stamps.tolist()
    total = max(c[3] - c[0], 1)
    return [ms * (c[i + 1] - c[i]) / total for i in range(3)]


def _k9_bound(x, R, row, C, n_t, bound):
    """K9's chain mode's bound, from what the function itself must move:
    n_t R row elements of x's dtype (x and dy read, dx written, and the
    residual read and dres written with one), the four fp32 [C]
    parameters read and the [6, C] fp32 outputs written; the kernel's own
    partials are its scratch, not the function's."""
    return bound(8 * R * row, n_t * R * row * x.element_size() + 10 * C * 4)


def check_bn_apply(dev, timer, card):
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply as KF
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply_bwd as KB
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(SEED + 6)
    src = "paddle_tpu_torch/ops/cuda_kernels/csrc/"
    k8 = k9 = None
    for mode, R, row, C, act, has_res, main_path in BN_SHAPES:
        x = (1.5 * torch.randn((R, row), generator=g) + 0.3).to(dev)
        dy = torch.randn((R, row), generator=g).to(dev)
        res = torch.randn((R, row), generator=g).to(dev) if has_res else None
        scale = (1 + 0.2 * torch.randn((C,), generator=g)).to(dev)
        bias = (0.2 * torch.randn((C,), generator=g)).to(dev)
        mean = (0.3 + 0.1 * torch.randn((C,), generator=g)).to(dev)
        inv = torch.rsqrt(2.25 + torch.rand((C,), generator=g)).to(dev)
        p = (scale, bias, mean, inv)
        shape = (f"{mode} [{R}, {row}] C={C} act={act} "
                 f"residual={'yes' if has_res else 'no'}")

        y = KF.bn_apply_act(x, *p, act, res, mode)
        err = _agree(f"bn_apply_act {shape}", y,
                     KF.bn_apply_act_plain(x, *p, act, res, mode))
        ms = timer(lambda: KF.bn_apply_act(x, *p, act, res, mode))
        plain_ms = timer(lambda: KF.bn_apply_act_plain(x, *p, act, res, mode))
        # one library call computes the unfused case only: inference batch
        # norm over the same statistics (var = 1/inv^2 - eps); a residual or
        # an act would be further calls
        lib_ms = lib_bwd = lib_chain = None
        if act == "identity" and not has_res and mode == "cl":
            hw = int(round((R // BN_B) ** 0.5))
            x4 = x.reshape(BN_B, hw, hw, C).permute(0, 3, 1, 2)
            dy4 = dy.reshape(BN_B, hw, hw, C).permute(0, 3, 1, 2)
            var = 1.0 / (inv * inv) - 1e-5
            lib = lambda x4, s, b: F.batch_norm(  # noqa: E731
                x4, mean, var, s, b, training=False, eps=1e-5)
            lib_ms = timer(lambda: lib(x4, scale, bias))
            lib_bwd = timer(_autograd_lib(lib, (x4, scale, bias), dy4))
            lib_chain = timer(_bn_train_backward(x4, dy4, scale, mean, inv))
        n_t = 3 if has_res else 2
        bound, by = _bound(4 * R * row, (n_t * R * row + 4 * C) * 4)
        _row("K8 bn_apply_act", shape, ms, plain_ms, lib_ms, bound, by, err, card)
        if k8 is None:
            k8 = {"name": "bn_apply_act", "route": "cuda",
                  "source": src + "bn_apply.cu",
                  "replaces": "paddle_tpu/ops/pallas_kernels/epilogue.py:151",
                  "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}

        got = KB.bn_apply_act_backward(x, *p, dy, act, res, mode)
        ref = KB.bn_apply_act_backward_plain(x, *p, dy, act, res, mode)
        err = _agree(f"bn_apply_act_backward dx {shape}", got[0], ref[0])
        if has_res:
            err = max(err, _agree(f"bn_apply_act_backward dres {shape}",
                                  got[1], ref[1]))
        elif got[1] is not None:
            raise RuntimeError("bn_apply_act_backward: dres without a residual")
        sum_err = max(_sums_agree(f"bn_apply_act_backward {n} {shape}", o, r)
                      for n, o, r in zip(("P1", "P2", "dscale", "dbias"),
                                         got[2:], ref[2:]))
        one_ms = timer(lambda: KB.bn_apply_act_backward(x, *p, dy, act, res,
                                                        mode))

        # the main path's call: the chain mode (the sums, the fold and dx in
        # one launch, as the training step runs it)
        M = R * row // C
        got = KB.bn_apply_act_backward(x, *p, dy, act, res, mode, M)
        ref = KB.bn_apply_act_backward_plain(x, *p, dy, act, res, mode, M)
        err = max(err, _agree(f"bn_apply_act_backward chain dx {shape}",
                              got[0], ref[0]))
        _repeats(f"bn_apply_act_backward chain {shape}", got,
                 KB.bn_apply_act_backward(x, *p, dy, act, res, mode, M))
        sum_err = max([sum_err] + [
            _sums_agree(f"bn_apply_act_backward chain {n} {shape}", o, r)
            for n, o, r in zip(("dscale", "dbias"), got[4:], ref[4:])])
        ms = timer(lambda: KB.bn_apply_act_backward(x, *p, dy, act, res, mode,
                                                    M))
        plain_ms = timer(lambda: KB.bn_apply_act_backward_plain(
            x, *p, dy, act, res, mode, M))
        phases = _k9_phases(KB, (x, *p, dy, act, res, mode, M), ms)
        bound, by = _k9_bound(x, R, row, C, 5 if has_res else 3, _bound)
        _row("K9 bn_apply_act_backward", shape + f" with the statistics chain "
             f"(pass 1 / fold / pass 2 by the kernel's clock: "
             f"{' / '.join(f'{t:.4f}' for t in phases)} ms; one pass without "
             f"it: {one_ms:.4f} ms, against the inference batch norm's "
             f"backward: {_ms(lib_bwd)} ms; sums within {sum_err:.1e} of "
             f"their max-abs)", ms, plain_ms, lib_chain, bound, by, err, card)
        if k9 is None:
            k9 = {"name": "bn_apply_act_backward", "route": "cuda",
                  "source": src + "bn_apply_backward.cu",
                  "replaces": "paddle_tpu/ops/pallas_kernels/epilogue.py:182",
                  "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound, "bound_by": by, "library_ms": lib_chain}

        if main_path:
            # what the forward op does in torch beside the kernel at this
            # shape: the batch statistics (mean and E[x^2], with the square
            # materialized)
            stats_ms = timer(lambda: (x.mean(dim=0), (x * x).mean(dim=0)))
            print(f"   beside the kernels at {mode} [{R}, {row}]: forward "
                  f"batch statistics {stats_ms:.4f} ms [{card}]")
    return [k8, k9]


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
# tools/_sweep.py's long-context run (`_sweep.py 8 2048 1`: BERT-base,
# max_position = S, use_flash_attention, decorate(Adam(1e-4))), and the fp32
# step at the fp32 phase's 4096 tokens that drives K10/K11 in fp32
LONG_B, LONG_S = 8, 2048
LONG_FP32_B, LONG_FP32_S = 4, 1024


def _bert_cfg(S, flash=False):
    """BERT-base's widths for seq S: max_position max(512, S) as
    tools/_sweep.py sets it, and the flash flag."""
    from paddle_tpu_torch.models import transformer

    return transformer.TransformerConfig(
        **dict(BERT_BASE, max_position=max(512, S), use_flash_attention=flash))


def _train_launches(S, L):
    """Per-step launches of each wrapper in an fp32 BERT step of L layers:
    one attention forward and backward a layer (K2 and K4, or K10 and K11
    past S = 512), layer norm after the embeddings and twice a layer, one
    cross entropy over the lm head."""
    from paddle_tpu_torch.ops import cuda_kernels as ck

    want = dict.fromkeys(ck.launch_counts(), 0)
    fwd, bwd = (("flash_attention_fwd", "flash_attention_backward") if S > 512
                else ("causal_prefill_attention", "attention_backward"))
    want.update({fwd: L, bwd: L, "layer_norm_act": 2 * L + 1,
                 "layer_norm_act_backward": 2 * L + 1, "softmax_xent_fwd": 1,
                 "softmax_xent_bwd": 1})
    return want


GRAD_RTOL = 1e-3   # of each gradient's max-abs: fp32 sums reordered, 12 layers


def _bert_feed(cfg, B, S):
    """One seeded batch in __graft_entry__._example_feed's form."""
    rng = np.random.default_rng(SEED)
    return {"src_ids": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "pos_ids": np.tile(np.arange(S, dtype=np.int32), (B, 1)),
            "lm_label": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "lm_weight": np.ones((B, S), np.float32)}


def _bert_step_flops(cfg, B, S):
    """bench.py:130-133: 6 N T over the matmul parameters plus attention."""
    H, L, F_, V = cfg.hidden_size, cfg.num_layers, cfg.ffn_size, cfg.vocab_size
    tokens = B * S
    return (6 * (L * (4 * H * H + 2 * H * F_) + H * V) * tokens
            + 12 * L * H * S * tokens)


def _checkpointed(attention, q, k, v):
    """attention(q, k, v) under torch.utils.checkpoint: its backward
    recomputes the [B, nh, S, S] scores, so that one layer's live at a time
    (at S = 2048, B = 8 one fp32 score tensor is 1.6 GB); the arithmetic is
    attention's own."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(attention, q, k, v, use_reentrant=False)


def _bert_oracle(P, feed, cfg, ln_names):
    """The BERT pretrain loss in plain torch (F.linear, the plain
    attention, F.layer_norm, log_softmax) over the parameter tensors P,
    each layer's attention checkpointed."""
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
        a = _checkpointed(lambda q, k, v: torch.softmax(
            q @ k.transpose(-1, -2) * dh ** -0.5, dim=-1) @ v, q, k, v)
        x = ln(x + fc(a.transpose(1, 2).reshape(B, S, H), pre + ".mha.out"))
        f = fc(F.gelu(fc(x, pre + ".ffn.in")), pre + ".ffn.out")
        x = ln(x + f)
    logp = torch.log_softmax(fc(x, "lm_head"), dim=-1)
    tok = -logp.gather(-1, feed["lm_label"].long()[..., None])[..., 0]
    w = feed["lm_weight"]
    return (tok * w).sum() / (w.sum() + 1e-6)


def train(dev, card, B=TRAIN_B, S=TRAIN_S, flash=False):
    """The BERT-base pretrain step through the port's entry points: step 1
    held against the plain-torch autograd oracle (loss, every gradient, the
    updated parameters by the JAX package's Adam formula), launches per
    step counted, then TRAIN_STEPS timed steps on the same batch. `flash`
    sets use_flash_attention (the JAX package's long-context flag)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck

    cfg = _bert_cfg(S, flash)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        avg_loss, _ = transformer.bert_pretrain(cfg, seq_len=S)
        pt.optimizer.Adam(learning_rate=TRAIN_LR).minimize(avg_loss)
    startup.random_seed = SEED
    exe, scope = pt.Executor(), pt.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    names = [p.name for p in main.all_parameters()]
    n_elems = sum(scope.find_var(n).numel() for n in names)
    print(f"trainer built in {time.perf_counter() - t0:.2f} s: BERT-base "
          f"B={B} S={S} fp32 (use_flash_attention={flash}), {len(names)} "
          f"parameters, {n_elems} elements, {len(main.global_block.ops)} ops "
          f"a step [{card}]")
    feed = _bert_feed(cfg, B, S)
    p0 = {n: scope.find_var(n).clone() for n in names}

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[avg_loss] + [n + "@GRAD" for n in names])
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = ck.launch_counts()
    if counts != _train_launches(S, cfg.num_layers):
        raise RuntimeError(f"launches in one step {counts}, expected "
                           f"{_train_launches(S, cfg.num_layers)}")
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
    tokens = B * S
    step_flops = _bert_step_flops(cfg, B, S)
    print(f"trained {TRAIN_STEPS} steps in {wall:.3f} s: "
          f"{TRAIN_STEPS / wall:.3f} steps/s, {TRAIN_STEPS * tokens / wall:.1f} "
          f"tokens/s, {TRAIN_STEPS * step_flops / wall / 1e12:.2f} model "
          f"TFLOP/s ({step_flops / 1e12:.3f} TFLOP a step); losses "
          f"{[round(x, 5) for x in losses]} [{card}]")
    return exe, main, scope, feed, avg_loss, counts


# bench.py:278 _resnet_arm's on-chip configuration (ResNet-50, 1000 classes,
# 224x224, space-to-depth stem, NHWC, Momentum(0.1, 0.9)), cut to fp32 and
# batch 32
RN_B, RN_HW, RN_CLASSES, RN_LR, RN_MU, RN_STEPS = 32, 224, 1000, 0.1, 0.9, 5
# One batch of 32 repeated at lr 0.1 climbs (7.47, then 15.8, 31.6, 41.0,
# 53.8, 57.3 on the H100; the last layer alone moves each logit by about
# lr |features|^2 / B a step), so after step 1 has been held to the oracle
# at lr 0.1 the timed steps restart from the same initial state with the
# learning-rate variable set to this, and the loss must fall
RN_FALL_LR = 0.01
RN_STAGES = (3, 4, 6, 3)


RELU_NEAR = 2e-4    # of the largest input of that relu


def _tally(dev):
    t = {k: torch.zeros((), dtype=torch.int64, device=dev)
         for k in ("near", "taken", "far", "elems")}
    for k in ("fwd", "fwd_max", "fwd_l2"):
        t[k] = torch.zeros((), device=dev)
    return t


class _PortForward(torch.autograd.Function):
    """The port's tensor in the forward pass, the gradient of the oracle's
    own tensor in the backward."""

    @staticmethod
    def forward(ctx, own, port):
        return port.to(own.dtype, copy=True)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _resnet50_oracle(P, img, label, stats, port_relu, tally,
                     low=torch.float32, relu_near=RELU_NEAR, forced=False):
    """The NHWC space-to-depth ResNet-50 loss in plain torch (F.conv2d,
    explicit batch statistics by the model's formula var = E[x^2] -
    E[x]^2, F.max_pool2d, F.cross_entropy) over the parameter tensors P;
    leaves every batch norm's (mean, biased var) in `stats` by name.

    `low` is the dtype of the activations and products: float32, or
    bfloat16 for the AMP program's cast scheme (every conv and the fc on
    bf16 views of the fp32 weights, each batch norm's statistics and apply
    in fp32 on the bf16 conv output with its scale and bias rounded to
    bf16, the result rounded to bf16; the loss averaged in fp32).

    relu'(z) at a z within rounding of zero is on in one evaluation and
    off in another, and one such element moves some entries of a weight
    gradient by about 1/sqrt(N) of their size (N the samples per channel,
    1568 at the last stage at B=32), far beyond the limit the gradients
    are held to. The two forward passes differ by rounding, so the band is
    relative: for |z| <= relu_near max|z| of that relu the oracle takes
    the port's decision (`port_relu`: the port's output after each relu,
    by batch-norm name) and everywhere else its own; `tally` counts the
    elements near zero, those of them where the two differed, and the
    disagreements elsewhere, and keeps the largest difference between the
    two forward passes after a relu, in max-abs (`fwd`), in max-abs of
    that relu's largest output (`fwd_max`) and in relative L2 (`fwd_l2`).
    With port_relu None the oracle takes its own decisions
    everywhere (an independent reference).

    With `forced`, the forward pass goes on from each relu with the port's
    output (the oracle's own output keeps the gradient): every layer of
    the oracle reads the port's input to that layer, so the tally holds
    each layer's forward pass on its own, and rounding does not compound
    over depth. In bf16 it would: one unit of a conv output's last place,
    where two cuDNN algorithms sum apart, grows over 50 layers of batch
    norm until the outputs after a relu differ by up to 2.4 and the last
    stage's gradients by 0.30 in relative L2 (B=128 on the H100)."""
    import torch.nn.functional as F

    c = lambda t: t.to(low)  # noqa: E731  (no copy in fp32)

    def relu(z, name):
        if port_relu is None:
            return torch.relu(z).to(low)
        port_y = port_relu[name].permute(0, 3, 1, 2)
        own, port = z > 0, port_y > 0
        near = z.detach().abs() <= relu_near * z.detach().abs().max()
        differ = own != port
        tally["near"] += near.sum()
        tally["taken"] += (differ & near).sum()
        tally["far"] += (differ & ~near).sum()
        tally["elems"] += z.numel()
        y = (z * torch.where(near, port, own)).to(low)
        d = y.detach().float() - port_y.float()
        tally["fwd"] = torch.maximum(tally["fwd"], d.abs().max())
        tally["fwd_max"] = torch.maximum(tally["fwd_max"], d.abs().max()
                                         / torch.clamp(port_y.abs().max(), min=1e-30))
        tally["fwd_l2"] = torch.maximum(tally["fwd_l2"], d.norm() / torch.clamp(
            port_y.float().norm(), min=1e-30))
        return _PortForward.apply(y, port_y) if forced else y

    def conv(x, name, stride=1, pad=0):
        return F.conv2d(x, c(P[name + ".w_0"]).permute(3, 2, 0, 1), None,
                        stride, pad)

    def bn(x, name):
        x = x.float()
        mean = x.mean(dim=(0, 2, 3))
        var = (x * x).mean(dim=(0, 2, 3)) - mean * mean
        stats[name] = (mean.detach(), var.detach())
        v = lambda t: t[None, :, None, None]  # noqa: E731
        return ((x - v(mean)) * v(torch.rsqrt(var + 1e-5))
                * v(c(P[name + ".w_0"]).float()) + v(c(P[name + ".b_0"]).float()))

    n, h, w, ch = img.shape
    x = c(img).reshape(n, h // 2, 2, w // 2, 2, ch).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, h // 2, w // 2, 4 * ch).permute(0, 3, 1, 2)
    x = relu(bn(conv(F.pad(x, (2, 1, 2, 1)), "stem"), "stem.bn"), "stem.bn")
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, blocks in enumerate(RN_STAGES):
        width = 64 * 2 ** stage
        for i in range(blocks):
            stride = 2 if (i == 0 and stage > 0) else 1
            pre = f"res{stage}.{i}"
            y = relu(bn(conv(x, pre + ".c1"), pre + ".c1.bn"), pre + ".c1.bn")
            y = relu(bn(conv(y, pre + ".c2", stride, 1), pre + ".c2.bn"),
                     pre + ".c2.bn")
            y = bn(conv(y, pre + ".c3"), pre + ".c3.bn")
            if x.shape[1] != width * 4 or stride != 1:
                x = c(bn(conv(x, pre + ".sc", stride), pre + ".sc.bn"))
            x = relu(y + x.float(), pre + ".c3.bn")
    logits = c(c(x.float().mean(dim=(2, 3))) @ c(P["fc_0.w_0"])) + c(P["fc_0.b_0"])
    return F.cross_entropy(logits.float(), label,
                           reduction="none").to(low).float().mean()


def train_resnet(dev, card):
    """The ResNet-50 training step through the port's entry points: step 1
    held against the plain-torch autograd oracle (loss, every gradient, the
    momentum update, the running statistics), launches per step counted,
    then RN_STEPS timed steps on the same batch."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import cuda_kernels as ck

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        img = L.data(name="img", shape=[RN_HW, RN_HW, 3], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        loss, acc, _ = resnet.resnet50(img, label, num_classes=RN_CLASSES,
                                       s2d_stem=True, data_format="NHWC")
        pt.optimizer.Momentum(RN_LR, RN_MU).minimize(loss)
    startup.random_seed = SEED
    ops = [op.type for op in main.global_block.ops]
    n_bn = ops.count("batch_norm") + ops.count("conv2d_bn")
    if n_bn != 53 or ops.count("batch_norm_grad") + ops.count("conv2d_bn_grad") != 53:
        raise RuntimeError(f"ResNet-50 has 53 batch norms, the program {n_bn}")
    expected = dict.fromkeys(ck.launch_counts(), 0)
    # K9 in its chain mode: one launch a batch norm
    expected.update(bn_apply_act=n_bn, bn_apply_act_backward=n_bn,
                    softmax_xent_fwd=1, softmax_xent_bwd=1)

    exe, scope = pt.Executor(), pt.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    names = [p.name for p in main.all_parameters()]
    n_elems = sum(scope.find_var(n).numel() for n in names)
    print(f"trainer built in {time.perf_counter() - t0:.2f} s: ResNet-50 "
          f"B={RN_B} {RN_HW}x{RN_HW} NHWC s2d stem fp32, {len(names)} "
          f"parameters, {n_elems} elements, {len(ops)} ops a step "
          f"({ops.count('conv2d_bn')} conv2d_bn, {ops.count('batch_norm')} "
          f"batch_norm) [{card}]")
    rng = np.random.default_rng(SEED)
    feed = {"img": rng.standard_normal((RN_B, RN_HW, RN_HW, 3)).astype(np.float32),
            "label": rng.integers(0, RN_CLASSES, (RN_B, 1)).astype(np.int64)}
    feed = {k: torch.from_numpy(v).to(dev) for k, v in feed.items()}
    feed["label"] = feed["label"].to(torch.int32)
    p0 = {n: scope.find_var(n).clone() for n in names}
    bn_names = sorted(n[:-len(".mean")] for n in main.global_block.vars
                      if n.endswith(".bn.mean"))
    # the port's output after each relu, all folded into the norm ops
    relu_vars = {op.inputs["Scale"][0][:-len(".w_0")]: op.outputs["Y"][0]
                 for op in main.global_block.ops
                 if op.type in ("conv2d_bn", "batch_norm")
                 and op.attr("act", "") == "relu"}
    if len(relu_vars) != 49 or "relu" in ops:
        raise RuntimeError(f"ResNet-50 has 49 relus folded into its norm ops, "
                           f"the program {len(relu_vars)}")

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[loss] + [n + "@GRAD" for n in names]
                  + list(relu_vars.values()))
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = ck.launch_counts()
    if counts != expected:
        raise RuntimeError(f"launches in one step {counts}, expected {expected}")
    loss1, grads = out[0], dict(zip(names, out[1:]))
    port_relu = dict(zip(relu_vars, out[1 + len(names):]))

    P = {n: t.clone().requires_grad_() for n, t in p0.items()}
    stats = {}
    tally = _tally(dev)
    ref_loss = _resnet50_oracle(P, feed["img"], feed["label"].long()[:, 0],
                                stats, port_relu, tally)
    ref_grads = torch.autograd.grad(ref_loss, [P[n] for n in names])
    ref_loss = ref_loss.detach()
    tally = {k: v.item() for k, v in tally.items()}
    if tally["far"]:
        raise RuntimeError(f"{tally['far']} relu decisions differ from the "
                           f"oracle's beyond {RELU_NEAR} of the relu's "
                           f"largest input off zero (the two "
                           f"forward passes differ by up to {tally['fwd']:.3e})")
    if not abs(float(loss1) - float(ref_loss)) <= 1e-4 * abs(float(ref_loss)):
        raise RuntimeError(f"step-1 loss {float(loss1)} vs oracle "
                           f"{float(ref_loss)}")
    # First momentum step from zero velocity: v = g, p = p0 - lr g. The
    # port's update against the formula on its own gradients, and against
    # the formula on the oracle's (the gradient limit times lr); both allow
    # the parameter's own fp32 spacing, 2.4e-7 of its max-abs.
    worst = own_err = ref_err = vel_err = 0.0
    for n, rg in zip(names, ref_grads):
        scale = float(rg.abs().max())
        e = float((grads[n] - rg).abs().max()) / max(scale, 1e-30)
        if not e <= GRAD_RTOL:
            raise RuntimeError(f"{n}@GRAD differs from the oracle by {e:.3e} "
                               f"of its max-abs {scale:.3e}")
        worst = max(worst, e)
        p1 = scope.find_var(n)
        vel_err = max(vel_err, float(
            (scope.find_var(f"{n}_velocity_0") - grads[n]).abs().max()))
        spacing = 2.4e-7 * float(p0[n].abs().max())
        step = max(RN_LR * scale, 1e-30)
        own = float((p1 - (p0[n] - RN_LR * grads[n])).abs().max())
        ref = float((p1 - (p0[n] - RN_LR * rg)).abs().max())
        own_err = max(own_err, max(own - spacing, 0.0) / step)
        ref_err = max(ref_err, max(ref - spacing, 0.0) / step)
    if vel_err != 0.0 or not own_err <= 1e-6 or not ref_err <= GRAD_RTOL:
        raise RuntimeError(
            f"momentum step 1: velocity differs from the gradient by "
            f"{vel_err:.3e}; beyond fp32 spacing the parameters differ from "
            f"p0 - lr g by {own_err:.3e} of lr max|g| on the port's gradients "
            f"(limit 1e-6) and by {ref_err:.3e} on the oracle's (limit "
            f"{GRAD_RTOL})")
    stat_err = 0.0
    if sorted(stats) != bn_names:
        raise RuntimeError("the oracle's batch norms are not the program's")
    for n, (m, v) in stats.items():
        for got, want in ((scope.find_var(n + ".mean"), (1 - 0.9) * m),
                          (scope.find_var(n + ".var"), 0.9 + (1 - 0.9) * v)):
            err = (got - want).abs()
            if not bool((err <= 1e-5 + 1e-4 * want.abs()).all()):
                raise RuntimeError(f"running statistics of {n} differ from the "
                                   f"oracle's by {float(err.max()):.3e}")
            stat_err = max(stat_err, float(err.max()))
    peak1 = torch.cuda.max_memory_allocated()
    print(f"step 1 ({first:.3f} s, first use of every conv shape): loss "
          f"{float(loss1):.6f}, oracle {float(ref_loss):.6f}; worst gradient "
          f"error {worst:.3e} of its max-abs (limit {GRAD_RTOL}); velocity "
          f"equals the gradient; momentum update within {own_err:.3e} of lr "
          f"max|g| of p0 - lr g on the port's gradients and {ref_err:.3e} on "
          f"the oracle's; {len(stats)} "
          f"running mean/var pairs within {stat_err:.3e} of the oracle's; "
          f"of {tally['near']} relu inputs within {RELU_NEAR} of their "
          f"relu's largest off zero the "
          f"oracle's own decision differed from the port's at "
          f"{tally['taken']}, and at none farther off (the two forward "
          f"passes differ by up to {tally['fwd']:.3e} after a relu); "
          f"launches {counts}")
    del P, ref_grads, ref_loss, grads, out, stats, port_relu

    # back to the initial state (parameters, zero velocities, running
    # statistics at 0 / 1), the learning rate at RN_FALL_LR
    lr_name = next(op.inputs["LearningRate"][0] for op in main.global_block.ops
                   if op.type == "momentum")
    scope.find_var(lr_name).fill_(RN_FALL_LR)
    for n in names:
        scope.find_var(n).copy_(p0[n])
        scope.find_var(f"{n}_velocity_0").zero_()
    for n in bn_names:
        scope.find_var(n + ".mean").zero_()
        scope.find_var(n + ".var").fill_(1.0)

    def step():
        return exe.run(main, feed=feed, scope=scope, fetch_list=[loss],
                       return_numpy=False)[0]

    first_loss = float(step())   # cuDNN has now picked every algorithm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step() for _ in range(RN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [float(lv) for lv in losses]
    if abs(first_loss - float(loss1)) > 1e-5 * float(loss1):
        raise RuntimeError(f"the restored state gives loss {first_loss}, the "
                           f"initial state gave {float(loss1)}")
    if not all(np.isfinite(losses)) or not losses[-1] < first_loss:
        raise RuntimeError(f"the loss did not fall at lr {RN_FALL_LR}: "
                           f"{first_loss}, then {losses}")
    print(f"trained {RN_STEPS} steps (lr {RN_FALL_LR} from the initial state, "
          f"after one untimed step) in {wall:.3f} s: "
          f"{1e3 * wall / RN_STEPS:.2f} ms a step, "
          f"{RN_STEPS * RN_B / wall:.1f} images/s, peak device memory "
          f"{peak / 2**30:.3f} GiB in a step ({peak1 / 2**30:.3f} GiB in step "
          f"1 with every gradient fetched and the oracle beside it); losses "
          f"{[round(x, 5) for x in losses]} [{card}]")
    return (lambda: step()), counts


# ---------------------------------------------------------------------------
# bf16: the kernels at the AMP training steps' shapes, #15, and the two AMP
# training steps at bench.py's batch 128
# ---------------------------------------------------------------------------

BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, dense bf16 tensor cores
# a bf16 output rounded once on each side of a comparison: two units of
# its last place (2^-8 each) plus a floor of a hundredth of the max-abs
BF16_RTOL, BF16_FLOOR = 2.0 ** -7, 1e-2
AMP_B, AMP_S = 128, 128        # bench.py:120 (BERT) and :282 (ResNet-50)
CSRC = "paddle_tpu_torch/ops/cuda_kernels/csrc/"


def _bound16(flops, nbytes):
    return _bound(flops, nbytes, BF16_FLOPS_PER_S)


def _agree16(name, out, ref, floor=BF16_FLOOR, skip=None):
    """A bf16 kernel output against its plain version's: |out - ref| <=
    BF16_RTOL |ref| + floor max|ref| everywhere but at `skip` (elements
    whose relu decision sits within rounding of zero). Returns the max abs
    err."""
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype \
            or not torch.isfinite(out.float()).all():
        raise RuntimeError(f"{name}: {tuple(out.shape)} {out.dtype} vs "
                           f"{tuple(ref.shape)} {ref.dtype}, or non-finite")
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    if skip is not None:
        err = err.masked_fill(skip, 0.0)
    if not bool((err <= BF16_RTOL * r.abs() + floor * r.abs().max()).all()):
        raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                           f"(max abs err {err.max().item():.3e}, max-abs "
                           f"{r.abs().max().item():.3e})")
    return float(err.max().item())


# K7's dx = g (p - onehot): its typical element is g / V or less, a
# thousandth of the one-hot entry that sets its max-abs, so a floor tied to
# the max-abs would pass a kernel that drops most of the softmax. dx is held
# element by element: fp32 to 1e-4 relative (ex2.approx and the row sums in
# another order move p by a few 1e-6), bf16 to one unit of its last place
# (2^-7 |ref|: one fp32 value rounded either side of a rounding boundary),
# both with a floor of a thousandth of the median |ref| (taken over a
# strided sample of about 2^20 elements).
XENT_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
XENT_FLOOR = 1e-3


def _agree_xent(name, out, ref):
    """K7's dx against its plain version's, element by element; returns
    the max abs err."""
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype \
            or not torch.isfinite(out.float()).all():
        raise RuntimeError(f"{name}: {tuple(out.shape)} {out.dtype} vs "
                           f"{tuple(ref.shape)} {ref.dtype}, or non-finite")
    if not ref.numel():
        return 0.0
    r = ref.float()
    a = r.abs()
    typical = float(a.flatten()[::max(1, a.numel() >> 20)].median())
    err = (out.float() - r).abs()
    bad = err > XENT_RTOL[ref.dtype] * a + XENT_FLOOR * typical
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        raise RuntimeError(
            f"{name}: kernel disagrees with its plain version at "
            f"{int(bad.sum())} elements, the first flat index {i}: "
            f"{out.flatten()[i].item():.6e} vs {ref.flatten()[i].item():.6e} "
            f"(median |ref| {typical:.3e})")
    return float(err.max().item())


def _bf16_entry(name, source, replaces, err, ms, plain_ms, bound, by, lib_ms):
    return {"name": name, "dtype": "bfloat16", "route": "cuda",
            "source": CSRC + source, "replaces": replaces,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


# ResNet-50's batch-norm applies at B=128 (bench.py:282), NHWC "cl" on the
# main path, the NCHW layout's "cr" at the first and last bottleneck widths
BN_SHAPES_AMP = (  # (mode, R, row, C, act, residual)
    ("cl", AMP_B * 56 * 56, 64, 64, "relu", False),
    ("cl", AMP_B * 56 * 56, 256, 256, "identity", False),
    ("cl", AMP_B * 56 * 56, 256, 256, "relu", True),
    ("cl", AMP_B * 7 * 7, 2048, 2048, "identity", False),
    ("cl", AMP_B * 7 * 7, 2048, 2048, "relu", True),
    ("cr", AMP_B * 256, 3136, 256, "relu", True),
    ("cr", AMP_B * 2048, 49, 2048, "relu", True),
)


# bf16 K2 / K4, one case for each route of the kernels: BERT-base
# attention at the AMP shape (one block a head; timed, the entries'
# numbers), bench.py:137's long BERT shape B=64, S=512 (streamed key tiles;
# timed), causal at a ragged S, kv_lens with a kv_len 0 row on both routes,
# a head width padded to 48 (40) and dh = 128
ATTN16_CASES = (  # (B, nh, S, dh, causal, kv_lens, timed)
    (AMP_B, 12, AMP_S, 64, False, None, True),
    (64, 12, 512, 64, False, None, True),
    (4, 12, 100, 64, True, None, False),
    (3, 12, 128, 64, True, (100, 0, 128), False),
    (3, 12, 384, 64, False, (300, 0, 384), False),
    (4, 12, 128, 40, False, None, False),
    (4, 12, 200, 40, True, None, False),
    (4, 12, 128, 128, False, None, False),
    (4, 12, 512, 128, True, None, False),
)


def _check_attention16(dev, timer, card, g):
    """bf16 K2 and K4 against their plain versions at ATTN16_CASES, the
    timed ones beside SDPA (forward, and backward through autograd) and
    their bounds; a kv_len 0 row must give zeros. Returns the two entries
    (the AMP shape's numbers)."""
    from paddle_tpu_torch.ops.cuda_kernels import attention_bwd as K4
    from paddle_tpu_torch.ops.cuda_kernels import prefill_attention as K2
    import torch.nn.functional as F

    entries = []
    for B, nh, S, dh, causal, lens, timed in ATTN16_CASES:
        q, k, v, do = (torch.randn((B, nh, S, dh), generator=g).to(
            dev, torch.bfloat16) for _ in range(4))
        kl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device=dev)
        sc = dh ** -0.5
        shape = (f"B={B} nh={nh} S={S} dh={dh} causal={causal}"
                 + ("" if lens is None else f" kv_lens={list(lens)}") + " bf16")
        o = K2.causal_prefill_attention(q, k, v, causal, sc, kl)
        err2 = _agree16(f"causal_prefill_attention {shape}", o,
                        K2.causal_prefill_attention_plain(q, k, v, causal, sc,
                                                          kl))
        got = K4.attention_backward(q, k, v, do, causal, sc, kl)
        ref = K4.attention_backward_plain(q, k, v, do, causal, sc, kl)
        # dQ, dK, dV sum S terms of dS and P rounded to bf16 on both sides
        err4 = max(_agree16(f"attention_backward {shape} d{n}", a, r,
                            floor=2e-2) for n, a, r in zip("qkv", got, ref))
        if lens is not None and 0 in lens:
            b = lens.index(0)
            if o[b].any() or any(t[b].any() for t in got):
                raise RuntimeError(f"K2/K4 {shape}: the kv_len 0 row is not "
                                   f"all zeros")
        if not timed:
            print(f"K2/K4 bf16 {shape}: max_abs_err {err2:.3e} / {err4:.3e} "
                  f"[{card}]")
            continue
        ms = timer(lambda: K2.causal_prefill_attention(q, k, v, causal, sc))
        plain_ms = timer(lambda: K2.causal_prefill_attention_plain(
            q, k, v, causal, sc))
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=sc))
        bound, by = _bound16(2 * 2 * B * nh * S * S * dh,
                             4 * B * nh * S * dh * 2)
        _row("K2 causal_prefill_attention", shape, ms, plain_ms, lib_ms, bound,
             by, err2, card)
        fwd = _bf16_entry(
            "causal_prefill_attention", "prefill_attention.cu",
            "paddle_tpu/ops/pallas_kernels/short_attention.py:248 "
            "+ paddle_tpu/ops/pallas_kernels/attention.py:211",
            err2, ms, plain_ms, bound, by, lib_ms)
        ms = timer(lambda: K4.attention_backward(q, k, v, do, causal, sc))
        plain_ms = timer(lambda: K4.attention_backward_plain(
            q, k, v, do, causal, sc))
        lib_ms = timer(_autograd_lib(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=sc), (q, k, v), do))
        bound, by = _bound16(5 * 2 * B * nh * S * S * dh,
                             7 * B * nh * S * dh * 2)
        _row("K4 attention_backward", shape, ms, plain_ms, lib_ms, bound, by,
             err4, card)
        if not entries:
            entries = [fwd, _bf16_entry(
                "attention_backward", "attention_backward.cu",
                "paddle_tpu/ops/pallas_kernels/short_attention.py:164 "
                "+ paddle_tpu/ops/pallas_kernels/attention.py:154",
                err4, ms, plain_ms, bound, by, lib_ms)]
        del q, k, v, do, o, got, ref
        torch.cuda.empty_cache()
    return entries


def check_bf16_kernels(dev, timer, card):
    """K2-K9 in bf16 against their plain versions in bf16, at the AMP
    steps' shapes: BERT-base at B=128, S=128 (attention [128, 12, 128, 64],
    with K2/K4's other routes in ATTN16_CASES, layer norm [16384, 768],
    cross entropy [16384, 30522]) and ResNet-50's batch-norm applies at
    B=128; bounds at 2 bytes an element or bf16 operations, the library
    yardstick in bf16 where one call computes the same function."""
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply as K8
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply_bwd as K9
    from paddle_tpu_torch.ops.cuda_kernels import layer_norm as K3
    from paddle_tpu_torch.ops.cuda_kernels import layer_norm_bwd as K5
    from paddle_tpu_torch.ops.cuda_kernels import xent_bwd as K7
    from paddle_tpu_torch.ops.cuda_kernels import xent_fwd as K6
    import torch.nn.functional as F

    bf = torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(SEED + 10)

    def rnd(*shape, scale=1.0, shift=0.0, dtype=bf):
        return (scale * torch.randn(shape, generator=g) + shift).to(dev, dtype)

    out = _check_attention16(dev, timer, card, g)

    # K3 / K5: BERT-base layer norm, 16384 rows of 768
    R, Kd = AMP_B * AMP_S, 768
    x, dy = rnd(R, Kd), rnd(R, Kd)
    s_, b_ = rnd(Kd, scale=0.1, shift=1.0, dtype=torch.float32), \
        rnd(Kd, scale=0.1, dtype=torch.float32)
    shape = f"R={R} K={Kd} act=identity bf16"
    y = K3.layer_norm_act(x, s_, b_, 1e-5, "identity")
    ref = K3.layer_norm_act_plain(x, s_, b_, 1e-5, "identity")
    err = max(_agree16("layer_norm_act bf16 y", y[0], ref[0]),
              *(_agree(f"layer_norm_act bf16 {n}", o, r)
                for n, o, r in zip(("mean", "var"), y[1:], ref[1:])))
    ms = timer(lambda: K3.layer_norm_act(x, s_, b_, 1e-5, "identity"))
    plain_ms = timer(lambda: K3.layer_norm_act_plain(x, s_, b_, 1e-5, "identity"))
    sb, bb = s_.to(bf), b_.to(bf)
    lib_ms = timer(lambda: F.layer_norm(x, (Kd,), sb, bb, 1e-5))
    bound, by = _bound16(0, 2 * R * Kd * 2 + 2 * Kd * 4 + 2 * R * 4)
    _row("K3 layer_norm_act", shape, ms, plain_ms, lib_ms, bound, by, err, card)
    out.append(_bf16_entry("layer_norm_act", "layer_norm.cu",
                           "paddle_tpu/ops/pallas_kernels/epilogue.py:421",
                           err, ms, plain_ms, bound, by, lib_ms))
    got = K5.layer_norm_act_backward(x, s_, b_, dy, 1e-5, "identity")
    ref = K5.layer_norm_act_backward_plain(x, s_, b_, dy, 1e-5, "identity")
    err = max(_agree16("layer_norm_act_backward bf16 dx", got[0], ref[0]),
              *(_sums_agree(f"layer_norm_act_backward bf16 {n}", o, r)
                for n, o, r in zip(("dscale", "dbias"), got[1:], ref[1:])))
    _repeats("layer_norm_act_backward bf16", got,
             K5.layer_norm_act_backward(x, s_, b_, dy, 1e-5, "identity"))
    ms = timer(lambda: K5.layer_norm_act_backward(x, s_, b_, dy, 1e-5, "identity"))
    plain_ms = timer(lambda: K5.layer_norm_act_backward_plain(
        x, s_, b_, dy, 1e-5, "identity"))
    lib_ms = timer(_autograd_lib(lambda x, s, b: F.layer_norm(
        x, (Kd,), s, b, 1e-5), (x, sb, bb), dy))
    bound, by = _bound16(0, 3 * R * Kd * 2 + 4 * Kd * 4)
    _row("K5 layer_norm_act_backward", shape, ms, plain_ms, lib_ms, bound, by,
         err, card)
    out.append(_bf16_entry("layer_norm_act_backward", "layer_norm_backward.cu",
                           "paddle_tpu/ops/pallas_kernels/epilogue.py:373",
                           err, ms, plain_ms, bound, by, lib_ms))
    del x, dy, y, got, ref

    # K6 / K7: the BERT-base lm head at B=128, S=128
    N, V = AMP_B * AMP_S, 30522
    x = rnd(N, V, scale=3.0)
    lab = torch.randint(0, V, (N,), generator=g, dtype=torch.int32).to(dev)
    gl = rnd(N, dtype=torch.float32)
    lab64 = lab.long()
    shape = f"N={N} V={V} bf16 logits"
    err = max(_agree(f"softmax_xent_fwd bf16 {n}", o, r) for n, o, r in zip(
        ("loss", "m", "lse"), K6.softmax_xent_fwd(x, lab),
        K6.softmax_xent_fwd_plain(x, lab)))
    ms = timer(lambda: K6.softmax_xent_fwd(x, lab))
    plain_ms = timer(lambda: K6.softmax_xent_fwd_plain(x, lab))
    lib_ms = timer(lambda: F.cross_entropy(x, lab64, reduction="none"))
    bound, by = _bound16(0, N * V * 2 + 4 * N * 4)
    _row("K6 softmax_xent_fwd", shape, ms, plain_ms, lib_ms, bound, by, err, card)
    out.append(_bf16_entry("softmax_xent_fwd", "softmax_xent_fwd.cu",
                           "paddle_tpu/ops/pallas_kernels/xent.py:221",
                           err, ms, plain_ms, bound, by, lib_ms))
    lib_ms = timer(_autograd_lib(lambda x: F.cross_entropy(
        x, lab64, reduction="none"), (x,), gl.to(bf)))
    saved = K6.softmax_xent_fwd_plain(x, lab)[1:]
    for mode, stats in (("recomputed stats (program path, #12)", ()),
                        ("saved stats (#11)", saved)):
        err = _agree_xent(f"softmax_xent_bwd bf16 {mode}",
                          K7.softmax_xent_bwd(x, lab, gl, *stats),
                          K7.softmax_xent_bwd_plain(x, lab, gl, *stats))
        ms = timer(lambda: K7.softmax_xent_bwd(x, lab, gl, *stats))
        plain_ms = timer(lambda: K7.softmax_xent_bwd_plain(x, lab, gl, *stats))
        bound, by = _bound16(0, 2 * N * V * 2 + (2 + len(stats)) * N * 4)
        _row("K7 softmax_xent_bwd", f"{shape} {mode}", ms, plain_ms, lib_ms,
             bound, by, err, card)
        if not stats:
            out.append(_bf16_entry(
                "softmax_xent_bwd", "softmax_xent_bwd.cu",
                "paddle_tpu/ops/pallas_kernels/xent.py:228 "
                "+ paddle_tpu/ops/pallas_kernels/xent.py:139",
                err, ms, plain_ms, bound, by, lib_ms))
    del x, saved

    # K8 / K9: ResNet-50's batch-norm applies at B=128
    k8 = k9 = None
    for mode, R, row, C, act, has_res in BN_SHAPES_AMP:
        x = rnd(R, row, scale=1.5, shift=0.3)
        dy = rnd(R, row)
        res = rnd(R, row) if has_res else None
        p = (rnd(C, scale=0.2, shift=1.0, dtype=torch.float32),
             rnd(C, scale=0.2, dtype=torch.float32),
             rnd(C, scale=0.1, shift=0.3, dtype=torch.float32),
             torch.rsqrt(2.25 + torch.rand((C,), generator=g)).to(dev))
        shape = (f"{mode} [{R}, {row}] C={C} act={act} residual="
                 f"{'yes' if has_res else 'no'} bf16")
        err = _agree16(f"bn_apply_act {shape}",
                       K8.bn_apply_act(x, *p, act, res, mode),
                       K8.bn_apply_act_plain(x, *p, act, res, mode))
        ms = timer(lambda: K8.bn_apply_act(x, *p, act, res, mode))
        plain_ms = timer(lambda: K8.bn_apply_act_plain(x, *p, act, res, mode))
        lib_ms = lib_bwd = lib_chain = None
        if act == "identity" and not has_res and mode == "cl":
            hw = int(round((R // AMP_B) ** 0.5))
            x4 = x.reshape(AMP_B, hw, hw, C).permute(0, 3, 1, 2)
            dy4 = dy.reshape(AMP_B, hw, hw, C).permute(0, 3, 1, 2)
            var = 1.0 / (p[3] * p[3]) - 1e-5
            lib = lambda x4, s, b: F.batch_norm(  # noqa: E731
                x4, p[2], var, s, b, training=False, eps=1e-5)
            lib_ms = timer(lambda: lib(x4, p[0], p[1]))
            lib_bwd = timer(_autograd_lib(lib, (x4, p[0], p[1]), dy4))
            lib_chain = timer(_bn_train_backward(x4, dy4, p[0], p[2], p[3]))
        n_t = 3 if has_res else 2
        bound, by = _bound16(4 * R * row, n_t * R * row * 2 + 4 * C * 4)
        _row("K8 bn_apply_act", shape, ms, plain_ms, lib_ms, bound, by, err, card)
        if k8 is None:
            k8 = _bf16_entry("bn_apply_act", "bn_apply.cu",
                             "paddle_tpu/ops/pallas_kernels/epilogue.py:151",
                             err, ms, plain_ms, bound, by, lib_ms)
        got = K9.bn_apply_act_backward(x, *p, dy, act, res, mode)
        ref = K9.bn_apply_act_backward_plain(x, *p, dy, act, res, mode)
        # bf16 operands make a pre-activation of exactly (or within fp32
        # rounding of) zero common: there the kernel's fused multiply-add
        # and the plain version's separate steps may take the relu apart,
        # which changes dx by all of dy * inv * scale; such elements are
        # counted and left out of the comparison
        skip, n_skip, slack = None, 0, (None, None)
        if act == "relu":
            sv, bv, mv, iv = (K8.param_view(t, x, mode) for t in p)
            xc = x.float() - mv
            z = xc * (iv * sv) + bv
            if res is not None:
                z += res.float()
            skip = z.abs() <= 1e-5 * z.abs().max()
            n_skip = int(skip.sum())
            # what those elements can move P1 = sum dz and P2 = sum dz xc by
            dyf = dy.float().masked_fill(~skip, 0.0).abs()
            fold = ((lambda t: t.sum(dim=0)) if mode == "cl" else  # noqa: E731
                    (lambda t: t.sum(dim=1).reshape(-1, C).sum(dim=0)))
            slack = (fold(dyf), fold(dyf * xc.abs()))
            del z, xc, dyf
        err = _agree16(f"bn_apply_act_backward dx {shape}", got[0], ref[0],
                       skip=skip)
        if has_res:
            err = max(err, _agree16(f"bn_apply_act_backward dres {shape}",
                                    got[1], ref[1], skip=skip))
        # dscale = P2 inv and dbias = P1: their slack follows
        if slack[0] is not None:
            slack = slack + (slack[1] * p[3], slack[0])
        else:
            slack = (None,) * 4
        sum_err = max(_sums_agree(f"bn_apply_act_backward {n} {shape}", o, r,
                                  sl)
                      for n, o, r, sl in zip(("P1", "P2", "dscale", "dbias"),
                                             got[2:], ref[2:], slack))
        one_ms = timer(lambda: K9.bn_apply_act_backward(x, *p, dy, act, res,
                                                        mode))

        # the main path's call: the chain mode (the sums, the fold and dx in
        # one launch, as the AMP step runs it)
        M = R * row // C
        got = K9.bn_apply_act_backward(x, *p, dy, act, res, mode, M)
        ref = K9.bn_apply_act_backward_plain(x, *p, dy, act, res, mode, M)
        err = max(err, _agree16(f"bn_apply_act_backward chain dx {shape}",
                                got[0], ref[0], skip=skip))
        _repeats(f"bn_apply_act_backward chain {shape}", got,
                 K9.bn_apply_act_backward(x, *p, dy, act, res, mode, M))
        ms = timer(lambda: K9.bn_apply_act_backward(x, *p, dy, act, res, mode,
                                                    M))
        plain_ms = timer(lambda: K9.bn_apply_act_backward_plain(
            x, *p, dy, act, res, mode, M))
        phases = _k9_phases(K9, (x, *p, dy, act, res, mode, M), ms)
        bound, by = _k9_bound(x, R, row, C, 5 if has_res else 3, _bound16)
        _row("K9 bn_apply_act_backward", shape + f" with the statistics "
             f"chain (pass 1 / fold / pass 2 by the kernel's clock: "
             f"{' / '.join(f'{t:.4f}' for t in phases)} ms; one pass without "
             f"it: {one_ms:.4f} ms, against the "
             f"inference batch norm's backward: {_ms(lib_bwd)} ms; sums within "
             f"{sum_err:.1e} of their max-abs; {n_skip} relu decisions within "
             f"1e-5 of the largest pre-activation off zero left out)", ms,
             plain_ms, lib_chain, bound, by, err, card)
        if k9 is None:
            k9 = _bf16_entry("bn_apply_act_backward", "bn_apply_backward.cu",
                             "paddle_tpu/ops/pallas_kernels/epilogue.py:182",
                             err, ms, plain_ms, bound, by, lib_chain)
        del x, dy, res, got, ref
    torch.cuda.empty_cache()
    return out + [k8, k9]


def check_bottleneck(dev, timer, card):
    """#15 at the tool's shape (B=128, 56x56, C=256, M=64): the tool's entry
    point as a path (one block, then a chain of K_CHAIN, its launches
    counted from 0), the kernel against bottleneck_block_plain on the card,
    its time, bound and the library chain's, then the tool's A/B."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.ops.cuda_kernels import bottleneck as BB

    x, w1, w2, w3 = BB.inputs(dev, SEED)
    ck.reset_launch_counts()
    y = BB.bottleneck_block(x, w1, w2, w3)
    c = x
    for _ in range(BB.K_CHAIN):
        c = BB.bottleneck_block(c, w1, w2, w3)
    torch.cuda.synchronize()
    launches = ck.launch_counts_by_dtype()["bottleneck_block"]
    if launches != {"bfloat16": 1 + BB.K_CHAIN} or not torch.isfinite(
            c.float()).all():
        raise RuntimeError(f"bottleneck_block path: launches {launches}, or "
                           f"a non-finite chained output")
    err = _agree16("bottleneck_block", y, BB.bottleneck_block_plain(x, w1, w2, w3))
    ms = timer(lambda: BB.bottleneck_block(x, w1, w2, w3))
    plain_ms = timer(lambda: BB.bottleneck_block_plain(x, w1, w2, w3))
    lib_ms = timer(lambda: BB.library_chain(x, w1, w2, w3))
    w_bytes = (w1.numel() + w2.numel() + w3.numel()) * 2
    bound, by = _bound16(BB.flops(x, w1), 2 * x.numel() * 2 + w_bytes)
    _row("#15 bottleneck_block", f"B={BB.B} {BB.H}x{BB.W} C={BB.C} M={BB.M} "
         f"bf16", ms, plain_ms, lib_ms, bound, by, err, card)
    ab = BB.ab(dev)
    print(f"#15 A/B (the tool's protocol, L2 warm): max rel err kernel vs "
          f"library chain {ab['max_rel_err']:.4f}; single-shot kernel "
          f"{ab['kernel_ms']:.4f} ms ({ab['kernel_tflops']:.1f} TF/s), library "
          f"chain {ab['library_ms']:.4f} ms ({ab['library_tflops']:.1f} TF/s); "
          f"chained x{BB.K_CHAIN}: kernel {ab['chain_kernel_ms']:.4f} ms/block, "
          f"library chain {ab['chain_library_ms']:.4f} ms/block [{card}]")
    if not ab["max_rel_err"] <= 2e-2:
        raise RuntimeError(f"bottleneck_block vs the library chain: max rel "
                           f"err {ab['max_rel_err']:.4f}")
    e = _bf16_entry("bottleneck_block", "bottleneck_block.cu",
                    "tools/_rn_pallas_block.py:64", err, ms, plain_ms, bound,
                    by, lib_ms)
    e["launches"] = launches["bfloat16"]
    return e


def _flash_bound(B, nh, S, dh, causal, products, tensors, bf16):
    """The least time of a flash-attention call: `products` products of 2
    flops a live (query, key) pair and dim, at the fp32 or bf16 peak; bytes:
    `tensors` [B, nh, S, dh] tensors of the dtype and one fp32 [B, nh, S]
    statistic, each moved once (K10: q, k, v, out and lse written; K11: q,
    k, v, o, dO, dq, dk, dv and lse read)."""
    pairs = B * nh * (S * (S + 1) // 2 if causal else S * S)
    return _bound(2 * products * pairs * dh,
                  tensors * B * nh * S * dh * (2 if bf16 else 4) + B * nh * S * 4,
                  BF16_FLOPS_PER_S if bf16 else FP32_FLOPS_PER_S)


# the TPU kernels K10 and K11 replace: jax's bundled flash attention behind
# the JAX package's flash_bundled arm
FLASH_REPLACES = ("paddle_tpu/ops/attention_ops.py:147 -> "
                  "jax/experimental/pallas/ops/tpu/flash_attention.py:")


def _device_kernels(fn):
    """The names of the device kernels one call of `fn` launches, read from
    torch.profiler (after a first call that warms it up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


def check_flash(dev, timer, card):
    """K10 and K11 against their plain versions, fp32 and bf16, causal and
    not: at the long-context steps' shapes (B=8, S=2048 bf16 and B=4,
    S=1024 fp32, BERT-base's 12 heads of 64, not causal), causal at S=2048
    and 1024, and at a ragged S = 1000 with dh = 128. K11 is handed the
    plain forward's output and lse on both sides. Library yardsticks:
    scaled_dot_product_attention forward, and its autograd backward; at the
    fp32 main-path shape the script prints which device kernels they run."""
    from paddle_tpu_torch.ops.cuda_kernels import _build
    from paddle_tpu_torch.ops.cuda_kernels import flash_attention as K10
    from paddle_tpu_torch.ops.cuda_kernels import flash_attention_bwd as K11
    import torch.nn.functional as F

    # the wgmma kernels' registers at launch (K10, K11 and K12; the consumer
    # warpgroups take more by setmaxnreg), spills and shared memory
    for src, kernel, regs, rest in _resources(_build):
        if "_wg_kernel" in kernel:
            print(f"wgmma {src}: {kernel}: {regs} registers at launch, "
                  f"{rest} [{card}]")
    g = torch.Generator(device="cpu").manual_seed(SEED + 20)
    bf, f32 = torch.bfloat16, torch.float32
    entries = {}
    # (B, nh, S, dh, causal, dtype); the first two are the main paths' shapes
    cases = ((LONG_B, 12, LONG_S, 64, False, bf),
             (LONG_FP32_B, 12, LONG_FP32_S, 64, False, f32),
             (2, 12, 2048, 64, True, bf), (2, 12, 1024, 64, True, f32),
             (2, 4, 1000, 128, False, bf), (2, 4, 1000, 128, True, f32))
    for i, (B, nh, S, dh, causal, dt) in enumerate(cases):
        low = dt == bf
        sc = dh ** -0.5
        q, k, v, do = (torch.randn((B, nh, S, dh), generator=g).to(dev, dt)
                       for _ in range(4))
        shape = (f"B={B} nh={nh} S={S} dh={dh} causal={causal} "
                 f"{'bf16' if low else 'fp32'}")
        out, lse = K10.flash_attention_fwd(q, k, v, causal, sc)
        ref, ref_lse = K10.flash_attention_fwd_plain(q, k, v, causal, sc)
        err = max((_agree16 if low else _agree)("flash_attention_fwd out", out,
                                                ref),
                  _agree("flash_attention_fwd lse", lse, ref_lse))
        ms = timer(lambda: K10.flash_attention_fwd(q, k, v, causal, sc))
        plain_ms = timer(lambda: K10.flash_attention_fwd_plain(q, k, v, causal,
                                                               sc))
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=sc))
        bound, by = _flash_bound(B, nh, S, dh, causal, 2, 4, low)
        _row("K10 flash_attention_fwd", shape, ms, plain_ms, lib_ms, bound, by,
             err, card)
        fwd = {"name": "flash_attention_fwd", "route": "cuda",
               "dtype": str(dt).replace("torch.", ""),
               "source": CSRC + "flash_attention.cu",
               "replaces": FLASH_REPLACES + "589",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
        del out, lse
        got = K11.flash_attention_backward(q, k, v, ref, ref_lse, do, causal, sc)
        want = K11.flash_attention_backward_plain(q, k, v, ref, ref_lse, do,
                                                  causal, sc)
        # dQ, dK, dV sum S terms of dS and P rounded to bf16 on both sides
        err = max(_agree16(f"flash_attention_backward d{n}", o, r, floor=2e-2)
                  if low else _agree(f"flash_attention_backward d{n}", o, r)
                  for n, o, r in zip("qkv", got, want))
        del got, want
        ms = timer(lambda: K11.flash_attention_backward(
            q, k, v, ref, ref_lse, do, causal, sc))
        plain_ms = timer(lambda: K11.flash_attention_backward_plain(
            q, k, v, ref, ref_lse, do, causal, sc))
        lib_bwd = _autograd_lib(
            lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=sc), (q, k, v), do)
        lib_ms = timer(lib_bwd)
        if i < 2:
            fwd_names = _device_kernels(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=sc))
            print(f"library yardstick at {shape}: SDPA forward runs "
                  f"{fwd_names}; its backward runs "
                  f"{_device_kernels(lib_bwd)} [{card}]")
        del lib_bwd
        bound, by = _flash_bound(B, nh, S, dh, causal, 5, 8, low)
        _row("K11 flash_attention_backward", shape, ms, plain_ms, lib_ms,
             bound, by, err, card)
        if i < 2:
            entries[dt] = [fwd, dict(
                fwd, name="flash_attention_backward",
                source=CSRC + "flash_attention_backward.cu",
                replaces=FLASH_REPLACES + "941 + :1287",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms)]
        del q, k, v, do, ref, ref_lse
        torch.cuda.empty_cache()
    return entries[f32], entries[bf]


PROBE_ITERS = 100      # the tools' default (tools/_attn_probe.py:17)


def check_attn_probe(dev, timer, card):
    """K12 through its tool entry point (`attn_probe.table`, the tool's
    seven rows, its launches counted from 0), then each variant at the
    tool's shape against its plain version, timed beside its bound and the
    library yardstick (scaled_dot_product_attention for the full variants,
    q + v for copy)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.ops.cuda_kernels import attn_probe as K12
    import torch.nn.functional as F

    ck.reset_launch_counts()
    rows = K12.table(dev, PROBE_ITERS)
    torch.cuda.synchronize()
    launches = ck.launch_counts_by_dtype()["attention_probe"]
    if launches != {"bfloat16": len(K12.VARIANTS) * (PROBE_ITERS + 1)}:
        raise RuntimeError(f"attention_probe table: launches {launches}")
    print(f"K12 the tool's table (B={K12.B} nh={K12.NH} S={K12.S} "
          f"dh={K12.DH} bf16, {PROBE_ITERS} calls a row, L2 warm) [{card}]:")
    for name, ms in rows:
        print(f"  {name:16s} {ms:8.4f} ms   {ms / K12.B * 1e3:6.3f} us/step")
    q, k, v = K12.inputs(dev)
    sm = K12.DH ** -0.5
    B, nh, S, dh = q.shape
    flops = {"copy": B * nh * S * dh, "qk": 2 * B * nh * S * dh * dh,
             "qk_max": 2 * B * nh * S * S * dh,
             "softmax": 2 * B * nh * S * S * dh}
    entry = None
    for variant in K12.VARIANTS:
        got = K12.attention_probe(variant, q, k, v, sm)
        ref = K12.attention_probe_plain(variant, q, k, v, sm)
        if variant == "copy":
            if not torch.equal(got, ref):
                raise RuntimeError("attention_probe copy differs from q + v")
            err = 0.0
        else:
            err = _agree16(f"attention_probe {variant}", got, ref)
        ms = timer(lambda: K12.attention_probe(variant, q, k, v, sm))
        plain_ms = timer(lambda: K12.attention_probe_plain(variant, q, k, v, sm))
        lib_ms = None
        if variant.startswith("full") and variant != "full_bf16sm":
            lib_ms = timer(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                  scale=sm))
        elif variant == "copy":
            lib_ms = timer(lambda: q + v)
        # bytes: q, k, v and out each once (copy: q, v, out); qk reads
        # only the first dh keys of a head
        nbytes = (4 if variant.startswith("full") else 3) * q.numel() * 2
        if variant == "qk":
            nbytes = (2 * q.numel() + B * nh * min(S, dh) * dh) * 2
        bound, by = _bound16(flops.get(variant, 4 * B * nh * S * S * dh),
                             nbytes)
        _row(f"K12 attention_probe {variant}", f"B={B} nh={nh} S={S} dh={dh} "
             f"bf16", ms, plain_ms, lib_ms, bound, by, err, card)
        if variant == "full":
            entry = _bf16_entry("attention_probe", "attn_probe.cu",
                                "tools/_attn_probe.py:29", err, ms, plain_ms,
                                bound, by, lib_ms)
    q, k, v = (torch.randn((8, nh, 200, dh), generator=torch.Generator(
        device="cpu").manual_seed(SEED + 13)).to(dev, torch.bfloat16)
        for _ in range(3))
    worst = 0.0
    for variant in K12.VARIANTS:
        got = K12.attention_probe(variant, q, k, v, sm)
        ref = K12.attention_probe_plain(variant, q, k, v, sm)
        if variant == "copy":
            if not torch.equal(got, ref):
                raise RuntimeError("attention_probe copy differs from q + v "
                                   "at S=200")
        else:
            worst = max(worst, _agree16(f"attention_probe {variant} S=200",
                                        got, ref))
    print(f"K12 attention_probe, all seven variants at B=8 nh={nh} S=200 "
          f"dh={dh}: max_abs_err {worst:.3e} [{card}]")
    entry["launches"] = launches["bfloat16"]
    return entry


def check_dma_probe(dev, timer, card):
    """K13 through its tool entry point (`dma_probe.table`, the tool's seven
    rows, launches counted from 0), then both layouts at every bb exactly
    equal to their plain version (2 x is exact in bf16), timed beside the
    bound (bytes) and the library's x * 2.0."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.ops.cuda_kernels import dma_probe as K13

    ck.reset_launch_counts()
    rows = K13.table(dev, PROBE_ITERS)
    torch.cuda.synchronize()
    launches = ck.launch_counts_by_dtype()["dma_copy"]
    n_rows = 2 * len(K13.BLOCKS)
    if launches != {"bfloat16": n_rows * (PROBE_ITERS + 1)}:
        raise RuntimeError(f"dma_copy table: launches {launches}")
    print(f"K13 the tool's table ({PROBE_ITERS} calls a row, L2 warm) [{card}]:")
    for name, ms, gbs in rows:
        print(f"  {name:28s} {ms:8.4f} ms   {gbs:7.1f} GB/s")
    entry = None
    for x in K13.inputs(dev):
        bound, by = _bound16(x.numel(), 2 * x.numel() * 2)
        lib_ms = timer(lambda: x * 2.0)
        for bb in K13.BLOCKS:
            got = K13.dma_copy(x, bb)
            if not torch.equal(got, K13.dma_copy_plain(x)):
                raise RuntimeError(f"dma_copy {tuple(x.shape)} bb={bb} "
                                   f"differs from 2 x")
            ms = timer(lambda: K13.dma_copy(x, bb))
            plain_ms = timer(lambda: K13.dma_copy_plain(x))
            _row(f"K13 dma_copy bb={bb}", f"{list(x.shape)} bf16", ms,
                 plain_ms, lib_ms, bound, by, 0.0, card)
            if entry is None:
                entry = _bf16_entry("dma_copy", "dma_probe.cu",
                                    "tools/_attn_dma.py:34 + :47", 0.0, ms,
                                    plain_ms, bound, by, lib_ms)
    entry["launches"] = launches["bfloat16"]
    return entry


def _expected_launches(program):
    """{wrapper: {dtype: launches}} one run of `program` makes, from its
    ops and the dtypes of their vars."""
    block = program.global_block
    rules = {"fused_attention": ("causal_prefill_attention", "Q"),
             "fused_attention_grad": ("attention_backward", "Q"),
             "layer_norm": ("layer_norm_act", "X"),
             "layer_norm_grad": ("layer_norm_act_backward", "X"),
             "softmax_with_cross_entropy": ("softmax_xent_fwd", "Logits"),
             "softmax_with_cross_entropy_grad": ("softmax_xent_bwd", "Logits"),
             "batch_norm": ("bn_apply_act", "Y"),
             "conv2d_bn": ("bn_apply_act", "Y"),
             "batch_norm_grad": ("bn_apply_act_backward", "Y"),
             "conv2d_bn_grad": ("bn_apply_act_backward", "Y")}
    want: dict = {}
    flash = {"fused_attention": "flash_attention_fwd",
             "fused_attention_grad": "flash_attention_backward"}
    for op in block.ops:
        if op.type not in rules:
            continue
        wrapper, slot = rules[op.type]
        if op.type in flash and block.var(op.inputs["Q"][0]).shape[2] > 512:
            wrapper = flash[op.type]      # past S = 512: K10 and K11
        if slot != "Y":
            name = op.inputs[slot][0]
        elif "Y" in op.outputs:
            name = op.outputs["Y"][0]
        else:     # a norm's grad op: the dtype of the forward's Y
            name = op.inputs["Y@GRAD"][0][:-len("@GRAD")]
        dt = block.var(name).dtype.value
        want.setdefault(wrapper, {})
        want[wrapper][dt] = want[wrapper].get(dt, 0) + 1
    return want


def _check_launches(program, what):
    from paddle_tpu_torch.ops import cuda_kernels as ck

    got = {k: v for k, v in ck.launch_counts_by_dtype().items() if v}
    want = _expected_launches(program)
    if got != want:
        raise RuntimeError(f"{what}: launches by dtype {got}, the program's "
                           f"ops say {want}")
    return got


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm()) / max(float(b.float().norm()),
                                                       1e-30)


# Each bf16 gradient is held against the oracle of the same cast scheme in
# relative L2 (the elementwise spread of two bf16 computations is that of
# their rounding, not of the algorithm): within twice the distance bf16
# itself puts between that oracle and the fp32 oracle of the same weights
# and relu decisions, plus 2e-2 (the two round the backward at different
# places: the kernels' P and dS, K9's dx), and never beyond AMP_GRAD_CAP,
# so that a gradient zeroed (1 from the oracle's) or negated (2) is refused
AMP_GRAD_BAND = (2.0, 2e-2)
AMP_GRAD_CAP = 0.25
# the loss likewise: within twice the bf16 oracle's distance from the fp32
# oracle's plus 5e-3 of it (bf16 per-token or per-image losses averaged in
# fp32)
AMP_LOSS_RTOL = 5e-3


def _hold_amp_loss(what, loss, bf_loss, fp_loss):
    lim = 2 * abs(bf_loss - fp_loss) + AMP_LOSS_RTOL * abs(bf_loss)
    if not abs(loss - bf_loss) <= lim:
        raise RuntimeError(f"{what} step-1 loss {loss} vs the bf16 oracle's "
                           f"{bf_loss} (fp32 oracle {fp_loss}; limit {lim:.3e})")
    return lim


def _amp_grads_beyond(grads, bf_grads, limits):
    """[(distance, limit, name)] of the gradients beyond their limits."""
    rows = ((_rel_l2(grads[n], bf_grads[n]), lim, n) for n, lim in limits.items())
    return sorted(r for r in rows if not r[0] <= r[1])


def _hold_amp_grads(names, grads, bf_grads, fp_grads):
    """Every gradient within its limit (AMP_GRAD_BAND, AMP_GRAD_CAP); then
    the planted controls: the gradient with the largest limit, zeroed and
    negated, must each be refused. Returns (worst distance, its limit, the
    largest limit)."""
    k, c = AMP_GRAD_BAND
    bf, fp = dict(zip(names, bf_grads)), dict(zip(names, fp_grads))
    d_ref = {n: _rel_l2(bf[n], fp[n]) for n in names}
    limits = {n: min(k * d_ref[n] + c, AMP_GRAD_CAP) for n in names}
    rows = sorted((_rel_l2(grads[n], bf[n]), n) for n in names)
    print("  farthest gradients (relative L2 from the bf16 oracle, the bf16 "
          "oracle's from the fp32 one): " + "; ".join(
              f"{n} {d:.3e} ({d_ref[n]:.3e})" for d, n in rows[-5:]))
    bad = _amp_grads_beyond(grads, bf, limits)
    if bad:
        d, lim, n = bad[-1]
        raise RuntimeError(f"{len(bad)} gradients beyond their limits, e.g. "
                           f"{n}@GRAD: {d:.3e} from the bf16 oracle in "
                           f"relative L2, limit {lim:.3e} (the bf16 oracle "
                           f"is {d_ref[n]:.3e} from the fp32 one)")
    top = max(limits, key=limits.get)
    for plant, g in (("zeroed", torch.zeros_like(grads[top])),
                     ("negated", -grads[top])):
        if not _amp_grads_beyond({top: g}, bf, {top: limits[top]}):
            raise RuntimeError(f"the gradient gate passed {top}@GRAD {plant}")
    worst, n = rows[-1]
    return worst, limits[n], limits[top]


def _bert_amp_oracle(P, feed, cfg, ln_names, low):
    """The BERT pretrain loss in plain torch under the AMP program's cast
    scheme (low = bfloat16): every product on bf16 views of the fp32
    weights, the bias adds, the residual stream and gelu in bf16, the layer
    norms with fp32 statistics (the first one, on the fp32 embedding sum,
    in fp32), fp32 attention scores and softmax with the unnormalized
    weights rounded to bf16 before they multiply V, the per-token loss from
    an fp32 log-softmax rounded to bf16, weighted in bf16 and averaged in
    fp32; each layer's attention checkpointed. low = float32 is the same
    model in fp32."""
    import torch.nn.functional as F

    H, nh = cfg.hidden_size, cfg.num_heads
    dh = H // nh
    lns = iter(ln_names)
    c = lambda t: t.to(low)  # noqa: E731

    def fc(x, pre):
        return x @ c(P[pre + ".w"]) + c(P[pre + ".b"])

    def ln(x):
        sn, bn = next(lns)
        return F.layer_norm(x.float(), (H,), c(P[sn]).float(),
                            c(P[bn]).float(), 1e-5).to(low)

    def attention(q, k, v):
        s = (q.float() @ k.float().transpose(-1, -2)) * dh ** -0.5
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        return ((c(e).float() @ v.float()) / e.sum(dim=-1, keepdim=True)).to(low)

    ids, pos = feed["src_ids"].long(), feed["pos_ids"].long()
    sn, bn = next(lns)
    x = c(F.layer_norm(P["encoder.word_emb"][ids] + P["encoder.pos_emb"][pos],
                       (H,), P[sn], P[bn], 1e-5))
    B, S = ids.shape
    for i in range(cfg.num_layers):
        pre = f"encoder.layer{i}"
        qkv = fc(x, pre + ".mha.qkv").reshape(B, S, 3, nh, dh)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        a = _checkpointed(attention, q, k, v)
        x = ln(x + fc(a.transpose(1, 2).reshape(B, S, H), pre + ".mha.out"))
        f = fc(F.gelu(fc(x, pre + ".ffn.in")), pre + ".ffn.out")
        x = ln(x + f)
    logp = torch.log_softmax(fc(x, "lm_head").float(), dim=-1)
    tok = c(-logp.gather(-1, feed["lm_label"].long()[..., None])[..., 0])
    w = feed["lm_weight"]
    return (tok * c(w)).float().sum() / (w.sum() + 1e-6)


def train_bert_amp(dev, card, B=AMP_B, S=AMP_S, flash=False):
    """bench.py:75-81's configuration: bert_pretrain(BERT-base, seq 128) +
    decorate(Adam(1e-4)), B=128, one seeded batch, through the port's entry
    points; with B, S and flash = True, tools/_sweep.py's long-context run.
    Step 1 against the bf16 oracle of the same cast scheme (loss, every
    gradient in relative L2, the Adam update), launches by dtype from the
    program's vars, then 5 timed steps whose loss must fall."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck

    what = f"BERT-base AMP B={B} S={S}"
    cfg = _bert_cfg(S, flash)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        avg_loss, _ = transformer.bert_pretrain(cfg, seq_len=S)
        amp.decorate(pt.optimizer.Adam(learning_rate=TRAIN_LR)).minimize(avg_loss)
    startup.random_seed = SEED
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    ops = [op.type for op in main.global_block.ops]
    print(f"AMP trainer: {what} bf16 (decorate(Adam({TRAIN_LR})), "
          f"use_flash_attention={flash}, max_position={cfg.max_position}), "
          f"{len(ops)} ops a step, {ops.count('cast')} casts [{card}]")
    feed = _bert_feed(cfg, B, S)
    p0 = {n: scope.find_var(n).clone() for n in names}

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[avg_loss] + [n + "@GRAD" for n in names])
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = _check_launches(main, what)
    loss1, grads = out[0], dict(zip(names, out[1:]))
    del out

    ln_names = [(op.inputs["Scale"][0].split("@")[0],
                 op.inputs["Bias"][0].split("@")[0])
                for op in main.global_block.ops if op.type == "layer_norm"]
    fd = {k: torch.from_numpy(v).to(dev) for k, v in feed.items()}
    ref = {}
    torch.cuda.reset_peak_memory_stats()
    for low in (torch.bfloat16, torch.float32):
        P = {n: t.clone().requires_grad_() for n, t in p0.items()}
        lv = _bert_amp_oracle(P, fd, cfg, ln_names, low)
        ref[low] = (float(lv.detach()),
                    torch.autograd.grad(lv, [P[n] for n in names]))
        del P, lv
    peak = torch.cuda.max_memory_allocated() / 2**30
    ref_loss, ref_grads = ref[torch.bfloat16]
    loss_lim = _hold_amp_loss(what, float(loss1), ref_loss,
                              ref[torch.float32][0])
    worst, lim, top = _hold_amp_grads(names, grads, ref_grads,
                                      ref[torch.float32][1])
    lr_t = TRAIN_LR * (1 - 0.999) ** 0.5 / (1 - 0.9)

    def adam_step1(g):
        return lr_t * (0.1 * g / (torch.sqrt(0.001 * g * g) + 1e-8))

    # the port's fp32 update against the formula on its own fp32 gradient
    # (every element), and on the oracle's where the oracle's gradient is
    # at least a fifth of its max-abs (its sign is then sure)
    own_err = ref_err = 0.0
    n_sure = 0
    for n, rg in zip(names, ref_grads):
        p1 = scope.find_var(n)
        if p1.dtype != torch.float32 or grads[n].dtype != torch.float32:
            raise RuntimeError(f"{n}: master weight {p1.dtype}, gradient "
                               f"{grads[n].dtype}: both must be fp32")
        own_err = max(own_err, float((p1 - (p0[n] - adam_step1(grads[n])))
                                     .abs().max()))
        sure = rg.abs() > 0.2 * rg.abs().max()
        n_sure += int(sure.sum())
        if bool(sure.any()):
            d = (p1 - (p0[n] - adam_step1(rg)))[sure]
            ref_err = max(ref_err, float(d.abs().max()))
    if not max(own_err, ref_err) <= 1e-2 * TRAIN_LR:
        raise RuntimeError(f"AMP step-1 parameters differ from the Adam step "
                           f"by {own_err:.3e} on the port's gradients and "
                           f"{ref_err:.3e} on the oracle's (limit 1e-2 lr)")
    print(f"{what} step 1 ({first:.3f} s): loss {float(loss1):.6f}, bf16 oracle "
          f"{ref_loss:.6f}, fp32 oracle {ref[torch.float32][0]:.6f} (limit "
          f"{loss_lim:.3e}); worst gradient {worst:.3e} from the "
          f"bf16 oracle in relative L2 (its limit {lim:.3e}; the largest "
          f"limit {top:.3e}, where a planted zeroed and negated gradient "
          f"were refused); fp32 master weights "
          f"within {own_err:.3e} of the Adam step on the port's gradients and "
          f"{ref_err:.3e} on the oracle's ({n_sure} elements of sure sign; "
          f"limit 1e-2 lr); launches by dtype {counts}; peak device memory "
          f"with the oracles {peak:.2f} GiB")
    del ref, ref_grads, grads

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
        raise RuntimeError(f"the AMP loss did not fall: step 1 "
                           f"{float(loss1)}, then {losses}")
    tokens = B * S
    step_flops = _bert_step_flops(cfg, B, S)
    print(f"{what} trained {TRAIN_STEPS} steps in {wall:.3f} s: "
          f"{TRAIN_STEPS / wall:.3f} steps/s, {TRAIN_STEPS * tokens / wall:.1f} "
          f"tokens/s, {TRAIN_STEPS * step_flops / wall / 1e12:.2f} model "
          f"TFLOP/s ({step_flops / 1e12:.3f} TFLOP a step); losses "
          f"{[round(x, 5) for x in losses]} [{card}]")
    step = lambda: exe.run(main, feed=feed, scope=scope,  # noqa: E731
                           fetch_list=[avg_loss], return_numpy=False)
    return step, counts


RN50_FWD_FLOPS_PER_IMG = 2 * 4.089e9     # bench.py:32
# bf16: each layer of the two oracles reads the port's input to that layer
# (`forced`); there the relu inputs of the oracle and the port differ by
# one layer's rounding, the oracle takes the port's decision within
# RELU_NEAR_BF16 of the relu's largest input off zero and its own beyond;
# at most RELU_FAR_SHARE of the relu inputs may fall on different sides of
# zero beyond that band, and no relu's output may differ from the port's
# by more than AMP_FWD_L2 in relative L2 or, anywhere, by more than
# RELU_NEAR_BF16 of its largest output
RELU_NEAR_BF16 = 3e-2
RELU_FAR_SHARE = 1e-5
AMP_FWD_L2 = 1e-2
# each running mean and variance within twice the distance between the
# bf16 and the fp32 oracles' plus 2e-3, of its max-abs, and never beyond
# AMP_STAT_CAP
AMP_STAT_CAP = 2e-2


def train_resnet_amp(dev, card):
    """bench.py:282-306's configuration: resnet50(img, label, s2d_stem=True,
    data_format="NHWC") + decorate(Momentum(0.1, 0.9)), B=128, 224x224, one
    seeded batch. Step 1 against the bf16 oracle, each of whose layers reads
    the port's input to it (each relu's output and decisions, loss,
    gradients in relative L2, momentum, running statistics), launches by
    dtype, then from the initial state at lr RN_FALL_LR 5 timed steps whose
    loss must fall."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import cuda_kernels as ck

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        img = L.data(name="img", shape=[RN_HW, RN_HW, 3], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        loss, acc, _ = resnet.resnet50(img, label, num_classes=RN_CLASSES,
                                       s2d_stem=True, data_format="NHWC")
        amp.decorate(pt.optimizer.Momentum(RN_LR, RN_MU)).minimize(loss)
    startup.random_seed = SEED
    ops = [op.type for op in main.global_block.ops]
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    print(f"AMP trainer: ResNet-50 B={AMP_B} {RN_HW}x{RN_HW} NHWC s2d stem "
          f"bf16 (decorate(Momentum({RN_LR}, {RN_MU}))), {len(ops)} ops a "
          f"step, {ops.count('cast')} casts, {ops.count('conv2d_bn')} "
          f"conv2d_bn [{card}]")
    rng = np.random.default_rng(SEED)
    feed = {"img": torch.from_numpy(rng.standard_normal(
                (AMP_B, RN_HW, RN_HW, 3)).astype(np.float32)).to(dev),
            "label": torch.from_numpy(rng.integers(
                0, RN_CLASSES, (AMP_B, 1)).astype(np.int32)).to(dev)}
    p0 = {n: scope.find_var(n).clone() for n in names}
    bn_names = sorted(n[:-len(".mean")] for n in main.global_block.vars
                      if n.endswith(".bn.mean"))
    relu_vars = {op.inputs["Scale"][0].split("@")[0][:-len(".w_0")]:
                 op.outputs["Y"][0] for op in main.global_block.ops
                 if op.type in ("conv2d_bn", "batch_norm")
                 and op.attr("act", "") == "relu"}

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[loss] + [n + "@GRAD" for n in names]
                  + list(relu_vars.values()))
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = _check_launches(main, "ResNet-50 AMP step")
    if counts != {"bn_apply_act": {"bfloat16": 53},
                  "bn_apply_act_backward": {"bfloat16": 53},
                  "softmax_xent_fwd": {"bfloat16": 1},
                  "softmax_xent_bwd": {"bfloat16": 1}}:
        raise RuntimeError(f"ResNet-50 AMP step launches {counts}")
    loss1, grads = out[0], dict(zip(names, out[1:]))
    port_relu = dict(zip(relu_vars, out[1 + len(names):]))
    del out

    lab = feed["label"].long()[:, 0]
    ref = {}
    for low in (torch.bfloat16, torch.float32):
        stats, tally = {}, _tally(dev)
        P = {n: t.clone().requires_grad_() for n, t in p0.items()}
        lv = _resnet50_oracle(P, feed["img"], lab, stats, port_relu, tally,
                              low, RELU_NEAR_BF16, forced=True)
        ref[low] = (float(lv.detach()),
                    torch.autograd.grad(lv, [P[n] for n in names]), stats,
                    {k: v.item() for k, v in tally.items()})
        del P, lv
    del port_relu
    ref_loss, ref_grads, stats, tally = ref[torch.bfloat16]
    fp_loss, fp_grads, fp_stats, fp_tally = ref.pop(torch.float32)
    del ref
    print(f"  each oracle layer on the port's input: of {tally['elems']} relu "
          f"inputs {tally['near']} within {RELU_NEAR_BF16} of their relu's "
          f"largest off zero, the bf16 oracle's own decision differed from "
          f"the port's at {tally['taken']} of them and at {tally['far']} "
          f"farther off (the fp32 oracle's at {fp_tally['taken']} and "
          f"{fp_tally['far']}); the outputs after a relu within "
          f"{tally['fwd_l2']:.3e} in relative L2, {tally['fwd']:.3e} in "
          f"max-abs and {tally['fwd_max']:.3e} of the relu's largest output "
          f"of the port's (fp32 oracle {fp_tally['fwd_l2']:.3e}, "
          f"{fp_tally['fwd']:.3e}, {fp_tally['fwd_max']:.3e}); loss {float(loss1):.6f}, bf16 oracle "
          f"{ref_loss:.6f}, fp32 oracle {fp_loss:.6f}")
    loss_lim = _hold_amp_loss("ResNet-50 AMP", float(loss1), ref_loss, fp_loss)
    worst, lim, top = _hold_amp_grads(names, grads, ref_grads, fp_grads)
    # the fp32 oracle's outputs are unrounded: only its decisions are held
    for what, t, l2, mx in (("bf16", tally, tally["fwd_l2"], tally["fwd_max"]),
                            ("fp32", fp_tally, 0.0, 0.0)):
        if (t["far"] > RELU_FAR_SHARE * t["elems"] or not l2 <= AMP_FWD_L2
                or not mx <= RELU_NEAR_BF16):
            raise RuntimeError(
                f"the port's relu outputs against the {what} oracle's on the "
                f"same inputs: {t['far']} of {t['elems']} decisions differ "
                f"beyond {RELU_NEAR_BF16} of the relu's largest input (limit "
                f"{RELU_FAR_SHARE} of all), outputs up to {l2:.3e} apart in "
                f"relative L2 (limit {AMP_FWD_L2}) and {mx:.3e} of the "
                f"largest output (limit {RELU_NEAR_BF16})")
    vel_err = own_err = 0.0
    for n in names:
        g, p1 = grads[n], scope.find_var(n)
        if p1.dtype != torch.float32 or g.dtype != torch.float32:
            raise RuntimeError(f"{n}: master weight {p1.dtype}, gradient "
                               f"{g.dtype}: both must be fp32")
        vel_err = max(vel_err, float(
            (scope.find_var(f"{n}_velocity_0") - g).abs().max()))
        spacing = 2.4e-7 * float(p0[n].abs().max())
        own = float((p1 - (p0[n] - RN_LR * g)).abs().max())
        own_err = max(own_err, max(own - spacing, 0.0)
                      / max(RN_LR * float(g.abs().max()), 1e-30))
    if vel_err != 0.0 or not own_err <= 1e-6:
        raise RuntimeError(f"AMP momentum step 1: velocity differs from the "
                           f"gradient by {vel_err:.3e}, the parameters from "
                           f"p0 - lr g by {own_err:.3e} of lr max|g|")
    if sorted(stats) != bn_names or sorted(fp_stats) != bn_names:
        raise RuntimeError("the oracle's batch norms are not the program's")
    # the statistics are forward quantities of one layer each (the oracle
    # reads the port's input to it); a running mean zeroed is refused
    stat_err = stat_top = 0.0
    for n in bn_names:
        for i, (got, run) in enumerate(((scope.find_var(n + ".mean"), 0.0),
                                        (scope.find_var(n + ".var"), 0.9))):
            if got.dtype != torch.float32:
                raise RuntimeError(f"running statistics of {n}: {got.dtype}")
            want = run + (1 - 0.9) * stats[n][i]
            scale = max(float(want.abs().max()), 1e-30)
            ref_err = float((run + (1 - 0.9) * fp_stats[n][i] - want).abs().max())
            stat_lim = min(2 * ref_err / scale + 2e-3, AMP_STAT_CAP)
            err = float((got - want).abs().max()) / scale
            if not err <= stat_lim:
                raise RuntimeError(
                    f"running statistics of {n} differ from the bf16 oracle's "
                    f"by {err:.3e} of their max-abs, limit {stat_lim:.3e} "
                    f"(the fp32 oracle's differ by {ref_err / scale:.3e})")
            if i == 0 and not float(want.abs().max()) / scale > stat_lim:
                raise RuntimeError(f"the statistics gate passed {n}.mean zeroed")
            stat_err, stat_top = max(stat_err, err), max(stat_top, stat_lim)
    peak1 = torch.cuda.max_memory_allocated()
    print(f"AMP step 1 ({first:.3f} s): loss {float(loss1):.6f}, bf16 oracle "
          f"{ref_loss:.6f}, fp32 oracle {fp_loss:.6f} (limit {loss_lim:.3e}); "
          f"worst gradient {worst:.3e} from the bf16 oracle in relative L2 "
          f"(its limit {lim:.3e}; the largest limit {top:.3e}, where a "
          f"planted zeroed and negated gradient were refused); velocity "
          f"equals the gradient, fp32 master weights within {own_err:.3e} of "
          f"lr max|g| of p0 - lr g; {len(stats)} running mean/var pairs "
          f"within {stat_err:.3e} of their max-abs (largest limit "
          f"{stat_top:.3e}); relu decisions beyond the band differ at "
          f"{tally['far']} (limit {RELU_FAR_SHARE} of {tally['elems']}), "
          f"outputs after a relu within {tally['fwd_l2']:.3e} in relative L2 "
          f"(limit {AMP_FWD_L2}) and {tally['fwd_max']:.3e} of the largest "
          f"(limit {RELU_NEAR_BF16}); launches by dtype {counts}")
    del ref_grads, fp_grads, grads, stats, fp_stats

    lr_name = next(op.inputs["LearningRate"][0] for op in main.global_block.ops
                   if op.type == "momentum")
    scope.find_var(lr_name).fill_(RN_FALL_LR)
    for n in names:
        scope.find_var(n).copy_(p0[n])
        scope.find_var(f"{n}_velocity_0").zero_()
    for n in bn_names:
        scope.find_var(n + ".mean").zero_()
        scope.find_var(n + ".var").fill_(1.0)

    def step():
        return exe.run(main, feed=feed, scope=scope, fetch_list=[loss],
                       return_numpy=False)[0]

    first_loss = float(step())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step() for _ in range(RN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [float(lv) for lv in losses]
    if abs(first_loss - float(loss1)) > 1e-2 * float(loss1):
        raise RuntimeError(f"the restored state gives loss {first_loss}, the "
                           f"initial state gave {float(loss1)}")
    if not all(np.isfinite(losses)) or not losses[-1] < first_loss:
        raise RuntimeError(f"the AMP loss did not fall at lr {RN_FALL_LR}: "
                           f"{first_loss}, then {losses}")
    ms = 1e3 * wall / RN_STEPS
    print(f"AMP trained {RN_STEPS} steps (lr {RN_FALL_LR} from the initial "
          f"state, after one untimed step) in {wall:.3f} s: {ms:.2f} ms a step, "
          f"{RN_STEPS * AMP_B / wall:.1f} images/s, "
          f"{3 * RN50_FWD_FLOPS_PER_IMG * AMP_B / (ms / 1e3) / 1e12:.2f} model "
          f"TFLOP/s (3 x bench.py's forward FLOPs an image), peak device "
          f"memory {peak / 2**30:.3f} GiB in a step ({peak1 / 2**30:.3f} GiB "
          f"in step 1 with every gradient and relu output fetched); losses "
          f"{[round(x, 5) for x in losses]} [{card}]")
    return step, counts


LN_FOCUS = ("K3/K5 (layer norm)", ("layer_norm",))


BN_GRADS = "batch_norm grad"


def ranged(fn, name):
    """`fn` called inside a torch.profiler range `name` (name it after a
    word: the profiler demangles a name like "K5 call" as a C++ symbol)."""
    def call(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return call


def kernels_in_ranges(prof, name, own=""):
    """(calls, kernels, device ms of those kernels, kernels whose name
    holds `own`, {name: count} of the others) of the torch.profiler range
    `name` in a finished profile: the device activities (kernels, copies,
    fills) that lie inside the device-timeline span of one of its calls
    (one stream, so those are the ones its calls launched)."""
    from collections import Counter

    from torch.autograd import DeviceType

    spans, acts = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        tr = (e.time_range.start, e.time_range.end, e.name)
        (spans if e.name == name else acts).append(tr)
    spans.sort()
    inside = [(s, t, n) for s, t, n in acts
              if any(a <= s and t <= b for a, b, _ in spans)]
    others = Counter(n.replace("(anonymous namespace)::", "")[:60]
                     for _, _, n in inside if not (own and own in n))
    return (len(spans), len(inside), sum(t - s for s, t, _ in inside) / 1e3,
            len(inside) - sum(others.values()), dict(others))


def _profile(run, card, what, *focus, ranges=()):
    """Trace `run` with torch.profiler: the device's busy share of its wall
    time, and device time by kernel (single stream, so kernel times add up
    without overlap); each `focus` = (label, name patterns): those kernels'
    device time and launches on a line of their own; each of `ranges`, a
    torch.profiler range: its calls and the kernels inside them."""
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
        if e.device_type != DeviceType.CUDA or e.key in ranges:
            continue          # a range's device span is no kernel of its own
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
    groups = {"bn_apply kernels (K8/K9)": ("bn_apply",),
              "flash attention kernels (K10/K11)": ("flash_",),
              "other hand-written kernels": (
                  "layer_norm", "attention", "attn_bwd", "softmax_xent",
                  "paged_decode", "bottleneck"),
              "library convolutions and products": (
                  "conv", "xmma", "cudnn", "cutlass", "gemm", "gemv", "wgrad",
                  "dgrad", "nchwToNhwc", "nhwcToNchw", "sgemm", "nvjet")}
    sums = dict.fromkeys(list(groups) + ["torch elementwise, reductions, copies"], 0.0)
    for us, _, key in rows:
        low = key.lower()
        name = next((g for g, pats in groups.items()
                     if any(p.lower() in low for p in pats)),
                    "torch elementwise, reductions, copies")
        sums[name] += us
    for name, us in sums.items():
        print(f"  by group: {us / 1e3:9.3f} ms {100 * us / busy:5.1f}%  {name}")
    for label, pats in focus:
        hit = [(key.replace("(anonymous namespace)::", "").replace(
                    "void ", "").split("(")[0], n, us)
               for us, n, key in rows if any(p in key for p in pats)]
        total = sum(us for _, _, us in hit)
        print(f"  {label}: {total / 1e3:.3f} ms = {100 * total / busy:.1f}% of "
              f"busy, " + "; ".join(f"{k} x{n} {us / 1e3:.3f} ms"
                                    for k, n, us in hit) + f" [{card}]")
    for name in ranges:
        calls, n, ms, hand, others = kernels_in_ranges(prof, name, "bn_apply")
        print(f"  inside the {calls} {name!r} calls: {n} kernel launches, "
              f"{ms:.3f} ms ({hand} of them K9's, {n - hand} torch's: "
              f"{others}) [{card}]")


def _kernel_name(mangled: str) -> str:
    """`name<template args>` of a kernel's mangled name (nested names; the
    integer, bool, float and bf16 template arguments the port's kernels
    have)."""
    i, name = 3, mangled                         # past "_ZN"
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    if mangled[i:i + 1] != "I":
        return name
    args, j = [], i + 1
    while j < len(mangled) and mangled[j] != "E":
        if mangled.startswith("Li", j):
            k = mangled.index("E", j)
            args.append(mangled[j + 2:k])
            j = k + 1
        elif mangled.startswith("Lb", j):
            args.append("true" if mangled[j + 2] == "1" else "false")
            j += 4
        elif mangled[j] == "f":
            args.append("float")
            j += 1
        elif mangled[j].isdigit():
            k = j
            while mangled[k].isdigit():
                k += 1
            t = mangled[k:k + int(mangled[j:k])]
            args.append("bf16" if t == "__nv_bfloat16" else t)
            j = k + int(mangled[j:k])
        else:
            break
    return name + "<" + ", ".join(args) + ">"


# dynamic shared memory (bytes) of the kernels that size it by their template
# arguments (ptxas reports static shared memory only): the fp32 K2/K4 kernels
# (D, RG), the layouts of csrc/attention_f32.cuh and attention_backward.cu
# (D + 4 floats a tile row, 8 RG rows a block, two stages of 64-row streamed
# tiles, score rows of 80 floats, 144 in the head kernel); the bf16 K10/K11
# wgmma kernels, csrc/flash_attention.cu and flash_attention_backward.cu
# (1024 bytes of alignment slack, resident tiles, ST stages of streamed
# tiles; a stage of the key pass is rounded up to 1024 bytes); K12's wgmma
# kernel, csrc/attn_probe.cu (1024 bytes of slack, 2 Q stages of 64 NWG
# rows, 10 or 5 K/V stages of 128 rows, 64 output rows a warpgroup)
DYN_SMEM = {
    "prefill_attention_f32_kernel":
        lambda D, RG: 4 * ((8 * RG + 256) * (D + 4) + 8 * RG * 80),
    "attn_bwd_head_f32_kernel": lambda: 4 * (4 * 128 * 68 + 128 * 144),
    "attn_bwd_q_f32_kernel":
        lambda D, RG: 4 * ((16 * RG + 256) * (D + 4) + 8 * RG * 80),
    "attn_bwd_kv_f32_kernel":
        lambda D, RG: 4 * ((16 * RG + 256) * (D + 4) + 256 + 8 * RG * 80),
    "flash_fwd_wg_kernel":
        lambda D, KN, ST, NWG: 1024 + 2 * (64 * NWG * D + 2 * ST * KN * D),
    "flash_bwd_dq_wg_kernel":
        lambda D, KN, ST: 1024 + 2 * (2 * 128 * D + 2 * ST * KN * D),
    "flash_bwd_dkv_wg_kernel":
        lambda D, QM, ST: 1024 + 4 * 128 * D
        + ST * -(-(4 * QM * D + 8 * QM) // 1024) * 1024,
    "attn_probe_wg_kernel":
        lambda VAR, NWG: 1024 + 128 * (128 * NWG + (10 if NWG == 2 else 5)
                                       * 128 + 64 * NWG)}


def _resources(build):
    """(source, kernel, registers, spills) of every kernel, from nvcc's
    -Xptxas -v report, with the dynamic shared memory of those in
    DYN_SMEM."""
    out = []
    for src in build.SOURCES:
        log = build.BUILD_DIR / f"{src}.log"
        if not log.exists():
            continue
        kernel, spill = "?", ""
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = _kernel_name(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                spill = f"spills {m.group(1)} / {m.group(2)} bytes"
            m = re.search(r"Used (\d+) registers", line)
            if m:
                base, smem = kernel.split("<")[0], ""
                st = re.search(r"(\d+) bytes smem", line)
                if st:
                    smem = f", {st.group(1)} bytes of static shared memory"
                if base in DYN_SMEM:
                    args = (int(a) for a in kernel[len(base) + 1:-1].split(", ")
                            if a)
                    smem += (f", {DYN_SMEM[base](*args)} bytes of dynamic "
                             f"shared memory")
                out.append((src, kernel, m.group(1), spill + smem))
    return out


def _print_resources(build):
    for src, kernel, regs, rest in _resources(build):
        print(f"  {src}: {kernel}: {regs} registers, {rest}")


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
    _print_resources(_build)

    timer = _Timer(dev)
    entries = [check_paged_decode(dev, timer, card),
               check_prefill(dev, timer, card),
               check_layer_norm(dev, timer, card),
               check_attention_backward(dev, timer, card),
               check_layer_norm_backward(dev, timer, card),
               *check_softmax_xent(dev, timer, card),
               *check_bn_apply(dev, timer, card)]
    for e in entries:
        e["dtype"] = "float32"
    bf16_entries = check_bf16_kernels(dev, timer, card)
    check_layer_norm_edges(dev, card)
    check_xent_edges(dev, card)
    tool_entry = check_bottleneck(dev, timer, card)
    flash32, flash16 = check_flash(dev, timer, card)
    entries += flash32
    bf16_entries += flash16
    probe_entries = [check_attn_probe(dev, timer, card),
                     check_dma_probe(dev, timer, card)]
    del timer
    torch.cuda.empty_cache()
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
                 card, "BERT-base training step",
                 ("fp32 K2/K4", ("prefill_attention", "attn_bwd")), LN_FOCUS)
    del exe, main_p, scope, feed
    torch.cuda.empty_cache()
    rn_step, rn_counts = train_resnet(dev, card)
    if args.profile:
        _profile(rn_step, card, "ResNet-50 training step")
    del rn_step
    torch.cuda.empty_cache()
    bert_amp_step, bert_amp_counts = train_bert_amp(dev, card)
    if args.profile:
        _profile(bert_amp_step, card, "BERT-base AMP training step (B=128)",
                 LN_FOCUS)
    del bert_amp_step
    torch.cuda.empty_cache()
    rn_amp_step, rn_amp_counts = train_resnet_amp(dev, card)
    if args.profile:
        from paddle_tpu_torch.ops import nn_ops
        bn_backward = nn_ops._bn_backward
        nn_ops._bn_backward = ranged(bn_backward, BN_GRADS)
        _profile(rn_amp_step, card, "ResNet-50 AMP training step (B=128)",
                 ranges=(BN_GRADS,))
        nn_ops._bn_backward = bn_backward
    del rn_amp_step
    torch.cuda.empty_cache()
    long_step, long_counts = train_bert_amp(dev, card, LONG_B, LONG_S,
                                            flash=True)
    if args.profile:
        _profile(long_step, card, f"long-context BERT-base AMP training step "
                 f"(B={LONG_B}, S={LONG_S})", LN_FOCUS)
    del long_step
    torch.cuda.empty_cache()
    exe, main_p, scope, feed, avg_loss, long32_counts = train(
        dev, card, LONG_FP32_B, LONG_FP32_S, flash=True)
    if args.profile:
        _profile(lambda: exe.run(main_p, feed=feed, scope=scope,
                                 fetch_list=[avg_loss], return_numpy=False),
                 card, f"long-context BERT-base fp32 training step "
                 f"(B={LONG_FP32_B}, S={LONG_FP32_S})")
    del exe, main_p, scope, feed
    # launches on the main paths, each counted from 0 just before its run:
    # serving (K1-K3) and the fp32 BERT (K2-K7) and ResNet-50 (K6-K9) steps,
    # all fp32; the AMP BERT (K2-K7: bf16, and K3/K5 fp32 for the embedding
    # layer norm) and ResNet-50 (K6-K9 bf16) steps; the long-context AMP
    # step (K10/K11 bf16, K3/K5-K7 as at S=128) and fp32 step (K3, K5-K7,
    # K10/K11 fp32); #15's, K12's and K13's own paths (their launches set by
    # their checks)
    runs = [{n: {"float32": c} for n, c in counts.items() if c}
            for counts in (serve_counts, train_counts, rn_counts,
                           long32_counts)]
    runs += [bert_amp_counts, rn_amp_counts, long_counts]
    for e in entries + bf16_entries:
        e["launches"] = sum(r.get(e["name"], {}).get(e["dtype"], 0)
                            for r in runs)
        if not e["launches"]:
            raise RuntimeError(f"{e['name']} ({e['dtype']}) was launched on no "
                               f"main path")
    keys = ("name", "dtype", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in
                                  entries + bf16_entries + [tool_entry]
                                  + probe_entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
