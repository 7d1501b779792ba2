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
              K1-K3 at the serving shapes (K1 also at one long row, and
              in bf16 also at 8 rows of 4000, within one bf16 unit of an
              fp32 evaluation of the same inputs),
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
              random weights from seed 0, the engine's default: prefix cache
              on) serves 6 requests with prompts of 5..400 tokens, twice
              (the second pass hits the prefix cache); every request must
              finish with zero leaked pages, the serving kernels' launch
              counts must have moved, and the greedy tokens must equal the
              port's own dense full-forward oracle on the same scope
              (teacher-forced: each token the oracle's argmax over the
              engine's own prefix) and the two passes each other;
              speculative decoding (draft_k 4) on the same weights and
              requests, with the engine's n-gram drafts and with the known
              greedy continuation as the draft (every draft accepted), the
              tokens bit for bit the plain engine's; the prefix cache: 8
              requests sharing a 256-token system prompt, then the prompt
              alone twice (full hits, copy-on-write), against the dense
              oracle and a prefix_cache=False engine bit for bit, prefill
              tokens computed = prompt tokens - prefix hits, no leaked page
              before or after the cache's flush; bf16 serving
              (DecoderConfig(dtype="bfloat16")) of the same requests with
              the prefix cache on, plain decode (K1 bf16) and draft_k 4,
              each generated token's dense bf16 oracle logit within
              BF16_DELTA_ULPS bf16 units of the oracle's max, K1-K3
              launched in bf16; that gate at BERT-base width must refuse
              two planted faults, K1 reading the page table one page on
              and a copy-on-write that leaves the new page zero, at the
              random weights or, for a fault that passes there, with the
              attention peaked (q/k/v x4, out x2), where the unfaulted
              engine must pass;
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
              then a chain of 10) with launches counted (all on its wgmma
              kernel), against its plain version at the tool's inputs and
              at a unit-variance set where the convolutions, not the
              residual, set the output (there also against the library
              chain), two calls bit for bit, and the tool's A/B against
              the library chain;
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
              then 5 timed steps whose loss must fall; the BERT AMP step
              again under decorate(Lamb(linear_lr_warmup(polynomial_decay(
              ...)))), BERT's LAMB recipe: 5 runs across warmup into decay,
              the learning rate fetched each run against its closed form,
              step 1's fp32 master weights against the LAMB formula in
              float64 (1e-2 of each parameter's own step lr x trust), the
              beta powers beta^6 in fp32, the loss finite, launches by
              dtype; the twelve optimizers and three wrappers (apply and
              restore) on a tiny program, 3 steps each under one of three
              schedules, and nine schedules alone, on the card against
              the CPU (1e-7 + 1e-5 relative), every update and schedule op
              dispatched under the sync debug mode "error"; dgc on
              BERT-base's word embedding gradient (23.4 M elements)
              against a float64 sort-based quantile;
              transformer_wmt at bench.py:355 bench_wmt's widths
              (Transformer-base, dropout 0, src = tgt = 128, label
              smoothing 0.1) + decorate(Adam(1e-4)) at B=128, held as the
              BERT AMP step (K2/K4 bf16 three times a layer pair: the
              encoder's and the decoder's self-attention and the
              cross-attention; K3/K5 bf16 five times; the soft-label cross
              entropy on no kernel), 5 timed steps (steps/s, src + tgt
              tokens/s, bench.py:411's model TFLOP/s); then wmt_base() as
              published (dropout 0.1, attention unfused) at B=32: every
              dropout mask of step 1 fetched, its keep rate within 5
              binomial sigmas of 0.9, its values 0 and 1 / 0.9, its op's
              Out = X * Mask bit for bit, the oracles applying those
              masks, the masks repeated bit for bit by the same run
              counter and changed by a new one;
     book models — models/seq2seq.py's attention seq2seq at its own widths
              (word_dim 128, hidden_dim 256) over the WMT'14 dictionary of
              the book's machine-translation chapter (30000 words), B=64
              pairs padded to 50 (lengths 5-50), Adam(1e-3), fp32: step 1's
              loss, every gradient and the Adam update against a plain-torch
              oracle (the GRU and the attention step written out as loops),
              K6/K7 once each a step (and against their plain versions at
              its N=3200, V=30000), the loss falling over 5 timed steps;
              then infer_model's beam search (16 sources, beam 4, 50 While
              iterations): every step's beams the oracle's best, recomputed
              from the port's own previous beams, the sentences a numpy
              backtrack of the port's buffers, the loop's host syncs one an
              iteration (and one to leave) and its body free of any other
              (sync debug mode "error"), beam_search with finished rows
              against the frozen-beam rule; MNIST (BASELINE.json's first
              configuration): mnist_mlp and mnist_conv + Adam(1e-3) at
              B=128, step 1 against plain-torch oracles, K6/K7 once each;
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
              checkpointed, peak memory printed); the same step from the
              same start under RecomputeOptimizer (tools/_sweep.py's
              SWEEP_RECOMPUTE arm: checkpoints transformer
              .last_layer_outputs): its loss bit for bit the plain step's,
              every gradient within 2e-2 relative L2 of the plain step's,
              K10 twice a layer (the forward and the replay), K11 once,
              K3/K5 bf16 inside the replays, its peak memory above its
              start below the plain step's; then an fp32 step at B=4,
              S=1024 (K10/K11 in fp32) held as phase 4;
  9. io, inference, recompute and the rest of the book — ResNet-50
              (bench.py:278's configuration) trained 3 fp32 steps at B=128,
              its running statistics set from one training-mode pass, its
              clone(for_test=True) saved by io.save_inference_model and
              served by create_paddle_predictor: the fp32 logits bit for
              bit a direct run of the clone and within 1e-4 relative L2 of
              a plain-torch oracle on the saved files, 53 K8 launches in
              inference mode and no K9, K6 or K7; the bf16 predictor
              (AnalysisConfig(enable_bf16=True), 53 bf16 K8 launches)
              within twice the bf16 oracle's distance from the fp32 oracle
              plus INFER_BF16_FLOOR, a gate that must refuse K8 reading
              the variance one channel on; BERT-base (S=128, B=128) as
              feature extraction the same way (12 K2 and 25 K3 launches in
              each dtype; the bf16 gate must refuse K2 reading the keys one
              position on); images/s and tokens/s, peak memory and device
              busy of each predictor; the ResNet-50 AMP step under
              RecomputeOptimizer (checkpoints at the 16 bottleneck outputs
              and the loss) against the plain AMP step from the same
              start: the loss and the running statistics bit for bit,
              every gradient within 2e-2 relative L2, K8 twice and K9 once
              a batch norm, K6 twice and K7 once (the replays through
              `_BatchNormFn` and `_XentFn`), peak memory and ms a step of
              both; word2vec (the book's defaults, B=100) and dense DeepFM
              (bench.py:436's widths, B=2048) under SGD(1e-3): step 1
              against plain-torch oracles, the loss falling over 5 timed
              steps (examples/s);
 10. the data pipeline, sparse gradients and the sequence/RNN tail —
              DeepFM (bench.py:423 bench_deepfm's TPU arm: 26 fields, 13
              dense, vocab 100000, embed 16, hidden 400x3, is_sparse=True,
              SGD(1e-3)) trained from 8 MultiSlot files of 16384 lines
              (written from seed 0 in bench.py's format) through
              Executor.train_from_dataset and a QueueDataset at batch 2048:
              the native parser equal bit for bit to the plain parser on
              every file, a malformed line raising in both; one sparse step
              against the dense program's and a plain-torch oracle (the
              loss bit for bit, fm_w1 and fm_emb within SPARSE_L2, their
              untouched rows bit for bit, sgd under the sync debug mode
              "error"); one Adam step's lazy update against a plain-torch
              lazy Adam (untouched rows of the parameter and both moments
              bit for bit, touched rows within LAZY_ADAM_L2); a one-thread
              pass against a plain Executor.run loop over the same batches
              (TRAINER_L2); 64 batches a 4-thread pass (stage counters);
              DeviceLoader feeds bit for bit the host arrays, copied on a
              side stream; examples/s end to end (5 passes after a warm
              one) and on one resident batch, their ratio, the device's
              busy share and the host split; word2vec with is_sparse=True
              at B=100 held as DeepFM's step, its shared table's grad four
              concatenated SelectedRows; the 12 new sequence and RNN ops at
              the sizes users run (cudnn_lstm 2 layers bidirectional H=512,
              lstmp 4x512 / 256, DeepSpeech2's row_conv, sequence_conv 128
              filters, the rest at B=64, T=100, D=128), forward and every
              grad on the card against the same program on the CPU within
              SEQ_L2, ms a run each; tiered giant embeddings (ctr_giant):
              bench.py:557's parity (a 512 x 8 table behind a 256-slot
              cache, 12 SGD steps, within EMB_PARITY_ATOL of the dense
              program, every eviction written back), then bench.py:639
              bench_deepfm_giant's TPU arm (DeepFM at vocab 10,000,000:
              fm_emb, 640 MB, tiered at FLAGS_emb_hbm_budget_mb=64 into
              1,048,576 slots, fm_w1 dense) from 4 zipf-1.5 MultiSlot
              files through train_from_dataset on 4 threads (examples/s of
              5 passes after a warm one beside the same program with no
              budget, the hit rate against EMB_HIT_RATE_FLOOR, device busy,
              the stage counters), an evicting arm at 8,192 slots (a
              one-thread pass against the no-budget program within
              EMB_PARITY_ATOL, write-backs = evictions, 2 steps with every
              op's compute under the sync debug mode "error"), the host
              tier's delta checkpoints through CheckpointManager (restored
              bit for bit, the cache cold) and two stall drills
              (emb_host_stall, pipeline_stall) raising StallError;
 11. output — the `kernels` JSON line (fp32 and bf16 entries, #15, K12
              and K13, each with its dtype), the card line (nvidia-smi name
              and power limit), and last the `ok` JSON line.
Needs one CUDA device; exits non-zero without one.

    python3 chip_smoke.py --profile

also traces one more serving pass of each serving phase (the default
engine, speculative decoding, the prefix cache, bf16) and one more
training step of each configuration (the long-context fp32 one included)
with torch.profiler (in the BERT AMP steps under Adam and LAMB, the update
ops' kernels in a profiler range)
and prints where the device time went (per kernel, and the device's busy
share of the wall time; in the fp32 BERT step, K2's and K4's time and
launches; in the BERT and WMT steps, K3's and K5's; in the ResNet-50 AMP
step, the kernels launched inside the batch-norm grad ops, K9's and
torch's; in the WMT step, K2's and K4's and the kernels of its soft-label
chain: one_hot, label_smooth, the label's cast and the cross entropy, and
the cross entropy's grad; one seq2seq training step and one decode; the
long-context step under RecomputeOptimizer beside the plain one; the
ResNet-50 AMP step under RecomputeOptimizer). The predictors of phase 9
are traced in every run, for their device busy share.
"""
from __future__ import annotations

import argparse
import contextlib
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


def _paged_inputs(K, dev, g, lens, P, pages, dtype):
    B, nh, dh, ps = len(lens), 12, 64, 16
    perm = torch.randperm(pages, generator=g)
    table = torch.zeros((B, P), dtype=torch.int32)
    used = 0
    for b in range(B):
        n = -(-int(lens[b]) // ps)
        table[b, :n] = perm[used:used + n]
        used += n
    q = torch.randn((B, nh, dh), generator=g).to(dev, dtype)
    kp = torch.randn((pages, ps, nh, dh), generator=g).to(dev, dtype)
    vp = torch.randn((pages, ps, nh, dh), generator=g).to(dev, dtype)
    return (q, kp, vp, table.to(dev),
            torch.tensor(lens, dtype=torch.int32).to(dev))


def _ulp16(x):
    """One unit in the last place of bf16 at |x| (fp32 in, fp32 out): 2^-7
    of the power of two at or below |x|, and of 2^-126 below that."""
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def _paged_case(K, dev, timer, card, g, lens, P, pages=512,
                dtype=torch.float32):
    """K1 at B = len(lens) rows of nh=12, dh=64, ps=16 (the serving
    model's widths) over a table P pages wide, against its plain version;
    returns (max_abs_err, ms, plain_ms, bound_ms). bf16: under `_agree16`
    against the plain version (which rounds the probabilities to bf16), and
    within one bf16 unit of the output's last place (plus 2^-20 of the
    row's max-abs for fp32 sums taken in another order) of the plain
    version run in fp32 on the same bf16 inputs."""
    args = _paged_inputs(K, dev, g, lens, P, pages, dtype)
    q, table, lens_d = args[0], args[3], args[4]
    B, nh, dh = q.shape
    ps = args[1].shape[1]
    scale = dh ** -0.5
    out = K.paged_decode_attention(*args, scale)
    ref = K.paged_decode_attention_plain(*args, scale)
    live = lens_d > 0
    name = "paged_decode_attention" + (" bf16" if dtype != torch.float32
                                       else "")
    if dtype == torch.float32:
        err = _agree(name, out[live], ref[live])
    else:
        err = _agree16(name, out[live], ref[live])
        r32 = K.paged_decode_attention_plain(
            *(t.float() for t in args[:3]), table, lens_d, scale)[live]
        o = out[live].float()
        tol = _ulp16(r32) + 2.0 ** -20 * r32.abs().amax(dim=-1, keepdim=True)
        if not bool(((o - r32).abs() <= tol).all()):
            raise RuntimeError(
                f"{name}: more than one bf16 unit from the fp32 plain "
                f"version on the same inputs (max abs err "
                f"{(o - r32).abs().max().item():.3e})")
    if not bool((out[~live] == 0).all()):
        raise RuntimeError(f"{name}: kv_len 0 row not zero")
    _repeats(name, [out], [K.paged_decode_attention(*args, scale)])
    ms = timer(lambda: K.paged_decode_attention(*args, scale))
    plain_ms = timer(lambda: K.paged_decode_attention_plain(*args, scale))
    # the live slots' K and V (what this data needs), q, out, table, lens
    esize = q.element_size()
    nbytes = (2 * int(lens_d.sum()) * nh * dh * esize + 2 * q.numel() * esize
              + table.numel() * 4 + B * 4)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    sfx = "f32" if dtype == torch.float32 else "bf16"
    chunk, span, grid, smem, hg, occ = K._plan(B, nh, dh, ps, P, sfx)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if grid > occ * sms:
        raise RuntimeError(f"{name}: cooperative grid {grid} exceeds the "
                           f"resident blocks {occ} x {sms} SMs")
    _row(f"K1 {name}", f"B={B} nh={nh} dh={dh} ps={ps} P={P} "
         f"lens={list(lens)} (spans of {span} slots, chunks of {chunk}, {grid} blocks, "
         f"{smem} B of shared memory, {occ} blocks an SM)", ms,
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


def check_paged_decode16(dev, timer, card):
    """K1's bf16 entry at the fp32 rows' shapes: the serving batch, one row
    of 500 slots and 8 rows of 4000 (tables 256 pages wide, the engine's
    power-of-two width, as flash_ab.py times fp32 K1 there; a pool of 2048
    pages). No single torch call pages, so no library yardstick."""
    from paddle_tpu_torch.ops.cuda_kernels import paged_attention as K

    g = torch.Generator(device="cpu").manual_seed(SEED + 20)
    bf = torch.bfloat16
    err, ms, plain_ms, bound = _paged_case(
        K, dev, timer, card, g, [1, 16, 17, 500, 0, 33, 257, 64], 32,
        dtype=bf)
    _paged_case(K, dev, timer, card, g, [500], 32, dtype=bf)
    _paged_case(K, dev, timer, card, g, [4000] * 8, 256, pages=2048, dtype=bf)
    return _bf16_entry("paged_decode_attention", "paged_attention.cu",
                       "paddle_tpu/ops/pallas_kernels/paged_attention.py:164",
                       err, ms, plain_ms, bound, "bytes", None)


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


def check_softmax_xent(dev, timer, card, N=4096, V=30522):
    """K6 and K7 at the BERT-base lm head (B=32, S=128), or at [N, V]."""
    from paddle_tpu_torch.ops.cuda_kernels import xent_bwd as KB
    from paddle_tpu_torch.ops.cuda_kernels import xent_fwd as KF
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(SEED + 5)
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


# the serving phases: DecoderConfig() as published (BERT-base width, 12
# layers, vocab 30522, max_position 512), page size 16 (the flag's default)
SERVE_CFG: dict = {}
SERVE_LENS, SERVE_NEW = (5, 17, 64, 130, 257, 400), 16
# the prefix-cache phase: a 256-token system prompt (16 pages) shared by 8
# requests with distinct suffixes, then resubmitted alone twice (full hits)
PREFIX_SYS, PREFIX_SUFFIX = 256, (5, 13, 21, 29, 37, 45, 53, 64)
SPEC_K = 4
# the bf16 serving gate: at each generated position the dense bf16
# oracle's logit for the engine's token must be within this many bf16
# units of the last place (at the oracle's max |logit| of that position)
# of the oracle's max; argmax near-ties make bit equality between two bf16
# paths meaningless
BF16_DELTA_ULPS = 16


def _serve_cfg(dtype="float32"):
    from paddle_tpu_torch.serving import DecoderConfig

    return DecoderConfig(**dict(SERVE_CFG, dtype=dtype))


def _serve_prompts(cfg, seed, lens, prefix=()):
    rng = np.random.default_rng(seed)
    return [list(prefix) + [int(t) for t in rng.integers(1, cfg.vocab_size, n)]
            for n in lens]


def _copy_weights(src, dst):
    with torch.no_grad():
        for n in src.parameter_names():
            dst._scope.find_var(n).copy_(src._scope.find_var(n))


def _dense_rows(eng, prompt, out):
    """The dense full-forward oracle on the engine's scope, teacher-forced
    over prompt + out: one causal pass gives, for each generated token, the
    logits [len(out), V] of the position that predicts it."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.framework import Program, program_guard
    from paddle_tpu_torch.serving import build_full_forward_program
    from paddle_tpu_torch.serving import model as sv_model

    if getattr(eng, "_oracle", None) is None:
        full = Program()
        with program_guard(full, Program()), unique_name.guard():
            eng._oracle = (full, build_full_forward_program(eng.cfg))
    full, io = eng._oracle
    seq = list(prompt) + list(out)[:-1]
    (lg,) = eng._exe.run(
        full, scope=eng._scope, fetch_list=[io["logits"]], return_numpy=False,
        feed={sv_model.TOK_FEED: np.asarray(seq, np.int32)[None, :],
              sv_model.POS_FEED: np.arange(len(seq), dtype=np.int32)[None, :]})
    if tuple(lg.shape) != (1, len(seq), eng.cfg.vocab_size) \
            or not bool(torch.isfinite(lg.float()).all()):
        raise RuntimeError("dense oracle logits malformed")
    return lg[0, len(prompt) - 1:].float()


def _hold_exact(what, eng, prompts, outs):
    """fp32: every generated token is the dense oracle's argmax over the
    engine's own prefix, which makes the sequence the oracle's greedy
    replay."""
    for i, (p, out) in enumerate(zip(prompts, outs)):
        want = _dense_rows(eng, p, out).argmax(dim=-1).tolist()
        if want != list(out):
            raise RuntimeError(f"{what}: request {i} (prompt {len(p)}) "
                               f"diverged from the dense oracle: {list(out)} "
                               f"vs {want}")


def _hold_delta(what, eng, prompts, outs):
    """bf16: at every generated position the oracle's logit for the
    engine's token is within BF16_DELTA_ULPS bf16 units (at the oracle's
    max |logit| there) of the oracle's max. Returns (positions, positions
    off the oracle's argmax, the largest gap in units)."""
    n = differ = 0
    worst = 0.0
    for i, (p, out) in enumerate(zip(prompts, outs)):
        rows = _dense_rows(eng, p, out)
        mx = rows.max(dim=-1).values
        got = rows.gather(1, torch.tensor(list(out), device=rows.device)
                          [:, None])[:, 0]
        units = (mx - got) / _ulp16(rows.abs().max(dim=-1).values)
        worst = max(worst, float(units.max()))
        if bool((units > BF16_DELTA_ULPS).any()):
            j = int((units > BF16_DELTA_ULPS).nonzero()[0])
            raise RuntimeError(
                f"{what}: request {i} (prompt {len(p)}) token {j} "
                f"({out[j]}) is {float(units[j]):.1f} bf16 units below the "
                f"dense oracle's max ({float(mx[j]):.4f}), past "
                f"{BF16_DELTA_ULPS}")
        n += len(out)
        differ += int((rows.argmax(dim=-1).cpu()
                       != torch.tensor(list(out))).sum())
    return n, differ, worst


def _launched(counts):
    """The wrappers of a launch_counts{,_by_dtype}() that launched."""
    return {k: v for k, v in counts.items() if v}


def _check_serving_launches(what, counts, want):
    """`want`: {wrapper: dtype}; each must have launched in `counts`
    (launch_counts_by_dtype of the run)."""
    missing = [f"{k} ({d})" for k, d in want.items()
               if not counts.get(k, {}).get(d)]
    if missing:
        raise RuntimeError(f"{what}: never launched {missing}: {counts}")


def _drive(eng, prompts, new=None):
    """Submit `prompts` together and drain; returns (rids, wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=new or SERVE_NEW) for p in prompts]
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for rid in rids:
        if eng.requests[rid].state != "finished":
            raise RuntimeError(f"request {rid} ended {eng.requests[rid].state}")
    return rids, wall


def _report(what, eng, rids, wall, card):
    ttft = [eng.requests[r].t_first_token - eng.requests[r].arrival_t
            for r in rids]
    n_tok = sum(len(eng.result(r)) for r in rids)
    lens = [eng.requests[r].prompt_len for r in rids]
    print(f"{what}: {len(rids)} requests (prompts {lens}, "
          f"{len(eng.result(rids[0]))} new tokens each) in {wall:.3f} s: "
          f"{n_tok / wall:.1f} tokens/s, p50 TTFT "
          f"{statistics.median(ttft) * 1e3:.1f} ms [{card}]")


def _no_leaks(what, eng, flush=True):
    if eng.leaked_pages():
        raise RuntimeError(f"{what}: {eng.leaked_pages()} leaked pages")
    if flush:
        eng.flush_prefix_cache()
        if eng.leaked_pages() or eng.pool.free_count != eng.pool.num_pages:
            raise RuntimeError(
                f"{what}: after the prefix-cache flush {eng.leaked_pages()} "
                f"leaked, {eng.pool.num_pages - eng.pool.free_count} pages "
                f"still in use")


def serve(dev, card):
    """The engine's default (prefix cache on, no speculation) at BERT-base
    width: 6 requests of 5..400 prompt tokens, the greedy tokens held
    against the dense oracle, zero leaked pages, K1-K3 launched."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import ServingEngine

    cfg = _serve_cfg()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    names = eng.parameter_names()
    n_elems = sum(eng._scope.find_var(n).numel() for n in names)
    print(f"engine built in {time.perf_counter() - t0:.2f} s ({len(names)} "
          f"parameters, {n_elems} elements; ops a run: prefill "
          f"{len(eng._prefill_prog.global_block.ops)}, decode "
          f"{len(eng._decode_prog.global_block.ops)}, window "
          f"{len(eng._window_prog.global_block.ops)}; pool "
          f"{eng.pool_pages}x{eng.page_size}; prefix cache "
          f"{'on' if eng.prefix_cache else 'off'}, draft_k {eng.draft_k}) "
          f"[{card}]")
    # one short request first: CUDA context, cuBLAS handles, allocator
    eng.submit([1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=2)
    eng.run_until_drained()

    prompts = _serve_prompts(cfg, SEED, SERVE_LENS)
    steps0 = eng.stats["decode_steps"]
    ck.reset_launch_counts()
    rids, wall = _drive(eng, prompts)
    counts = ck.launch_counts()
    _check_serving_launches("serving", ck.launch_counts_by_dtype(),
                            {k: "float32" for k in SERVE_KERNELS})
    _no_leaks("serving", eng, flush=False)
    _report("served (first pass, every bucket's GEMM shapes new)", eng, rids,
            wall, card)
    print(f"  {eng.stats['decode_steps'] - steps0} decode steps, prefill buckets "
          f"{sorted(eng.stats['prefill_signatures'], key=str)}, launches "
          f"{_launched(counts)}")
    again, wall = _drive(eng, prompts)
    _report("served (second pass, same requests: prefix-cache hits)", eng,
            again, wall, card)
    outs = [eng.result(r) for r in rids]
    if [eng.result(r) for r in again] != outs:
        raise RuntimeError("the second pass (prefix-cache hits) gave other "
                           "tokens than the first")
    _hold_exact("serving", eng, prompts, outs)
    print("greedy tokens equal the dense full-forward oracle for every request")
    _no_leaks("serving", eng)
    return eng, prompts, outs, counts


def serve_prefix(dev, card, profile=False):
    """The prefix cache in fp32: 8 requests sharing a PREFIX_SYS-token
    system prompt (the cold pass: the first prefills it, the others map its
    pages and prefill their suffixes through the window program), then the
    system prompt alone twice (the warm pass: full hits, whose first decode
    step copies the last shared page). Held against the dense oracle, a
    prefix_cache=False engine on the same weights (tokens bit for bit) and
    the engine's own accounting."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import ServingEngine

    cfg = _serve_cfg()
    eng = ServingEngine(cfg, device=dev, seed=SEED, prefix_cache=True)
    sysp = _serve_prompts(cfg, SEED + 1, (PREFIX_SYS,))[0]
    prompts = _serve_prompts(cfg, SEED + 2, PREFIX_SUFFIX, prefix=sysp)
    ck.reset_launch_counts()
    cold, cold_wall = _drive(eng, prompts)
    warm, warm_wall = _drive(eng, [sysp, sysp])
    counts = ck.launch_counts_by_dtype()
    _check_serving_launches("prefix cache", counts,
                            {k: "float32" for k in SERVE_KERNELS})
    _report(f"prefix cache, cold pass (one system prompt prefilled, "
            f"{len(cold) - 1} suffixes through the window program)", eng,
            cold, cold_wall, card)
    _report("prefix cache, warm pass (the system prompt alone twice: full "
            "hits)", eng, warm, warm_wall, card)
    st = eng.stats
    all_prompts = prompts + [sysp, sysp]
    outs = [eng.result(r) for r in cold + warm]
    total = sum(len(p) for p in all_prompts)
    print(f"  prefix_hit_tokens {st['prefix_hit_tokens']} of {total} prompt "
          f"tokens, prefill_tokens_computed {st['prefill_tokens_computed']}, "
          f"lookups {st['prefix_lookups']}, full hits "
          f"{st['prefix_full_hits']}, cow_copies {st['cow_copies']}, "
          f"preemptions {st['preemptions']}, launches {_launched(counts)}")
    if not (st["prefix_hit_tokens"] > 0 and st["prefix_full_hits"] >= 1
            and st["cow_copies"] >= 1):
        raise RuntimeError(f"prefix cache: no hit, full hit or copy-on-write "
                           f"({st})")
    if st["preemptions"] or st["prefill_tokens_computed"] != \
            total - st["prefix_hit_tokens"]:
        raise RuntimeError(
            f"prefix cache: {st['prefill_tokens_computed']} prefill tokens "
            f"computed, not the {total} prompt tokens less the "
            f"{st['prefix_hit_tokens']} hit ({st['preemptions']} "
            f"preemptions)")
    _no_leaks("prefix cache", eng, flush=False)
    _hold_exact("prefix cache", eng, all_prompts, outs)
    if profile:
        _profile(lambda: _drive(eng, all_prompts), card,
                 f"prefix-cache serving pass (the {len(all_prompts)} "
                 f"requests again: every prompt a hit)",
                 ("K1", ("paged_decode",)))
    plain = ServingEngine(cfg, device=dev, seed=SEED, prefix_cache=False)
    _copy_weights(eng, plain)
    got, _ = _drive(plain, prompts)
    got2, _ = _drive(plain, [sysp, sysp])
    if [plain.result(r) for r in got + got2] != outs:
        raise RuntimeError("prefix cache: tokens differ from the "
                           "prefix_cache=False engine's")
    _no_leaks("prefix cache", eng)
    print("prefix cache: greedy tokens equal the dense oracle and the "
          "prefix_cache=False engine's for every request; no page leaked "
          "before or after the flush")
    return counts


def serve_spec(dev, card, base, prompts, want, profile=False):
    """Speculative decoding in fp32 (draft_k = SPEC_K) on `base`'s weights,
    the 6 serving requests twice: (a) with the engine's own `ngram_draft`,
    (b) with the known greedy continuation as the draft (every draft must be
    accepted: the multi-token acceptance path). Tokens bit for bit `base`'s
    (draft_k = 0)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving import engine as sv_engine

    eng = ServingEngine(base.cfg, device=dev, seed=SEED, draft_k=SPEC_K)
    _copy_weights(base, eng)
    ck.reset_launch_counts()
    rids, wall = _drive(eng, prompts)
    counts = ck.launch_counts_by_dtype()
    _check_serving_launches("speculative decoding", counts,
                            {"causal_prefill_attention": "float32",
                             "layer_norm_act": "float32"})
    st = dict(eng.stats)
    _report(f"speculative decoding (draft_k {SPEC_K}, ngram_draft)", eng,
            rids, wall, card)
    if [eng.result(r) for r in rids] != want:
        raise RuntimeError("speculative decoding: tokens differ from the "
                           "draft_k=0 engine's")
    if not st["spec_steps"]:
        raise RuntimeError("speculative decoding: no speculative step")
    print(f"  {st['spec_steps']} speculative steps, acceptance "
          f"{st['spec_accepted']}/{st['spec_proposed']} = "
          f"{st['spec_accepted'] / max(1, st['spec_proposed']):.4f} "
          f"(reported, not gated), launches {_launched(counts)}")

    known = [list(p) + list(w) for p, w in zip(prompts, want)]

    def oracle_draft(tokens, k, window=128):
        tokens = [int(t) for t in tokens]
        for seq in known:
            if seq[:len(tokens)] == tokens:
                cont = seq[len(tokens):len(tokens) + k]
                return cont + [tokens[-1]] * (k - len(cont))
        raise RuntimeError("oracle draft: an unknown sequence")

    own = sv_engine.ngram_draft
    sv_engine.ngram_draft = oracle_draft
    try:
        rids, wall = _drive(eng, prompts)
    finally:
        sv_engine.ngram_draft = own
    prop = eng.stats["spec_proposed"] - st["spec_proposed"]
    acc = eng.stats["spec_accepted"] - st["spec_accepted"]
    steps = eng.stats["spec_steps"] - st["spec_steps"]
    _report(f"speculative decoding (draft_k {SPEC_K}, the known greedy "
            f"continuation as the draft)", eng, rids, wall, card)
    if [eng.result(r) for r in rids] != want:
        raise RuntimeError("speculative decoding with oracle drafts: tokens "
                           "differ from the draft_k=0 engine's")
    if not prop or acc != prop:
        raise RuntimeError(f"speculative decoding with oracle drafts: "
                           f"{acc} of {prop} drafts accepted")
    print(f"  oracle drafts: {acc}/{prop} accepted in {steps} speculative "
          f"steps ({sum(len(w) for w in want)} tokens)")
    if profile:
        _profile(lambda: _drive(eng, prompts), card, f"speculative serving "
                 f"pass (draft_k {SPEC_K}, ngram_draft, prompts hit the "
                 f"prefix cache)")
    _no_leaks("speculative decoding", eng)
    return counts


def serve_bf16(dev, card, profile=False):
    """bf16 serving, DecoderConfig(dtype="bfloat16"): the requests of the
    prefix-cache phase and the 6 serving requests, on a prefix-cache engine
    with plain decode (K1 bf16) and one with draft_k = SPEC_K on the same
    weights, each held to the dense bf16 oracle teacher-forced within
    BF16_DELTA_ULPS, with zero leaked pages."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import ServingEngine

    cfg = _serve_cfg("bfloat16")
    sysp = _serve_prompts(cfg, SEED + 1, (PREFIX_SYS,))[0]
    shared = _serve_prompts(cfg, SEED + 2, PREFIX_SUFFIX, prefix=sysp)
    plain = _serve_prompts(cfg, SEED, SERVE_LENS)
    print(f"bf16 serving gate: the dense bf16 oracle's logit for each "
          f"generated token within {BF16_DELTA_ULPS} bf16 units of its max")
    base = None
    counts = {}
    for k in (0, SPEC_K):
        eng = ServingEngine(cfg, device=dev, seed=SEED, prefix_cache=True,
                            draft_k=k)
        if base is None:
            base = eng
        else:
            _copy_weights(base, eng)
        ck.reset_launch_counts()
        rids, wall = _drive(eng, shared)
        rids2, _ = _drive(eng, [sysp, sysp])
        rids3, wall3 = _drive(eng, plain)
        run = ck.launch_counts_by_dtype()
        want = {"causal_prefill_attention": "bfloat16",
                "layer_norm_act": "bfloat16"}
        if not k:
            want["paged_decode_attention"] = "bfloat16"
        _check_serving_launches(f"bf16 serving (draft_k {k})", run, want)
        for name, by in run.items():
            for d, c in by.items():
                counts.setdefault(name, {})[d] = \
                    counts.get(name, {}).get(d, 0) + c
        st = eng.stats
        if not (st["prefix_full_hits"] >= 1 and st["cow_copies"] >= 1
                and (not k or st["spec_steps"])):
            raise RuntimeError(f"bf16 serving (draft_k {k}): no full hit, "
                               f"copy-on-write or speculative step ({st})")
        _report(f"bf16 serving (draft_k {k}), shared-prefix requests", eng,
                rids, wall, card)
        _report(f"bf16 serving (draft_k {k}), the 6 serving requests", eng,
                rids3, wall3, card)
        _no_leaks(f"bf16 serving (draft_k {k})", eng, flush=False)
        n, differ, worst = _hold_delta(
            f"bf16 serving (draft_k {k})", eng, shared + [sysp, sysp] + plain,
            [eng.result(r) for r in rids + rids2 + rids3])
        print(f"  draft_k {k}: {n} generated positions within "
              f"{BF16_DELTA_ULPS} bf16 units of the dense oracle's max (the "
              f"largest gap {worst:.2f} units); {differ} off the oracle's "
              f"argmax; prefix hits {st['prefix_hit_tokens']} tokens, "
              f"{st['prefix_full_hits']} full, cow_copies "
              f"{st['cow_copies']}, speculative steps {st['spec_steps']} "
              f"(accepted {st['spec_accepted']}/{st['spec_proposed']}); "
              f"launches {_launched(run)}")
        if profile and not k:
            _profile(lambda: _drive(eng, plain), card, "bf16 serving pass "
                     "(the 6 serving requests again: prefix-cache hits)",
                     ("K1 bf16", ("paged_decode",)))
        _no_leaks(f"bf16 serving (draft_k {k})", eng)
    return counts


# the bf16 gate's planted faults (tests/test_torch_smoke_oracle.py plants
# the same two in the plain versions on the CPU): K1 reading each row's page
# table one page on, and copy-on-write leaving the new page zero
SERVE_FAULTS = ("k1_shifted_table", "cow_without_copy")
# peaked attention, as that test scales decoder_tiny's: the q/k/v
# projections times 4 and the attention output projection times 2
QKV_SCALE, OUT_SCALE = 4.0, 2.0


@contextlib.contextmanager
def _planted(fault):
    """`fault` planted on the card's path: the K1 wrapper called with the
    page table rolled by one ordinal, or the copy-on-write's page copy
    replaced by zeroing the new page."""
    from paddle_tpu_torch.ops import attention_ops as ao

    if fault == "k1_shifted_table":
        name, real = "paged_decode_attention", ao.paged_decode_attention

        def faulty(q, k_pool, v_pool, page_table, *args, **kw):
            return real(q, k_pool, v_pool, page_table.roll(-1, dims=1),
                        *args, **kw)
    else:
        name, real = "kv_cache_copy_page_", ao.kv_cache_copy_page_

        def faulty(k_pool, v_pool, src, dst):
            for pool in (k_pool, v_pool):
                pool[dst.long().reshape(-1)[:1]] = 0
            return k_pool, v_pool
    setattr(ao, name, faulty)
    try:
        yield
    finally:
        setattr(ao, name, real)


def _peak_attention(eng):
    with torch.no_grad():
        for n in eng.parameter_names():
            if n.endswith(".mha.qkv.w"):
                eng._scope.find_var(n).mul_(QKV_SCALE)
            elif n.endswith(".mha.out.w"):
                eng._scope.find_var(n).mul_(OUT_SCALE)


def _bf16_gate_run(dev, fault, peaked):
    """serve_bf16's requests on a prefix-cache engine with plain decode,
    `fault` planted (or none), the attention peaked or not; returns the
    gate's verdict: None if it passed, else its message."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import ServingEngine

    cfg = _serve_cfg("bfloat16")
    sysp = _serve_prompts(cfg, SEED + 1, (PREFIX_SYS,))[0]
    prompts = (_serve_prompts(cfg, SEED + 2, PREFIX_SUFFIX, prefix=sysp)
               + [sysp, sysp] + _serve_prompts(cfg, SEED, SERVE_LENS))
    eng = ServingEngine(cfg, device=dev, seed=SEED, prefix_cache=True,
                        draft_k=0)
    if peaked:
        _peak_attention(eng)
    ck.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        if fault:
            stack.enter_context(_planted(fault))
        rids, _ = _drive(eng, prompts[:len(PREFIX_SUFFIX)])
        rids2, _ = _drive(eng, prompts[len(PREFIX_SUFFIX):])
    _check_serving_launches(f"bf16 gate run ({fault})",
                            ck.launch_counts_by_dtype(),
                            {"paged_decode_attention": "bfloat16"})
    if not eng.stats["cow_copies"]:
        raise RuntimeError(f"bf16 gate run ({fault}): no copy-on-write")
    try:
        _hold_delta(f"bf16 serving with {fault}", eng, prompts,
                    [eng.result(r) for r in rids + rids2])
    except RuntimeError as e:
        return str(e)
    return None


def serve_bf16_faults(dev, card):
    """The bf16 serving gate at BERT-base width must refuse each of
    SERVE_FAULTS, BF16_DELTA_ULPS unchanged: first at the random weights as
    they are; a fault that passes there is planted again with the attention
    peaked (QKV_SCALE, OUT_SCALE), where the gate must refuse it and pass
    the unfaulted engine. Fails if a fault passes both."""
    width = f"hidden width {_serve_cfg().hidden_size}"
    peaked_needed = False
    for fault in SERVE_FAULTS:
        for peaked in (False, True):
            verdict = _bf16_gate_run(dev, fault, peaked)
            how = "peaked attention" if peaked else "the random weights"
            if verdict is not None:
                print(f"bf16 serving gate refused {fault} at {width} with "
                      f"{how}: {verdict[:160]} [{card}]")
                peaked_needed |= peaked
                break
            print(f"bf16 serving gate passed {fault} at {width} with {how} "
                  f"[{card}]")
        else:
            raise RuntimeError(f"the bf16 serving gate passed {fault} with "
                               f"the random and the peaked weights")
    if peaked_needed:
        verdict = _bf16_gate_run(dev, None, True)
        if verdict is not None:
            raise RuntimeError(f"the bf16 gate refused the unfaulted engine "
                               f"with peaked attention: {verdict}")
        print(f"bf16 serving gate passed the unfaulted engine with peaked "
              f"attention [{card}]")


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


def _hold_step1(what, scope, names, p0, grads, ref_grads, lr):
    """An fp32 step 1 of Adam(lr) against its oracle: every gradient within
    GRAD_RTOL of the oracle's max-abs, and the updated parameters by the
    JAX package's Adam formula (first step, moments from zero). The first
    step moves a weight by about lr whatever its gradient, so both limits
    are a hundredth of a step: the port's update against the formula on its
    own gradients (every element), and against the formula on the oracle's
    (elements whose sign the gradient check makes sure of, above the
    epsilon's reach). Returns (worst gradient error, the two update errors,
    the elements of sure sign)."""
    lr_t = lr * (1 - 0.999) ** 0.5 / (1 - 0.9)

    def adam_step1(g):
        return lr_t * (0.1 * g / (torch.sqrt(0.001 * g * g) + 1e-8))

    worst = own_err = ref_err = 0.0
    n_sure = 0
    for n, rg in zip(names, ref_grads):
        scale = float(rg.abs().max())
        e = float((grads[n] - rg).abs().max()) / max(scale, 1e-30)
        if not e <= GRAD_RTOL:
            raise RuntimeError(f"{what}: {n}@GRAD differs from the oracle by "
                               f"{e:.3e} of its max-abs {scale:.3e}")
        worst = max(worst, e)
        p1 = scope.find_var(n)
        own_err = max(own_err, float((p1 - (p0[n] - adam_step1(grads[n])))
                                     .abs().max()))
        sure = rg.abs() > max(2 * GRAD_RTOL * scale, 1e-5)
        n_sure += int(sure.sum())
        if bool(sure.any()):
            d = (p1 - (p0[n] - adam_step1(rg)))[sure]
            ref_err = max(ref_err, float(d.abs().max()))
    if not max(own_err, ref_err) <= 1e-2 * lr:
        raise RuntimeError(f"{what}: step-1 parameters differ from the JAX "
                           f"Adam step by {own_err:.3e} on the port's "
                           f"gradients and {ref_err:.3e} on the oracle's "
                           f"(limit 1e-2 lr)")
    return worst, own_err, ref_err, n_sure


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
    worst, own_err, ref_err, n_sure = _hold_step1(
        "BERT-base", scope, names, p0, grads, ref_grads, TRAIN_LR)
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
# a head width padded to 48 (40) and dh = 128, and the WMT step's 8 heads
# (its self-attentions and cross-attention, K and V separate buffers from Q
# as in every case here)
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
    (AMP_B, 8, 128, 64, False, None, False),    # the WMT step's (bench.py:355)
    (AMP_B, 8, 128, 64, True, None, False),
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

    # K3 / K5 at the WMT step's rows (bench.py:355: 16384 rows of 512)
    Kw = WMT_BASE["hidden_size"]
    x, dy = rnd(R, Kw), rnd(R, Kw)
    s_, b_ = rnd(Kw, scale=0.1, shift=1.0, dtype=torch.float32), \
        rnd(Kw, scale=0.1, dtype=torch.float32)
    err3 = _agree16(f"layer_norm_act bf16 K={Kw} y",
                    K3.layer_norm_act(x, s_, b_, 1e-5, "identity")[0],
                    K3.layer_norm_act_plain(x, s_, b_, 1e-5, "identity")[0])
    got = K5.layer_norm_act_backward(x, s_, b_, dy, 1e-5, "identity")
    ref = K5.layer_norm_act_backward_plain(x, s_, b_, dy, 1e-5, "identity")
    err5 = max(_agree16(f"layer_norm_act_backward bf16 K={Kw} dx", got[0],
                        ref[0]),
               *(_sums_agree(f"layer_norm_act_backward bf16 K={Kw} {n}", o, r)
                 for n, o, r in zip(("dscale", "dbias"), got[1:], ref[1:])))
    print(f"K3/K5 bf16 R={R} K={Kw} (the WMT step's rows): max_abs_err "
          f"{err3:.3e} / {err5:.3e} [{card}]")
    del x, dy, got, ref

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
    counted from 0, every one on the wgmma kernel), the kernel against
    bottleneck_block_plain at the tool's inputs and at the unit set (x ~
    N(0, 1), weights scaled to keep unit variance: there the chain, not the
    residual, sets the output, and this comparison refuses a dropped halo,
    a zeroed centre tap and y3 off by 2%, tests/test_torch_smoke_oracle.py),
    against the library chain at the unit set, two calls bit for bit, its
    time, bound and the library chain's, then the tool's A/B."""
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
    routes = dict(BB.bottleneck_block.launches_by_route)
    if launches != {"bfloat16": 1 + BB.K_CHAIN} \
            or routes != {"wgmma": 1 + BB.K_CHAIN} \
            or not torch.isfinite(c.float()).all():
        raise RuntimeError(f"bottleneck_block path: launches {launches} by "
                           f"kernel {routes}, or a non-finite chained output")
    err = _agree16("bottleneck_block", y, BB.bottleneck_block_plain(x, w1, w2, w3))
    if not torch.equal(y, BB.bottleneck_block(x, w1, w2, w3)):
        raise RuntimeError("bottleneck_block: two calls on the same inputs "
                           "differ")
    unit = BB.inputs(dev, SEED, scale="unit")
    yu = BB.bottleneck_block(*unit)
    err_u = _agree16("bottleneck_block (unit inputs)", yu,
                     BB.bottleneck_block_plain(*unit))
    err_l = _agree16("bottleneck_block (unit inputs) vs the library chain", yu,
                     BB.library_chain(*unit).contiguous())
    print(f"#15 at the unit input set: max_abs_err {err_u:.3e} against the "
          f"plain version, {err_l:.3e} against the library chain (max-abs "
          f"{yu.float().abs().max().item():.3e}) [{card}]")
    del unit, yu
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
                    "tools/_rn_pallas_block.py:64", max(err, err_u), ms,
                    plain_ms, bound, by, lib_ms)
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


_LAUNCH_RULES = {  # op type: (wrapper, the slot whose var's dtype it runs)
    "fused_attention": ("causal_prefill_attention", "Q"),
    "fused_attention_grad": ("attention_backward", "Q"),
    "layer_norm": ("layer_norm_act", "X"),
    "layer_norm_grad": ("layer_norm_act_backward", "X"),
    "softmax_with_cross_entropy": ("softmax_xent_fwd", "Logits"),
    "softmax_with_cross_entropy_grad": ("softmax_xent_bwd", "Logits"),
    "batch_norm": ("bn_apply_act", "Y"),
    "conv2d_bn": ("bn_apply_act", "Y"),
    "batch_norm_grad": ("bn_apply_act_backward", "Y"),
    "conv2d_bn_grad": ("bn_apply_act_backward", "Y")}
_FLASH = {"fused_attention": "flash_attention_fwd",
          "fused_attention_grad": "flash_attention_backward"}


def _launch_of(op_type, op, block):
    """(wrapper, dtype) that `op` (read as an op of `op_type`: its own
    type, or its grad's, on the forward op's slots) launches, or None."""
    if op_type not in _LAUNCH_RULES or _composed(op, block):
        return None
    wrapper, slot = _LAUNCH_RULES[op_type]
    if op_type in _FLASH and block.var(op.inputs["Q"][0]).shape[2] > 512:
        wrapper = _FLASH[op_type]         # past S = 512: K10 and K11
    if slot != "Y":
        name = op.inputs[slot][0]
    elif "Y" in op.outputs:
        name = op.outputs["Y"][0]
    else:     # a norm's grad op: the dtype of the forward's Y
        name = op.inputs["Y@GRAD"][0][:-len("@GRAD")]
    return wrapper, block.var(name).dtype.value


def _expected_launches(program):
    """{wrapper: {dtype: launches}} one run of `program` makes, from its
    ops and the dtypes of their vars. An op of a recompute segment runs in
    the forward and again in the replay of `recompute_grad`, where its
    autograd.Function's backward launches its grad's kernel once."""
    block = program.global_block
    want: dict = {}

    def add(hit, times=1):
        if hit is not None:
            wrapper, dt = hit
            want.setdefault(wrapper, {})
            want[wrapper][dt] = want[wrapper].get(dt, 0) + times

    for op in block.ops:
        if op.type == "recompute":
            sub = program.blocks[op.attr("sub_block")]
            for sop in sub.ops:
                add(_launch_of(sop.type, sop, sub), 2)
                add(_launch_of(sop.type + "_grad", sop, sub))
        else:
            add(_launch_of(op.type, op, block))
    return want


def _composed(op, block):
    """True for the ops that take the JAX package's XLA arm, composed in
    torch, and launch no kernel: a cross entropy with soft labels or
    ignore_index, an attention with a Bias or Sq != Sk."""
    if op.type.startswith("softmax_with_cross_entropy"):
        return op.attr("soft_label", False) or op.attr("ignore_index", -100) >= 0
    if op.type.startswith("fused_attention"):
        return ("Bias" in op.inputs or block.var(op.inputs["Q"][0]).shape[2]
                != block.var(op.inputs["K"][0]).shape[2])
    return False


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


# Adam's epsilon as step 1 sees it: 1e-8 / sqrt(1 - beta2); where |g| is
# past 30 of it, the first update is lr sign(g) to 3%
ADAM_EPS_HAT = 1e-8 / (1 - 0.999) ** 0.5


def _hold_adam_step1(scope, names, p0, grads, ref_grads):
    """The port's fp32 master weights after one Adam(TRAIN_LR) step against
    the formula on its own fp32 gradient (every element), and on the
    oracle's where the oracle's gradient is at least a fifth of its
    max-abs (its sign is then sure) and past 30 ADAM_EPS_HAT (the update
    is then lr sign(g): nearer Adam's epsilon it moves with the gradient's
    bf16 spread), within 1e-2 lr. Returns (the error on the port's
    gradients, on the oracle's, the elements of sure sign, a note on the
    elements that ADAM_EPS_HAT left out)."""
    lr_t = TRAIN_LR * (1 - 0.999) ** 0.5 / (1 - 0.9)

    def adam_step1(g):
        return lr_t * (0.1 * g / (torch.sqrt(0.001 * g * g) + 1e-8))

    own_err = ref_err = 0.0
    n_sure, n_near, worst, least = 0, 0, "", (float("inf"), "")
    for n, rg in zip(names, ref_grads):
        p1 = scope.find_var(n)
        if p1.dtype != torch.float32 or grads[n].dtype != torch.float32:
            raise RuntimeError(f"{n}: master weight {p1.dtype}, gradient "
                               f"{grads[n].dtype}: both must be fp32")
        own_err = max(own_err, float((p1 - (p0[n] - adam_step1(grads[n])))
                                     .abs().max()))
        a = rg.abs()
        least = min(least, (float(a.max()), n))
        sure = (a > 0.2 * a.max()) & (a > 30 * ADAM_EPS_HAT)
        n_sure += int(sure.sum())
        n_near += int((a > 0.2 * a.max()).sum()) - int(sure.sum())
        if bool(sure.any()):
            d = (p1 - (p0[n] - adam_step1(rg)))[sure].abs()
            if float(d.max()) > ref_err:
                i = int(d.argmax())
                ref_err = float(d.max())
                worst = (f"{n}, where the oracle's gradient is "
                         f"{float(rg[sure][i]):.3e} and the port's "
                         f"{float(grads[n][sure][i]):.3e} (max-abs "
                         f"{float(a.max()):.3e})")
    if not max(own_err, ref_err) <= 1e-2 * TRAIN_LR:
        raise RuntimeError(f"AMP step-1 parameters differ from the Adam step "
                           f"by {own_err:.3e} on the port's gradients and "
                           f"{ref_err:.3e} on the oracle's, at {worst} "
                           f"(limit 1e-2 lr)")
    note = (f"{n_near} elements within 30 of Adam's epsilon left out, the "
            f"smallest gradient max-abs {least[0]:.3e} ({least[1]})")
    return own_err, ref_err, n_sure, note


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


def _bert_amp_program(cfg, S, make_optimizer):
    """(main, startup, avg_loss): bert_pretrain(cfg, seq S) +
    decorate(make_optimizer()).minimize through the port's entry points,
    the optimizer (and its schedule) built inside the programs' guard."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.models import transformer

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        avg_loss, _ = transformer.bert_pretrain(cfg, seq_len=S)
        amp.decorate(make_optimizer()).minimize(avg_loss)
    startup.random_seed = SEED
    return main, startup, avg_loss


def train_bert_amp(dev, card, B=AMP_B, S=AMP_S, flash=False, keep=False):
    """bench.py:75-81's configuration: bert_pretrain(BERT-base, seq 128) +
    decorate(Adam(1e-4)), B=128, one seeded batch, through the port's entry
    points; with B, S and flash = True, tools/_sweep.py's long-context run.
    Step 1 against the bf16 oracle of the same cast scheme (loss, every
    gradient in relative L2, the Adam update), launches by dtype from the
    program's vars, then 5 timed steps whose loss must fall. keep = True
    also returns step 1's start and results for the recompute phase:
    {"p0", "feed", "loss1", "grads", "mem"} (mem: the device memory
    allocated before the step and its peak during it)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda_kernels as ck

    what = f"BERT-base AMP B={B} S={S}"
    cfg = _bert_cfg(S, flash)
    main, startup, avg_loss = _bert_amp_program(
        cfg, S, lambda: pt.optimizer.Adam(learning_rate=TRAIN_LR))
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
    mem = _step_memory()
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[avg_loss] + [n + "@GRAD" for n in names])
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    mem = mem()
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
    own_err, ref_err, n_sure, note = _hold_adam_step1(scope, names, p0,
                                                      grads, ref_grads)
    print(f"{what} step 1 ({first:.3f} s): loss {float(loss1):.6f}, bf16 oracle "
          f"{ref_loss:.6f}, fp32 oracle {ref[torch.float32][0]:.6f} (limit "
          f"{loss_lim:.3e}); worst gradient {worst:.3e} from the "
          f"bf16 oracle in relative L2 (its limit {lim:.3e}; the largest "
          f"limit {top:.3e}, where a planted zeroed and negated gradient "
          f"were refused); fp32 master weights "
          f"within {own_err:.3e} of the Adam step on the port's gradients and "
          f"{ref_err:.3e} on the oracle's ({n_sure} elements of sure sign, "
          f"{note}; limit 1e-2 lr); launches by dtype {counts}; peak device "
          f"memory with the oracles {peak:.2f} GiB; the step's own: "
          f"{mem[0] / 2**30:.3f} GiB allocated before it, peak "
          f"{mem[1] / 2**30:.3f} GiB")
    kept = (dict(p0=p0, feed=feed, loss1=loss1, grads=grads, mem=mem)
            if keep else None)
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
    if keep:
        return step, counts, kept
    return step, counts


def _step_memory():
    """Start a measurement of one step's device memory; the returned
    function ends it: (bytes allocated at the start, the peak since)."""
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    return lambda: (base, torch.cuda.max_memory_allocated())


# The LAMB phase: BERT's LAMB recipe (You et al., "Large Batch Optimization
# for Deep Learning: Training BERT in 76 Minutes", 2019) on the BERT AMP
# step: linear warmup from LAMB_START_LR to LAMB_LR over LAMB_WARMUP runs,
# then polynomial (power 1) decay to 0 at run LAMB_DECAY, weight decay
# LAMB_WD; LAMB_STEPS runs cross from warmup into decay. LAMB_START_LR is
# not 0: at 0 the first step would move no weight, and the step-1 hold
# would see nothing.
LAMB_LR, LAMB_START_LR, LAMB_WARMUP, LAMB_DECAY = 1e-4, 2e-5, 2, 6
LAMB_WD, LAMB_EPS, LAMB_STEPS = 0.01, 1e-6, 5


def _lamb_lr(step):
    """The schedule's closed form at run `step` (from 0)."""
    if step < LAMB_WARMUP:
        return LAMB_START_LR + (LAMB_LR - LAMB_START_LR) * step / LAMB_WARMUP
    return LAMB_LR * (1 - min(step, LAMB_DECAY) / LAMB_DECAY)


def _hold_lamb_step1(scope, names, p0, grads, lr0):
    """After step 1 each fp32 master weight against the LAMB formula on
    the port's own fp32 gradient, in float64, on every element: p0 - lr0
    trust r, r = m^ / (sqrt(v^) + eps) + wd p0 (the moments from zero, the
    beta powers at their fp32 initial values), trust = |p0| / |r| or 1
    where either norm is 0 (the zero biases), within 1e-2 of that
    parameter's own step lr0 trust: a weight matrix's trust is about 0.02,
    so a limit in units of lr would see nothing. Returns (the worst error
    in units of its step, its parameter, (least trust, its parameter),
    (largest trust, its parameter))."""
    b1p, b2p = float(np.float32(0.9)), float(np.float32(0.999))
    worst, at, trusts = 0.0, "", []
    for n in names:
        p1 = scope.find_var(n)
        if p1.dtype != torch.float32 or grads[n].dtype != torch.float32:
            raise RuntimeError(f"{n}: master weight {p1.dtype}, gradient "
                               f"{grads[n].dtype}: both must be fp32")
        p, g = p0[n].double(), grads[n].double()
        r = ((1 - 0.9) * g / (1 - b1p)) / (torch.sqrt(
            (1 - 0.999) * g * g / (1 - b2p)) + LAMB_EPS) + LAMB_WD * p
        pn, rn = float(p.norm()), float(r.norm())
        trust = pn / rn if pn > 0 and rn > 0 else 1.0
        step = lr0 * trust
        err = float((p1.double() - (p - step * r)).abs().max()) / step
        trusts.append((trust, n))
        if err > worst:
            worst, at = err, n
        del p, g, r
    if not worst <= 1e-2:
        raise RuntimeError(f"LAMB step-1 weights differ from the formula by "
                           f"{worst:.3e} of the step at {at} (limit 1e-2)")
    return worst, at, min(trusts), max(trusts)


def _range_ops(types, name):
    """Wrap the computes of the ops `types` in the profiler range `name`;
    returns the function that unwraps them."""
    from paddle_tpu_torch.ops.registry import get_op_def

    saved = {t: get_op_def(t).compute for t in types}
    for t, plain in saved.items():
        get_op_def(t).compute = ranged(plain, name)

    def undo():
        for t, c in saved.items():
            get_op_def(t).compute = c
    return undo


def train_bert_lamb(dev, card):
    """train_bert_amp's configuration (bench.py:75-81: BERT-base, bf16 AMP,
    B=128, S=128, one seeded batch) through the port's entry points, the
    optimizer decorate(Lamb(linear_lr_warmup(polynomial_decay(...)))):
    LAMB_STEPS runs, the learning rate fetched each run against its closed
    form (1e-6 relative), step 1's fp32 master weights against the LAMB
    formula (_hold_lamb_step1), every beta power after the last run equal
    to beta^(LAMB_STEPS + 1) as fp32 computes it, the loss finite at every
    run, and step 1's launches by dtype from the program's vars. Returns
    (a step callable, the launches)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.ops import cuda_kernels as ck

    what = f"BERT-base AMP LAMB B={AMP_B} S={AMP_S}"
    cfg = _bert_cfg(AMP_S)

    def lamb():
        lr = L.linear_lr_warmup(
            L.polynomial_decay(LAMB_LR, decay_steps=LAMB_DECAY,
                               end_learning_rate=0.0, power=1.0),
            warmup_steps=LAMB_WARMUP, start_lr=LAMB_START_LR, end_lr=LAMB_LR)
        return pt.optimizer.Lamb(learning_rate=lr, lamb_weight_decay=LAMB_WD,
                                 epsilon=LAMB_EPS)

    main, startup, avg_loss = _bert_amp_program(cfg, AMP_S, lamb)
    updates = [op for op in main.global_block.ops if op.type == "lamb"]
    lr_name = updates[0].inputs["LearningRate"][0]
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    n_elems = sum(scope.find_var(n).numel() for n in names)
    n_ops = len(main.global_block.ops)
    adam_ops = len(_bert_amp_program(cfg, AMP_S, lambda: pt.optimizer.Adam(
        learning_rate=TRAIN_LR))[0].global_block.ops)
    print(f"LAMB trainer: {what} bf16 (decorate(Lamb(linear_lr_warmup("
          f"polynomial_decay({LAMB_LR}, {LAMB_DECAY}, 0, 1), {LAMB_WARMUP}, "
          f"{LAMB_START_LR}, {LAMB_LR}), weight decay {LAMB_WD}))): "
          f"{n_ops} ops a step against the Adam step's {adam_ops} "
          f"({len(updates)} lamb ops), {len(names)} parameters of "
          f"{n_elems} elements [{card}]")
    feed = _bert_feed(cfg, AMP_B, AMP_S)
    p0 = {n: scope.find_var(n).clone() for n in names}

    ck.reset_launch_counts()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[avg_loss, lr_name] + [n + "@GRAD" for n in names])
    counts = _check_launches(main, what)
    fetched = [(out[0], out[1])]
    worst, at, least, most = _hold_lamb_step1(
        scope, names, p0, dict(zip(names, out[2:])), _lamb_lr(0))
    del out, p0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LAMB_STEPS - 1):
        fetched.append(exe.run(main, feed=feed, scope=scope,
                               fetch_list=[avg_loss, lr_name],
                               return_numpy=False))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(lv) for lv, _ in fetched]
    lrs = [float(lr[0]) for _, lr in fetched]
    want = [_lamb_lr(i) for i in range(LAMB_STEPS)]
    if not all(abs(a - b) <= 1e-6 * b for a, b in zip(lrs, want)):
        raise RuntimeError(f"{what}: learning rates {lrs}, the schedule's "
                           f"closed form {want}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{what}: a loss is not finite: {losses}")
    b1, b2 = torch.tensor([0.9]), torch.tensor([0.999])
    for _ in range(LAMB_STEPS):
        b1, b2 = b1 * 0.9, b2 * 0.999
    for op in updates:
        for slot, want_pow in (("Beta1Pow", b1), ("Beta2Pow", b2)):
            got = scope.find_var(op.inputs[slot][0]).cpu()
            if not torch.equal(got, want_pow):
                raise RuntimeError(f"{what}: {op.inputs[slot][0]} is "
                                   f"{got.tolist()}, beta^{LAMB_STEPS + 1} in "
                                   f"fp32 is {want_pow.tolist()}")
    print(f"{what}: learning rates {lrs} equal the closed form to 1e-6; "
          f"step-1 fp32 master weights within {worst:.3e} of their own step "
          f"of the LAMB formula (at {at}; limit 1e-2; trust from "
          f"{least[0]:.4e} ({least[1]}) to {most[0]:.4e} ({most[1]})); every "
          f"beta power beta^{LAMB_STEPS + 1} in fp32; launches by dtype "
          f"{counts}")
    print(f"{what} trained {LAMB_STEPS - 1} steps after step 1 in "
          f"{wall:.3f} s: {(LAMB_STEPS - 1) / wall:.3f} steps/s, "
          f"{(LAMB_STEPS - 1) * AMP_B * AMP_S / wall:.1f} tokens/s; "
          f"losses {[round(x, 5) for x in losses]} [{card}]")
    step = lambda: exe.run(main, feed=feed, scope=scope,  # noqa: E731
                           fetch_list=[avg_loss], return_numpy=False)
    return step, counts


# the optimizer check: the twelve optimizers and three wrappers on a tiny
# program, each under one schedule in turn; the ops that must dispatch with
# no host sync (the update ops and the schedules' ops)
OPT_CASES = ("sgd", "momentum", "adam", "dgc", "lars", "adagrad", "adamax",
             "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "lamb",
             "model_average", "lookahead", "ema")
OPT_SCHEDULES = ("noam", "cosine", "piecewise")
LR_SCHEDULES = ("noam", "exponential", "natural_exp", "inverse_time",
                "polynomial", "polynomial_cycle", "piecewise", "cosine",
                "warmup")
SYNC_FREE_OPS = ("sgd", "momentum", "adam", "adamax", "adagrad",
                 "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "lamb",
                 "lars_momentum", "dgc", "model_average_accum", "lookahead",
                 "increment", "floor", "ceil", "cos", "pow", "elementwise_pow",
                 "elementwise_min", "less_than", "piecewise_decay")
OPT_TOL = dict(rtol=1e-5, atol=1e-7)
DGC_SHAPE, DGC_SPARSITY = (30522, 768), 0.999   # BERT-base's word embedding


def _schedule(L, which):
    return {
        "noam": lambda: L.noam_decay(4096, 2),
        "exponential": lambda: L.exponential_decay(1e-2, 2, 0.5, True),
        "natural_exp": lambda: L.natural_exp_decay(1e-2, 2, 0.5),
        "inverse_time": lambda: L.inverse_time_decay(1e-2, 2, 0.5),
        "polynomial": lambda: L.polynomial_decay(1e-2, 5, 1e-4, power=2.0),
        "polynomial_cycle": lambda: L.polynomial_decay(1e-2, 3, 1e-4,
                                                       cycle=True),
        "piecewise": lambda: L.piecewise_decay([1, 2], [1e-2, 5e-3, 2e-3]),
        "cosine": lambda: L.cosine_decay(1e-2, 2, 4),
        "warmup": lambda: L.linear_lr_warmup(
            L.polynomial_decay(1e-2, 6, 0.0), 2, 2e-3, 1e-2),
    }[which]()


def _optimizer_program(case, schedule):
    """fc(8 -> 16, relu) -> fc(1) -> square error, B=16, under `case`;
    returns (main, startup, loss, the ModelAverage or EMA wrapper)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch import unique_name

    main, startup = pt.Program(), pt.Program()
    wrapper = None
    with pt.program_guard(main, startup), unique_name.guard():
        x = L.data(name="x", shape=[8], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        h = L.fc(x, size=16, act="relu")
        loss = L.mean(L.square_error_cost(L.fc(h, size=1), y))
        lr = _schedule(L, schedule)
        o = pt.optimizer
        {"sgd": lambda: o.SGD(lr), "momentum": lambda: o.Momentum(lr, 0.9),
         "adam": lambda: o.Adam(lr),
         "dgc": lambda: o.DGCMomentumOptimizer(
             lr, 0.9, rampup_begin_step=1, rampup_step=2, sparsity=[0.5, 0.9]),
         "lars": lambda: o.LarsMomentum(lr, 0.9),
         "adagrad": lambda: o.Adagrad(lr), "adamax": lambda: o.Adamax(lr),
         "decayed_adagrad": lambda: o.DecayedAdagrad(lr),
         "adadelta": lambda: o.Adadelta(lr),
         "rmsprop": lambda: o.RMSProp(lr, momentum=0.9),
         "ftrl": lambda: o.Ftrl(lr, l1=1e-3, l2=1e-3),
         "lamb": lambda: o.Lamb(lr),
         "model_average": lambda: o.Momentum(lr, 0.9),
         "lookahead": lambda: o.LookaheadOptimizer(o.Adam(lr), alpha=0.5,
                                                   k=2),
         "ema": lambda: o.SGD(lr)}[case]().minimize(loss)
        if case == "model_average":
            wrapper = o.ModelAverage(0.15, min_average_window=3,
                                     max_average_window=4)
        elif case == "ema":
            wrapper = o.ExponentialMovingAverage(0.9)
            wrapper.update()
    startup.random_seed = SEED
    return main, startup, loss, wrapper


def _sync_free(types, seen):
    """Run the computes of the ops `types` on CUDA under
    torch.cuda.set_sync_debug_mode("error"), so that a host sync inside
    one raises, counting the dispatches in `seen`; the mode is scoped to
    the op, since the executor's own copy of each host feed is a sync.
    Returns the function that unwraps them."""
    from paddle_tpu_torch.ops.registry import get_op_def

    saved = {t: get_op_def(t).compute for t in types}

    def wrap(t, plain):
        def compute(ctx):
            if ctx.device.type != "cuda":
                return plain(ctx)
            seen[t] = seen.get(t, 0) + 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return plain(ctx)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return compute

    for t, plain in saved.items():
        get_op_def(t).compute = wrap(t, plain)

    def undo():
        for t, c in saved.items():
            get_op_def(t).compute = c
    return undo


def _state_close(what, main, cuda_scope, cpu_scope):
    """Every persistable var of `main` on the card within OPT_TOL of the
    CPU's; returns the largest |card - CPU| in units of its limit, atol +
    rtol |CPU|."""
    worst = 0.0
    for v in main.global_block.vars.values():
        if not v.persistable:
            continue
        a = cuda_scope.find_var(v.name).cpu().double()
        b = cpu_scope.find_var(v.name).double()
        d = float(((a - b).abs() / (OPT_TOL["atol"] + OPT_TOL["rtol"]
                                    * b.abs())).max())
        if not d <= 1.0:
            raise RuntimeError(f"{what}: {v.name} on the card {a.flatten()[:4]} "
                               f"vs the CPU {b.flatten()[:4]}")
        worst = max(worst, d)
    return worst


def _check_dgc_bert(dev, card):
    """dgc once on a DGC_SHAPE fp32 gradient at DGC_SPARSITY, U and V
    random: the released entries exactly those at or past a float64
    sort-based quantile of |v| (jnp.quantile's linear interpolation,
    computed here), UOut and VOut their complements; and the op's time."""
    from paddle_tpu_torch.ops.registry import ExecContext, get_op_def

    gen = torch.Generator(device=dev).manual_seed(SEED)
    g, u, v = (torch.randn(DGC_SHAPE, generator=gen, device=dev) * s
               for s in (1.0, 0.1, 0.1))

    class Op:
        type, inputs, outputs = "dgc", {"Grad": ["g"], "U": ["u"],
                                        "V": ["v"]}, {}
        attrs = {"momentum": 0.9, "sparsity": DGC_SPARSITY}

    def run():
        return get_op_def("dgc").compute(
            ExecContext(Op, {"g": g, "u": u, "v": v}, dev))

    out = run()
    u1 = 0.9 * u + g
    v1 = v + u1
    a = torch.sort(v1.abs().reshape(-1).double()).values
    n = a.numel()
    pos = float(np.float32(DGC_SPARSITY)) * (n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    thr = float(np.float32(float(a[lo]) * (1 - (pos - lo))
                           + float(a[hi]) * (pos - lo)))
    keep = v1.abs() >= thr
    released = int((out["GradOut"] != 0).sum())
    if not (torch.equal(out["GradOut"], torch.where(keep, v1, 0))
            and torch.equal(out["VOut"], torch.where(keep, 0, v1))
            and torch.equal(out["UOut"], torch.where(keep, 0, u1))
            and released == int(keep.sum())):
        raise RuntimeError(f"dgc at {DGC_SHAPE}: released {released}, the "
                           f"float64 quantile's threshold {thr} releases "
                           f"{int(keep.sum())}")
    ms = _Timer(dev)(run, reps=5)
    print(f"dgc on a {list(DGC_SHAPE)} fp32 gradient ({n} elements, past "
          f"torch.quantile's 2^24) at sparsity {DGC_SPARSITY}: threshold "
          f"{thr:.6e} and {released} released entries equal the float64 "
          f"sort-based quantile's; {ms:.4f} ms a call [{card}]")


def check_optimizers(dev, card):
    """The optimizers and schedules on the card against the CPU in one
    process: each of OPT_CASES under one of OPT_SCHEDULES in turn, 3 steps
    from the same startup values (B=16), every persistable var within
    OPT_TOL, the wrappers' apply (the averages swapped in) and restore;
    each of LR_SCHEDULES alone over 8 runs, the learning rates within
    OPT_TOL; every op of SYNC_FREE_OPS dispatched under the sync debug mode
    "error" (no .item(), no bool() of a device tensor, no host quantile
    check); then _check_dgc_bert."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.weights import load_params, load_state

    seen: dict = {}
    undo = _sync_free(SYNC_FREE_OPS, seen)
    try:
        cpu, gpu = pt.Executor(place="cpu"), pt.Executor(place=dev)
        worst = 0.0
        for i, case in enumerate(OPT_CASES):
            sched = OPT_SCHEDULES[i % len(OPT_SCHEDULES)]
            what = f"{case} under {sched}"
            main, startup, loss, wrapper = _optimizer_program(case, sched)
            cs, gs = pt.Scope(), pt.Scope()
            cpu.run(startup, scope=cs)
            gpu.run(startup, scope=gs)
            block = main.global_block
            arrays = {v.name: cs.find_var(v.name).numpy()
                      for v in block.vars.values() if v.persistable}
            params = {p.name for p in main.all_parameters()}
            load_params(gs, main, {n: a for n, a in arrays.items()
                                   if n in params})
            load_state(gs, main, {n: a for n, a in arrays.items()
                                  if n not in params})
            rng = np.random.default_rng(SEED)
            for _ in range(3):
                feed = {"x": rng.standard_normal((16, 8)).astype(np.float32),
                        "y": rng.standard_normal((16, 1)).astype(np.float32)}
                (lc,) = cpu.run(main, feed=feed, fetch_list=[loss], scope=cs)
                (lg,) = gpu.run(main, feed=feed, fetch_list=[loss], scope=gs)
                if not np.allclose(lg, lc, rtol=1e-5):
                    raise RuntimeError(f"{what}: loss {lg} on the card, {lc} "
                                       f"on the CPU")
            worst = max(worst, _state_close(what, main, gs, cs))
            if wrapper is None:
                continue
            before = {n: gs.find_var(n).clone() for n in params}
            with wrapper.apply(gpu, scope=gs):
                on_card = {n: gs.find_var(n).cpu() for n in params}
            with wrapper.apply(cpu, scope=cs):
                for n in params:
                    if not torch.allclose(on_card[n], cs.find_var(n),
                                          **OPT_TOL) or torch.equal(
                                              on_card[n], before[n].cpu()):
                        raise RuntimeError(f"{what}: apply swapped in "
                                           f"{on_card[n].flatten()[:4]}, the "
                                           f"CPU {cs.find_var(n).flatten()[:4]}")
            if not all(torch.equal(gs.find_var(n), before[n]) for n in params):
                raise RuntimeError(f"{what}: restore did not bring the "
                                   f"parameters back")
        for sched in LR_SCHEDULES:
            main, startup = pt.Program(), pt.Program()
            with pt.program_guard(main, startup), unique_name.guard():
                lr = _schedule(L, sched)
            got = {}
            for exe in (cpu, gpu):
                scope = pt.Scope()
                exe.run(startup, scope=scope)
                got[exe] = [exe.run(main, fetch_list=[lr], scope=scope)[0][0]
                            for _ in range(8)]
            if not np.allclose(got[gpu], got[cpu], **OPT_TOL):
                raise RuntimeError(f"{sched}: learning rates {got[gpu]} on "
                                   f"the card, {got[cpu]} on the CPU")
        missing = [t for t in SYNC_FREE_OPS if not seen.get(t)]
        if missing:
            raise RuntimeError(f"never dispatched on the card: {missing}")
        print(f"optimizers: {len(OPT_CASES)} (12 optimizers and 3 wrappers, "
              f"apply and restore) x 3 steps and {len(LR_SCHEDULES)} "
              f"schedules x 8 runs agree with the CPU (the largest difference "
              f"{worst:.3f} of its limit, 1e-7 + 1e-5 |CPU|); "
              f"{sum(seen.values())} dispatches of {len(SYNC_FREE_OPS)} op "
              f"types under the sync debug mode \"error\" [{card}]")
        _check_dgc_bert(dev, card)
    finally:
        undo()


# bench.py:355 bench_wmt's TPU arm: Transformer-base (WMT en-de) widths,
# dropout off, src and tgt 128 at B=128, label smoothing 0.1,
# decorate(Adam(1e-4)); the dropout phase runs wmt_base() as published
# (dropout 0.1) at a batch cut to WMT_DROP_B
WMT_BASE = dict(vocab_size=37000, hidden_size=512, num_layers=6, num_heads=8,
                ffn_size=2048, max_position=256, dropout=0.0, use_tp=False)
WMT_B, WMT_S, WMT_EPS, WMT_DROP_B = 128, 128, 0.1, 32
# each dropout mask's keep rate within this many binomial sigmas of 1 - p
DROP_SIGMAS = 5.0


def _wmt_feed(cfg, B, S):
    """bench.py:381-388's feed (src = tgt = S), seeded."""
    rng = np.random.default_rng(SEED)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    return {"src_ids": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "src_pos": pos,
            "tgt_ids": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "tgt_pos": pos.copy(),
            "tgt_label": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "tgt_weight": np.ones((B, S), np.float32)}


def _wmt_step_flops(cfg, B, S):
    """bench.py:411-418 (src = tgt = S): 6 N T over the encoder's, the
    decoder's and the projection's matmul parameters plus attention."""
    H, L, F_, V = cfg.hidden_size, cfg.num_layers, cfg.ffn_size, cfg.vocab_size
    t = B * S
    enc, dec = L * (4 * H * H + 2 * H * F_), L * (8 * H * H + 2 * H * F_)
    return 6 * enc * t + 6 * (dec + H * V) * t + 12 * L * H * 3 * S * t


def _wmt_amp_oracle(P, feed, cfg, ln_names, low, masks=None):
    """The WMT loss in plain torch under the AMP program's cast scheme
    (low = bfloat16): the embedding streams (sqrt(H) word + position) in
    fp32, cast to bf16 where the first layer reads them; every product on
    bf16 views of the fp32 weights; the bias adds, residual stream and
    gelu in bf16; the layer norms with fp32 statistics; attention as K2
    computes it (fp32 scores and softmax, the unnormalized weights rounded
    to bf16 before they multiply V; each layer's checkpointed); the soft
    label (the one-hot smoothed by WMT_EPS in fp32) rounded to bf16, each
    token's loss from an fp32 log-softmax rounded to bf16, weighted in bf16
    and averaged in fp32. With `masks`, the port's dropout masks in program
    order, dropout where the program puts it and attention as the program
    builds it then: scores and their scale in bf16, softmax in bf16 (the
    causal one with -1e9 above the diagonal), the probabilities times the
    mask, then V. low = float32 is the same model in fp32."""
    import torch.nn.functional as F

    H, nh = cfg.hidden_size, cfg.num_heads
    dh = H // nh
    lns, drops = iter(ln_names), iter(masks or ())
    c = lambda t: t.to(low)  # noqa: E731

    def fc(x, pre):
        return x @ c(P[pre + ".w"]) + c(P[pre + ".b"])

    def ln(x):
        sn, bn = next(lns)
        return F.layer_norm(x.float(), (H,), c(P[sn]).float(),
                            c(P[bn]).float(), 1e-5).to(low)

    def drop(x):
        return x if masks is None else x * next(drops).to(x.dtype)

    def fused(q, k, v, causal):
        s = (q.float() @ k.float().transpose(-1, -2)) * dh ** -0.5
        if causal:
            s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool,
                                         device=s.device).triu(1), -1e30)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        return ((c(e).float() @ v.float()) / e.sum(dim=-1, keepdim=True)).to(low)

    def attention(q, k, v, causal):
        if masks is None:
            return _checkpointed(lambda q, k, v: fused(q, k, v, causal),
                                 q, k, v)
        s = (q @ k.transpose(-1, -2)) * dh ** -0.5
        if causal:
            s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool,
                                         device=s.device).triu(1), -1e9)
        return drop(torch.softmax(s, dim=-1)) @ v

    def heads(t, S, n):       # [B, S, n H] -> n x [B, nh, S, dh]
        return t.reshape(t.shape[0], S, n, nh, dh).permute(2, 0, 3, 1, 4)

    def merged(a):            # [B, nh, S, dh] -> [B, S, H]
        return a.transpose(1, 2).reshape(a.shape[0], a.shape[2], H)

    def ffn(x, pre):
        return fc(drop(F.gelu(fc(x, pre + ".in"))), pre + ".out")

    def embed(ids, pos, name):
        return drop(P["word_emb"][ids.long()] * H ** 0.5
                    + P[name + ".pos_emb"][pos.long()])

    S = feed["src_ids"].shape[1]
    x = embed(feed["src_ids"], feed["src_pos"], "enc")
    for i in range(cfg.num_layers):
        pre, x = f"enc.layer{i}", c(x)
        q, k, v = heads(fc(x, pre + ".mha.qkv"), S, 3)
        a = fc(merged(attention(q, k, v, False)), pre + ".mha.out")
        x = ln(x + drop(a))
        x = ln(x + drop(ffn(x, pre + ".ffn")))
    mem = x
    x = embed(feed["tgt_ids"], feed["tgt_pos"], "dec")
    for i in range(cfg.num_layers):
        pre, x = f"dec.layer{i}", c(x)
        q, k, v = heads(fc(x, pre + ".self.qkv"), S, 3)
        a = fc(merged(attention(q, k, v, True)), pre + ".self.out")
        x = ln(x + drop(a))
        (q,), (k, v) = heads(fc(x, pre + ".cross.q"), S, 1), \
            heads(fc(mem, pre + ".cross.kv"), S, 2)
        a = fc(merged(attention(q, k, v, False)), pre + ".cross.out")
        x = ln(x + drop(a))
        x = ln(x + drop(ffn(x, pre + ".ffn")))
    logp = torch.log_softmax(fc(x, "proj").float(), dim=-1)
    V = logp.shape[-1]
    onehot = F.one_hot(feed["tgt_label"].long(), V).float()
    soft = c((1 - WMT_EPS) * onehot + WMT_EPS / V)
    tok = c(-(soft.float() * logp).sum(dim=-1))
    w = feed["tgt_weight"]
    return (tok * c(w)).float().sum() / (w.sum() + 1e-6)


def _wmt_program(cfg, S):
    """transformer_wmt(cfg, S, S, WMT_EPS) + decorate(Adam(TRAIN_LR))
    through the port's entry points: (main, startup, avg_loss)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.models import transformer

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        avg_loss, _ = transformer.transformer_wmt(
            cfg, src_len=S, tgt_len=S, label_smooth_eps=WMT_EPS)
        amp.decorate(pt.optimizer.Adam(learning_rate=TRAIN_LR)).minimize(avg_loss)
    startup.random_seed = main.random_seed = SEED
    return main, startup, avg_loss


def _hold_wmt_step1(what, cfg, main, scope, names, p0, feed, loss1, grads,
                    masks=None):
    """Step 1 against the bf16 and fp32 oracles on the same weights (and
    masks): the loss, every gradient, the Adam update. Returns the line to
    print."""
    ln_names = [(op.inputs["Scale"][0].split("@")[0],
                 op.inputs["Bias"][0].split("@")[0])
                for op in main.global_block.ops if op.type == "layer_norm"]
    dev = p0[names[0]].device
    fd = {k: torch.from_numpy(v).to(dev) for k, v in feed.items()}
    ref = {}
    torch.cuda.reset_peak_memory_stats()
    for low in (torch.bfloat16, torch.float32):
        P = {n: t.clone().requires_grad_() for n, t in p0.items()}
        lv = _wmt_amp_oracle(P, fd, cfg, ln_names, low, masks)
        ref[low] = (float(lv.detach()),
                    torch.autograd.grad(lv, [P[n] for n in names]))
        del P, lv
    peak = torch.cuda.max_memory_allocated() / 2**30
    ref_loss, ref_grads = ref[torch.bfloat16]
    fp_loss, fp_grads = ref.pop(torch.float32)
    loss_lim = _hold_amp_loss(what, float(loss1), ref_loss, fp_loss)
    worst, lim, top = _hold_amp_grads(names, grads, ref_grads, fp_grads)
    own_err, ref_err, n_sure, note = _hold_adam_step1(scope, names, p0,
                                                      grads, ref_grads)
    return (f"loss {float(loss1):.6f}, bf16 oracle {ref_loss:.6f}, fp32 "
            f"oracle {fp_loss:.6f} (limit {loss_lim:.3e}); worst gradient "
            f"{worst:.3e} from the bf16 oracle in relative L2 (its limit "
            f"{lim:.3e}; the largest limit {top:.3e}, where a planted zeroed "
            f"and negated gradient were refused); fp32 master weights within "
            f"{own_err:.3e} of the Adam step on the port's gradients and "
            f"{ref_err:.3e} on the oracle's ({n_sure} elements of sure sign, "
            f"{note}; limit 1e-2 lr); peak device memory with the oracles "
            f"{peak:.2f} GiB")


def train_wmt_amp(dev, card):
    """bench.py:355 bench_wmt's TPU arm: transformer_wmt(Transformer-base,
    dropout 0, src = tgt = WMT_S, label smoothing WMT_EPS) +
    decorate(Adam(1e-4)), B = WMT_B, one seeded batch, through the port's
    entry points. Step 1 against the bf16 oracle of the same cast scheme
    (loss, every gradient in relative L2, the Adam update), launches by
    dtype from the program's vars (the encoder's and the decoder's self-
    attention and the cross-attention on K2/K4, every layer norm on K3/K5;
    the soft-label cross entropy on no kernel), then TRAIN_STEPS timed
    steps whose loss must fall."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck

    cfg = transformer.TransformerConfig(**WMT_BASE)
    B, S = WMT_B, WMT_S
    what = f"WMT Transformer-base AMP B={B} src=tgt={S}"
    main, startup, avg_loss = _wmt_program(cfg, S)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    ops = [op.type for op in main.global_block.ops]
    print(f"AMP trainer: {what} bf16 (decorate(Adam({TRAIN_LR})), label "
          f"smoothing {WMT_EPS}), {len(ops)} ops a step, {ops.count('cast')} "
          f"casts [{card}]")
    feed = _wmt_feed(cfg, B, S)
    p0 = {n: scope.find_var(n).clone() for n in names}

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[avg_loss] + [n + "@GRAD" for n in names])
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = _check_launches(main, what)
    L = cfg.num_layers
    by_kernel = {n: sum(c.values()) for n, c in counts.items()}
    if by_kernel != {"causal_prefill_attention": 3 * L,
                     "attention_backward": 3 * L,
                     "layer_norm_act": 5 * L, "layer_norm_act_backward": 5 * L}:
        raise RuntimeError(f"{what} launches {counts}: 3 attentions and 5 "
                           f"layer norms a layer pair, no cross entropy "
                           f"kernel, were expected")
    loss1, grads = out[0], dict(zip(names, out[1:]))
    del out
    held = _hold_wmt_step1(what, cfg, main, scope, names, p0, feed, loss1,
                           grads)
    print(f"{what} step 1 ({first:.3f} s): {held}; launches by dtype {counts}")
    del grads

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
        raise RuntimeError(f"the WMT AMP loss did not fall: step 1 "
                           f"{float(loss1)}, then {losses}")
    tokens = 2 * B * S                  # src + tgt (bench.py:420)
    step_flops = _wmt_step_flops(cfg, B, S)
    print(f"{what} trained {TRAIN_STEPS} steps in {wall:.3f} s: "
          f"{TRAIN_STEPS / wall:.3f} steps/s, {TRAIN_STEPS * tokens / wall:.1f} "
          f"tokens/s (src + tgt), {TRAIN_STEPS * step_flops / wall / 1e12:.2f} "
          f"model TFLOP/s ({step_flops / 1e12:.3f} TFLOP a step, bench.py:411); "
          f"losses {[round(x, 5) for x in losses]} [{card}]")
    step = lambda: exe.run(main, feed=feed, scope=scope,  # noqa: E731
                           fetch_list=[avg_loss], return_numpy=False)
    return step, counts


def _dropout_sites(main):
    """(X, Out, Mask) var names of every dropout op, in program order."""
    return [(op.inputs["X"][0], op.outputs["Out"][0], op.outputs["Mask"][0])
            for op in main.global_block.ops if op.type == "dropout"]


def _hold_masks(sites, got, p):
    """Each dropout's Mask keeps within DROP_SIGMAS binomial sigmas of
    1 - p, holds only 0 and 1 / (1 - p) as its dtype rounds it, and is the
    mask the op applied: its Out equals X * Mask bit for bit. Returns the
    keep rates' extremes and the elements."""
    rates, total = [], 0
    for (xn, on, mn), (x, o, m) in zip(sites, got):
        n, kept = m.numel(), int((m != 0).sum())
        sigma = (n * p * (1 - p)) ** 0.5
        if abs(kept - (1 - p) * n) > DROP_SIGMAS * sigma:
            raise RuntimeError(f"dropout mask {mn}: {kept} of {n} kept, "
                               f"{abs(kept - (1 - p) * n) / sigma:.1f} binomial "
                               f"sigmas from {1 - p} (limit {DROP_SIGMAS})")
        one = torch.ones((), dtype=m.dtype)
        keep_val = float(one / torch.tensor(1 - p, dtype=m.dtype))
        vals = torch.unique(m).float().cpu().tolist()
        if not set(vals) <= {0.0, keep_val}:
            raise RuntimeError(f"dropout mask {mn} holds {vals[:6]}, not "
                               f"only 0 and {keep_val}")
        bad = int((o != x * m).sum())
        if bad:
            raise RuntimeError(f"dropout mask {mn}: the op's Out differs from "
                               f"X * Mask at {bad} elements")
        rates.append(kept / n)
        total += n
    return min(rates), max(rates), total


def train_wmt_dropout(dev, card):
    """wmt_base() as published (dropout 0.1) under AMP, B = WMT_DROP_B (a
    batch cut), src = tgt = WMT_S, through the port's entry points: the
    attention takes the unfused ops (matmul, softmax, dropout) as in the
    JAX package. Step 1's dropout masks, fetched from the run, each keep
    within DROP_SIGMAS binomial sigmas of 0.9, hold {0, 1 / 0.9} in their
    dtype and are the masks their ops applied; step 1 against the bf16 and
    fp32 oracles, which apply those masks; a run with the same counter
    repeats every mask bit for bit, one with a new counter changes each."""
    import dataclasses

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck

    cfg = dataclasses.replace(transformer.wmt_base(), **{
        k: v for k, v in WMT_BASE.items() if k != "dropout"})
    B, S, p = WMT_DROP_B, WMT_S, cfg.dropout
    what = f"WMT wmt_base() (dropout {p}) AMP B={B} src=tgt={S}"
    main, startup, avg_loss = _wmt_program(cfg, S)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p_.name for p_ in main.all_parameters()]
    sites = _dropout_sites(main)
    ops = [op.type for op in main.global_block.ops]
    print(f"AMP trainer: {what} bf16, {len(ops)} ops a step, {len(sites)} "
          f"dropouts, {ops.count('matmul')} matmuls [{card}]")
    feed = _wmt_feed(cfg, B, S)
    p0 = {n: scope.find_var(n).clone() for n in names}
    trip = [n for site in sites for n in site]

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[avg_loss] + [n + "@GRAD" for n in names] + trip,
                  rng_counter=1)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = _check_launches(main, what)
    loss1, grads = out[0], dict(zip(names, out[1:1 + len(names)]))
    got = [tuple(out[1 + len(names) + 3 * i:4 + len(names) + 3 * i])
           for i in range(len(sites))]
    del out
    lo, hi, n_el = _hold_masks(sites, got, p)
    masks = [m for _, _, m in got]
    del got
    held = _hold_wmt_step1(what, cfg, main, scope, names, p0, feed, loss1,
                           grads, masks)
    del grads
    mask_names = [m for _, _, m in sites]
    again = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                    fetch_list=mask_names, rng_counter=1)
    for n, a, m in zip(mask_names, again, masks):
        if not torch.equal(a, m):
            raise RuntimeError(f"dropout mask {n}: the same (seed, counter) "
                               f"drew another mask")
    other = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                    fetch_list=mask_names, rng_counter=2)
    moved = [float((a != m).float().mean()) for a, m in zip(other, masks)]
    if not min(moved) > 0.05:
        n = mask_names[moved.index(min(moved))]
        raise RuntimeError(f"dropout mask {n}: a new counter changed only "
                           f"{min(moved):.3e} of it")
    print(f"{what} step 1 ({first:.3f} s): {len(sites)} masks, {n_el} "
          f"elements, keep rates {lo:.5f}..{hi:.5f} (each within "
          f"{DROP_SIGMAS} binomial sigmas of {1 - p}), each the mask its op "
          f"applied; the same counter repeated every mask bit for bit, a new "
          f"one changed {min(moved):.4f}..{max(moved):.4f} of each; {held}; "
          f"launches by dtype {counts} [{card}]")
    return counts


RN50_FWD_FLOPS_PER_IMG = 2 * 4.089e9     # bench.py:32
# bf16: each layer of the two oracles reads the port's input to that layer
# (`forced`); there the relu inputs of the oracle and the port differ by
# one layer's rounding, the oracle takes the port's decision within
# RELU_NEAR_BF16 of the relu's largest input off zero and its own beyond;
# at most RELU_FAR_SHARE of the relu inputs may fall on different sides of
# zero beyond that band, and no relu's output may differ from the port's
# by more than AMP_FWD_L2 in relative L2 or, anywhere, by more than
# RELU_NEAR_BF16 of its largest output. AMP_FWD_L2 was 1e-2 and passed a
# K8 whose output is 0.4% too large in every layer 512 wide
# (tests/test_torch_smoke_oracle.py); one layer's rounding puts the two
# 4.35e-5 apart on the H100 (B=128), so 1e-3 keeps 23x of room and
# refuses that fault
RELU_NEAR_BF16 = 3e-2
RELU_FAR_SHARE = 1e-5
AMP_FWD_L2 = 1e-3
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


# ---------------------------------------------------------------------------
# The book models: the attention seq2seq of the Fluid book's machine
# translation chapter (train and beam-search decode) and recognize_digits'
# MNIST models; then the long-context BERT AMP step under RecomputeOptimizer.
# ---------------------------------------------------------------------------

# models/seq2seq.py at its own widths (word_dim 128, hidden_dim 256) over the
# WMT'14 dictionary of the book's machine-translation chapter (30000 words):
# B=64 sentence pairs, source and target padded to 50 tokens, lengths 5-50
S2S_DICT, S2S_WORD, S2S_HIDDEN = 30000, 128, 256
S2S_B, S2S_T, S2S_MIN_LEN, S2S_LR, S2S_STEPS = 64, 50, 5, 1e-3, 5
S2S_BOS, S2S_EOS = 0, 1
# the decode: 16 sources, beam 4, 50 steps; scores held to 1e-5 relative
S2S_DEC_B, S2S_BEAM, S2S_MAX_LEN, S2S_SCORE_RTOL = 16, 4, 50, 1e-5
S2S_PARAMS = ("enc.emb", "enc.proj.w", "enc.proj.b", "enc.gru.w",
              "enc.gru.b", "dec.emb", "dec.in.w", "dec.in.b", "dec.gru.w",
              "dec.gru.b", "dec.out.w", "dec.out.b")


def _s2s_batch(B, seed):
    """B random sentence pairs of lengths S2S_MIN_LEN..S2S_T, ids 2.. in
    the dictionary, each padded with EOS; the decoder reads BOS + the target
    shifted by one."""
    rng = np.random.default_rng(seed)

    def sentences():
        lens = rng.integers(S2S_MIN_LEN, S2S_T + 1, B)
        ids = rng.integers(2, S2S_DICT, (B, S2S_T))
        ids[np.arange(S2S_T)[None, :] >= lens[:, None]] = S2S_EOS
        return ids.astype(np.int64), lens.astype(np.int64)

    src, slen = sentences()
    tout, tlen = sentences()
    tin = np.roll(tout, 1, axis=1)
    tin[:, 0] = S2S_BOS
    return {"src": src, "slen": slen, "tin": tin, "tout": tout, "tlen": tlen}


def _s2s_programs():
    """(train main, startup, loss, infer program, sentence ids, sentence
    scores): seq2seq.train_model + Adam(S2S_LR), and infer_model over
    S2S_DEC_B sources, which reads the training program's parameters."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import seq2seq

    widths = dict(word_dim=S2S_WORD, hidden_dim=S2S_HIDDEN)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        d = {n: L.data(name=n, shape=[S2S_T] if n in ("src", "tin", "tout")
                       else [], dtype="int64")
             for n in ("src", "slen", "tin", "tout", "tlen")}
        loss = seq2seq.train_model(d["src"], d["slen"], d["tin"], d["tout"],
                                   d["tlen"], S2S_DICT, **widths)
        pt.optimizer.Adam(learning_rate=S2S_LR).minimize(loss)
    startup.random_seed = SEED
    infer = pt.Program()
    with pt.program_guard(infer, pt.Program()), unique_name.guard():
        src = L.data(name="src", shape=[S2S_T], dtype="int64")
        src.shape = (S2S_DEC_B, S2S_T)
        slen = L.data(name="slen", shape=[], dtype="int64")
        sent, scores = seq2seq.infer_model(
            src, slen, S2S_DICT, beam_size=S2S_BEAM, max_len=S2S_MAX_LEN,
            bos_id=S2S_BOS, eos_id=S2S_EOS, **widths)
    return main, startup, loss, infer, sent, scores


def _gru_cell(x, h, w, b):
    """gru_unit_op.h's step written out: gates (u, r, c) from x + b, the
    update and reset gates on h @ w[:, :2H], the candidate on
    (r h) @ w[:, 2H:], h' = u (c - h) + h."""
    H = h.shape[1]
    xu, xr, xc = (x + b.reshape(1, -1)).split(H, dim=1)
    u = torch.sigmoid(xu + h @ w[:, :H])
    r = torch.sigmoid(xr + h @ w[:, H:2 * H])
    c = torch.tanh(xc + (r * h) @ w[:, 2 * H:])
    return u * (c - h) + h


def _s2s_encode(P, src, slen):
    """The encoder in plain torch: embedding, projection, a GRU over the
    padded time axis, the tail zeroed; (states, each row's last valid
    state, the [B, S] source mask)."""
    proj = P["s2s.enc.emb"][src] @ P["s2s.enc.proj.w"] + P["s2s.enc.proj.b"]
    B, S = src.shape
    h = torch.zeros((B, S2S_HIDDEN), dtype=proj.dtype, device=proj.device)
    hs = []
    for t in range(S):
        h = _gru_cell(proj[:, t], h, P["s2s.enc.gru.w"], P["s2s.enc.gru.b"])
        hs.append(h)
    mask = (torch.arange(S, device=src.device)[None, :]
            < slen[:, None]).to(proj.dtype)
    states = torch.stack(hs, dim=1) * mask[..., None]
    last = states[torch.arange(B, device=src.device), (slen - 1).clamp(min=0)]
    return states, last, mask


def _s2s_dec_step(P, word_ids, h, enc, mask):
    """One decoder step: dot attention of h over the masked source states,
    [word, context] through the input projection and the GRU cell, the
    output projection. Returns (h', logits)."""
    scores = (enc * h[:, None, :]).sum(-1)
    w = torch.softmax(scores.masked_fill(mask == 0, -1e9), dim=1) * mask
    ctx = (enc * w[:, :, None]).sum(1)
    x = (torch.cat([P["s2s.dec.emb"][word_ids], ctx], dim=1)
         @ P["s2s.dec.in.w"] + P["s2s.dec.in.b"])
    h = _gru_cell(x, h, P["s2s.dec.gru.w"], P["s2s.dec.gru.b"])
    return h, h @ P["s2s.dec.out.w"] + P["s2s.dec.out.b"]


def _s2s_loss(P, fd):
    """train_model's loss in plain torch: teacher-forced decoder, per-token
    cross entropy averaged over the valid target tokens."""
    import torch.nn.functional as F

    enc, h, mask = _s2s_encode(P, fd["src"], fd["slen"])
    B, T = fd["tin"].shape
    logits = []
    for t in range(T):
        h, lg = _s2s_dec_step(P, fd["tin"][:, t], h, enc, mask)
        logits.append(lg)
    logits = torch.stack(logits, dim=1)
    tok = F.cross_entropy(logits.reshape(B * T, -1), fd["tout"].reshape(-1),
                          reduction="none").reshape(B, T)
    m = (torch.arange(T, device=tok.device)[None, :]
         < fd["tlen"][:, None]).to(tok.dtype)
    return (tok * m).sum() / m.sum()


def _op_computes(program, iterations=0):
    """Op computes one run of `program` makes: its ops, plus a static_rnn's
    body once a step of its time axis (and again in its replayed grad),
    a while body once an iteration."""
    block = program.global_block
    n = len(block.ops)
    for op in block.ops:
        if op.type in ("static_rnn", "static_rnn_grad"):
            T = block.var(op.inputs["StepInputs"][0]).shape[0]
            n += T * len(program.blocks[op.attr("sub_block")].ops)
        elif op.type == "while":
            n += iterations * len(program.blocks[op.attr("sub_block")].ops)
    return n


def train_seq2seq(dev, card, profile=False):
    """seq2seq.train_model at S2S_* through the port's entry points, fp32:
    step 1's loss, every parameter gradient and the Adam update against the
    plain-torch oracle of the same model and batch (the GRU and the
    attention step written out as loops), K6 and K7 once each a step, then
    S2S_STEPS timed steps whose loss must fall; then the beam-search decode
    (`decode_seq2seq`) on the trained weights. Returns the launches of the
    training step and of the decode."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda_kernels as ck

    what = f"seq2seq B={S2S_B} T={S2S_T} V={S2S_DICT}"
    main, startup, loss, infer, sent, sent_scores = _s2s_programs()
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    if sorted(names) != sorted("s2s." + n for n in S2S_PARAMS):
        raise RuntimeError(f"{what}: parameters {names}")
    feed = _s2s_batch(S2S_B, SEED)
    computes = _op_computes(main)
    print(f"seq2seq trainer: {what} fp32 (Adam({S2S_LR}), word_dim "
          f"{S2S_WORD}, hidden_dim {S2S_HIDDEN}), "
          f"{sum(scope.find_var(n).numel() for n in names)} parameter "
          f"elements, {len(main.global_block.ops)} ops a step, {computes} op "
          f"computes a step (the StaticRNN body's ops each target step, in "
          f"the forward and in its replayed grad) [{card}]")
    p0 = {n: scope.find_var(n).clone() for n in names}

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[loss] + [n + "@GRAD" for n in names])
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = _check_launches(main, what)
    loss1, grads = out[0], dict(zip(names, out[1:]))
    del out
    P = {n: t.clone().requires_grad_() for n, t in p0.items()}
    fd = {k: torch.from_numpy(v).to(dev) for k, v in feed.items()}
    ref_loss = _s2s_loss(P, fd)
    ref_grads = torch.autograd.grad(ref_loss, [P[n] for n in names])
    ref_loss = float(ref_loss.detach())
    if not abs(float(loss1) - ref_loss) <= 1e-4 * abs(ref_loss):
        raise RuntimeError(f"{what}: step-1 loss {float(loss1)} vs oracle "
                           f"{ref_loss}")
    worst, own_err, ref_err, n_sure = _hold_step1(
        what, scope, names, p0, grads, ref_grads, S2S_LR)
    print(f"{what} step 1 ({first:.3f} s): loss {float(loss1):.6f}, oracle "
          f"{ref_loss:.6f}; worst gradient error {worst:.3e} of its max-abs "
          f"(limit {GRAD_RTOL}); updated parameters within {own_err:.3e} of "
          f"the Adam step on the port's gradients and {ref_err:.3e} on the "
          f"oracle's ({n_sure} elements of sure sign; limit 1e-2 lr); "
          f"launches {counts}")
    del P, ref_grads, grads, p0

    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(S2S_STEPS):
        (lv,) = exe.run(main, feed=feed, scope=scope, fetch_list=[loss],
                        return_numpy=False)
        losses.append(lv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(lv) for lv in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < float(loss1):
        raise RuntimeError(f"{what}: the loss did not fall: step 1 "
                           f"{float(loss1)}, then {losses}")
    tgt = int(feed["tlen"].sum())
    print(f"{what} trained {S2S_STEPS} steps in {wall:.3f} s: "
          f"{S2S_STEPS / wall:.3f} steps/s, {S2S_STEPS * tgt / wall:.1f} "
          f"target tokens/s ({tgt} valid of {S2S_B * S2S_T} a step), "
          f"{S2S_STEPS * computes / wall:.0f} op computes/s; losses "
          f"{[round(x, 5) for x in losses]} [{card}]")
    if profile:
        _profile(lambda: exe.run(main, feed=feed, scope=scope,
                                 fetch_list=[loss], return_numpy=False),
                 card, f"seq2seq training step ({computes} op computes)",
                 ("K6/K7", ("softmax_xent",)))
    dec_counts = decode_seq2seq(dev, card, exe, scope, infer, sent,
                                sent_scores, profile)
    return counts, dec_counts


@contextlib.contextmanager
def _sync_free_while(dev):
    """On the card, every op a `while` runs in its body under the sync
    debug mode "error": a host sync there raises. The loop's own read of
    its condition, its one sync an iteration, is let through."""
    if dev.type != "cuda":
        yield
        return
    from paddle_tpu_torch.ops import control_flow_ops as cf
    from paddle_tpu_torch.ops.registry import get_op_def

    opdef, read = get_op_def("while"), cf._read_cond
    compute = opdef.compute

    def guarded(ctx):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return compute(ctx)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def read_cond(t):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return read(t)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    opdef.compute, cf._read_cond = guarded, read_cond
    try:
        yield
    finally:
        opdef.compute, cf._read_cond = compute, read


def _hold_beams(dev, P, feed, ids, parents, scores):
    """Each decode step's selections (ids, parents, scores [T, BW]) against
    the oracle's best S2S_BEAM candidates of that step, the oracle's
    log-softmax recomputed from the port's own previous beams (teacher-
    forced along them): a live row's candidates are pre_score + logp over
    the dictionary, a finished row's (pre_id == EOS) only EOS at pre_score.
    Each selection must be a candidate whose oracle score is within
    S2S_SCORE_RTOL of the port's and no further below the oracle's
    beam-th best; each batch row's selections distinct; the sorted scores
    the oracle's. Ties closer than that may go either way. Returns (the
    worst score difference relative to its limit, the selections that
    continued a finished beam)."""
    beam = S2S_BEAM
    with torch.no_grad():
        src, slen = (torch.from_numpy(feed[k]).to(dev) for k in ("src", "slen"))
        enc, h, mask = _s2s_encode(P, src, slen)
        enc, h, mask = (t.repeat_interleave(beam, 0) for t in (enc, h, mask))
        BW = enc.shape[0]
        B = BW // beam
        pre_ids = torch.full((BW,), S2S_BOS, dtype=torch.long, device=dev)
        pre_scores = torch.zeros((B, beam), device=dev)
        pre_scores[:, 1:] = -1e9
        pre_scores = pre_scores.reshape(BW)
        row0 = torch.arange(B, device=dev).repeat_interleave(beam) * beam
        worst, frozen = 0.0, 0
        for t in range(ids.shape[0]):
            h_new, logits = _s2s_dec_step(P, pre_ids, h, enc, mask)
            cand = pre_scores[:, None] + torch.log_softmax(logits, dim=-1)
            done = pre_ids == S2S_EOS
            cand[done] = -float("inf")
            cand[done, S2S_EOS] = pre_scores[done]
            V = cand.shape[1]
            flat = cand.reshape(B, beam * V)
            top = flat.topk(beam, dim=1).values
            p_ids = ids[t].to(dev).long()
            p_par = parents[t].to(dev).long()
            p_sc = scores[t].to(dev).float()
            local = p_par - row0
            if not bool(((local >= 0) & (local < beam)).all()):
                raise RuntimeError(f"decode step {t}: parent {p_par.tolist()} "
                                   f"outside its batch row's beams")
            pos = (local * V + p_ids).reshape(B, beam)
            own = flat.gather(1, pos).reshape(BW)
            lim = S2S_SCORE_RTOL * top.abs().amax(dim=1).repeat_interleave(beam)
            d = torch.maximum((own - p_sc).abs(),
                              (top[:, -1].repeat_interleave(beam) - own).clamp(min=0))
            d_sorted = (p_sc.reshape(B, beam).sort(dim=1, descending=True)
                        .values - top).abs().reshape(BW)
            rel = float((torch.maximum(d, d_sorted) / lim).max())
            distinct = all(len(set(r)) == beam for r in pos.tolist())
            if not rel <= 1.0 or not distinct:
                raise RuntimeError(
                    f"decode step {t}: the port's beams (ids {p_ids.tolist()}, "
                    f"parents {p_par.tolist()}, scores {p_sc.tolist()}) are "
                    f"not the oracle's best {beam} (its scores of them "
                    f"{own.tolist()}, its best {top.tolist()}; worst "
                    f"{rel:.3f} of the limit)")
            worst = max(worst, rel)
            frozen += int(done[p_par].sum())
            pre_ids, pre_scores, h = p_ids, p_sc, h_new[p_par]
    return worst, frozen


def _backtrack(ids, parents):
    """The sentences beam_search_decode must give, backtracked in numpy
    from the step buffers [T, BW]."""
    T, BW = ids.shape
    out = np.zeros((BW, T), np.int64)
    ptr = np.arange(BW)
    for t in range(T - 1, -1, -1):
        out[:, t] = ids[t, ptr]
        ptr = parents[t, ptr]
    return out


def _check_frozen_beams(dev):
    """The beam_search op at the decode's shapes with every other row
    finished (random candidates, no ties): its selections against the rule
    written out per batch row (a finished row's one candidate is EOS at
    its pre_score, a live row's its K candidates). The decode of random
    weights may never finish a beam. Returns the selections that continued
    a finished row."""
    from paddle_tpu_torch.ops.registry import ExecContext, get_op_def

    g = torch.Generator().manual_seed(SEED + 7)
    beam = S2S_BEAM
    BW = S2S_DEC_B * beam
    pre_ids = torch.randint(2, S2S_DICT, (BW, 1), generator=g)
    pre_ids[::2] = S2S_EOS
    pre_scores = -10 * torch.rand((BW, 1), generator=g)
    ids = torch.randint(2, S2S_DICT, (BW, beam), generator=g)
    scores = -3 * torch.rand((BW, beam), generator=g)

    class Op:
        type = "beam_search"
        inputs = {s: [s] for s in ("pre_ids", "pre_scores", "ids", "scores")}
        outputs = {}
        attrs = {"beam_size": beam, "end_id": S2S_EOS}

    env = {"pre_ids": pre_ids.to(dev), "pre_scores": pre_scores.to(dev),
           "ids": ids.to(dev), "scores": scores.to(dev)}
    out = get_op_def("beam_search").compute(ExecContext(Op, env, dev))
    got_ids, got_sc, got_par = (out[k].reshape(-1).cpu() for k in (
        "selected_ids", "selected_scores", "parent_idx"))
    frozen = 0
    for b in range(S2S_DEC_B):
        cand = []
        for r in range(b * beam, (b + 1) * beam):
            if int(pre_ids[r]) == S2S_EOS:
                cand.append((float(pre_scores[r]), r, S2S_EOS))
            else:
                cand += [(float(pre_scores[r] + scores[r, k]), r, int(ids[r, k]))
                         for k in range(beam)]
        want = sorted(cand, reverse=True)[:beam]
        rows = slice(b * beam, (b + 1) * beam)
        got = list(zip(got_sc[rows].tolist(), got_par[rows].tolist(),
                       got_ids[rows].tolist()))
        if [(p, i) for _, p, i in got] != [(p, i) for _, p, i in want] or \
                max(abs(a[0] - w[0]) for a, w in zip(got, want)) > 1e-6:
            raise RuntimeError(f"beam_search with finished rows: batch row "
                               f"{b} selected {got}, the rule gives {want}")
        frozen += sum(int(pre_ids[p]) == S2S_EOS for _, p, _ in got)
    if not frozen:
        raise RuntimeError("beam_search with finished rows: none continued")
    return frozen


def decode_seq2seq(dev, card, exe, scope, infer, sent, sent_scores,
                   profile=False):
    """infer_model's beam search over S2S_DEC_B sources (beam S2S_BEAM,
    S2S_MAX_LEN steps through the While) on the training scope's weights:
    every step's selections against the oracle (`_hold_beams`), the
    sentences against a numpy backtrack of the port's own buffers, the
    loop's host syncs one an iteration (and one to leave), its body free of
    any other (`_sync_free_while`)."""
    from paddle_tpu_torch.ops import control_flow_ops as cf
    from paddle_tpu_torch.ops import cuda_kernels as ck

    (dec_op,) = [op for op in infer.global_block.ops
                 if op.type == "beam_search_decode"]
    bufs = [dec_op.inputs[s][0] for s in ("Ids", "ParentIdx", "Scores")]
    batch = _s2s_batch(S2S_DEC_B, SEED + 1)
    feed = {"src": batch["src"], "slen": batch["slen"]}
    syncs, iters = cf.while_op.host_syncs, cf.while_op.iterations
    ck.reset_launch_counts()
    with _sync_free_while(dev):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.run(infer, feed=feed, scope=scope, return_numpy=False,
                      fetch_list=[sent, sent_scores] + bufs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {k: v for k, v in ck.launch_counts_by_dtype().items() if v}
    syncs = cf.while_op.host_syncs - syncs
    iters = cf.while_op.iterations - iters
    if iters != S2S_MAX_LEN or syncs != iters + 1:
        raise RuntimeError(f"decode: {iters} iterations and {syncs} host "
                           f"syncs of the loop, for {S2S_MAX_LEN} steps")
    sent_ids, sent_sc, ids, parents, scores = (t.cpu() for t in out)
    P = {n: scope.find_var(n) for n in ("s2s." + p for p in S2S_PARAMS)}
    worst, frozen = _hold_beams(dev, P, feed, ids, parents, scores)
    want = _backtrack(ids.numpy().astype(np.int64),
                      parents.numpy().astype(np.int64))
    if not np.array_equal(sent_ids.numpy(), want) or not torch.equal(
            sent_sc, scores[-1]):
        raise RuntimeError("decode: beam_search_decode's sentences are not "
                           "the backtrack of the port's own buffers")
    computes = _op_computes(infer, iters)
    frozen_op = _check_frozen_beams(dev)
    print(f"seq2seq decode: B={S2S_DEC_B} beam {S2S_BEAM}, {iters} While "
          f"iterations and {syncs} host syncs of the loop (its body "
          f"sync-free), {wall:.3f} s ({S2S_DEC_B * iters / wall:.1f} source "
          f"tokens decoded/s, {computes} op computes); every step's beams "
          f"the oracle's best (worst {worst:.3f} of the score limit "
          f"{S2S_SCORE_RTOL} relative), {frozen} selections continuing a "
          f"finished beam, the sentences the backtrack of the buffers; "
          f"launches {counts}; beam_search with every other row finished: "
          f"the rule's selections, {frozen_op} of them continuing a "
          f"finished row at its score [{card}]")
    if profile:
        _profile(lambda: exe.run(infer, feed=feed, scope=scope,
                                 fetch_list=[sent], return_numpy=False),
                 card, f"seq2seq beam-search decode ({computes} op computes)")
    return counts


# recognize_digits' models (BASELINE.json's first configuration) at B=128
MNIST_B, MNIST_LR, MNIST_STEPS = 128, 1e-3, 5


def _mnist_oracle(which, P, names, img, label):
    """mnist_mlp or mnist_conv in plain torch over the parameters in the
    program's order; (mean cross entropy, logits)."""
    import torch.nn.functional as F

    it = iter(names)
    h = img
    if which == "mnist_mlp":
        for _ in range(2):
            h = torch.relu(h @ P[next(it)] + P[next(it)])
    else:
        for _ in range(2):
            w, b = P[next(it)], P[next(it)]
            h = F.max_pool2d(torch.relu(F.conv2d(h, w) + b[None, :, None, None]),
                             2, 2)
        h = h.reshape(h.shape[0], -1)
    logits = h @ P[next(it)] + P[next(it)]
    return F.cross_entropy(logits, label.reshape(-1).long()), logits


def train_mnist(dev, card):
    """models/mlp.py's mnist_mlp and mnist_conv + Adam(MNIST_LR) at
    B=MNIST_B, fp32, through the port's entry points: step 1's loss,
    accuracy, every gradient and the Adam update against the plain-torch
    oracle, K6 and K7 once each a step, then MNIST_STEPS timed steps whose
    loss must fall. Returns each model's step-1 launches."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import mlp
    from paddle_tpu_torch.ops import cuda_kernels as ck

    runs = []
    for which in ("mnist_mlp", "mnist_conv"):
        what = f"{which} B={MNIST_B}"
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), unique_name.guard():
            loss, acc, _ = getattr(mlp, which)()
            pt.optimizer.Adam(learning_rate=MNIST_LR).minimize(loss)
        startup.random_seed = SEED
        exe, scope = pt.Executor(), pt.Scope()
        exe.run(startup, scope=scope)
        names = [p.name for p in main.all_parameters()]
        rng = np.random.default_rng(SEED)
        shape = (MNIST_B, 784) if which == "mnist_mlp" else (MNIST_B, 1, 28, 28)
        feed = {"img": rng.random(shape).astype(np.float32),
                "label": rng.integers(0, 10, (MNIST_B, 1)).astype(np.int64)}
        p0 = {n: scope.find_var(n).clone() for n in names}
        ck.reset_launch_counts()
        out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                      fetch_list=[loss, acc] + [n + "@GRAD" for n in names])
        counts = _check_launches(main, what)
        grads = dict(zip(names, out[2:]))
        P = {n: t.clone().requires_grad_() for n, t in p0.items()}
        ref_loss, logits = _mnist_oracle(
            which, P, names, torch.from_numpy(feed["img"]).to(dev),
            torch.from_numpy(feed["label"]).to(dev))
        ref_grads = torch.autograd.grad(ref_loss, [P[n] for n in names])
        ref_loss = ref_loss.detach()
        ref_acc = float((logits.argmax(-1).cpu().numpy()
                         == feed["label"][:, 0]).mean())
        if not abs(float(out[0]) - float(ref_loss)) <= 1e-4 * float(ref_loss) \
                or abs(float(out[1]) - ref_acc) > 1.5 / MNIST_B:
            raise RuntimeError(f"{what}: step-1 loss {float(out[0])} and "
                               f"accuracy {float(out[1])}, oracle "
                               f"{float(ref_loss)} and {ref_acc}")
        worst, own_err, ref_err, n_sure = _hold_step1(
            what, scope, names, p0, grads, ref_grads, MNIST_LR)
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MNIST_STEPS):
            (lv,) = exe.run(main, feed=feed, scope=scope, fetch_list=[loss],
                            return_numpy=False)
            losses.append(lv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [float(lv) for lv in losses]
        if not all(np.isfinite(losses)) or not losses[-1] < float(out[0]):
            raise RuntimeError(f"{what}: the loss did not fall: step 1 "
                               f"{float(out[0])}, then {losses}")
        print(f"{what} fp32 (Adam({MNIST_LR})): step 1 loss "
              f"{float(out[0]):.6f} (oracle {float(ref_loss):.6f}), accuracy "
              f"{float(out[1]):.4f} (oracle {ref_acc:.4f}); worst gradient "
              f"error {worst:.3e} of its max-abs, update within {own_err:.3e} "
              f"/ {ref_err:.3e} of the Adam step ({n_sure} elements of sure "
              f"sign); {len(main.global_block.ops)} ops a step; launches "
              f"{counts}; {MNIST_STEPS} steps in {wall:.3f} s: "
              f"{MNIST_STEPS * MNIST_B / wall:.1f} images/s; losses "
              f"{[round(x, 5) for x in losses]} [{card}]")
        runs.append(counts)
    return runs


def _grad_groups(names, grads, ref):
    """{name with its layer index taken out: (max relative difference,
    relative L2 distance)}, the worst over the layers, of grads from ref."""
    groups: dict = {}
    for n in names:
        g, r = grads[n].float(), ref[n].float()
        scale = max(float(r.abs().max()), 1e-30)
        row = (float((g - r).abs().max()) / scale, _rel_l2(g, r))
        key = re.sub(r"layer\d+", "layer*", n)
        old = groups.get(key, (0.0, 0.0))
        groups[key] = (max(old[0], row[0]), max(old[1], row[1]))
    return groups


def train_bert_recompute(dev, card, plain):
    """tools/_sweep.py's `8 2048 1` with SWEEP_RECOMPUTE: bert_pretrain
    (BERT-base, S=LONG_S, use_flash_attention) +
    RecomputeOptimizer(decorate(Adam(1e-4))) with transformer
    .last_layer_outputs as checkpoints, B=LONG_B, one step from the plain
    long-context AMP step's start (`plain`, train_bert_amp's keep): its loss
    bit for bit the plain step's, every gradient within the AMP gate's
    floor (AMP_GRAD_BAND's 2e-2 relative L2) of the plain step's, launches
    by dtype as the program says (K10 twice a layer: the forward and the
    replay; K11 once; K3/K5 in bf16 inside the replays) and, on the card,
    the step's peak device memory above its start below the plain step's;
    then TRAIN_STEPS timed steps whose loss must fall. Returns (a step,
    the launches of the first)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.weights import load_params

    what = f"recompute BERT-base AMP B={LONG_B} S={LONG_S}"
    cfg = _bert_cfg(LONG_S, True)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        avg_loss, _ = transformer.bert_pretrain(cfg, seq_len=LONG_S)
        opt = pt.optimizer.RecomputeOptimizer(
            amp.decorate(pt.optimizer.Adam(learning_rate=TRAIN_LR)))
        opt._set_checkpoints(list(transformer.last_layer_outputs))
        opt.minimize(avg_loss)
    startup.random_seed = SEED
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    load_params(scope, main, {n: plain["p0"][n].cpu().numpy() for n in names})
    n_seg = sum(op.type == "recompute" for op in main.global_block.ops)
    print(f"{what}: {n_seg} recompute segments, {len(main.global_block.ops)} "
          f"ops a step in the top block [{card}]")
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    mem = _step_memory()
    t0 = time.perf_counter()
    out = exe.run(main, feed=plain["feed"], scope=scope, return_numpy=False,
                  fetch_list=[avg_loss] + [n + "@GRAD" for n in names])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mem = mem()
    counts = _check_launches(main, what)
    L = cfg.num_layers
    if (counts.get("flash_attention_fwd") != {"bfloat16": 2 * L}
            or counts.get("flash_attention_backward") != {"bfloat16": L}
            or counts.get("layer_norm_act_backward", {}).get("bfloat16")
            != 2 * L):
        raise RuntimeError(f"{what}: launches {counts}")
    loss, grads = out[0], dict(zip(names, out[1:]))
    del out
    loss0 = plain["loss1"]
    if loss.cpu().numpy().tobytes() != loss0.cpu().numpy().tobytes():
        raise RuntimeError(f"{what}: loss {float(loss)!r}, the plain step's "
                           f"{float(loss0)!r}: not bit for bit")
    groups = _grad_groups(names, grads, plain["grads"])
    far = max(groups.items(), key=lambda kv: kv[1][1])
    if not far[1][1] <= AMP_GRAD_BAND[1]:
        raise RuntimeError(f"{what}: {far[0]}@GRAD is {far[1][1]:.3e} from "
                           f"the plain step's in relative L2 (limit "
                           f"{AMP_GRAD_BAND[1]})")
    print(f"{what} step ({wall:.3f} s): loss {float(loss)!r} bit for bit the "
          f"plain step's; each gradient's max relative difference (of the "
          f"plain step's max-abs) and relative L2 from the plain step's, "
          f"worst over the layers: " + "; ".join(
              f"{k} {a:.2e} {b:.2e}" for k, (a, b) in sorted(groups.items()))
          + f"; launches by dtype {counts} [{card}]")
    (b0, p_plain), (b1, p_rc) = plain["mem"], mem
    print(f"{what} peak device memory: plain step {p_plain / 2**30:.3f} GiB "
          f"({(p_plain - b0) / 2**30:.3f} GiB above its start), recompute "
          f"step {p_rc / 2**30:.3f} GiB ({(p_rc - b1) / 2**30:.3f} GiB above "
          f"its start) [{card}]")
    if dev.type == "cuda" and not p_rc - b1 < p_plain - b0:
        raise RuntimeError(f"{what}: the recompute step's peak above its "
                           f"start is not below the plain step's")
    del grads
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        (lv,) = exe.run(main, feed=plain["feed"], scope=scope,
                        fetch_list=[avg_loss], return_numpy=False)
        losses.append(lv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(lv) for lv in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < float(loss):
        raise RuntimeError(f"{what}: the loss did not fall: step 1 "
                           f"{float(loss)}, then {losses}")
    step_flops = _bert_step_flops(cfg, LONG_B, LONG_S)
    print(f"{what} trained {TRAIN_STEPS} steps in {wall:.3f} s: "
          f"{TRAIN_STEPS / wall:.3f} steps/s, "
          f"{TRAIN_STEPS * LONG_B * LONG_S / wall:.1f} tokens/s, "
          f"{TRAIN_STEPS * step_flops / wall / 1e12:.2f} model TFLOP/s (the "
          f"plain step's count, the replays not in it); losses "
          f"{[round(x, 5) for x in losses]} [{card}]")
    step = lambda: exe.run(main, feed=plain["feed"], scope=scope,  # noqa: E731
                           fetch_list=[avg_loss], return_numpy=False)
    return step, counts


# ---------------------------------------------------------------------------
# io and the inference Predictor: ResNet-50 and BERT-base saved from their
# for_test clones and served by create_paddle_predictor in fp32 and bf16;
# the ResNet-50 AMP step under RecomputeOptimizer; word2vec and dense DeepFM
# ---------------------------------------------------------------------------

IR_B, IB_B, IB_S = 128, 128, 128    # bench.py:282's and :120's batches
IR_TRAIN_STEPS = 3
# the bf16 predictor's output against the fp32 predictor's, in relative L2:
# within twice the distance between the plain-torch bf16 and fp32 oracles
# (the same casts) plus this floor (the predictor's and the oracle's bf16
# round at different places: cuDNN's and the kernels' sums)
INFER_BF16_FLOOR = 1e-2
INFER_FP32_L2 = 1e-4
INFER_ITERS, INFER_PASSES = 5, 3     # bench.py:35 _timed_windows' protocol


def _timed_windows(run_once, iters=INFER_ITERS, passes=INFER_PASSES):
    """bench.py:35's protocol: `passes` windows of `iters` async runs, each
    ended by a device drain; the seconds a run of every window."""
    windows = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            run_once()
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / iters)
    return windows


def _saved_arrays(dirname, program, dev):
    """Every parameter and persistable of a saved inference program, read
    back from its .npy files (not through the port's loader) onto `dev`."""
    from paddle_tpu_torch.io import _encode_name

    import os
    return {v.name: torch.from_numpy(np.load(os.path.join(
                dirname, _encode_name(v.name) + ".npy"))).to(dev)
            for v in program.list_vars() if v.persistable}


def _infer_counts(pred, feed, what):
    """One predictor run with the launch counts reset just before and read
    just after, held against what its program's ops say."""
    from paddle_tpu_torch.ops import cuda_kernels as ck

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    out = pred.run_dict(feed, return_numpy=False)[0]
    torch.cuda.synchronize()
    return out, _check_launches(pred._program, what)


def _serve_predictor(pred, feed, n, card, what, unit):
    """Warm windows of runs (n `unit`s a run), peak device memory above the
    start, and the device's busy share over three traced runs."""
    run = lambda: pred.run_dict(feed, return_numpy=False)  # noqa: E731
    run()
    torch.cuda.synchronize()
    mem = _step_memory()
    windows = _timed_windows(run)
    base, peak = mem()
    busy = _profile(lambda: [run() for _ in range(3)], card, what)
    busy_txt = "not measured" if busy is None else f"{100 * busy:.1f}%"
    print(f"{what}: {n / min(windows):.1f} {unit}/s (best of windows "
          f"{[round(1e3 * w, 3) for w in windows]} ms a run), peak device "
          f"memory {(peak - base) / 2**30:.3f} GiB above the start "
          f"({peak / 2**30:.3f} GiB), device busy {busy_txt} [{card}]")
    return n / min(windows)


def _hold_bf16_predictor(what, out16, out32, ref16, ref32):
    """The bf16 predictor's distance from the fp32 one within twice the bf16
    oracle's from the fp32 oracle plus INFER_BF16_FLOOR; returns (its
    distance, the limit)."""
    d, d_ref = _rel_l2(out16, out32), _rel_l2(ref16, ref32)
    lim = 2 * d_ref + INFER_BF16_FLOOR
    if not d <= lim:
        raise RuntimeError(f"{what}: bf16 predictor {d:.3e} from the fp32 "
                           f"one in relative L2, limit {lim:.3e} (the bf16 "
                           f"oracle {d_ref:.3e} from the fp32 oracle)")
    return d, lim, d_ref


@contextlib.contextmanager
def _swapped(module, name, fault):
    """`module.name` replaced by fault(original) inside the block."""
    real = getattr(module, name)
    setattr(module, name, fault(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _refuses(what, pred, feed, out32, lim, module, name, fault, fault_what):
    """The bf16 gate must refuse `fault` planted in module.name."""
    with _swapped(module, name, fault):
        bad = pred.run_dict(feed, return_numpy=False)[0]
    d = _rel_l2(bad, out32)
    if d <= lim:
        raise RuntimeError(f"{what}: the bf16 gate passed {fault_what} "
                           f"({d:.3e} <= {lim:.3e})")
    print(f"{what}: the bf16 gate refuses {fault_what}: {d:.3e} from the "
          f"fp32 predictor, limit {lim:.3e}")


def _resnet50_infer(P, img, low=torch.float32):
    """The NHWC space-to-depth ResNet-50's logits in inference mode in plain
    torch over the arrays P (parameters and running statistics by name):
    F.conv2d (TF32 off) and F.batch_norm(training=False). In bf16, the
    bf16 predictor's casts: every array and the image rounded to bf16, each
    conv, norm, residual add and the fc's product and bias add rounded
    once, each norm computed in fp32 from those bf16 inputs."""
    import torch.nn.functional as F

    c = lambda t: t.to(low)  # noqa: E731

    def conv(x, name, stride=1, pad=0):
        return F.conv2d(x, c(P[name + ".w_0"]).permute(3, 2, 0, 1), None,
                        stride, pad)

    def bn(x, name):
        return F.batch_norm(
            x.float(), c(P[name + ".mean"]).float(), c(P[name + ".var"]).float(),
            c(P[name + ".w_0"]).float(), c(P[name + ".b_0"]).float(), False,
            0.0, 1e-5).to(low)

    n, h, w, ch = img.shape
    x = c(img).reshape(n, h // 2, 2, w // 2, 2, ch).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, h // 2, w // 2, 4 * ch).permute(0, 3, 1, 2)
    x = torch.relu(bn(conv(F.pad(x, (2, 1, 2, 1)), "stem"), "stem.bn"))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, blocks in enumerate(RN_STAGES):
        width = 64 * 2 ** stage
        for i in range(blocks):
            stride = 2 if (i == 0 and stage > 0) else 1
            pre = f"res{stage}.{i}"
            y = torch.relu(bn(conv(x, pre + ".c1"), pre + ".c1.bn"))
            y = torch.relu(bn(conv(y, pre + ".c2", stride, 1), pre + ".c2.bn"))
            y = bn(conv(y, pre + ".c3"), pre + ".c3.bn")
            if x.shape[1] != width * 4 or stride != 1:
                x = bn(conv(x, pre + ".sc", stride), pre + ".sc.bn")
            x = torch.relu(y + x)
    pooled = x.float().mean(dim=(2, 3)).to(low)
    return (pooled @ c(P["fc_0.w_0"])) + c(P["fc_0.b_0"])


def infer_resnet(dev, card):
    """ResNet-50 in bench.py:278's configuration (s2d stem, NHWC, 224x224,
    1000 classes): its clone(for_test=True) taken before Momentum(0.01,
    0.9)'s minimize, IR_TRAIN_STEPS fp32 training steps at B=IR_B, then
    every batch norm's running mean and variance written (weights
    .load_state) from one training-mode pass over the batch (the oracle's
    batch statistics): three steps leave them near 0 and 1, and fifty
    layers normalized by those drift far. The clone is saved with
    save_inference_model and served by create_paddle_predictor. fp32: the
    predictor's logits equal a direct Executor.run of the clone on the
    training scope bit for bit, and lie within INFER_FP32_L2 relative L2 of
    the plain-torch oracle on the saved files; K8 launches 53 times in
    inference mode, K9, K6 and K7 never. bf16 (AnalysisConfig(enable_bf16
    =True)): 53 bf16 K8 launches, the bf16 gate (`_hold_bf16_predictor`),
    which must refuse K8 reading the variance one channel on. Each
    predictor's images/s, peak memory and device busy."""
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.inference import (AnalysisConfig, NativeConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.weights import load_state

    what = f"ResNet-50 predictor B={IR_B}"
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        img = L.data(name="img", shape=[RN_HW, RN_HW, 3], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        loss, _, predict = resnet.resnet50(img, label, num_classes=RN_CLASSES,
                                           s2d_stem=True, data_format="NHWC")
        test_prog = main.clone(for_test=True)
        pt.optimizer.Momentum(RN_FALL_LR, RN_MU).minimize(loss)
    startup.random_seed = SEED
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(SEED)
    feed = {"img": torch.from_numpy(rng.standard_normal(
                (IR_B, RN_HW, RN_HW, 3)).astype(np.float32)).to(dev),
            "label": torch.from_numpy(rng.integers(
                0, RN_CLASSES, (IR_B, 1)).astype(np.int32)).to(dev)}
    losses = [float(exe.run(main, feed=feed, scope=scope, fetch_list=[loss],
                            return_numpy=False)[0])
              for _ in range(IR_TRAIN_STEPS)]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{what}: training losses {losses}")
    names = [p.name for p in main.all_parameters()]
    stats = {}
    with torch.no_grad():
        _resnet50_oracle({n: scope.find_var(n) for n in names}, feed["img"],
                         feed["label"].long()[:, 0], stats, None, _tally(dev))
    state = {v.name: scope.find_var(v.name).cpu().numpy()
             for v in main.global_block.vars.values()
             if v.persistable and v.name not in names}
    for n, (m, v) in stats.items():
        state[n + ".mean"], state[n + ".var"] = m.cpu().numpy(), v.cpu().numpy()
    load_state(scope, main, state)
    (direct,) = exe.run(test_prog, feed=feed, scope=scope,
                        fetch_list=[predict], return_numpy=False)
    img_feed = {"img": feed["img"]}
    with tempfile.TemporaryDirectory() as d:
        pt.io.save_inference_model(d, ["img"], [predict], exe,
                                   main_program=test_prog, scope=scope)
        pred = create_paddle_predictor(NativeConfig(model_dir=d))
        P = _saved_arrays(d, pred._program, dev)
        pred16 = create_paddle_predictor(AnalysisConfig(model_dir=d,
                                                        enable_bf16=True))
    out32, c32 = _infer_counts(pred, img_feed, what + " fp32")
    out16, c16 = _infer_counts(pred16, img_feed, what + " bf16")
    for dt, got in (("float32", c32), ("bfloat16", c16)):
        if got != {"bn_apply_act": {dt: 53}}:
            raise RuntimeError(f"{what} {dt}: launches {got}, want 53 K8 "
                               f"(inference mode) and nothing else")
    if not torch.equal(out32, direct):
        raise RuntimeError(f"{what}: the fp32 predictor's logits are not "
                           f"the direct run's bit for bit (max "
                           f"{float((out32 - direct).abs().max()):.3e} apart)")
    with torch.no_grad():
        ref32 = _resnet50_infer(P, feed["img"])
        ref16 = _resnet50_infer(P, feed["img"], torch.bfloat16)
    d32 = _rel_l2(out32, ref32)
    if not d32 <= INFER_FP32_L2:
        raise RuntimeError(f"{what}: fp32 predictor {d32:.3e} from the "
                           f"oracle in relative L2, limit {INFER_FP32_L2}")
    d16, lim, d_ref = _hold_bf16_predictor(what, out16, out32, ref16, ref32)
    print(f"{what}: {len(pred._program.global_block.ops)} ops saved from the "
          f"for_test clone (training losses {[round(x, 4) for x in losses]}); "
          f"fp32 logits bit for bit the direct run's, {d32:.3e} from the "
          f"plain-torch oracle on the saved files in relative L2 (limit "
          f"{INFER_FP32_L2}); bf16 {d16:.3e} from fp32 (limit {lim:.3e}: the "
          f"bf16 oracle is {d_ref:.3e} from the fp32 oracle); launches "
          f"{c32} and {c16} [{card}]")
    _refuses(what, pred16, img_feed, out32, lim, nn_ops, "bn_apply_act",
             lambda real: lambda x2, s, b, m, inv, *a: real(
                 x2, s, b, m, torch.roll(inv, -1), *a),
             "K8 reading the variance one channel on")
    del P, ref32, ref16, direct, exe, scope, main
    rates = [_serve_predictor(p, img_feed, IR_B, card, f"{what} {dt}",
                              "images") for p, dt in ((pred, "fp32"),
                                                      (pred16, "bf16"))]
    return [{k: v for k, v in c.items()} for c in (c32, c16)], rates


def _bert_features(P, ids, pos, cfg, ln_names, low=torch.float32):
    """The last encoder layer's output of BERT in plain torch over the
    arrays P: F.layer_norm, the plain attention, F.gelu. In bf16, the bf16
    predictor's casts: every array rounded to bf16, each product, bias add,
    residual add and layer norm's output rounded once, the norms and the
    attention's softmax computed in fp32 and its probabilities rounded
    before they weigh V."""
    import torch.nn.functional as F

    H, nh = cfg.hidden_size, cfg.num_heads
    dh = H // nh
    lns = iter(ln_names)
    c = lambda t: t.to(low)  # noqa: E731

    def fc(x, pre):
        return (x @ c(P[pre + ".w"])) + c(P[pre + ".b"])

    def ln(x):
        sn, bn = next(lns)
        return F.layer_norm(x.float(), (H,), c(P[sn]).float(),
                            c(P[bn]).float(), 1e-5).to(low)

    x = ln(c(P["encoder.word_emb"])[ids] + c(P["encoder.pos_emb"])[pos])
    B, S = ids.shape
    for i in range(cfg.num_layers):
        pre = f"encoder.layer{i}"
        qkv = fc(x, pre + ".mha.qkv").reshape(B, S, 3, nh, dh)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        p = torch.softmax((q.float() @ k.float().transpose(-1, -2))
                          * dh ** -0.5, dim=-1).to(low)
        a = (p.float() @ v.float()).to(low)
        x = ln(x + fc(a.transpose(1, 2).reshape(B, S, H), pre + ".mha.out"))
        x = ln(x + fc(F.gelu(fc(x, pre + ".ffn.in")), pre + ".ffn.out"))
    return x


def infer_bert(dev, card):
    """BERT-base (bench.py:107 BERT_BASE, S=IB_S) as feature extraction:
    bert_pretrain's for_test clone saved with feeds src_ids and pos_ids and
    the last encoder layer's output as the target, served at B=IB_B by fp32
    and bf16 predictors, held as in infer_resnet: fp32 bit for bit the
    direct run of the clone and within INFER_FP32_L2 of the plain-torch
    oracle on the saved files, 12 K2 forward and 25 K3 launches in each
    dtype and no K4-K7; the bf16 gate, which must refuse K2 reading the
    keys one position on. tokens/s, peak memory and device busy."""
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.inference import (AnalysisConfig, NativeConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import attention_ops

    what = f"BERT-base predictor B={IB_B} S={IB_S}"
    cfg = _bert_cfg(IB_S)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        transformer.bert_pretrain(cfg, seq_len=IB_S)
        feat = transformer.last_layer_outputs[-1]
        test_prog = main.clone(for_test=True)
    startup.random_seed = SEED
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {k: torch.from_numpy(v).to(dev)
            for k, v in _bert_feed(cfg, IB_B, IB_S).items()}
    (direct,) = exe.run(test_prog, feed=feed, scope=scope, fetch_list=[feat],
                        return_numpy=False)
    ln_names = [(op.inputs["Scale"][0], op.inputs["Bias"][0])
                for op in test_prog.global_block.ops if op.type == "layer_norm"]
    in_feed = {k: feed[k] for k in ("src_ids", "pos_ids")}
    with tempfile.TemporaryDirectory() as d:
        pt.io.save_inference_model(d, list(in_feed), [feat], exe,
                                   main_program=test_prog, scope=scope)
        pred = create_paddle_predictor(NativeConfig(model_dir=d))
        P = _saved_arrays(d, pred._program, dev)
        pred16 = create_paddle_predictor(AnalysisConfig(model_dir=d,
                                                        enable_bf16=True))
    out32, c32 = _infer_counts(pred, in_feed, what + " fp32")
    out16, c16 = _infer_counts(pred16, in_feed, what + " bf16")
    L = cfg.num_layers
    for dt, got in (("float32", c32), ("bfloat16", c16)):
        if got != {"causal_prefill_attention": {dt: L},
                   "layer_norm_act": {dt: 2 * L + 1}}:
            raise RuntimeError(f"{what} {dt}: launches {got}, want {L} K2 "
                               f"and {2 * L + 1} K3 and nothing else")
    if not torch.equal(out32, direct):
        raise RuntimeError(f"{what}: the fp32 predictor's features are not "
                           f"the direct run's bit for bit")
    ids, pos = feed["src_ids"].long(), feed["pos_ids"].long()
    with torch.no_grad():
        ref32 = _bert_features(P, ids, pos, cfg, ln_names)
        ref16 = _bert_features(P, ids, pos, cfg, ln_names, torch.bfloat16)
    d32 = _rel_l2(out32, ref32)
    if not d32 <= INFER_FP32_L2:
        raise RuntimeError(f"{what}: fp32 predictor {d32:.3e} from the "
                           f"oracle in relative L2, limit {INFER_FP32_L2}")
    d16, lim, d_ref = _hold_bf16_predictor(what, out16, out32, ref16, ref32)
    print(f"{what}: {len(pred._program.global_block.ops)} ops saved from the "
          f"for_test clone; fp32 features bit for bit the direct run's, "
          f"{d32:.3e} from the plain-torch oracle on the saved files in "
          f"relative L2 (limit {INFER_FP32_L2}); bf16 {d16:.3e} from fp32 "
          f"(limit {lim:.3e}: the bf16 oracle is {d_ref:.3e} from the fp32 "
          f"oracle); launches {c32} and {c16} [{card}]")
    _refuses(what, pred16, in_feed, out32, lim, attention_ops,
             "causal_prefill_attention",
             lambda real: lambda q, k, v, **kw: real(
                 q, torch.roll(k, 1, dims=2), v, **kw),
             "K2 reading the keys one position on")
    del P, ref32, ref16, direct, exe, scope, main
    rates = [_serve_predictor(p, in_feed, IB_B * IB_S, card,
                              f"{what} {dt}", "tokens")
             for p, dt in ((pred, "fp32"), (pred16, "bf16"))]
    return [dict(c) for c in (c32, c16)], rates


def _resnet_amp_program(recompute):
    """bench.py:282-306's ResNet-50 AMP program (decorate(Momentum(0.1,
    0.9)), bn_fuse_stats on); with `recompute`, under RecomputeOptimizer
    with checkpoints at the 16 bottleneck outputs (each block's relu after
    its residual add) and the mean loss, so that the head (pool, fc, cross
    entropy, mean) is a segment too. Not the per-image loss: the AMP
    rewrite casts nothing across a segment's boundary, so the fp32 mean
    after it would read the bf16 loss, which the plain program casts to
    fp32 first. Returns (main, startup, loss)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.models import resnet

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        img = L.data(name="img", shape=[RN_HW, RN_HW, 3], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        loss, _, _ = resnet.resnet50(img, label, num_classes=RN_CLASSES,
                                     s2d_stem=True, data_format="NHWC")
        opt = amp.decorate(pt.optimizer.Momentum(RN_LR, RN_MU))
        if recompute:
            ops = main.global_block.ops
            writer = {n: op for op in ops for n in op.output_names}
            checkpoints = [op.outputs["Out"][0] for op in ops
                           if op.type == "relu" and writer[
                               op.inputs["X"][0]].type == "elementwise_add"]
            if len(checkpoints) != 16:
                raise RuntimeError(f"ResNet-50 has 16 bottleneck outputs, "
                                   f"found {len(checkpoints)}")
            checkpoints.append(loss)
            opt = pt.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(checkpoints)
        opt.minimize(loss)
    startup.random_seed = SEED
    return main, startup, loss


def recompute_resnet(dev, card):
    """The ResNet-50 AMP step (bench.py:282-306, B=AMP_B) under
    RecomputeOptimizer (`_resnet_amp_program`) against the plain AMP step
    from the same start: the loss bit for bit the plain step's, every
    gradient within AMP_GRAD_BAND's 2e-2 relative L2 of the plain step's,
    the running statistics after the step the plain step's bit for bit
    (they moved once, not twice: the replays' are discarded), launches by
    dtype as the program says (K8 twice a batch norm, the forward and the
    replay, K9 once through `_BatchNormFn`; K6 twice and K7 once through
    `_XentFn`), the step's peak device memory above its start against the
    plain step's, and ms a step of both. Returns (the launches, a step
    under recompute)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.weights import load_params

    what = f"recompute ResNet-50 AMP B={AMP_B}"
    rng = np.random.default_rng(SEED)
    feed = {"img": torch.from_numpy(rng.standard_normal(
                (AMP_B, RN_HW, RN_HW, 3)).astype(np.float32)).to(dev),
            "label": torch.from_numpy(rng.integers(
                0, RN_CLASSES, (AMP_B, 1)).astype(np.int32)).to(dev)}
    runs = {}
    p0 = None
    for key in ("plain", "recompute"):
        main, startup, loss = _resnet_amp_program(key == "recompute")
        exe, scope = pt.Executor(), pt.Scope()
        exe.run(startup, scope=scope)
        names = [p.name for p in main.all_parameters()]
        if p0 is None:
            p0 = {n: scope.find_var(n).cpu().numpy() for n in names}
        load_params(scope, main, p0)
        stat_names = sorted(n for n in main.global_block.vars
                            if n.endswith(".bn.mean") or n.endswith(".bn.var"))
        from paddle_tpu_torch.ops import cuda_kernels as ck
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        mem = _step_memory()
        out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                      fetch_list=[loss] + [n + "@GRAD" for n in names])
        torch.cuda.synchronize()
        base, peak = mem()
        counts = _check_launches(main, f"{what} ({key})")
        step = lambda e=exe, m=main, s=scope, lv=loss: e.run(  # noqa: E731
            m, feed=feed, scope=s, fetch_list=[lv], return_numpy=False)
        runs[key] = dict(loss=out[0], grads=dict(zip(names, out[1:])),
                         stats={n: scope.find_var(n).clone()
                                for n in stat_names},
                         above=peak - base, peak=peak, counts=counts,
                         step=step, names=names,
                         segments=sum(op.type == "recompute"
                                      for op in main.global_block.ops))
        del out
    plain, rc = runs["plain"], runs["recompute"]
    want = {"bn_apply_act": {"bfloat16": 106},
            "bn_apply_act_backward": {"bfloat16": 53},
            "softmax_xent_fwd": {"bfloat16": 2},
            "softmax_xent_bwd": {"bfloat16": 1}}
    if rc["counts"] != want:
        raise RuntimeError(f"{what}: launches {rc['counts']}, want {want}")
    if not torch.equal(rc["loss"], plain["loss"]):
        raise RuntimeError(f"{what}: loss {float(rc['loss'])!r}, the plain "
                           f"step's {float(plain['loss'])!r}: not bit for bit")
    moved = 0
    for n, t in plain["stats"].items():
        if not torch.equal(rc["stats"][n], t):
            raise RuntimeError(f"{what}: running statistic {n} is "
                               f"{float((rc['stats'][n] - t).abs().max()):.3e}"
                               f" from the plain step's")
        moved += not torch.equal(t, torch.zeros_like(t) if n.endswith(".mean")
                                 else torch.ones_like(t))
    if moved != len(plain["stats"]):
        raise RuntimeError(f"{what}: {len(plain['stats']) - moved} running "
                           f"statistics did not move")
    groups = _grad_groups(rc["names"], rc["grads"], plain["grads"])
    far = max(groups.items(), key=lambda kv: kv[1][1])
    if not far[1][1] <= AMP_GRAD_BAND[1]:
        raise RuntimeError(f"{what}: {far[0]}@GRAD is {far[1][1]:.3e} from "
                           f"the plain step's in relative L2 (limit "
                           f"{AMP_GRAD_BAND[1]})")
    for r in (plain, rc):
        del r["grads"]
    ms = {}
    for key in ("plain", "recompute", "recompute", "plain"):
        r = runs[key]
        r["step"]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RN_STEPS):
            r["step"]()
        torch.cuda.synchronize()
        ms.setdefault(key, []).append(1e3 * (time.perf_counter() - t0)
                                      / RN_STEPS)
    print(f"{what}: {rc['segments']} recompute segments; loss "
          f"{float(rc['loss'])!r} bit for bit the plain step's; "
          f"{len(plain['stats'])} running statistics bit for bit the plain "
          f"step's (moved once); worst gradient {far[0]} {far[1][1]:.3e} from "
          f"the plain step's in relative L2 (limit {AMP_GRAD_BAND[1]}); "
          f"launches by dtype {rc['counts']} (plain step {plain['counts']}); "
          f"peak device memory above the step's start {rc['above'] / 2**30:.3f}"
          f" GiB, plain {plain['above'] / 2**30:.3f} GiB (absolute "
          f"{rc['peak'] / 2**30:.3f} and {plain['peak'] / 2**30:.3f}); ms a "
          f"step (P R R P, {RN_STEPS} steps each) recompute "
          f"{[round(x, 2) for x in ms['recompute']]}, plain "
          f"{[round(x, 2) for x in ms['plain']]} [{card}]")
    return rc["counts"], rc["step"]


# the book's word2vec at its defaults (dict 2000, embed 32, hidden 256,
# 4-gram) at B=100 and dense DeepFM at bench.py:436's on-chip widths (26
# fields, 13 dense, vocab 100,000, embed 16, hidden 400 x 3) at B=2048,
# each under SGD(1e-3) (the book's word2vec optimizer; bench_deepfm's)
W2V_B, DFM_B, BOOK_LR, BOOK_STEPS = 100, 2048, 1e-3, 5
DFM_CFG = dict(n_fields=26, n_dense=13, vocab_size=100_000, embed_dim=16,
               hidden_sizes=(400, 400, 400))


def _w2v_loss(P, fd, fc):
    """word2vec's mean loss in plain torch: the shared table, a sigmoid
    hidden layer, the softmax and -log(p[next] + 1e-12)."""
    emb = torch.cat([P["shared_w"][fd[f"w{i}"].long()[:, 0]]
                     for i in range(4)], dim=1)
    h = torch.sigmoid(emb @ P[fc[0][0]] + P[fc[0][1]])
    p = torch.softmax(h @ P[fc[1][0]] + P[fc[1][1]], dim=-1)
    return -torch.log(p.gather(1, fd["next_word"].long()) + 1e-12).mean()


def _dfm_loss(P, fd, out_b):
    """DeepFM's mean loss in plain torch: the first- and second-order FM
    terms, the relu tower and the stable sigmoid cross entropy."""
    ids, dense, z = fd["sparse_ids"].long(), fd["dense_x"], fd["label"]
    first = P["fm_w1"][ids].sum(dim=1) + dense @ P["fm_dense_w"]
    emb = P["fm_emb"][ids]
    sum_v = emb.sum(dim=1)
    second = 0.5 * (sum_v * sum_v - (emb * emb).sum(dim=1)).sum(
        dim=1, keepdim=True)
    deep = torch.cat([emb.reshape(ids.shape[0], -1), dense], dim=1)
    for i in range(len(DFM_CFG["hidden_sizes"])):
        deep = torch.relu(deep @ P[f"deep_w{i}"] + P[f"deep_b{i}"])
    x = first + second + deep @ P["deep_out_w"] + P[out_b]
    return (torch.clamp(x, min=0) - x * z
            + torch.log1p(torch.exp(-x.abs()))).mean()


def _dfm_out_bias(program):
    """The name of DeepFM's output bias, the one parameter models/deepfm.py
    leaves unnamed."""
    known = {"fm_w1", "fm_dense_w", "fm_emb", "deep_out_w"} | {
        f"deep_{k}{i}" for k in "wb"
        for i in range(len(DFM_CFG["hidden_sizes"]))}
    (out_b,) = [p.name for p in program.all_parameters()
                if p.name not in known]
    return out_b


def _train_book(dev, card, what, build, feed, oracle, n_examples):
    """One book model under SGD(BOOK_LR): step 1's loss and every gradient
    against the plain-torch oracle (GRAD_RTOL of each gradient's max-abs),
    the update p0 - lr g on the port's gradients within fp32 spacing,
    launches as the program says (none: no kernel-backed op), then
    BOOK_STEPS timed steps whose loss must fall. Returns the launches."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        loss, extra = build()
        pt.optimizer.SGD(BOOK_LR).minimize(loss)
    startup.random_seed = SEED
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    p0 = {n: scope.find_var(n).clone() for n in names}
    from paddle_tpu_torch.ops import cuda_kernels as ck
    ck.reset_launch_counts()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[loss] + [n + "@GRAD" for n in names])
    torch.cuda.synchronize()
    counts = _check_launches(main, what)
    loss1, grads = out[0], dict(zip(names, out[1:]))
    P = {n: t.clone().requires_grad_() for n, t in p0.items()}
    ref = oracle(P, feed, extra)
    ref_grads = dict(zip(names, torch.autograd.grad(ref, [P[n] for n in names])))
    ref = float(ref.detach())
    if not abs(float(loss1) - ref) <= 1e-5 * abs(ref):
        raise RuntimeError(f"{what}: step-1 loss {float(loss1)} vs oracle "
                           f"{ref}")
    worst = upd = 0.0
    for n in names:
        scale = max(float(ref_grads[n].abs().max()), 1e-30)
        e = float((grads[n] - ref_grads[n]).abs().max()) / scale
        if not e <= GRAD_RTOL:
            raise RuntimeError(f"{what}: {n}@GRAD differs from the oracle by "
                               f"{e:.3e} of its max-abs {scale:.3e}")
        worst = max(worst, e)
        spacing = 2.4e-7 * max(float(p0[n].abs().max()), 1e-30)
        upd = max(upd, float((scope.find_var(n) - (p0[n] - BOOK_LR * grads[n]))
                             .abs().max()) / spacing)
    if not upd <= 1.0:
        raise RuntimeError(f"{what}: the SGD update is {upd:.2f} fp32 "
                           f"spacings from p0 - lr g")
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BOOK_STEPS):
        losses.append(exe.run(main, feed=feed, scope=scope, fetch_list=[loss],
                              return_numpy=False)[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(lv) for lv in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < float(loss1):
        raise RuntimeError(f"{what}: the loss did not fall: step 1 "
                           f"{float(loss1)}, then {losses}")
    print(f"{what} step 1: loss {float(loss1):.6f}, oracle {ref:.6f}; "
          f"worst gradient error {worst:.3e} of its max-abs (limit "
          f"{GRAD_RTOL}); SGD update within {upd:.2f} fp32 spacings of p0 - "
          f"lr g; {len(main.global_block.ops)} ops a step, launches {counts}; "
          f"{BOOK_STEPS} steps in {wall:.3f} s: {BOOK_STEPS * n_examples / wall:.1f}"
          f" examples/s; losses {[round(x, 6) for x in losses]} [{card}]")
    return counts


def book_rest(dev, card):
    """word2vec (models/word2vec.py at its defaults, B=W2V_B) and dense
    DeepFM (models/deepfm.py at DFM_CFG, is_sparse=False, B=DFM_B), each
    held by `_train_book`; the data from SEED with numpy."""
    from paddle_tpu_torch.models import deepfm, word2vec

    rng = np.random.default_rng(SEED)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    w2v_feed = {f"w{i}": t(rng.integers(0, 2000, (W2V_B, 1)).astype(np.int32))
                for i in range(4)}
    w2v_feed["next_word"] = t(rng.integers(0, 2000, (W2V_B, 1))
                              .astype(np.int32))

    def w2v():
        loss, _, _ = word2vec.word2vec()
        return loss, [(f"fc_{i}.w_0", f"fc_{i}.b_0") for i in range(2)]

    F_, V = DFM_CFG["n_fields"], DFM_CFG["vocab_size"]
    dfm_feed = {"sparse_ids": t(rng.integers(0, V, (DFM_B, F_)).astype(np.int32)),
                "dense_x": t(rng.random((DFM_B, DFM_CFG["n_dense"]))
                             .astype(np.float32)),
                "label": t(rng.integers(0, 2, (DFM_B, 1)).astype(np.float32))}

    def dfm():
        loss, _, _ = deepfm.deepfm(is_sparse=False, **DFM_CFG)
        from paddle_tpu_torch.framework import default_main_program
        return loss, _dfm_out_bias(default_main_program())

    return [_train_book(dev, card, f"word2vec B={W2V_B}", w2v, w2v_feed,
                        _w2v_loss, W2V_B),
            _train_book(dev, card, f"dense DeepFM B={DFM_B}", dfm, dfm_feed,
                        _dfm_loss, DFM_B)]


# -- DeepFM CTR through train_from_dataset, sparse word2vec, the last
#    sequence and RNN ops

# bench.py:423 bench_deepfm's TPU arm: 8 MultiSlot files of 16384 lines
# from seed 0, QueueDataset at batch 2048 on 4 threads, SGD(1e-3)
CTR_FILES, CTR_LINES, CTR_B, CTR_THREADS, CTR_LR = 8, 16384, 2048, 4, 1e-3
CTR_PASSES = 5                       # timed passes after a warm one
CTR_DEVICE_ITERS, CTR_DEVICE_WINDOWS = 50, 3   # bench.py's device path
CTR_WIDTHS = (26, 13, 1)             # sparse_ids, dense_x, label slots
# a sparse step against the dense step and the oracle: the parameters in
# relative L2 (CUDA's index_add_ adds repeated ids in a varying order)
SPARSE_L2 = 1e-6
# one train_from_dataset pass against a plain loop of Executor.run over the
# same 64 batches: every parameter in relative L2
TRAINER_L2 = 1e-5
LAZY_ADAM_L2 = 1e-6       # touched rows against the oracle, steps 1 and 2
SMOKE_DATA = "_smoke_data"           # under the checkout; .gitignore lists it
W2V_SPARSE_B = 100


def _write_ctr_files(dirname):
    """bench.py:436-451's files: one line a sample, `26 ids 13 dense 1
    label`, the numbers drawn line by line from SEED as bench.py draws
    them."""
    import os

    V = DFM_CFG["vocab_size"]
    nf, nd = DFM_CFG["n_fields"], DFM_CFG["n_dense"]
    rng = np.random.default_rng(SEED)
    files = []
    for fi in range(CTR_FILES):
        p = os.path.join(dirname, f"part-{fi}")
        with open(p, "w") as f:
            for _ in range(CTR_LINES):
                ids = rng.integers(0, V, nf)
                dense = rng.random(nd).round(4)
                lbl = rng.integers(0, 2)
                f.write(f"{nf} {' '.join(map(str, ids))} "
                        f"{nd} {' '.join(map(str, dense))} 1 {lbl}\n")
        files.append(p)
    return files


def _ctr_batches(flats):
    """The 64 batches of the files in file order, cast by numpy as the
    feed vars declare them (ids int32, dense and label float32)."""
    nf, nd = DFM_CFG["n_fields"], DFM_CFG["n_dense"]
    out = []
    for flat in flats:
        for i in range(0, len(flat), CTR_B):
            c = flat[i:i + CTR_B]
            out.append({"sparse_ids": c[:, :nf].astype(np.int32),
                        "dense_x": c[:, nf:nf + nd].astype(np.float32),
                        "label": c[:, nf + nd:].astype(np.float32)})
    return out


def _ctr_program(is_sparse, make_opt):
    """DeepFM at DFM_CFG under make_opt(); returns (main, startup, its
    for_test clone (the loss alone), loss, feed vars, the output bias)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import deepfm

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        loss, _, feed_names = deepfm.deepfm(is_sparse=is_sparse, **DFM_CFG)
        test = main.clone(for_test=True)
        make_opt().minimize(loss)
    startup.random_seed = SEED
    return (main, startup, test, loss,
            [main.global_block.var(n) for n in feed_names],
            _dfm_out_bias(main))


def _on(dev, feed):
    return {k: torch.from_numpy(v).to(dev) for k, v in feed.items()}


def _untouched(V, ids, dev):
    mask = torch.ones(V, dtype=torch.bool, device=dev)
    mask[ids.reshape(-1).long()] = False
    return mask


def _check_parse(files, card):
    """The C parser against the plain Python parser, bit for bit on every
    file; a malformed line raises ValueError in both. Returns the parsed
    files."""
    import os

    from paddle_tpu_torch.native import library_path, parse_multislot_file

    t0 = time.perf_counter()
    parse_multislot_file(files[0], list(CTR_WIDTHS))   # builds the library
    build_s = time.perf_counter() - t0
    flats, c_s, py_s = [], 0.0, 0.0
    for p in files:
        t0 = time.perf_counter()
        fast = parse_multislot_file(p, list(CTR_WIDTHS))
        t1 = time.perf_counter()
        plain = parse_multislot_file(p, list(CTR_WIDTHS), native=False)
        py_s += time.perf_counter() - t1
        c_s += t1 - t0
        if fast.shape != (CTR_LINES, sum(CTR_WIDTHS)) or not np.array_equal(
                fast.view(np.int64), plain.view(np.int64)):
            raise RuntimeError(f"parse: the C parser differs from the plain "
                               f"parser on {p}")
        flats.append(fast)
    bad = os.path.join(os.path.dirname(files[0]), "malformed")
    with open(bad, "w") as f:
        f.write("26 1 2 3\n")
    for native in (True, False):
        try:
            parse_multislot_file(bad, list(CTR_WIDTHS), native=native)
        except ValueError:
            continue
        raise RuntimeError(f"parse: a malformed line passed the "
                           f"{'C' if native else 'plain'} parser")
    print(f"ctr parse: {len(files)} files of {CTR_LINES} lines, the C parser "
          f"(built in {build_s:.3f} s into {os.path.relpath(library_path())}) "
          f"equal bit for bit to the plain parser; {1e3 * c_s / len(files):.1f}"
          f" ms a file (plain {1e3 * py_s / len(files):.1f} ms); a malformed "
          f"line raises in both (host CPU) [{card}]")
    return flats


def _sparse_vs_dense(dev, card, what, build, feed, oracle, tables, lr):
    """One SGD step of the sparse program (its tables' grads SelectedRows)
    and one of the dense program from the same startup on one batch: the
    losses bit for bit; each table in `tables` {name: ids tensor} after the
    step within SPARSE_L2 relative L2 of the dense step's and of p0 - lr g
    with the plain-torch oracle's g, its untouched rows bit for bit; the
    sgd ops dispatched under the sync debug mode "error". Returns the
    sparse step's launches and the fetched SelectedRows grads."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    from paddle_tpu_torch.ops import cuda_kernels as ck

    exe = pt.Executor()
    after, losses, counts, srs, p0s = {}, {}, None, None, {}
    for sparse in (True, False):
        main, startup, loss, extra = build(sparse)
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        names = [p.name for p in main.all_parameters()]
        p0 = p0s[sparse] = {n: scope.find_var(n).clone() for n in names}
        seen = {}
        undo = _sync_free(("sgd",), seen)
        try:
            ck.reset_launch_counts()
            out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                          fetch_list=[loss] + ([n + "@GRAD" for n in tables]
                                               if sparse else []))
            torch.cuda.synchronize()
            if sparse:
                counts = _check_launches(main, what)
        finally:
            undo()
        if dev.type == "cuda" and seen.get("sgd") != len(names):
            raise RuntimeError(f"{what}: {seen} sgd dispatches, {len(names)} "
                               f"parameters")
        losses[sparse] = float(out[0])
        after[sparse] = {n: scope.find_var(n) for n in tables}
        if sparse:
            srs = dict(zip(tables, out[1:]))
            for n, sr in srs.items():
                if not isinstance(sr, SelectedRows):
                    raise RuntimeError(f"{what}: {n}@GRAD is {type(sr)}, not "
                                       f"a SelectedRows")
    if losses[True] != losses[False] or not all(
            torch.equal(p0s[True][n], p0s[False][n]) for n in names):
        raise RuntimeError(f"{what}: sparse loss {losses[True]} vs dense "
                           f"{losses[False]} from the same startup")
    p0 = p0s[True]
    P = {n: t.clone().requires_grad_() for n, t in p0.items()}
    ref = oracle(P, feed, extra)
    ref_g = dict(zip(names, torch.autograd.grad(ref, [P[n] for n in names])))
    ref = ref.detach()
    if not abs(float(ref) - losses[True]) <= 1e-5 * abs(float(ref)):
        raise RuntimeError(f"{what}: loss {losses[True]} vs oracle "
                           f"{float(ref)}")
    notes = []
    for n, ids in tables.items():
        want = p0[n] - lr * ref_g[n]
        e_dense = _rel_l2(after[True][n], after[False][n])
        e_ref = _rel_l2(after[True][n], want)
        spacing = float((after[True][n] - want).abs().max()) / (
            2.4e-7 * max(float(p0[n].abs().max()), 1e-30))
        keep = _untouched(p0[n].shape[0], ids, dev)
        if not (e_dense <= SPARSE_L2 and e_ref <= SPARSE_L2):
            raise RuntimeError(f"{what}: {n} after the sparse step is "
                               f"{e_dense:.3e} (dense) / {e_ref:.3e} (oracle) "
                               f"relative L2 away (limit {SPARSE_L2})")
        if not torch.equal(after[True][n][keep], p0[n][keep]):
            raise RuntimeError(f"{what}: untouched rows of {n} moved")
        notes.append(f"{n}: {e_dense:.3e} from the dense step, {e_ref:.3e} "
                     f"from p0 - lr g (at most {spacing:.2f} fp32 spacings), "
                     f"{int(keep.sum())} untouched rows bit for bit")
    print(f"{what} sparse = dense: loss {losses[True]!r} both (oracle "
          f"{float(ref):.6f}); " + "; ".join(notes) + f"; sgd under the sync "
          f"debug mode 'error'; launches {counts} [{card}]")
    return counts, srs


def _adam_oracle(P, M, g, b1p, b2p, touched):
    """The adam op's formula in plain torch on fp32 state: lr_t = lr
    sqrt(1 - b2^t) / (1 - b1^t) from the program's fp32 beta powers
    (1 - fp32(0.999) is 1.3e-5 from 0.001, which moves lr_t by 6e-6 of
    itself); where `touched` is given (a table's rows) only those rows
    move. Returns (p, m1, m2)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr_t = (1e-3 * torch.sqrt(1 - b2p) / (1 - b1p)).reshape(())
    m1 = b1 * M[0] + (1 - b1) * g
    m2 = b2 * M[1] + (1 - b2) * g * g
    p = P - lr_t * m1 / (torch.sqrt(m2) + eps)
    if touched is None:
        return p, m1, m2
    t = touched.reshape((-1,) + (1,) * (P.dim() - 1))
    return (torch.where(t, p, P), torch.where(t, m1, M[0]),
            torch.where(t, m2, M[1]))


def _lazy_adam_gate(dev, card, feeds):
    """Two Adam(1e-3) steps of the sparse DeepFM (batches 0 and 1) against
    a plain-torch lazy Adam on the oracle's gradients: after each step,
    fm_w1's and fm_emb's rows the step's ids miss bit for bit what they
    were before it in the parameter and both moments (in step 2 rows that
    step 1 moved, with moments a dense Adam would decay and apply), the
    touched rows within LAZY_ADAM_L2 relative L2 of the oracle, the adam
    ops under the sync debug mode "error"."""
    import paddle_tpu_torch as pt

    main, startup, _, loss, _, out_b = _ctr_program(
        True, lambda: pt.optimizer.Adam(1e-3))
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    adams = {op.inputs["Param"][0]: op for op in main.global_block.ops
             if op.type == "adam"}
    state = lambda: {n: tuple(scope.find_var(adams[n].inputs[s][0]).clone()  # noqa: E731
                              for s in ("Param", "Moment1", "Moment2"))
                     for n in names}
    ref = state()
    seen, notes = {}, []
    for step, feed in enumerate(feeds, 1):
        before = state()
        b1p, b2p = (scope.find_var(adams["fm_emb"].inputs[s][0]).clone()
                    for s in ("Beta1Pow", "Beta2Pow"))
        undo = _sync_free(("adam",), seen)
        try:
            exe.run(main, feed=feed, scope=scope, fetch_list=[loss],
                    return_numpy=False)
            torch.cuda.synchronize()
        finally:
            undo()
        after = state()
        P = {n: ref[n][0].clone().requires_grad_() for n in names}
        g = dict(zip(names, torch.autograd.grad(_dfm_loss(P, feed, out_b),
                                                [P[n] for n in names])))
        keep = _untouched(DFM_CFG["vocab_size"], feed["sparse_ids"], dev)
        ref = {n: _adam_oracle(ref[n][0], ref[n][1:], g[n], b1p, b2p,
                               ~keep if n in ("fm_w1", "fm_emb") else None)
               for n in names}
        for n in ("fm_w1", "fm_emb"):
            errs = {}
            for k, got, was, want in zip(("p", "m1", "m2"), after[n],
                                         before[n], ref[n]):
                if not torch.equal(got[keep], was[keep]):
                    raise RuntimeError(f"lazy Adam step {step}: untouched "
                                       f"rows of {n}'s {k} moved")
                errs[k] = _rel_l2(got[~keep], want[~keep])
                if not errs[k] <= LAZY_ADAM_L2:
                    raise RuntimeError(
                        f"lazy Adam step {step}: {n}'s {k} on the touched "
                        f"rows is {errs[k]:.3e} relative L2 from the oracle "
                        f"(limit {LAZY_ADAM_L2})")
            moved = int((before[n][1][keep] != 0).any(dim=-1).sum())
            notes.append(f"step {step} {n}: {int((~keep).sum())} touched rows "
                         f"within " + ", ".join(f"{k} {e:.3e}"
                                                for k, e in errs.items())
                         + f"; {int(keep.sum())} untouched rows bit for bit "
                           f"({moved} of them with nonzero moments)")
    if dev.type == "cuda" and seen.get("adam") != len(feeds) * len(names):
        raise RuntimeError(f"lazy Adam: {seen} adam dispatches")
    print(f"DeepFM lazy Adam: " + "; ".join(notes) + f"; "
          f"{seen.get('adam', 0)} adam ops under the sync debug mode 'error' "
          f"[{card}]")


def _check_loader(exe, main, batches, card):
    """DeviceLoader-staged feeds: copied on the placement's own side
    stream (not the consumer's), each tensor on the card and bit for bit
    the host array."""
    from paddle_tpu_torch.pipeline import DeviceLoader

    place = exe.feed_placer(main)
    staged = place(batches[0])
    if staged.stream is None or staged.event is None or \
            staged.stream == torch.cuda.current_stream():
        raise RuntimeError("loader: the batch was not copied on a side stream")
    side = staged.stream
    got = [staged.ready()] + list(DeviceLoader(
        lambda: iter(batches[1:8]), depth=2, placement=place))
    for feed, host in zip(got, batches[:8]):
        for k, a in host.items():
            t = feed[k]
            if not t.is_cuda or not torch.equal(t.cpu(), torch.from_numpy(a)):
                raise RuntimeError(f"loader: {k} differs from the host array")
    if len(got) != 8:
        raise RuntimeError(f"loader: {len(got)} batches of 8")
    print(f"ctr loader: 8 batches staged by DeviceLoader equal the host "
          f"arrays bit for bit, copied from pinned memory on the side stream "
          f"{side.cuda_stream:#x} (the consumer's is "
          f"{torch.cuda.current_stream().cuda_stream:#x}) [{card}]")


def ctr_deepfm(dev, card):
    """DeepFM CTR training through Executor.train_from_dataset at
    bench.py:423 bench_deepfm's widths, held by the gates of the parse,
    sparse = dense, the trainer loop, lazy Adam and the loader; then
    bench.py's report: examples/s end to end and on a resident batch,
    their ratio, the device's busy share and the host split."""
    import os
    import shutil

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import profiler as pprof

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        SMOKE_DATA, "ctr")
    shutil.rmtree(data, ignore_errors=True)
    os.makedirs(data)
    try:
        t0 = time.perf_counter()
        files = _write_ctr_files(data)
        print(f"ctr data: {CTR_FILES} files x {CTR_LINES} lines written in "
              f"{time.perf_counter() - t0:.2f} s (host)")
        flats = _check_parse(files, card)
        batches = _ctr_batches(flats)
        feed0 = _on(dev, batches[0])

        def build(sparse):
            main, startup, _, loss, _, out_b = _ctr_program(
                sparse, lambda: pt.optimizer.SGD(CTR_LR))
            return main, startup, loss, out_b

        counts, srs = _sparse_vs_dense(
            dev, card, f"DeepFM B={CTR_B}", build, feed0, _dfm_loss,
            {"fm_w1": feed0["sparse_ids"], "fm_emb": feed0["sparse_ids"]},
            CTR_LR)
        K = CTR_B * DFM_CFG["n_fields"]
        for n, sr in srs.items():
            if sr.rows.shape != (K,) or sr.height != DFM_CFG["vocab_size"]:
                raise RuntimeError(f"DeepFM: {n}@GRAD has {sr.rows.shape} "
                                   f"rows of height {sr.height}")
        _lazy_adam_gate(dev, card, [feed0, _on(dev, batches[1])])

        main, startup, test, loss, use_vars, _ = _ctr_program(
            True, lambda: pt.optimizer.SGD(CTR_LR))
        exe = pt.Executor()

        def dataset(threads):
            ds = pt.DatasetFactory().create_dataset("QueueDataset")
            ds.set_batch_size(CTR_B)
            ds.set_thread(threads)
            ds.set_use_var(use_vars)
            ds.set_filelist(files)
            return ds

        # one thread: file order, against the plain loop
        scope, plain = pt.Scope(), pt.Scope()
        exe.run(startup, scope=scope)
        exe.run(startup, scope=plain)
        (loss0,) = exe.run(test, feed=feed0, fetch_list=[loss], scope=scope)
        exe.train_from_dataset(main, dataset(1), scope=scope,
                               print_period=10**9)
        for b in batches:
            exe.run(main, feed=b, scope=plain)
        torch.cuda.synchronize()
        worst = max((_rel_l2(scope.find_var(p.name), plain.find_var(p.name)),
                     p.name) for p in main.all_parameters())
        if not worst[0] <= TRAINER_L2:
            raise RuntimeError(f"trainer: {worst[1]} after a one-thread pass is "
                               f"{worst[0]:.3e} relative L2 from the plain loop "
                               f"(limit {TRAINER_L2})")
        print(f"ctr trainer: one train_from_dataset pass on 1 thread over "
              f"{len(batches)} batches ends within {worst[0]:.3e} relative L2 "
              f"of a plain Executor.run loop (worst {worst[1]}; limit "
              f"{TRAINER_L2}) [{card}]")
        _check_loader(exe, main, batches, card)

        # four threads: the warm pass, then the timed passes
        pprof.stage_counters(reset=True)
        exe.train_from_dataset(main, dataset(CTR_THREADS), scope=scope,
                               print_period=10**9)
        snap = pprof.stage_counters(reset=True)
        n_b = snap["pipeline.host_ingest"]["events"]
        if n_b != len(batches) or snap["dataset.assemble"]["events"] != n_b:
            raise RuntimeError(f"trainer: a {CTR_THREADS}-thread pass consumed "
                               f"{snap}, not {len(batches)} batches")
        walls = []
        for _ in range(CTR_PASSES):
            pprof.stage_counters(reset=True)
            t0 = time.perf_counter()
            exe.train_from_dataset(main, dataset(CTR_THREADS), scope=scope,
                                   print_period=10**9)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            snap = pprof.stage_counters()
        n_ex = CTR_FILES * CTR_LINES
        e2e = [n_ex / w for w in walls]
        busy = _profile(lambda: exe.train_from_dataset(
            main, dataset(CTR_THREADS), scope=scope, print_period=10**9),
            card, "DeepFM train_from_dataset pass")
        dev_feed = {"sparse_ids": feed0["sparse_ids"],
                    "dense_x": feed0["dense_x"], "label": feed0["label"]}
        exe.run(main, feed=dev_feed, scope=scope)
        dev_windows = _timed_windows(lambda: exe.run(main, feed=dev_feed,
                                                     scope=scope),
                                     CTR_DEVICE_ITERS, CTR_DEVICE_WINDOWS)
        device = CTR_B / min(dev_windows)
        (loss1,) = exe.run(test, feed=feed0, fetch_list=[loss], scope=scope)
        if not (np.isfinite(loss1) and float(loss1) < float(loss0)):
            raise RuntimeError(f"DeepFM: batch 0's loss went from "
                               f"{float(loss0)} to {float(loss1)}")
        split = ", ".join(f"{k} {v['seconds']:.4f} s / {v['events']}"
                          for k, v in sorted(snap.items()))
        busy_txt = "not measured" if busy is None else f"{100 * busy:.1f}%"
        print(f"DeepFM train_from_dataset (B={CTR_B}, {CTR_THREADS} threads, "
              f"{n_ex} examples a pass): end to end {max(e2e):.1f} examples/s "
              f"(best of {CTR_PASSES} passes; passes {[round(x, 1) for x in e2e]}"
              f"), device path {device:.1f} examples/s (best of windows "
              f"{[round(1e3 * w, 3) for w in dev_windows]} ms a step), ratio "
              f"{max(e2e) / device:.3f}; device busy {busy_txt} of a pass; "
              f"host split of the last pass (thread-seconds / events): {split}"
              f"; batch 0's loss {float(loss0):.6f} -> {float(loss1):.6f} "
              f"[{card}]")
        return counts
    finally:
        shutil.rmtree(data, ignore_errors=True)


# -- tiered giant embeddings: bench.py:639 bench_deepfm_giant's TPU arm

# bench.py:652-656: fm_emb 10M x 16 fp32 (640 MB) against a 64 MB budget, 4
# files of 16384 zipf-1.5 lines, QueueDataset at B=2048 on 4 threads
GIANT_VOCAB, GIANT_BUDGET_MB, GIANT_FILES = 10_000_000, 64.0, 4
GIANT_SLOTS = 1 << 20                 # 64 MB / 64-byte rows
GIANT_EVICT_SLOTS = 8192              # ~4x a batch's distinct ids
# tools/gate.py:123 EMB_PARITY_ATOL and :129 EMB_HIT_RATE_FLOOR
EMB_PARITY_ATOL, EMB_HIT_RATE_FLOOR = 1e-4, 0.5
STALL_S, STALL_LIMIT_S = 0.3, 10.0    # the chaos drills' window and limit
EMB_FLAGS = ("emb_hbm_budget_mb", "emb_cache_slots", "emb_ckpt_base_every",
             "watchdog_stall_s", "max_inflight_steps")


def _write_giant_files(dirname):
    """bench.py:684-697's files: one line a sample, `26 ids 13 dense 1
    label`, the ids zipf(1.5) - 1 mod the vocabulary, drawn line by line
    from seed 0 as bench.py draws them."""
    import os

    nf, nd = DFM_CFG["n_fields"], DFM_CFG["n_dense"]
    rng = np.random.default_rng(SEED)
    files = []
    for fi in range(GIANT_FILES):
        p = os.path.join(dirname, f"part-{fi}")
        with open(p, "w") as f:
            for _ in range(CTR_LINES):
                ids = (rng.zipf(1.5, nf) - 1) % GIANT_VOCAB
                dense = rng.random(nd).round(4)
                lbl = rng.integers(0, 2)
                f.write(f"{nf} {' '.join(map(str, ids))} "
                        f"{nd} {' '.join(map(str, dense))} 1 {lbl}\n")
        files.append(p)
    return files


def _giant_program(budget_mb, slots=0):
    """DeepFM at bench_deepfm_giant's widths under SGD(CTR_LR) with
    FLAGS_emb_hbm_budget_mb = budget_mb (and FLAGS_emb_cache_slots =
    slots); returns (main, startup, loss, feed vars)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import flags, unique_name
    from paddle_tpu_torch.models import deepfm

    flags.set_flags({"emb_hbm_budget_mb": budget_mb,
                     "emb_cache_slots": slots})
    cfg = dict(DFM_CFG, vocab_size=GIANT_VOCAB)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        loss, _, feed_names = deepfm.deepfm(**cfg)
        pt.optimizer.SGD(CTR_LR).minimize(loss)
    startup.random_seed = SEED
    return (main, startup, loss,
            [main.global_block.var(n) for n in feed_names])


def _tiered_parity_on_card(dev, card):
    """bench.py:557 _tiered_parity on the card: a 512 x 8 table behind a
    256-slot cache (6 fields, B=32) and the dense-lookup program, 12 SGD(0.1)
    steps from the same values over the same batches: every parameter
    within EMB_PARITY_ATOL, evictions, and as many write-backs as
    evictions. Returns the tiered (main, startup, loss) for the drills."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import flags, layers as L, unique_name
    from paddle_tpu_torch.param_attr import ParamAttr

    V, D, F, B = 512, 8, 6, 32

    def minimized(budget, slots):
        flags.set_flags({"emb_hbm_budget_mb": budget,
                         "emb_cache_slots": slots})
        m, st = pt.Program(), pt.Program()
        m.random_seed = st.random_seed = 7
        with pt.program_guard(m, st), unique_name.guard():
            ids = L.data(name="ids", shape=[F], dtype="int64")
            label = L.data(name="label", shape=[1], dtype="float32")
            emb = L.embedding(ids, size=[V, D], is_sparse=True,
                              param_attr=ParamAttr(name="ptbl"))
            logit = L.fc(L.reduce_sum(emb, dim=1), size=1,
                         param_attr=ParamAttr(name="pw"),
                         bias_attr=ParamAttr(name="pb"))
            loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
            pt.optimizer.SGD(0.1).minimize(loss)
        return m, st, loss

    def feed(s):
        rng = np.random.default_rng(500 + s)
        return {"ids": rng.integers(0, V, (B, F)).astype(np.int64),
                "label": rng.integers(0, 2, (B, 1)).astype(np.float32)}

    exe = pt.Executor()
    dense, tiered = minimized(0.0, 0), minimized(0.001, 256)
    sd, st = pt.Scope(), pt.Scope()
    exe.run(dense[1], scope=sd)
    exe.run(tiered[1], scope=st)
    eng = tiered[0]._tiered_engine
    eng.tables["ptbl"].host.load_rows(np.arange(V),
                                      sd.find_var("ptbl").cpu().numpy())
    eng.tables["ptbl"].host.clear_dirty()
    for n in ("pw", "pb"):
        st.set_var(n, sd.find_var(n).clone())
    for s in range(12):
        exe.run(dense[0], feed=feed(s), fetch_list=[dense[2]], scope=sd)
        exe.run_async(tiered[0], feed=feed(s), fetch_list=[tiered[2]],
                      scope=st)
    exe.wait()
    eng.flush_all()
    stats = eng.stats("ptbl")
    drift = max(float(np.abs(eng.export_dense("ptbl", st)
                             - sd.find_var("ptbl").cpu().numpy()).max()),
                *(float((st.find_var(n) - sd.find_var(n)).abs().max())
                  for n in ("pw", "pb")))
    if not (drift <= EMB_PARITY_ATOL and stats["evictions"] > 0
            and stats["writebacks"] == stats["evictions"]):
        raise RuntimeError(f"tiered parity: drift {drift:.3e} (limit "
                           f"{EMB_PARITY_ATOL}), {stats}")
    print(f"tiered parity (bench.py:557 on the card): 12 SGD(0.1) steps of a "
          f"512 x 8 table behind a 256-slot cache end {drift:.3e} from the "
          f"dense-lookup program (limit {EMB_PARITY_ATOL}); "
          f"{stats['evictions']} evictions, {stats['writebacks']} write-backs, "
          f"hit rate {stats['hit_rate']} [{card}]")
    return tiered


def _giant_pass(exe, main, ds, scope):
    t0 = time.perf_counter()
    exe.train_from_dataset(main, ds, scope=scope, print_period=10**9)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _giant_arm(exe, main, startup, dataset):
    """A warm train_from_dataset pass and CTR_PASSES timed ones on 4
    threads: (examples/s of each timed pass, the scope, the last pass's
    stage counters)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import profiler as pprof

    scope = pt.Scope()
    exe.run(startup, scope=scope)
    _giant_pass(exe, main, dataset(CTR_THREADS), scope)
    rates = []
    for _ in range(CTR_PASSES):
        pprof.stage_counters(reset=True)
        rates.append(GIANT_FILES * CTR_LINES
                     / _giant_pass(exe, main, dataset(CTR_THREADS), scope))
    return rates, scope, pprof.stage_counters()


def _evicting_arm(dev, card, exe, files):
    """FLAGS_emb_cache_slots = GIANT_EVICT_SLOTS at full width: one
    one-thread pass (file order) of the tiered program, evicting every
    batch and writing back through the loader's async path, against the
    no-budget program over the same batches from the same values: fm_emb
    (export_dense) and every other parameter within EMB_PARITY_ATOL, as
    many write-backs as evictions; then two steps with every op's compute
    under the sync debug mode "error". Returns (the tiered program, its
    scope, the launches of the gated steps)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda_kernels as ck

    def dataset(prog_vars):
        ds = pt.DatasetFactory().create_dataset("QueueDataset")
        ds.set_batch_size(CTR_B)
        ds.set_thread(1)
        ds.set_use_var(prog_vars)
        ds.set_filelist(files)
        return ds

    tm, ts, tl, tvars = _giant_program(GIANT_BUDGET_MB, GIANT_EVICT_SLOTS)
    dm, ds_, dl, dvars = _giant_program(0.0)
    eng = tm._tiered_engine
    st, sd = pt.Scope(), pt.Scope()
    exe.run(ts, scope=st)
    exe.run(ds_, scope=sd)
    host = eng.tables["fm_emb"].host
    sd.set_var("fm_emb", torch.from_numpy(host.to_dense()).to(dev))
    names = [p.name for p in dm.all_parameters() if p.name != "fm_emb"]
    for n in names:
        st.set_var(n, sd.find_var(n).clone())
    t0 = time.perf_counter()
    exe.train_from_dataset(tm, dataset(tvars), scope=st, print_period=10**9)
    torch.cuda.synchronize()
    t_tiered = time.perf_counter() - t0
    exe.train_from_dataset(dm, dataset(dvars), scope=sd, print_period=10**9)
    torch.cuda.synchronize()
    eng.flush_all()
    stats = eng.stats("fm_emb")
    table = eng.export_dense("fm_emb", st)
    errs = {"fm_emb": float(np.abs(table - sd.find_var("fm_emb").cpu()
                                   .numpy()).max())}
    for n in names:
        errs[n] = float((st.find_var(n) - sd.find_var(n)).abs().max())
    worst = max(errs, key=errs.get)
    other = max((n for n in errs if n != "fm_emb"), key=errs.get)
    if not (errs[worst] <= EMB_PARITY_ATOL and stats["evictions"] > 0
            and stats["writebacks"] == stats["evictions"]):
        raise RuntimeError(f"evicting arm: {worst} {errs[worst]:.3e} from "
                           f"the dense program (limit {EMB_PARITY_ATOL}), "
                           f"{stats}")
    batches = _ctr_batches_of(files)
    types = sorted({op.type for op in tm.global_block.ops})
    seen = {}
    undo = _sync_free(types, seen)
    try:
        ck.reset_launch_counts()
        for b in batches[:2]:
            exe.run(tm, feed=b, fetch_list=[tl], scope=st,
                    return_numpy=False)
        torch.cuda.synchronize()
        counts = _check_launches(tm, "DeepFM giant, evicting")
    finally:
        undo()
    n_ops = sum(seen.values())
    if sorted(seen) != types or min(seen.values()) < 2:
        raise RuntimeError(f"evicting arm: op computes under the sync debug "
                           f"mode in 2 steps: {seen}")
    print(f"DeepFM giant, evicting arm (FLAGS_emb_cache_slots="
          f"{GIANT_EVICT_SLOTS}): a one-thread pass of {len(batches)} batches "
          f"in {t_tiered:.2f} s, {stats['evictions']} evictions, "
          f"{stats['writebacks']} write-backs landed off the step, hit rate "
          f"{stats['hit_rate']}, prefetch width {stats['prefetch_rows']} "
          f"({stats.get('prefetch_grows', 0)} grows); against the no-budget "
          f"program over the same batches: fm_emb (export_dense) "
          f"{errs['fm_emb']:.3e}, worst other {other} {errs[other]:.3e} "
          f"(limit {EMB_PARITY_ATOL}); 2 more steps with all {n_ops} op "
          f"computes ({len(types)} op types) under the sync debug mode "
          f"'error'; launches {counts} [{card}]")
    return tm, st, tl, batches, counts


def _ctr_batches_of(files):
    """The files' batches in file order, as the feed vars declare them."""
    from paddle_tpu_torch.native import parse_multislot_file

    return _ctr_batches([parse_multislot_file(p, list(CTR_WIDTHS))
                         for p in files])


def _delta_checkpoints(exe, card, main, scope, loss, batches, root):
    """CheckpointManager over the evicting arm's program with
    FLAGS_emb_ckpt_base_every=2: a save after each of 4 steps (full bases at
    the first and the third, deltas between), the host tier overwritten
    with zeros and restored: the table equal bit for bit to the snapshot
    after the 4th save, the cache cold, one more step's loss finite."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.resilience import CheckpointManager

    flags.set_flags({"emb_ckpt_base_every": 2})
    eng = main._tiered_engine
    host = eng.tables["fm_emb"].host
    mgr = CheckpointManager(root, main_program=main, scope=scope)
    secs, frags = [], []
    for step, b in enumerate(batches[2:6]):
        exe.run(main, feed=b, fetch_list=[loss], scope=scope)
        t0 = time.perf_counter()
        mgr.save(step, executor=exe)
        secs.append(time.perf_counter() - t0)
        frags.append(mgr.read_manifest(step)["extra"]["tiered_embedding"]
                     ["tables"]["fm_emb"])
    snap = eng.export_dense("fm_emb", scope)
    for sh in host.shards:
        sh[...] = 0
    t0 = time.perf_counter()
    got = mgr.restore(executor=exe)
    t_restore = time.perf_counter() - t0
    same = got == 3 and np.array_equal(host.to_dense(), snap)
    cold = not eng.tables["fm_emb"].row2slot
    (lv,) = exe.run(main, feed=batches[6], fetch_list=[loss], scope=scope)
    bases = [f["base_step"] for f in frags]
    if not (same and cold and np.isfinite(lv).all() and bases == [0, 0, 2, 2]):
        raise RuntimeError(f"delta checkpoints: restored step {got}, table "
                           f"equal {same}, cache cold {cold}, loss {lv}, "
                           f"bases {bases}")
    print(f"delta checkpoints (CheckpointManager, FLAGS_emb_ckpt_base_every="
          f"2): saves after 4 steps took {[round(s, 3) for s in secs]} s "
          f"(bases of {host.nbytes / 2**20:.0f} MiB at the 1st and 3rd, "
          f"deltas of {[f['delta_rows'] for f in frags]} rows); the zeroed "
          f"host tier restored in {t_restore:.3f} s, bit for bit the "
          f"snapshot, the cache cold; the next step's loss {float(lv):.6f} "
          f"[{card}]")


def _stall_drills(card, exe, small):
    """Chaos on the card, FLAGS_watchdog_stall_s = STALL_S: the
    emb_host_stall site parks the resolver on the DeviceLoader's thread,
    and pipeline_stall makes run_async's oldest step one that never
    completes; each must raise StallError (naming the DeviceLoader with its
    queue depth; naming the step with the steps in flight and the stage
    counters) within STALL_LIMIT_S."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.pipeline import DeviceLoader
    from paddle_tpu_torch.resilience import StallError, fault_scope

    main, startup, loss = small
    flags.set_flags({"watchdog_stall_s": STALL_S, "max_inflight_steps": 2})
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feeds = []
    for s in range(4):
        rng = np.random.default_rng(900 + s)
        feeds.append({"ids": rng.integers(0, 512, (32, 6)).astype(np.int64),
                      "label": rng.integers(0, 2, (32, 1)).astype(np.float32)})
    got = {}
    t0 = time.perf_counter()
    with fault_scope("emb_host_stall:2"):
        it = iter(DeviceLoader(lambda: iter(feeds), depth=1,
                               placement=exe.feed_placer(main)))
        exe.run_async(main, feed=next(it), fetch_list=[loss], scope=scope)
        try:
            for feed in it:
                exe.run_async(main, feed=feed, fetch_list=[loss], scope=scope)
        except StallError as e:
            got["emb_host_stall"] = (e, time.perf_counter() - t0)
        it.close()
    exe.wait()
    t0 = time.perf_counter()
    with fault_scope("pipeline_stall:1"):
        try:
            for feed in feeds[:3]:
                exe.run_async(main, feed=feed, fetch_list=[loss], scope=scope)
        except StallError as e:
            got["pipeline_stall"] = (e, time.perf_counter() - t0)
    exe.wait()
    ok = {
        "emb_host_stall": lambda e: "DeviceLoader" in e.what
        and "queue_depth" in e.state,
        "pipeline_stall": lambda e: "Executor async step" in e.what
        and len(e.state.get("inflight_step_ids", ())) == 3
        and "emb.resolved_batches" in e.state.get("profiler_stages", {})}
    for site, check in ok.items():
        if site not in got or not check(got[site][0]) or \
                got[site][1] > STALL_LIMIT_S:
            raise RuntimeError(f"stall drill {site}: {got.get(site)}")
    print(f"stall drills (FLAGS_watchdog_stall_s={STALL_S}): emb_host_stall "
          f"raised StallError in {got['emb_host_stall'][1]:.2f} s "
          f"({got['emb_host_stall'][0].what!r}, queue depth "
          f"{got['emb_host_stall'][0].state['queue_depth']}); pipeline_stall "
          f"in run_async's drain in {got['pipeline_stall'][1]:.2f} s "
          f"({got['pipeline_stall'][0].what!r}, in flight "
          f"{got['pipeline_stall'][0].state['inflight_step_ids']}) [{card}]")


def ctr_giant(dev, card):
    """DeepFM at bench.py:639 bench_deepfm_giant's TPU arm with its fm_emb
    (10M x 16 fp32, 640 MB) tiered behind a 64 MB device cache: bench.py:557's
    parity on the card, the full-width arm through train_from_dataset
    beside the same program with no budget, an evicting arm against the
    dense program, the host tier's delta checkpoints and the two stall
    drills. Returns the evicting arm's launches (none)."""
    import os
    import shutil

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import flags

    saved = {k: flags.get_flag(k) for k in EMB_FLAGS}
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        SMOKE_DATA, "giant")
    shutil.rmtree(data, ignore_errors=True)
    os.makedirs(data)
    try:
        small = _tiered_parity_on_card(dev, card)
        t0 = time.perf_counter()
        files = _write_giant_files(data)
        print(f"giant data: {GIANT_FILES} files x {CTR_LINES} zipf(1.5) lines "
              f"written in {time.perf_counter() - t0:.2f} s (host)")
        exe = pt.Executor()
        t0 = time.perf_counter()
        main, startup, loss, use_vars = _giant_program(GIANT_BUDGET_MB)
        t_build = time.perf_counter() - t0
        eng = getattr(main, "_tiered_engine", None)
        if eng is None or sorted(eng.tables) != ["fm_emb"] or \
                eng.tables["fm_emb"].slots != GIANT_SLOTS:
            raise RuntimeError(f"giant: the rewrite tiered "
                               f"{sorted(eng.tables) if eng else []}, not "
                               f"fm_emb at {GIANT_SLOTS} slots")

        def dataset(threads, vs=use_vars):
            ds = pt.DatasetFactory().create_dataset("QueueDataset")
            ds.set_batch_size(CTR_B)
            ds.set_thread(threads)
            ds.set_use_var(vs)
            ds.set_filelist(files)
            return ds

        rates, scope, snap = _giant_arm(exe, main, startup, dataset)
        busy = _profile(lambda: exe.train_from_dataset(
            main, dataset(CTR_THREADS), scope=scope, print_period=10**9),
            card, "DeepFM giant train_from_dataset pass")
        eng.flush_all()
        st = eng.stats("fm_emb")
        if not (st["hit_rate"] is not None
                and st["hit_rate"] >= EMB_HIT_RATE_FLOOR):
            raise RuntimeError(f"giant: hit rate {st['hit_rate']} below "
                               f"{EMB_HIT_RATE_FLOOR}: {st}")
        del main, startup, scope, eng
        dm, dst, _, dvars = _giant_program(0.0)
        drates, _, _ = _giant_arm(exe, dm, dst, lambda t: dataset(t, dvars))
        del dm, dst
        torch.cuda.empty_cache()
        split = ", ".join(f"{k} {v['seconds']:.4f} s / {v['events']}"
                          for k, v in sorted(snap.items()))
        busy_txt = "not measured" if busy is None else f"{100 * busy:.1f}%"
        print(f"DeepFM giant (bench.py:639, fm_emb {GIANT_VOCAB} x "
              f"{DFM_CFG['embed_dim']} fp32 tiered at FLAGS_emb_hbm_budget_mb="
              f"{GIANT_BUDGET_MB:g}: {st['slots']} slots, fm_w1 dense; host "
              f"tier {st['host_bytes'] / 2**20:.0f} MiB against the "
              f"{GIANT_BUDGET_MB:g} MiB budget; built in {t_build:.2f} s): "
              f"{max(rates):.1f} examples/s end to end (best of {CTR_PASSES} "
              f"passes on {CTR_THREADS} threads; passes "
              f"{[round(r, 1) for r in rates]}); the same program with no "
              f"budget (fm_emb dense on the card) {max(drates):.1f} (passes "
              f"{[round(r, 1) for r in drates]}), ratio "
              f"{max(rates) / max(drates):.3f}; hit rate {st['hit_rate']} "
              f"(floor {EMB_HIT_RATE_FLOOR}), {st['miss_ids']} missed and "
              f"{st['hit_ids']} hit id occurrences over {st['batches']} "
              f"batches, {st['resident_rows']} rows resident, prefetch width "
              f"{st['prefetch_rows']}, {st.get('evictions', 0)} evictions; "
              f"device busy {busy_txt} of a pass; stage counters of the last "
              f"timed pass (thread-seconds / events): {split} [{card}]")
        tm, ts, tl, batches, counts = _evicting_arm(dev, card, exe, files)
        _delta_checkpoints(exe, card, tm, ts, tl, batches,
                           os.path.join(data, "ckpt"))
        del tm, ts
        _stall_drills(card, exe, small)
        return counts
    finally:
        flags.set_flags(saved)
        shutil.rmtree(data, ignore_errors=True)


def sparse_word2vec(dev, card):
    """word2vec at the book's defaults with is_sparse=True at B =
    W2V_SPARSE_B: the sparse step against the dense step and the oracle as
    DeepFM's, and the shared table's grad the four lookups' SelectedRows
    concatenated (4 B rows of height 2000)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import word2vec

    rng = np.random.default_rng(SEED)
    feed = {f"w{i}": rng.integers(0, 2000, (W2V_SPARSE_B, 1)).astype(np.int32)
            for i in range(4)}
    feed["next_word"] = rng.integers(0, 2000, (W2V_SPARSE_B, 1)).astype(np.int32)
    feed = _on(dev, feed)
    ids = torch.cat([feed[f"w{i}"] for i in range(4)], dim=1)

    def build(sparse):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), unique_name.guard():
            loss, _, _ = word2vec.word2vec(is_sparse=sparse)
            pt.optimizer.SGD(BOOK_LR).minimize(loss)
        startup.random_seed = SEED
        return main, startup, loss, [(f"fc_{i}.w_0", f"fc_{i}.b_0")
                                     for i in range(2)]

    counts, srs = _sparse_vs_dense(dev, card, f"sparse word2vec "
                                   f"B={W2V_SPARSE_B}", build, feed,
                                   _w2v_loss, {"shared_w": ids}, BOOK_LR)
    sr = srs["shared_w"]
    if (sr.values.shape != (4 * W2V_SPARSE_B, 32) or sr.height != 2000
            or not torch.equal(torch.sort(sr.rows.long()).values,
                               torch.sort(ids.reshape(-1).long()).values)):
        raise RuntimeError(f"sparse word2vec: shared_w@GRAD is {sr}, not the "
                           f"four lookups' rows")
    print(f"sparse word2vec: shared_w@GRAD is one SelectedRows of "
          f"{sr.rows.shape[0]} rows (the four lookups' {W2V_SPARSE_B} each, "
          f"concatenated by backward's sums), height {sr.height} [{card}]")
    return counts


SEQ_B, SEQ_T, SEQ_D = 64, 100, 128
SEQ_RNN_B, SEQ_RNN_H, SEQ_PROJ = 32, 512, 256   # cudnn_lstm and lstmp, T=100
SEQ_ROW = (16, 200, 1024)            # row_conv's B, T, D (DeepSpeech2)
SEQ_L2 = 1e-5        # each output and grad on the card against the CPU


def _seq_cases():
    """(op, inputs {slot: {name: array}}, outputs, attrs, cotangent shapes
    {output: shape}) at the sizes users run: cudnn_lstm 2 layers
    bidirectional H=512 over D=512, B=32, T=100; lstmp size 4x512, proj
    256, B=32, T=100; row_conv DeepSpeech2's lookahead (D=1024, context 2,
    B=16, T=200); sequence_conv D=128, 128 filters, width 3; the rest at
    B=64, T=100, D=128 (match_matrix_tensor with 4 channels, its
    [64, 4, 100, 100] scores pooled by sequence_topk_avg_pooling)."""
    rng = np.random.default_rng(SEED)
    B, T, D = SEQ_B, SEQ_T, SEQ_D

    def f(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def lens(n, hi, lo=1):
        return rng.integers(lo, hi + 1, n).astype(np.int64)

    H, L, RB, P = SEQ_RNN_H, 2, SEQ_RNN_B, SEQ_PROJ
    nw = sum(2 * ((H if l == 0 else 2 * H) * 4 * H + H * 4 * H + 4 * H)
             for l in range(L))
    RWB, RWT, RWD = SEQ_ROW
    off = lens(B, T // 2, 0)
    return [
        ("sequence_slice", {"X": {"x": f(B, T, D)}, "Offset": {"off": off},
                            "Length": {"ln": np.minimum(lens(B, T // 2), T - off)}},
         {"Out": ["o"], "OutLength": ["ol"]}, {}, {"o": (B, T, D)}),
        ("sequence_erase", {"X": {"x": rng.integers(0, 20, (B, T)).astype(np.int64)},
                            "Length": {"ln": lens(B, T)}},
         {"Out": ["o"], "OutLength": ["ol"]}, {"tokens": [0, 3, 7]}, {}),
        ("sequence_expand_as", {"X": {"x": f(B, D)},
                                "Y": {"y": np.zeros((B * 4, D), np.float32)}},
         {"Out": ["o"]}, {}, {"o": (B * 4, D)}),
        ("sequence_scatter", {"X": {"x": f(B, T)},
                              "Ids": {"ids": rng.integers(0, T, (B, 10)).astype(np.int64)},
                              "Updates": {"upd": f(B, 10)},
                              "IdsLength": {"il": lens(B, 10)}},
         {"Out": ["o"]}, {}, {"o": (B, T)}),
        ("sequence_conv", {"X": {"x": f(B, T, D)},
                           "Filter": {"w": f(3 * D, D, scale=0.05)},
                           "Length": {"ln": lens(B, T)}},
         {"Out": ["o"]}, {"contextStart": -1, "contextLength": 3},
         {"o": (B, T, D)}),
        ("sequence_enumerate", {"X": {"x": rng.integers(0, 1000, (B, T)).astype(np.int64)},
                                "Length": {"ln": lens(B, T)}},
         {"Out": ["o"]}, {"win_size": 3, "pad_value": 0}, {}),
        ("sequence_reshape", {"X": {"x": f(B, T, D)}}, {"Out": ["o"]},
         {"new_dim": 2 * D}, {"o": (B, T // 2, 2 * D)}),
        ("match_matrix_tensor", {"X": {"x": f(B, T, D)}, "Y": {"y": f(B, T, D)},
                                 "W": {"w": f(D, 4, D, scale=0.05)},
                                 "XLength": {"xl": lens(B, T)},
                                 "YLength": {"yl": lens(B, T)}},
         {"Out": ["o"]}, {}, {"o": (B, 4, T, T)}),
        ("sequence_topk_avg_pooling", {"X": {"x": f(B, 4, T, T)},
                                       "RowLength": {"rl": lens(B, T)},
                                       "ColLength": {"cl": lens(B, T)}},
         {"Out": ["o"]}, {"topks": [1, 3, 5, 10], "channel_num": 4},
         {"o": (B, T, 16)}),
        ("lstmp", {"Input": {"x": f(RB, T, 4 * H, scale=0.5)},
                   "Weight": {"w": f(P, 4 * H, scale=0.05)},
                   "ProjWeight": {"pw": f(H, P, scale=0.05)},
                   "Bias": {"b": f(1, 4 * H, scale=0.1)}},
         {"Projection": ["p"], "Cell": ["c"]},
         {"proj_activation": "tanh"}, {"p": (RB, T, P), "c": (RB, T, H)}),
        ("cudnn_lstm", {"Input": {"x": f(RB, T, H)},
                        "W": {"w": f(nw, scale=0.04)},
                        "InitH": {"h0": f(2 * L, RB, H)},
                        "InitC": {"c0": f(2 * L, RB, H)}},
         {"Out": ["o"], "LastH": ["lh"], "LastC": ["lc"]},
         {"num_layers": L, "hidden_size": H, "is_bidirec": True,
          "dropout_prob": 0.0},
         {"o": (RB, T, 2 * H), "lh": (2 * L, RB, H), "lc": (2 * L, RB, H)}),
        ("row_conv", {"X": {"x": f(RWB, RWT, RWD)},
                      "Filter": {"w": f(3, RWD, scale=0.5)}},
         {"Out": ["o"]}, {}, {"o": (RWB, RWT, RWD)}),
    ]


def _seq_program(op, ins, outs, attrs, cots):
    """`op` over vars named as `ins`, and the grads of its outputs named in
    `cots` (fed cotangents) for its floating inputs that reach them, by the
    port's `gradients`: (program, feed names of the cotangents, fetch
    names)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name

    main = pt.Program()
    with pt.program_guard(main, pt.Program()), unique_name.guard():
        block = main.global_block
        diff = []
        for d in ins.values():
            for n, a in d.items():
                v = block.create_var(name=n, shape=a.shape, dtype=str(a.dtype),
                                     stop_gradient=a.dtype.kind != "f")
                if a.dtype.kind == "f" and not (op == "sequence_expand_as"
                                                and n == "y"):
                    diff.append(v)
        block.append_op(op, {s: list(d) for s, d in ins.items()}, outs, attrs)
        grads = []
        if cots:
            targets = [block.var(n) for n in cots]
            tgs = [block.create_var(name=n + "_cot", shape=s, dtype="float32")
                   for n, s in cots.items()]
            grads = [g.name for g in pt.gradients(targets, diff, tgs)
                     if g is not None]
    return main, [n for ns in outs.values() for n in ns] + grads


def seq_tail(dev, card):
    """The 12 new sequence and RNN ops on the card, forward and every grad,
    against the same program on the CPU (the port's own, which the CPU
    tests hold against the JAX package): fp32, TF32 off, each output and
    grad within SEQ_L2 relative L2 (integer outputs bit for bit); ms a run
    of each op's program (forward and grads) on the card."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda_kernels as ck

    gpu, cpu = pt.Executor(), pt.Executor(place="cpu")
    rng = np.random.default_rng(SEED + 1)
    rows = []
    for op, ins, outs, attrs, cot_shapes in _seq_cases():
        main, fetch = _seq_program(op, ins, outs, attrs, cot_shapes)
        feed = {n: a for d in ins.values() for n, a in d.items()}
        feed.update({n + "_cot": rng.standard_normal(s).astype(np.float32)
                     for n, s in cot_shapes.items()})
        dfeed = _on(dev, feed)
        ck.reset_launch_counts()
        got = gpu.run(main, feed=dfeed, fetch_list=fetch, scope=pt.Scope(),
                      return_numpy=False)
        torch.cuda.synchronize()
        _check_launches(main, op)
        want = cpu.run(main, feed=feed, fetch_list=fetch, scope=pt.Scope(),
                       return_numpy=False)
        worst = 0.0
        for n, g, w in zip(fetch, got, want):
            if not w.is_floating_point():
                if not torch.equal(g.cpu(), w):
                    raise RuntimeError(f"{op}: {n} differs on the card")
                continue
            e = _rel_l2(g.cpu(), w)
            if not e <= SEQ_L2:
                raise RuntimeError(f"{op}: {n} on the card is {e:.3e} "
                                   f"relative L2 from the CPU (limit {SEQ_L2})")
            worst = max(worst, e)
        scope = pt.Scope()
        windows = _timed_windows(lambda: gpu.run(
            main, feed=dfeed, fetch_list=fetch, scope=scope,
            return_numpy=False), 5, 3)
        n_grads = len(fetch) - sum(len(v) for v in outs.values())
        rows.append(f"{op} {1e3 * min(windows):.3f} ms ({n_grads} grads, "
                    f"worst {worst:.2e})")
    print(f"seq tail on the card against the CPU (relative L2 <= {SEQ_L2}; "
          f"ms a run of forward and grads, best of 3 windows of 5): "
          + "; ".join(rows) + f" [{card}]")


LN_FOCUS = ("K3/K5 (layer norm)", ("layer_norm",))
# the optimizer's update ops of a step, one profiler range each
UPDATE_OPS = "update ops"


BN_GRADS = "batch_norm grad"


# the WMT step's soft-label chain: one_hot -> label_smooth -> the cast of
# the label to bf16 -> the soft-label cross entropy, and its grad
SOFT_CHAIN = ("soft label chain", "soft label xent grad")


def _range_soft_chain():
    """Wrap the computes of the WMT step's soft-label chain in the
    profiler ranges SOFT_CHAIN; returns the function that unwraps them."""
    from paddle_tpu_torch.ops.registry import get_op_def

    saved = {}

    def wrap(op_type, name, pick=lambda op: True):
        d = get_op_def(op_type)
        plain = saved[op_type] = d.compute

        def compute(ctx):
            if not pick(ctx.op):
                return plain(ctx)
            with torch.profiler.record_function(name):
                return plain(ctx)
        d.compute = compute

    for t in ("one_hot", "label_smooth", "softmax_with_cross_entropy"):
        wrap(t, SOFT_CHAIN[0])
    wrap("cast", SOFT_CHAIN[0],
         lambda op: op.inputs["X"][0].startswith("label_smooth"))
    wrap("softmax_with_cross_entropy_grad", SOFT_CHAIN[1])

    def undo():
        for t, c in saved.items():
            get_op_def(t).compute = c
    return undo


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
    time (returned; None where the profiler saw no device time), and
    device time by kernel (single stream, so kernel times add up
    without overlap); each `focus` = (label, name patterns): those kernels'
    device time and launches on a line of their own; each of `ranges`, a
    (name, pattern, label) of a torch.profiler range: its calls and the
    kernels inside them (those whose name holds `pattern` counted apart as
    `label`'s)."""
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
        if e.device_type != DeviceType.CUDA or e.key in {r[0] for r in ranges}:
            continue          # a range's device span is no kernel of its own
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        print(f"profile {what}: torch.profiler saw no device time (not "
              f"measured) [{card}]")
        return None
    print(f"profile {what}: wall {wall_us / 1e3:.1f} ms (traced), device busy "
          f"{busy / 1e3:.1f} ms = {100 * busy / wall_us:.1f}% [{card}]")
    for us, n, key in sorted(rows, reverse=True)[:12]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / busy:5.1f}%  x{n:<6d} {key[:90]}")
    groups = {"bn_apply kernels (K8/K9)": ("bn_apply",),
              "flash attention kernels (K10/K11)": ("flash_",),
              "other hand-written kernels": (
                  "layer_norm", "attention", "prefill_mma", "attn_bwd",
                  "softmax_xent", "paged_decode", "bottleneck"),
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
    for name, own, label in ranges:
        calls, n, ms, hand, others = kernels_in_ranges(prof, name, own)
        mine = f"{hand} of them {label}, {n - hand} torch's: " if own else ""
        print(f"  inside the {calls} {name!r} calls: {n} kernel launches, "
              f"{ms:.3f} ms ({mine}{others}) [{card}]")
    return busy / wall_us


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
# rows, 10 or 5 K/V stages of 128 rows, 64 output rows a warpgroup); #15's
# wgmma kernel, csrc/bottleneck_block.cu (1024 bytes of slack, 8 KB atoms:
# 2 KC of w1 and w3, 9 of w2, 3 y1 tiles, 4 x and 4 residual atoms); K13,
# csrc/dma_probe.cu (6 stages of 32 KB)
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
                                       * 128 + 64 * NWG),
    "bottleneck_wg_kernel": lambda KC: 1024 + 8192 * (2 * KC + 20),
    "dma_probe_kernel": lambda: 6 * 32768}


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
    bf16_entries.append(check_paged_decode16(dev, timer, card))
    check_layer_norm_edges(dev, card)
    check_xent_edges(dev, card)
    tool_entry = check_bottleneck(dev, timer, card)
    flash32, flash16 = check_flash(dev, timer, card)
    entries += flash32
    bf16_entries += flash16
    probe_entries = [check_attn_probe(dev, timer, card),
                     check_dma_probe(dev, timer, card)]
    check_softmax_xent(dev, timer, card, N=S2S_B * S2S_T, V=S2S_DICT)
    del timer
    torch.cuda.empty_cache()
    eng, prompts, outs, serve_counts = serve(dev, card)
    if args.profile:
        def serve_pass():
            for p in prompts:
                eng.submit(p, max_new_tokens=SERVE_NEW)
            eng.run_until_drained()
        _profile(serve_pass, card, "serving pass")
    spec_counts = serve_spec(dev, card, eng, prompts, outs, args.profile)
    del eng
    torch.cuda.empty_cache()
    prefix_counts = serve_prefix(dev, card, args.profile)
    torch.cuda.empty_cache()
    serve16_counts = serve_bf16(dev, card, args.profile)
    torch.cuda.empty_cache()
    serve_bf16_faults(dev, card)
    torch.cuda.empty_cache()
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
        undo = _range_ops(("adam",), UPDATE_OPS)
        _profile(bert_amp_step, card, "BERT-base AMP training step (B=128)",
                 LN_FOCUS, ranges=((UPDATE_OPS, "", ""),))
        undo()
    del bert_amp_step
    torch.cuda.empty_cache()
    lamb_step, lamb_counts = train_bert_lamb(dev, card)
    if args.profile:
        undo = _range_ops(("lamb",), UPDATE_OPS)
        _profile(lamb_step, card, "BERT-base AMP training step under LAMB "
                 "(B=128)", LN_FOCUS, ranges=((UPDATE_OPS, "", ""),))
        undo()
    del lamb_step
    torch.cuda.empty_cache()
    check_optimizers(dev, card)
    torch.cuda.empty_cache()
    rn_amp_step, rn_amp_counts = train_resnet_amp(dev, card)
    if args.profile:
        from paddle_tpu_torch.ops import nn_ops
        bn_backward = nn_ops._bn_backward
        nn_ops._bn_backward = ranged(bn_backward, BN_GRADS)
        _profile(rn_amp_step, card, "ResNet-50 AMP training step (B=128)",
                 ranges=((BN_GRADS, "bn_apply", "K9's"),))
        nn_ops._bn_backward = bn_backward
    del rn_amp_step
    torch.cuda.empty_cache()
    wmt_step, wmt_counts = train_wmt_amp(dev, card)
    if args.profile:
        undo = _range_soft_chain()
        _profile(wmt_step, card, f"WMT Transformer-base AMP training step "
                 f"(B={WMT_B}, src=tgt={WMT_S})", LN_FOCUS,
                 ("bf16 K2/K4", ("prefill_mma", "attn_bwd")),
                 ranges=tuple((n, "", "") for n in SOFT_CHAIN))
        undo()
    del wmt_step
    torch.cuda.empty_cache()
    wmt_drop_counts = train_wmt_dropout(dev, card)
    torch.cuda.empty_cache()
    s2s_counts, dec_counts = train_seq2seq(dev, card, args.profile)
    torch.cuda.empty_cache()
    mnist_counts = train_mnist(dev, card)
    torch.cuda.empty_cache()
    long_step, long_counts, plain = train_bert_amp(dev, card, LONG_B, LONG_S,
                                                   flash=True, keep=True)
    if args.profile:
        _profile(long_step, card, f"long-context BERT-base AMP training step "
                 f"(B={LONG_B}, S={LONG_S})", LN_FOCUS)
    del long_step
    torch.cuda.empty_cache()
    rc_step, rc_counts = train_bert_recompute(dev, card, plain)
    if args.profile:
        _profile(rc_step, card, f"long-context BERT-base AMP training step "
                 f"under RecomputeOptimizer (B={LONG_B}, S={LONG_S})",
                 LN_FOCUS, ("K10/K11", ("flash_",)))
    del plain, rc_step
    torch.cuda.empty_cache()
    infer_rn_counts, _ = infer_resnet(dev, card)
    torch.cuda.empty_cache()
    infer_bert_counts, _ = infer_bert(dev, card)
    torch.cuda.empty_cache()
    rc_rn_counts, rc_rn_step = recompute_resnet(dev, card)
    if args.profile:
        _profile(rc_rn_step, card, f"ResNet-50 AMP training step under "
                 f"RecomputeOptimizer (B={AMP_B})")
    del rc_rn_step
    torch.cuda.empty_cache()
    book_counts = book_rest(dev, card)
    torch.cuda.empty_cache()
    ctr_counts = ctr_deepfm(dev, card)
    torch.cuda.empty_cache()
    giant_counts = ctr_giant(dev, card)
    torch.cuda.empty_cache()
    w2v_sparse_counts = sparse_word2vec(dev, card)
    torch.cuda.empty_cache()
    seq_tail(dev, card)
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
    # all fp32; the prefix-cache (K1-K3) and speculative (K2, K3) serving
    # phases in fp32 and the bf16 serving phase (K1-K3 bf16); the AMP BERT (K2-K7: bf16, and K3/K5 fp32 for the embedding
    # layer norm) and ResNet-50 (K6-K9 bf16) steps, the AMP BERT step under
    # LAMB (as under Adam); the long-context AMP
    # step (K10/K11 bf16, K3/K5-K7 as at S=128) and fp32 step (K3, K5-K7,
    # K10/K11 fp32); the WMT AMP step (K2-K5 bf16) and its dropout step
    # (K3/K5 bf16); the seq2seq step and the MNIST steps (K6/K7 fp32), the
    # seq2seq decode (none), the recompute step (K10 twice a layer, K11,
    # K3/K5 bf16 in the replays, K6/K7 bf16); the ResNet-50 and BERT-base
    # predictors (K8 in inference mode; K2 and K3), fp32 and bf16; the
    # ResNet-50 AMP step under recompute (K8 twice a batch norm, K9 in the
    # replays, K6 twice, K7 in its replay); word2vec and DeepFM, dense
    # and sparse, and the sequence/RNN tail (none);
    # #15's, K12's and K13's own paths (their launches set by their checks)
    runs = [{n: {"float32": c} for n, c in counts.items() if c}
            for counts in (serve_counts, train_counts, rn_counts,
                           long32_counts)]
    runs += [prefix_counts, spec_counts, serve16_counts, bert_amp_counts,
             lamb_counts, rn_amp_counts, wmt_counts, wmt_drop_counts,
             long_counts, s2s_counts, dec_counts, *mnist_counts, rc_counts,
             *infer_rn_counts, *infer_bert_counts, rc_rn_counts, *book_counts,
             ctr_counts, giant_counts, w2v_sparse_counts]
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
