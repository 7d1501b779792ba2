"""The port's attention and layer-norm kernels and the training steps that
run them, timed, for comparing two checkouts of the repo on one card: the
fp32 flash pair (K10, K11) and the long-context fp32 step by default, the
fp32 short-sequence pair (K2, K4) and the BERT-base step with `--kernels
short`, the bf16 flash pair and the long-context AMP step with `--kernels
flash_bf16`, the layer norm (K3, K5) and the BERT-base AMP and fp32 steps
with `--kernels layer_norm`, the softmax cross-entropy backward (K7), the
attention probe (K12) and the BERT-base steps with `--kernels xent_probe`;
the batch-norm apply (K8), its output digests and the MobileNetV3-Large
and ResNet-50 AMP steps with `--kernels bn_apply`; the fused bottleneck
block (#15) and the copy probe (K13) beside their library calls with
`--kernels probes`; with `--kernels variants --edits FILE`, design
alternatives of K7, K8, K12, #15 or K13 beside the source as it is.

It builds the kernels of the `paddle_tpu_torch` under `--root` (default:
this script's directory) and takes that checkout's `chip_smoke.py` helpers
(timer, BERT-base configuration and batch; for `--kernels layer_norm` and
`bn_paged` also its profiler-range helpers `ranged` and
`kernels_in_ranges`). Then:
  * K10 and K11 at chip_smoke's fp32 shapes of `check_flash` (B=4, nh=12,
    S=1024, dh=64; causal B=2, S=1024; causal B=2, nh=4, S=1000, dh=128),
    each held against its plain version and timed (CUDA events, L2
    flushed, median of 15), K11 split into its two passes by
    torch.profiler;
  * the long-context fp32 step (BERT-base, B=4, S=1024,
    use_flash_attention, Adam) built through the port's entry points and
    traced `--steps` times with torch.profiler: wall time, device busy
    time, and K10/K11's device time and launches.
With `--kernels short`, instead:
  * fp32 K2 at chip_smoke's timed shapes of `check_prefill` (B=1, nh=12,
    dh=64, causal S=8..512; B=2, S=128, kv_lens [100, 0]; B=32, S=128)
    and fp32 K4 at those of `check_attention_backward` (B=32, S=128; B=4,
    S=512; causal B=2, S=128, kv_lens [100, 0]), each held against its
    plain version and timed as above; K4's query/key pair also at S <= 128
    where the checkout has `attention_backward_pair`;
  * the BERT-base fp32 step (B=32, S=128, Adam(1e-4)) built through the
    port's entry points and traced `--steps` times: wall time, device busy
    time, and K2/K4's device time and launches.
With `--kernels flash_bf16`, instead:
  * bf16 K10 and K11 at chip_smoke's bf16 shapes of `check_flash` (B=8,
    nh=12, S=2048, dh=64; causal B=2, S=2048; B=2, nh=4, S=1000, dh=128),
    each held against its plain version and timed as above, K11 split
    into its two passes by torch.profiler;
  * the long-context AMP step (BERT-base, B=8, S=2048,
    use_flash_attention, decorate(Adam)) traced `--steps` times: wall
    time, device busy time, and K10/K11's device time and launches.
With `--kernels layer_norm`, instead:
  * K3 and K5 (layer norm forward and backward) at chip_smoke's shapes
    (fp32 R = 1, 8, 512, 4096 and bf16 R = 16384, K = 768), each held
    against its plain version and timed as above;
  * the BERT-base AMP step (B=128, S=128, decorate(Adam)) and fp32 step
    (B=32) traced `--steps` times each: wall time, device busy time, the
    kernels whose names hold `layer_norm` (time and launches), and the
    device-timeline spans of K3's and K5's wrapper calls (their kernels,
    any torch reductions beside them and the gaps between, from
    torch.profiler ranges around the calls).
With `--kernels bn_paged`, instead:
  * K9 in its chain mode as the checkout's training step runs it (dx,
    dscale, dbias) at chip_smoke's main-path fp32 shapes and its bf16 "cl"
    shapes, timed as above and split by torch.profiler into pass 1, the
    fold (whatever runs between the first and the last K9 kernel) and
    pass 2 (one kernel: by its own clock); K1 at chip_smoke's serving
    shape, at one row of 500 slots and at 8 rows of 4000;
  * the ResNet-50 AMP step (B=128) traced `--steps` times: wall, device
    busy time, K9's time and launches, and the kernels launched inside the
    batch-norm grad ops (K9's and torch's); then as many traced serving
    passes (chip_smoke's six prompts, 16 new tokens each) with K1's device
    time and launches.
With `--kernels bn_apply`, instead:
  * K8 (batch-norm apply, forward) at chip_smoke's fp32 BN_SHAPES, bf16
    BN_SHAPES_AMP and MobileNetV3's BN_MBV3, one row a map size (the
    lists kept here as K8_SHAPES: a parent's chip_smoke may lack them),
    held against its plain version, timed as above beside its bound,
    torch's own elementwise kernel over the same bytes (add, or neg
    without a residual) and, at the identity shapes without a residual,
    inference-mode F.batch_norm over the same statistics; K8 and the
    elementwise kernel again with the L2 holding clean lines (a 96 MB read
    after the flush); each output's SHA-256 over its bytes, from inputs
    seeded alike in every checkout, so two checkouts compare bit for bit;
  * the MobileNetV3-Large (B=128, fp32 NCHW) and ResNet-50 AMP (B=128)
    training steps traced `--steps` times each: wall, device busy time,
    and K8's device time and launches a step.
With `--kernels xent_probe`, instead:
  * K7 (softmax cross-entropy backward) in both modes, recomputed and
    saved statistics, at chip_smoke's fp32 (N=4096) and bf16 (N=16384)
    shapes, V=30522, held against its plain version and timed as above,
    with K6 (the forward, unchanged) beside it as a control and the
    forward op's unread `Softmax` output (nn_ops.py's
    `softmax_with_cross_entropy`) timed alone;
  * K12's seven variants at the tool's shape, with SDPA and q + v;
  * the BERT-base AMP (B=128) and fp32 (B=32) steps traced `--steps`
    times each: wall, device busy time, K7's time and launches, and the
    kernels the forward xent op launches besides K6 (the glue).
With `--kernels probes`, instead:
  * #15 at the tool's shape (B=128, 56x56, C=256, M=64) held against its
    plain version, then `--steps` rounds of: #15 and the library chain
    (three bf16 F.conv2d) timed as above, and in the tool's chained
    protocol (`bottleneck.ab`: ms a block over K_CHAIN = 10 blocks, L2
    warm); K13's six rows (both layouts, bb = 1, 4, 16), each equal to 2 x,
    beside x * 2.0, timed as above.
With `--kernels variants --edits FILE`, instead: FILE is JSON, {"kernel":
"k7", "k8", "k12", "b15" or "k13", "variants": {name: [[old, new], ...]}},
each variant a list of text edits of the kernel's source
(csrc/softmax_xent_bwd.cu, csrc/bn_apply.cu, csrc/attn_probe.cu,
csrc/bottleneck_block.cu or csrc/dma_probe.cu; an edit that no longer
matches raises). Each variant and the source as it is ("as
built") are compiled by nvcc in parallel into libraries of their own under
build/variants/, held against the plain version (a variant that disagrees
is reported and not timed) and timed in turns, `--steps` rounds: K7 in
both modes at the BERT-base lm head (fp32 N=4096, bf16 N=16384, V=30522),
K8 at K8_SHAPES, K12's seven variants at the tool's shape with SDPA and q + v, #15's wgmma
kernel at the tool's shape (held at the tool's and the unit inputs, timed
at the tool's) with the library chain, or K13's six rows with x * 2.0.
Run it on two checkouts in turn, alternating (A B B A), each in a process
of its own:

    python3 flash_ab.py --root /path/to/checkout --label parent
    python3 flash_ab.py --kernels short --root /path/to/checkout --label parent
    python3 flash_ab.py --kernels flash_bf16 --root /path/to/checkout --label parent
    python3 flash_ab.py --kernels layer_norm --root /path/to/checkout --label parent
    python3 flash_ab.py --kernels bn_paged --root /path/to/checkout --label parent
    python3 flash_ab.py --kernels bn_apply --root /path/to/checkout --label parent
    python3 flash_ab.py --kernels xent_probe --root /path/to/checkout --label parent
    python3 flash_ab.py --kernels probes --root /path/to/checkout --label parent

and the variants of one checkout in one process:

    python3 flash_ab.py --kernels variants --edits k7_variants.json

Each line ends with the card's name and power limit."""
import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch


def _trace(fn, pats=("flash_",), ranges=()):
    """(wall ms, device busy ms, {kernel: (launches, ms)} of the kernels
    whose names hold one of `pats`, {range: (calls, ms)} of the device-
    timeline span of each torch.profiler range named in `ranges`, from its
    first kernel's start to its last kernel's end) of one call of `fn`
    under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, hit, spans = 0.0, {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.key in ranges:      # a range's span on the device timeline
            spans[e.key] = (e.count, round(e.self_device_time_total / 1e3, 4))
            continue
        busy += e.self_device_time_total / 1e3
        if any(p in e.key for p in pats):     # instantiations summed by name
            name = e.key.replace("(anonymous namespace)::", "").split(
                "<")[0].split("::")[-1].split("(")[0]
            n, ms = hit.get(name, (0, 0.0))
            hit[name] = (n + e.count,
                         round(ms + e.self_device_time_total / 1e3, 4))
    return wall, busy, hit, spans


def _bert_step(cs, S, flash, amp=False, B=None):
    """One BERT-base training step at `S` through the port's entry points,
    on chip_smoke's seeded weights and batch: fp32, or under AMP
    (decorate(Adam)) at the long-context batch unless `B` is given."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import transformer

    cfg = cs._bert_cfg(S, flash=flash)
    main_p, startup = pt.Program(), pt.Program()
    with pt.program_guard(main_p, startup), unique_name.guard():
        avg_loss, _ = transformer.bert_pretrain(cfg, seq_len=S)
        opt = pt.optimizer.Adam(learning_rate=cs.TRAIN_LR)
        (mixed_precision.decorate(opt) if amp else opt).minimize(avg_loss)
    startup.random_seed = cs.SEED
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    B = B or (cs.LONG_B if amp else cs.LONG_FP32_B if flash else cs.TRAIN_B)
    feed = cs._bert_feed(cfg, B, S)

    def step():
        exe.run(main_p, feed=feed, scope=scope, fetch_list=[avg_loss],
                return_numpy=False)
    return B, step


def _traced_steps(step, what, label, pats, steps, tag, card):
    step()                                   # every GEMM shape met once
    for rep in range(steps):
        wall, busy, hit, _ = _trace(step, pats)
        ms = sum(t for _, t in hit.values())
        print(f"{tag} {what} trace {rep}: wall {wall:.1f} ms, device busy "
              f"{busy:.1f} ms = {100 * busy / wall:.1f}%, {label} {ms:.3f} ms "
              f"= {100 * ms / busy:.1f}% of busy {hit} [{card}]", flush=True)


def _short(cs, dev, card, timer, tag, steps):
    """fp32 K2 and K4 at chip_smoke's timed shapes, then the traced BERT
    fp32 steps."""
    from paddle_tpu_torch.ops.cuda_kernels import attention_bwd as K4
    from paddle_tpu_torch.ops.cuda_kernels import prefill_attention as K2

    g = torch.Generator(device="cpu").manual_seed(cs.SEED + 21)
    nh, dh = 12, 64
    sc = dh ** -0.5
    lens = [100, 0]
    cases = [(1, S, None, True) for S in (8, 100, 128, 256, 512)]
    cases += [(2, 128, lens, True), (32, 128, None, False)]
    for B, S, kv, causal in cases:
        q, k, v = (torch.randn((B, nh, S, dh), generator=g).to(dev)
                   for _ in range(3))
        kl = None if kv is None else torch.tensor(kv, dtype=torch.int32,
                                                  device=dev)
        cs._agree("causal_prefill_attention",
                  K2.causal_prefill_attention(q, k, v, causal, sc, kl),
                  K2.causal_prefill_attention_plain(q, k, v, causal, sc, kl))
        ms = timer(lambda: K2.causal_prefill_attention(q, k, v, causal, sc,
                                                       kl))
        print(f"{tag} K2 fp32 B={B} nh={nh} S={S} dh={dh} causal={causal} "
              f"kv_lens={kv}: {ms:.4f} ms [{card}]", flush=True)
    for B, S, causal, kv in ((32, 128, False, None), (4, 512, False, None),
                             (2, 128, True, lens)):
        q, k, v, do = (torch.randn((B, nh, S, dh), generator=g).to(dev)
                       for _ in range(4))
        kl = None if kv is None else torch.tensor(kv, dtype=torch.int32,
                                                  device=dev)
        fns = [K4.attention_backward]
        if S <= 128 and hasattr(K4, "attention_backward_pair"):
            fns.append(K4.attention_backward_pair)
        want = K4.attention_backward_plain(q, k, v, do, causal, sc, kl)
        times = {}
        for fn in fns:
            for n, o, r in zip("qkv", fn(q, k, v, do, causal, sc, kl), want):
                cs._agree(f"{fn.__name__} d{n}", o, r)
            times[fn.__name__] = round(timer(
                lambda: fn(q, k, v, do, causal, sc, kl)), 4)
        print(f"{tag} K4 fp32 B={B} nh={nh} S={S} dh={dh} causal={causal} "
              f"kv_lens={kv}: {times} ms [{card}]", flush=True)
        del q, k, v, do, want
    torch.cuda.empty_cache()
    B, step = _bert_step(cs, cs.TRAIN_S, flash=False)
    _traced_steps(step, f"BERT-base fp32 step B={B} S={cs.TRAIN_S}", "K2/K4",
                  ("prefill_attention", "attn_bwd"), steps, tag, card)
    return 0


def _flash_bf16(cs, dev, card, timer, tag, steps):
    """bf16 K10 and K11 at chip_smoke's bf16 shapes, then the traced
    long-context AMP steps."""
    from paddle_tpu_torch.ops.cuda_kernels import flash_attention as K10
    from paddle_tpu_torch.ops.cuda_kernels import flash_attention_bwd as K11

    g = torch.Generator(device="cpu").manual_seed(cs.SEED + 20)
    for B, nh, S, dh, causal in ((cs.LONG_B, 12, cs.LONG_S, 64, False),
                                 (2, 12, 2048, 64, True),
                                 (2, 4, 1000, 128, False)):
        q, k, v, do = (torch.randn((B, nh, S, dh), generator=g).to(
            dev, torch.bfloat16) for _ in range(4))
        sc = dh ** -0.5
        out, lse = K10.flash_attention_fwd(q, k, v, causal, sc)
        ref, ref_lse = K10.flash_attention_fwd_plain(q, k, v, causal, sc)
        cs._agree16("flash_attention_fwd out", out, ref)
        cs._agree("flash_attention_fwd lse", lse, ref_lse)
        bwd = lambda: K11.flash_attention_backward(  # noqa: E731
            q, k, v, ref, ref_lse, do, causal, sc)
        want = K11.flash_attention_backward_plain(q, k, v, ref, ref_lse, do,
                                                  causal, sc)
        for n, o, r in zip("qkv", bwd(), want):
            cs._agree16(f"flash_attention_backward d{n}", o, r, floor=2e-2)
        fwd_ms = timer(lambda: K10.flash_attention_fwd(q, k, v, causal, sc))
        bwd_ms = timer(bwd)
        passes = {n: round(ms / c, 4) for n, (c, ms) in _trace(bwd)[2].items()}
        print(f"{tag} bf16 B={B} nh={nh} S={S} dh={dh} causal={causal}: K10 "
              f"{fwd_ms:.4f} ms, K11 {bwd_ms:.4f} ms (passes, traced: "
              f"{passes}) [{card}]", flush=True)
        del q, k, v, do, out, lse, ref, ref_lse, want
        torch.cuda.empty_cache()
    B, step = _bert_step(cs, cs.LONG_S, flash=True, amp=True)
    _traced_steps(step, f"long-context AMP step B={B} S={cs.LONG_S}",
                  "K10/K11", ("flash_",), steps, tag, card)
    return 0


def _layer_norm(cs, dev, card, timer, tag, steps):
    """K3 and K5 at chip_smoke's shapes, then the traced BERT-base AMP and
    fp32 steps with the device time inside K3's and K5's calls."""
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.ops.cuda_kernels import layer_norm as K3
    from paddle_tpu_torch.ops.cuda_kernels import layer_norm_bwd as K5

    g = torch.Generator(device="cpu").manual_seed(cs.SEED + 22)
    Kd = 768
    for dt, R in ((torch.float32, 1), (torch.float32, 8), (torch.float32, 512),
                  (torch.float32, 4096), (torch.bfloat16, cs.AMP_B * cs.AMP_S)):
        x, dy = (torch.randn((R, Kd), generator=g).to(dev, dt) for _ in range(2))
        s = (1 + 0.1 * torch.randn((Kd,), generator=g)).to(dev)
        b = (0.1 * torch.randn((Kd,), generator=g)).to(dev)
        hold = cs._agree16 if dt == torch.bfloat16 else cs._agree
        hold("layer_norm_act y", K3.layer_norm_act(x, s, b)[0],
             K3.layer_norm_act_plain(x, s, b)[0])
        got = K5.layer_norm_act_backward(x, s, b, dy)
        ref = K5.layer_norm_act_backward_plain(x, s, b, dy)
        hold("layer_norm_act_backward dx", got[0], ref[0])
        for n, o, r in zip(("dscale", "dbias"), got[1:], ref[1:]):
            cs._agree(f"layer_norm_act_backward {n}", o, r, atol=1e-4)
        k3 = timer(lambda: K3.layer_norm_act(x, s, b))
        k5 = timer(lambda: K5.layer_norm_act_backward(x, s, b, dy))
        print(f"{tag} {str(dt)[6:]} R={R} K={Kd}: K3 {k3:.4f} ms, K5 {k5:.4f} "
              f"ms [{card}]", flush=True)
        del x, dy, got, ref
    torch.cuda.empty_cache()

    # profiler ranges around the wrappers as the layer_norm op calls them
    spans = ("layer_norm_act call", "layer_norm_act_backward call")
    nn_ops.layer_norm_act = cs.ranged(nn_ops.layer_norm_act, spans[0])
    nn_ops.layer_norm_act_backward = cs.ranged(
        nn_ops.layer_norm_act_backward, spans[1])
    for what, amp, B in ((f"BERT-base AMP step B={cs.AMP_B} S={cs.AMP_S}",
                          True, cs.AMP_B),
                         (f"BERT-base fp32 step B={cs.TRAIN_B} S={cs.TRAIN_S}",
                          False, cs.TRAIN_B)):
        _, step = _bert_step(cs, cs.AMP_S if amp else cs.TRAIN_S, flash=False,
                             amp=amp, B=B)
        step()
        for rep in range(steps):
            wall, busy, hit, inside = _trace(step, ("layer_norm",), spans)
            ms = sum(t for _, t in hit.values())
            span = sum(t for _, t in inside.values())
            print(f"{tag} {what} trace {rep}: wall {wall:.1f} ms, device busy "
                  f"{busy:.1f} ms = {100 * busy / wall:.1f}%, layer_norm "
                  f"kernels {ms:.3f} ms {hit}, the wrappers' calls span "
                  f"{span:.3f} ms {inside} [{card}]", flush=True)
        del step
        torch.cuda.empty_cache()
    return 0


def _k9_step_call(KB, x, p, dy, act, res, mode):
    """K9's chain mode as the checkout's training step runs it, giving dx,
    dscale and dbias: one call with the count M where the wrapper takes it,
    else the two-pass call with the statistics chain as a callable and the
    parameter gradients from its sums (the step's torch ops around it)."""
    import inspect

    scale, _, mean, inv = p
    R, row = x.shape
    M = R * row // scale.shape[0]
    if "count" in inspect.signature(KB.bn_apply_act_backward).parameters:
        return lambda: KB.bn_apply_act_backward(x, *p, dy, act, res, mode, M)

    def chain(p1, p2):
        _, _, dmean, dinv = KB.bn_param_grads(p1, p2, scale, inv)
        dvar = -0.5 * inv * inv * inv * dinv
        return (dmean - 2.0 * mean * dvar) / M, 2.0 * dvar / M

    def call():
        dx, dres, p1, p2 = KB.bn_apply_act_backward(x, *p, dy, act, res,
                                                    mode, chain)
        return (dx, dres, *KB.bn_param_grads(p1, p2, scale, inv)[:2])
    return call


def _k9_split(call):
    """(pass 1, fold, pass 2) device ms of one two-pass K9 chain call under
    torch.profiler, the host a spin ahead: the first and last K9 kernels'
    durations, and the time from the first's end to the last's start (the
    fold, whatever runs it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2_000_000)
        call()
        torch.cuda.synchronize()
    k = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == DeviceType.CUDA and "bn_apply" in e.name)
    if not k:
        return "not measured (the trace held no K9 kernel)"
    if len(k) == 1:
        return round((k[0][1] - k[0][0]) / 1e3, 4), 0.0, 0.0
    return tuple(round(t / 1e3, 4) for t in (
        k[0][1] - k[0][0], k[-1][0] - k[0][1], k[-1][1] - k[-1][0]))


def _resnet_amp_step(cs, dev):
    """One ResNet-50 AMP training step (B=128, NHWC, s2d stem,
    decorate(Momentum)) through the port's entry points, on chip_smoke's
    seeded weights and a seeded batch."""
    import numpy as np

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.models import resnet

    main_p, startup = pt.Program(), pt.Program()
    with pt.program_guard(main_p, startup), unique_name.guard():
        img = L.data(name="img", shape=[cs.RN_HW, cs.RN_HW, 3], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        loss, _, _ = resnet.resnet50(img, label, num_classes=cs.RN_CLASSES,
                                     s2d_stem=True, data_format="NHWC")
        amp.decorate(pt.optimizer.Momentum(cs.RN_FALL_LR, cs.RN_MU)).minimize(loss)
    startup.random_seed = cs.SEED
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(cs.SEED)
    feed = {"img": torch.from_numpy(rng.standard_normal(
                (cs.AMP_B, cs.RN_HW, cs.RN_HW, 3)).astype(np.float32)).to(dev),
            "label": torch.from_numpy(rng.integers(
                0, cs.RN_CLASSES, (cs.AMP_B, 1)).astype(np.int32)).to(dev)}

    def step():
        exe.run(main_p, feed=feed, scope=scope, fetch_list=[loss],
                return_numpy=False)
    return step


def _mbv3_step(cs, dev):
    """One MobileNetV3-Large x1.0 training step (B=128, 224x224, fp32 NCHW,
    Momentum) through the port's entry points, as chip_smoke's
    train_mobilenet_v3 times it."""
    import numpy as np

    import paddle_tpu_torch as pt

    main_p, startup, loss = cs._mbv3_program(pt)
    exe, scope = pt.Executor(place=dev), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(cs.SEED + 30)
    feed = {"img": torch.from_numpy(rng.standard_normal(
                (cs.MBV3_B, 3, cs.MBV3_HW, cs.MBV3_HW)).astype(np.float32)).to(dev),
            "label": torch.from_numpy(rng.integers(
                0, cs.MBV3_CLASSES, (cs.MBV3_B, 1)).astype(np.int32)).to(dev)}

    def step():
        exe.run(main_p, feed=feed, scope=scope, fetch_list=[loss],
                return_numpy=False)
    return step


# K8's timed shapes (dtype, mode, R, row, C, act, residual): chip_smoke's
# BN_SHAPES (fp32, ResNet-50 at B=32), BN_SHAPES_AMP (bf16, B=128) and
# BN_MBV3 (fp32, MobileNetV3-Large at B=128, one row a map size)
K8_SHAPES = (
    ("float32", "cl", 32 * 56 * 56, 256, 256, "identity", False),
    ("float32", "cl", 32 * 112 * 112, 64, 64, "relu", False),
    ("float32", "cl", 32 * 56 * 56, 256, 256, "relu", True),
    ("float32", "cl", 32 * 7 * 7, 2048, 2048, "relu", True),
    ("float32", "cr", 32 * 256, 3136, 256, "relu", True),
    ("float32", "cr", 32 * 2048, 49, 2048, "relu", True),
    ("float32", "cl", 1009, 37, 37, "relu", True),
    ("bfloat16", "cl", 128 * 56 * 56, 64, 64, "relu", False),
    ("bfloat16", "cl", 128 * 56 * 56, 256, 256, "identity", False),
    ("bfloat16", "cl", 128 * 56 * 56, 256, 256, "relu", True),
    ("bfloat16", "cl", 128 * 7 * 7, 2048, 2048, "identity", False),
    ("bfloat16", "cl", 128 * 7 * 7, 2048, 2048, "relu", True),
    ("bfloat16", "cr", 128 * 256, 3136, 256, "relu", True),
    ("bfloat16", "cr", 128 * 2048, 49, 2048, "relu", True),
    ("float32", "cr", 128 * 16, 112 * 112, 16, "relu", False),
    ("float32", "cr", 128 * 72, 56 * 56, 72, "relu", False),
    ("float32", "cr", 128 * 120, 28 * 28, 120, "relu", False),
    ("float32", "cr", 128 * 672, 14 * 14, 672, "identity", False),
    ("float32", "cr", 128 * 960, 7 * 7, 960, "identity", False),
)
# the kernels of K8 in any checkout (the PR 3 design's two, the flat one);
# K9's are bn_apply_bwd
K8_KERNELS = ("bn_apply_cl", "bn_apply_cr", "bn_apply_fwd")


class _CleanTimer:
    """chip_smoke's timer (median of 15 calls, each after a 96 MB write that
    evicts the L2 and a spin of the device) with a 96 MB read after the
    write: the timed call finds the L2 holding clean lines, so it writes
    back none of the flush's dirty ones."""

    def __init__(self, device):
        self.flush = torch.empty(96 * 2**20 // 4, device=device)
        self.other = torch.ones(96 * 2**20 // 4, device=device)

    def __call__(self, fn, reps=15):
        import statistics

        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            self.other.sum()
            torch.cuda._sleep(2_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def _digest(t):
    """SHA-256 of a tensor's bytes (bf16 through its 16-bit words)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


def _bn_apply(cs, dev, card, timer, tag, steps):
    """K8 at K8_SHAPES (held, timed, the library beside it, the output's
    digest), then the traced MobileNetV3-Large and ResNet-50 AMP steps."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda_kernels import bn_apply as K8

    g = torch.Generator(device="cpu").manual_seed(cs.SEED + 24)
    clean = _CleanTimer(dev)
    for dt, mode, R, row, C, act, has_res in K8_SHAPES:
        dtype = getattr(torch, dt)
        x = (1.5 * torch.randn((R, row), generator=g) + 0.3).to(dev, dtype)
        res = (torch.randn((R, row), generator=g).to(dev, dtype) if has_res
               else None)
        scale, bias, mean, inv = (
            (1 + 0.2 * torch.randn((C,), generator=g)).to(dev),
            (0.2 * torch.randn((C,), generator=g)).to(dev),
            (0.3 + 0.1 * torch.randn((C,), generator=g)).to(dev),
            torch.rsqrt(2.25 + torch.rand((C,), generator=g)).to(dev))
        p = (scale, bias, mean, inv)
        y = K8.bn_apply_act(x, *p, act, res, mode)
        agree = cs._agree16 if dtype == torch.bfloat16 else cs._agree
        agree(f"bn_apply_act {dt} {mode} [{R}, {row}]", y,
              K8.bn_apply_act_plain(x, *p, act, res, mode))
        ms = timer(lambda: K8.bn_apply_act(x, *p, act, res, mode))
        # torch's own elementwise kernel over the same bytes (x and the
        # residual read, y written): what a stream of them costs here
        out = torch.empty_like(x)
        elem = ((lambda: torch.add(x, res, out=out)) if has_res else
                (lambda: torch.neg(x, out=out)))
        elem_ms = timer(elem)
        clean_ms = clean(lambda: K8.bn_apply_act(x, *p, act, res, mode))
        clean_elem = clean(elem)
        nbytes = (3 if has_res else 2) * R * row * x.element_size() + 16 * C
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
        lib = "n/a"
        if act == "identity" and not has_res:
            if mode == "cl":                 # images of square maps
                B = 32 if dt == "float32" else 128
                hw = int(round((R // B) ** 0.5))
                x4 = x.reshape(B, hw, hw, C).permute(0, 3, 1, 2)
            else:
                h = int(round(row ** 0.5))
                x4 = x.reshape(R // C, C, h, row // h)
            var = 1.0 / (inv * inv) - 1e-5
            lib = "{:.4f}".format(timer(lambda: F.batch_norm(
                x4, mean, var, scale, bias, training=False, eps=1e-5)))
        print(f"{tag} K8 {dt} {mode} [{R}, {row}] C={C} act={act} residual="
              f"{has_res}: {ms:.4f} ms, bound {bound:.4f} ms "
              f"({100 * bound / ms:.1f}%), inference F.batch_norm {lib} ms, "
              f"torch elementwise at the same bytes {elem_ms:.4f} ms; with "
              f"the L2 clean: K8 {clean_ms:.4f}, elementwise "
              f"{clean_elem:.4f} ms; sha256 {_digest(y)} [{card}]",
              flush=True)
        del x, res, y, out
        torch.cuda.empty_cache()

    for what, make in ((f"MobileNetV3-Large step B={cs.MBV3_B}", _mbv3_step),
                       (f"ResNet-50 AMP step B={cs.AMP_B}", _resnet_amp_step)):
        step = make(cs, dev)
        step()                                   # every conv shape met once
        for rep in range(steps):
            wall, busy, hit, _ = _trace(step, K8_KERNELS)
            ms = sum(t for _, t in hit.values())
            n = sum(c for c, _ in hit.values())
            print(f"{tag} {what} trace {rep}: wall {wall:.1f} ms, device busy "
                  f"{busy:.1f} ms = {100 * busy / wall:.1f}%, K8 {ms:.4f} ms in "
                  f"{n} launches = {100 * ms / busy:.2f}% of busy {hit} "
                  f"[{card}]", flush=True)
        del step
        torch.cuda.empty_cache()
    return 0


def _bn_paged(cs, dev, card, timer, tag, steps):
    """K9's chain mode at chip_smoke's fp32 and bf16 shapes and K1 at its
    serving shape and one long row, then the traced ResNet-50 AMP steps
    and serving passes."""
    import numpy as np

    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply_bwd as KB
    from paddle_tpu_torch.ops.cuda_kernels import paged_attention as K1
    from paddle_tpu_torch.serving import DecoderConfig, ServingEngine

    g = torch.Generator(device="cpu").manual_seed(cs.SEED + 23)
    shapes = [(torch.float32,) + c[:6] for c in cs.BN_SHAPES if c[6]]
    shapes += [(torch.bfloat16,) + c for c in cs.BN_SHAPES_AMP if c[0] == "cl"]
    for dt, mode, R, row, C, act, has_res in shapes:
        x = (1.5 * torch.randn((R, row), generator=g) + 0.3).to(dev, dt)
        dy = torch.randn((R, row), generator=g).to(dev, dt)
        res = (torch.randn((R, row), generator=g).to(dev, dt) if has_res
               else None)
        p = ((1 + 0.2 * torch.randn((C,), generator=g)).to(dev),
             (0.2 * torch.randn((C,), generator=g)).to(dev),
             (0.3 + 0.1 * torch.randn((C,), generator=g)).to(dev),
             torch.rsqrt(2.25 + torch.rand((C,), generator=g)).to(dev))
        call = _k9_step_call(KB, x, p, dy, act, res, mode)
        got = call()
        if not all(bool(torch.isfinite(t.float()).all())
                   for t in got if t is not None):
            raise RuntimeError(f"K9 chain {dt} [{R}, {row}]: non-finite output")
        ms = timer(call)
        if hasattr(cs, "_k9_phases"):      # one kernel: its own clock
            how, split = "the kernel's clock", tuple(round(t, 4) for t in (
                cs._k9_phases(KB, (x, *p, dy, act, res, mode,
                                   R * row // C), ms)))
        else:
            how, split = "the profiler", _k9_split(call)
        print(f"{tag} K9 chain {str(dt)[6:]} {mode} [{R}, {row}] act={act} "
              f"residual={has_res}: {ms:.4f} ms (pass 1, fold, pass 2 by "
              f"{how}: {split} ms) [{card}]", flush=True)
        del x, dy, res, got
    torch.cuda.empty_cache()

    for lens in ([1, 16, 17, 500, 0, 33, 257, 64], [500], [4000] * 8):
        B, nh, dh, ps = len(lens), 12, 64, 16
        P = 1 << (-(-max(lens) // ps) - 1).bit_length()   # the engine's width
        pages = max(512, B * P)
        perm = torch.randperm(pages, generator=g)
        table = torch.zeros((B, P), dtype=torch.int32)
        used = 0
        for b, n in enumerate(lens):
            k = -(-n // ps)
            table[b, :k] = perm[used:used + k]
            used += k
        q = torch.randn((B, nh, dh), generator=g).to(dev)
        kp, vp = (torch.randn((pages, ps, nh, dh), generator=g).to(dev)
                  for _ in range(2))
        args = (q, kp, vp, table.to(dev),
                torch.tensor(lens, dtype=torch.int32, device=dev), dh ** -0.5)
        live = args[4] > 0
        cs._agree("paged_decode_attention",
                  K1.paged_decode_attention(*args)[live],
                  K1.paged_decode_attention_plain(*args)[live])
        ms = timer(lambda: K1.paged_decode_attention(*args))
        print(f"{tag} K1 B={B} lens={lens}: {ms:.4f} ms [{card}]", flush=True)
    torch.cuda.empty_cache()

    step = _resnet_amp_step(cs, dev)
    rng_name = "batch_norm grad"
    nn_ops._bn_backward = cs.ranged(nn_ops._bn_backward, rng_name)
    step()
    for rep in range(steps):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        from torch.autograd import DeviceType
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.key != rng_name) / 1e3
        bn = [(e.count, e.self_device_time_total / 1e3)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and "bn_apply_bwd" in e.key]
        calls, n, ms, own, others = cs.kernels_in_ranges(prof, rng_name,
                                                         "bn_apply")
        print(f"{tag} ResNet-50 AMP step B={cs.AMP_B} trace {rep}: wall "
              f"{wall:.1f} ms, device busy {busy:.1f} ms = "
              f"{100 * busy / wall:.1f}%, K9 {sum(t for _, t in bn):.3f} ms "
              f"x{sum(c for c, _ in bn)}; inside the {calls} batch-norm grad "
              f"calls {n} kernel launches ({own} K9's, {n - own} torch's), "
              f"{ms:.3f} ms" + (f"; torch's: {others}" if rep == 0 else "")
              + f" [{card}]", flush=True)
    del step
    torch.cuda.empty_cache()

    eng = ServingEngine(DecoderConfig(), device=dev, seed=cs.SEED)
    eng.submit([1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=2)
    eng.run_until_drained()
    rng = np.random.default_rng(cs.SEED)
    prompts = [[int(t) for t in rng.integers(1, 30000, n)]
               for n in (5, 17, 64, 130, 257, 400)]

    def serve_pass():
        for pr in prompts:
            eng.submit(pr, max_new_tokens=16)
        eng.run_until_drained()
    serve_pass()
    for rep in range(steps):
        wall, busy, hit, _ = _trace(serve_pass, ("paged_decode",))
        print(f"{tag} serving pass trace {rep}: wall {wall:.1f} ms, device "
              f"busy {busy:.1f} ms = {100 * busy / wall:.1f}%, K1 {hit} "
              f"[{card}]", flush=True)
    return 0


def _xent_step_trace(step, rng):
    """(wall ms, device busy ms, (K7 launches, K7 ms), (glue launches, glue
    ms, {name: count})) of one traced call of `step`: the glue being the
    device activities inside the spans of the profiler range `rng` (the
    forward xent op's calls) other than K6."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in cuda if e.key != rng) / 1e3
    k7 = [(e.count, e.self_device_time_total / 1e3) for e in cuda
          if "softmax_xent_bwd" in e.key]
    acts = [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(a, b) for a, b, n in acts if n == rng]
    glue = [(a, b, n) for a, b, n in acts if n != rng
            and "softmax_xent" not in n
            and any(s <= a and b <= t for s, t in spans)]
    names = Counter(n.replace("(anonymous namespace)::", "")[:50]
                    for _, _, n in glue)
    return (wall, busy, (sum(c for c, _ in k7), sum(t for _, t in k7)),
            (len(glue), sum(b - a for a, b, _ in glue) / 1e3, dict(names)))


def _xent_probe(cs, dev, card, timer, tag, steps):
    """K7 in both modes at chip_smoke's shapes beside K6 and the Softmax
    glue, K12's seven variants, then the traced BERT-base AMP and fp32
    steps with K7's and the glue's device time."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda_kernels import attn_probe as K12
    from paddle_tpu_torch.ops.cuda_kernels import xent_bwd as K7
    from paddle_tpu_torch.ops.cuda_kernels import xent_fwd as K6
    from paddle_tpu_torch.ops.registry import get_op_def

    g = torch.Generator(device="cpu").manual_seed(cs.SEED + 24)
    V = 30522
    for dt, N in ((torch.float32, cs.TRAIN_B * cs.TRAIN_S),
                  (torch.bfloat16, cs.AMP_B * cs.AMP_S)):
        x = (3 * torch.randn((N, V), generator=g)).to(dev, dt)
        lab = torch.randint(0, V, (N,), generator=g, dtype=torch.int32).to(dev)
        gl = torch.randn((N,), generator=g).to(dev)
        # K7's element-by-element comparison where the checkout has it
        hold = getattr(cs, "_agree_xent", None) or (
            cs._agree16 if dt == torch.bfloat16 else cs._agree)
        _, m, lse = K6.softmax_xent_fwd(x, lab)
        k6 = timer(lambda: K6.softmax_xent_fwd(x, lab))
        glue = timer(lambda: torch.exp(x.float() - (m + lse)[:, None]).to(dt))
        times = {}
        for mode, stats in (("recomputed", ()), ("saved", (m, lse))):
            hold(f"softmax_xent_bwd {mode}",
                 K7.softmax_xent_bwd(x, lab, gl, *stats),
                 K7.softmax_xent_bwd_plain(x, lab, gl, *stats))
            times[mode] = round(timer(
                lambda: K7.softmax_xent_bwd(x, lab, gl, *stats)), 4)
        print(f"{tag} K7 {str(dt)[6:]} N={N} V={V}: {times} ms; K6 (control) "
              f"{k6:.4f} ms; the unread Softmax output's glue alone "
              f"{glue:.4f} ms [{card}]", flush=True)
        del x, m, lse
        torch.cuda.empty_cache()

    q, k, v = K12.inputs(dev)
    sm = K12.DH ** -0.5
    row = {}
    for name in K12.VARIANTS:
        got = K12.attention_probe(name, q, k, v, sm)
        want = K12.attention_probe_plain(name, q, k, v, sm)
        if name == "copy":
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError("attention_probe copy differs from q + v")
        else:
            cs._agree16(f"attention_probe {name}", got, want)
        row[name] = round(timer(lambda: K12.attention_probe(name, q, k, v,
                                                            sm)), 4)
    row["sdpa"] = round(timer(lambda: F.scaled_dot_product_attention(
        q, k, v, scale=sm)), 4)
    row["q + v"] = round(timer(lambda: q + v), 4)
    print(f"{tag} K12 [{K12.B}, {K12.NH}, {K12.S}, {K12.DH}] ms: {row} "
          f"[{card}]", flush=True)
    del q, k, v

    rng = "xent forward op"
    fwd = get_op_def("softmax_with_cross_entropy")
    fwd.compute = cs.ranged(fwd.compute, rng)
    for what, amp, B, S in ((f"BERT-base AMP step B={cs.AMP_B}", True,
                             cs.AMP_B, cs.AMP_S),
                            (f"BERT-base fp32 step B={cs.TRAIN_B}", False,
                             cs.TRAIN_B, cs.TRAIN_S)):
        _, step = _bert_step(cs, S, flash=False, amp=amp, B=B)
        step()
        for rep in range(steps):
            wall, busy, (n7, ms7), (ng, msg, names) = _xent_step_trace(step,
                                                                       rng)
            print(f"{tag} {what} trace {rep}: wall {wall:.1f} ms, device busy "
                  f"{busy:.1f} ms = {100 * busy / wall:.1f}%, K7 {ms7:.4f} ms "
                  f"x{n7}, the Softmax glue {msg:.4f} ms in {ng} launches "
                  f"{names} [{card}]", flush=True)
        del step
        torch.cuda.empty_cache()
    return 0


def _probe_yardsticks(cs, dev, card, timer, tag, kernel):
    """The library call beside #15 (kernel "b15": the chain of three
    F.conv2d) or K13 ("k13": x * 2.0), L2 flushed."""
    from paddle_tpu_torch.ops.cuda_kernels import bottleneck as BB
    from paddle_tpu_torch.ops.cuda_kernels import dma_probe as K13

    if kernel == "b15":
        args = BB.inputs(dev, cs.SEED)
        print(f"{tag} b15 yardstick: library chain "
              f"{timer(lambda: BB.library_chain(*args)):.4f} ms [{card}]",
              flush=True)
    if kernel == "k13":
        for x in K13.inputs(dev):
            print(f"{tag} k13 yardstick {list(x.shape)}: x * 2.0 "
                  f"{timer(lambda: x * 2.0):.4f} ms [{card}]", flush=True)


def _probes(cs, dev, card, timer, tag, steps):
    """#15 at the tool's shape, L2 flushed and in the tool's chained
    protocol, beside the library chain; K13's six rows beside x * 2.0, L2
    flushed; `steps` rounds."""
    from paddle_tpu_torch.ops.cuda_kernels import bottleneck as BB
    from paddle_tpu_torch.ops.cuda_kernels import dma_probe as K13

    args = BB.inputs(dev, cs.SEED)
    cs._agree16("bottleneck_block", BB.bottleneck_block(*args),
                BB.bottleneck_block_plain(*args))
    xs = K13.inputs(dev)
    for x in xs:
        for bb in K13.BLOCKS:
            got = K13.dma_copy(x, bb)
            torch.cuda.synchronize()
            if not torch.equal(got, K13.dma_copy_plain(x)):
                raise RuntimeError(f"dma_copy {list(x.shape)} bb={bb} differs "
                                   f"from 2 x")
    for rep in range(steps):
        ms = timer(lambda: BB.bottleneck_block(*args))
        lib = timer(lambda: BB.library_chain(*args))
        ab = BB.ab(dev)
        print(f"{tag} #15 round {rep} [{BB.B}, {BB.H}, {BB.W}, {BB.C}] M={BB.M}: "
              f"kernel {ms:.4f} ms, library chain {lib:.4f} ms (L2 flushed); "
              f"chained x{BB.K_CHAIN}: kernel {ab['chain_kernel_ms']:.4f}, "
              f"library chain {ab['chain_library_ms']:.4f} ms/block; "
              f"single-shot L2 warm: kernel {ab['kernel_ms']:.4f}, library "
              f"chain {ab['library_ms']:.4f} [{card}]", flush=True)
        for x in xs:
            row = {"x * 2.0": round(timer(lambda: x * 2.0), 4)}
            for bb in K13.BLOCKS:
                row[f"bb={bb}"] = round(timer(lambda: K13.dma_copy(x, bb)), 4)
            print(f"{tag} K13 round {rep} {list(x.shape)} ms: {row} [{card}]",
                  flush=True)
    return 0


def _variant_libraries(source, variants, entries, argtypes):
    """{variant: {entry: bound C function}}: csrc/<source>.cu with each
    variant's edits, compiled by nvcc in parallel under build/variants/."""
    from paddle_tpu_torch.ops.cuda_kernels import _build

    where = _build.BUILD_DIR / "variants"
    where.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / f"{source}.cu").read_text()
    jobs = {}
    for i, (name, edits) in enumerate(variants.items()):
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: edit no longer matches "
                                   f"{source}.cu: {old[:60]!r}")
            src = src.replace(old, new)
        cu = where / f"{source}_{i}.cu"
        cu.write_text(src)
        so = cu.with_suffix(".so")
        jobs[name] = so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
    fns = {}
    for name, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out.decode()[-3000:]}")
        lib = ctypes.CDLL(str(so))
        fns[name] = {e: _build.bind(lib, e, argtypes) for e in entries}
    return fns


def _k7_variant_cases(cs, dev, fns):
    """(label, call, plain) for each variant of K7, dtype and mode."""
    from paddle_tpu_torch.ops.cuda_kernels import _build
    from paddle_tpu_torch.ops.cuda_kernels import xent_bwd as K7

    g = torch.Generator(device="cpu").manual_seed(cs.SEED + 25)
    V = 30522
    for dt, N, sfx in ((torch.float32, cs.TRAIN_B * cs.TRAIN_S, "f32"),
                       (torch.bfloat16, cs.AMP_B * cs.AMP_S, "bf16")):
        x = (3 * torch.randn((N, V), generator=g)).to(dev, dt)
        lab = torch.randint(0, V, (N,), generator=g, dtype=torch.int32).to(dev)
        gl = torch.randn((N,), generator=g).to(dev)
        m = x.float().amax(-1)
        lse = torch.logsumexp(x.float() - m[:, None], -1)
        for mode, st in (("recomputed", ()), ("saved", (m, lse))):
            want = K7.softmax_xent_bwd_plain(x, lab, gl, *st)
            for name, f in fns.items():
                # the tensors, not their addresses: the cases outlive the loop
                def call(f=f[f"softmax_xent_bwd_{sfx}"], x=x, lab=lab, gl=gl,
                         st=st, N=N):
                    dx = torch.empty_like(x)
                    stats = tuple(t.data_ptr() for t in st) or (None, None)
                    _build.launch("softmax_xent_bwd", f, x.data_ptr(),
                                  lab.data_ptr(), gl.data_ptr(), *stats,
                                  dx.data_ptr(), N, V, _build.stream_of(x))
                    return dx
                yield name, f"{sfx} N={N} V={V} {mode}", call, want


def _k12_variant_cases(cs, dev, fns):
    from paddle_tpu_torch.ops.cuda_kernels import _build
    from paddle_tpu_torch.ops.cuda_kernels import attn_probe as K12

    q, k, v = K12.inputs(dev)
    sm = K12.DH ** -0.5
    B, nh, S, dh = q.shape
    for var, (code, gh) in K12.VARIANTS.items():
        want = K12.attention_probe_plain(var, q, k, v, sm)
        for name, f in fns.items():
            def call(f=f["attn_probe_bf16"], code=code, gh=gh):
                out = torch.empty_like(q)
                _build.launch("attention_probe", f, q.data_ptr(), k.data_ptr(),
                              v.data_ptr(), out.data_ptr(), B, nh, S, dh, code,
                              gh, sm, _build.stream_of(q))
                return out
            yield name, f"[{B}, {nh}, {S}, {dh}] {var}", call, want


def _b15_variant_cases(cs, dev, fns):
    """#15's wgmma kernel at the tool's shape, the tool's inputs, checked
    at the unit set too (the variants' plain-version comparison)."""
    from paddle_tpu_torch.ops.cuda_kernels import _build
    from paddle_tpu_torch.ops.cuda_kernels import bottleneck as BB

    shape = (BB.B, BB.H, BB.W, BB.C, BB.M)
    grid = BB.plan(shape, BB._sms(dev))["grid"]
    for scale in ("unit", "tool"):
        args = BB.inputs(dev, cs.SEED, shape, scale)
        want = BB.bottleneck_block_plain(*args)
        for name, f in fns.items():
            def call(f=f["bottleneck_block_wg_bf16"], args=args):
                out = torch.empty_like(args[0])
                _build.launch("bottleneck_block", f,
                              *(t.data_ptr() for t in args), out.data_ptr(),
                              *shape, grid, _build.stream_of(out))
                return out
            yield name, f"{list(shape)} {scale} inputs", call, want


def _k13_variant_cases(cs, dev, fns):
    from paddle_tpu_torch.ops.cuda_kernels import _build
    from paddle_tpu_torch.ops.cuda_kernels import dma_probe as K13

    for x in K13.inputs(dev):
        want = K13.dma_copy_plain(x)
        for bb in K13.BLOCKS:
            for name, f in fns.items():
                def call(f=f["dma_probe_bf16"], x=x, bb=bb):
                    out = torch.empty_like(x)
                    _build.launch("dma_copy", f, x.data_ptr(), out.data_ptr(),
                                  x.shape[0], x[0].numel(), bb,
                                  _build.stream_of(x))
                    return out
                yield name, f"{list(x.shape)} bb={bb}", call, want


def _k8_variant_cases(cs, dev, fns):
    """K8 at K8_SHAPES, each variant through its C entry."""
    from paddle_tpu_torch.ops.cuda_kernels import _build
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply as K8

    g = torch.Generator(device="cpu").manual_seed(cs.SEED + 26)
    for dt, mode, R, row, C, act, has_res in K8_SHAPES:
        dtype = getattr(torch, dt)
        x = (1.5 * torch.randn((R, row), generator=g) + 0.3).to(dev, dtype)
        res = (torch.randn((R, row), generator=g).to(dev, dtype) if has_res
               else None)
        p = tuple((1 + 0.2 * torch.randn((C,), generator=g)).to(dev)
                  for _ in range(4))
        want = K8.bn_apply_act_plain(x, *p, act, res, mode)
        for name, f in fns.items():
            def call(f=f[f"bn_apply_act_{_build.ELEM[dtype]}"], x=x, res=res,
                     p=p, mode=mode, act=act):
                y = torch.empty_like(x)
                _build.launch("bn_apply_act", f, x.data_ptr(),
                              *(t.data_ptr() for t in p),
                              None if res is None else res.data_ptr(),
                              y.data_ptr(), *x.shape, p[0].shape[0],
                              K8.MODES.index(mode), K8.ACTS.index(act),
                              _build.stream_of(x))
                return y
            yield name, f"{dt} {mode} [{R}, {row}] {act} res={has_res}", \
                call, want


def _variants(cs, dev, card, timer, tag, steps, edits):
    """Design alternatives of K7, K8, K12, #15 or K13 (text edits of the
    source, from the JSON file `edits`) beside the source as it is."""
    import torch.nn.functional as F

    c = ctypes
    spec = json.loads(Path(edits).read_text())
    variants = {"as built": [], **spec["variants"]}
    # kernel -> (source, entries, their argtypes, cases)
    kinds = {
        "k7": ("softmax_xent_bwd",
               ("softmax_xent_bwd_f32", "softmax_xent_bwd_bf16"),
               [c.c_void_p] * 6 + [c.c_int] * 2 + [c.c_void_p],
               _k7_variant_cases),
        "k12": ("attn_probe", ("attn_probe_bf16",),
                [c.c_void_p] * 4 + [c.c_int] * 6 + [c.c_float, c.c_void_p],
                _k12_variant_cases),
        "b15": ("bottleneck_block", ("bottleneck_block_wg_bf16",),
                [c.c_void_p] * 5 + [c.c_int] * 6 + [c.c_void_p],
                _b15_variant_cases),
        "k13": ("dma_probe", ("dma_probe_bf16",),
                [c.c_void_p, c.c_void_p, c.c_int, c.c_longlong, c.c_int,
                 c.c_void_p], _k13_variant_cases),
        "k8": ("bn_apply", ("bn_apply_act_f32", "bn_apply_act_bf16"),
               [c.c_void_p] * 7 + [c.c_int] * 5 + [c.c_void_p],
               _k8_variant_cases)}
    source, entries, argtypes, cases_of = kinds[spec["kernel"]]
    fns = _variant_libraries(source, variants, entries, argtypes)
    cases = list(cases_of(cs, dev, fns))
    refused = set()
    for name, what, call, want in cases:
        if name in refused:
            continue
        try:
            if spec["kernel"] == "k7":
                cs._agree_xent(f"{name} {what}", call(), want)
            elif spec["kernel"] == "k8":
                (cs._agree if want.dtype == torch.float32 else cs._agree16)(
                    f"{name} {what}", call(), want)
            elif what.endswith("copy") or spec["kernel"] == "k13":
                torch.cuda.synchronize()
                if not torch.equal(call(), want):
                    raise RuntimeError(f"{name} {what}: differs from its "
                                       f"plain version")
            else:
                cs._agree16(f"{name} {what}", call(), want)
        except RuntimeError as e:
            refused.add(name)
            print(f"{tag} variant {name!r} refused: {e} [{card}]", flush=True)
    for rep in range(steps):
        rows = {}
        for name, what, call, _ in cases:
            if name not in refused and "unit inputs" not in what:
                rows.setdefault(what, {})[name] = round(timer(call), 4)
        for what, row in rows.items():
            print(f"{tag} {spec['kernel']} {what} round {rep} ms: {row} "
                  f"[{card}]", flush=True)
    if spec["kernel"] in ("b15", "k13"):
        _probe_yardsticks(cs, dev, card, timer, tag, spec["kernel"])
    if spec["kernel"] == "k12":
        from paddle_tpu_torch.ops.cuda_kernels import attn_probe as K12

        q, k, v = K12.inputs(dev)
        sm = K12.DH ** -0.5
        print(f"{tag} k12 yardsticks: sdpa "
              f"{timer(lambda: F.scaled_dot_product_attention(q, k, v, scale=sm)):.4f}"
              f" ms, q + v {timer(lambda: q + v):.4f} ms [{card}]", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--kernels",
                    choices=("flash", "short", "flash_bf16", "layer_norm",
                             "bn_paged", "bn_apply", "xent_probe", "probes",
                             "variants"),
                    default="flash",
                    help="flash: fp32 K10/K11 and the long-context fp32 "
                         "step; short: fp32 K2/K4 and the BERT-base fp32 "
                         "step; flash_bf16: bf16 K10/K11 and the "
                         "long-context AMP step; layer_norm: K3/K5 and the "
                         "BERT-base AMP and fp32 steps; bn_paged: K9's chain "
                         "mode and K1, the ResNet-50 AMP step and serving "
                         "passes; bn_apply: K8 with its output digests, the "
                         "MobileNetV3-Large and ResNet-50 AMP steps; "
                         "xent_probe: K7 (with K6 and the Softmax "
                         "glue), K12, the BERT-base AMP and fp32 steps; "
                         "probes: #15 and K13 beside their library calls; "
                         "variants: the design alternatives in --edits")
    ap.add_argument("--edits", help="with --kernels variants: a JSON file "
                                    "of a kernel's variants (see above)")
    args = ap.parse_args()
    if args.kernels == "variants" and not args.edits:
        ap.error("--kernels variants takes --edits FILE")
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs
    from paddle_tpu_torch.ops.cuda_kernels import _build
    from paddle_tpu_torch.ops.cuda_kernels import flash_attention as K10
    from paddle_tpu_torch.ops.cuda_kernels import flash_attention_bwd as K11

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs._card()
    _build.build_all()
    timer = cs._Timer(dev)
    tag = f"flash_ab {args.label}"
    if args.kernels == "short":
        return _short(cs, dev, card, timer, tag, args.steps)
    if args.kernels == "flash_bf16":
        return _flash_bf16(cs, dev, card, timer, tag, args.steps)
    if args.kernels == "layer_norm":
        return _layer_norm(cs, dev, card, timer, tag, args.steps)
    if args.kernels == "bn_paged":
        return _bn_paged(cs, dev, card, timer, tag, args.steps)
    if args.kernels == "bn_apply":
        return _bn_apply(cs, dev, card, timer, tag, args.steps)
    if args.kernels == "xent_probe":
        return _xent_probe(cs, dev, card, timer, tag, args.steps)
    if args.kernels == "probes":
        return _probes(cs, dev, card, timer, tag, args.steps)
    if args.kernels == "variants":
        return _variants(cs, dev, card, timer, tag, args.steps, args.edits)

    g = torch.Generator(device="cpu").manual_seed(cs.SEED + 20)
    for B, nh, S, dh, causal in ((4, 12, 1024, 64, False),
                                 (2, 12, 1024, 64, True),
                                 (2, 4, 1000, 128, True)):
        q, k, v, do = (torch.randn((B, nh, S, dh), generator=g).to(dev)
                       for _ in range(4))
        sc = dh ** -0.5
        out, lse = K10.flash_attention_fwd(q, k, v, causal, sc)
        ref, ref_lse = K10.flash_attention_fwd_plain(q, k, v, causal, sc)
        cs._agree("flash_attention_fwd out", out, ref)
        cs._agree("flash_attention_fwd lse", lse, ref_lse)
        bwd = lambda: K11.flash_attention_backward(  # noqa: E731
            q, k, v, ref, ref_lse, do, causal, sc)
        want = K11.flash_attention_backward_plain(q, k, v, ref, ref_lse, do,
                                                  causal, sc)
        for n, o, r in zip("qkv", bwd(), want):
            cs._agree(f"flash_attention_backward d{n}", o, r)
        fwd_ms = timer(lambda: K10.flash_attention_fwd(q, k, v, causal, sc))
        bwd_ms = timer(bwd)
        passes = {n: round(ms / c, 4) for n, (c, ms) in _trace(bwd)[2].items()}
        print(f"{tag} fp32 B={B} nh={nh} S={S} dh={dh} causal={causal}: K10 "
              f"{fwd_ms:.4f} ms, K11 {bwd_ms:.4f} ms (passes, traced: "
              f"{passes}) [{card}]", flush=True)
        del q, k, v, do, out, lse, ref, ref_lse, want
        torch.cuda.empty_cache()

    B, step = _bert_step(cs, cs.LONG_FP32_S, flash=True)
    _traced_steps(step, f"long-context fp32 step B={B} S={cs.LONG_FP32_S}",
                  "K10/K11", ("flash_",), args.steps, tag, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
