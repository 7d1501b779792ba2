"""The port's fp32 flash-attention kernels (K10, K11) and the long-context
fp32 training step that runs them, timed, for comparing two checkouts of
the repo on one card.

It builds the kernels of the `paddle_tpu_torch` under `--root` (default:
this script's directory) and takes that checkout's `chip_smoke.py` helpers
(timer, BERT-base configuration and batch). Then:
  * K10 and K11 at chip_smoke's fp32 shapes of `check_flash` (B=4, nh=12,
    S=1024, dh=64; causal B=2, S=1024; causal B=2, nh=4, S=1000, dh=128),
    each held against its plain version and timed (CUDA events, L2
    flushed, median of 15), K11 split into its two passes by
    torch.profiler;
  * the long-context fp32 step (BERT-base, B=4, S=1024,
    use_flash_attention, Adam) built through the port's entry points and
    traced `--steps` times with torch.profiler: wall time, device busy
    time, and K10/K11's device time and launches.
Run it on two checkouts in turn, alternating (A B B A), each in a process
of its own:

    python3 flash_ab.py --root /path/to/checkout --label parent

Each line ends with the card's name and power limit."""
import argparse
import sys
import time
from pathlib import Path

import torch


def _trace(fn):
    """(wall ms, device busy ms, {kernel: (launches, ms)} of the flash
    kernels) of one call of `fn` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, flash = 0.0, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        busy += e.self_device_time_total / 1e3
        if "flash_" in e.key:
            name = e.key.split("<")[0].split("::")[-1]
            flash[name] = (e.count, round(e.self_device_time_total / 1e3, 4))
    return wall, busy, flash


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import transformer
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

    B, S = cs.LONG_FP32_B, cs.LONG_FP32_S
    cfg = cs._bert_cfg(S, flash=True)
    main_p, startup = pt.Program(), pt.Program()
    with pt.program_guard(main_p, startup), unique_name.guard():
        avg_loss, _ = transformer.bert_pretrain(cfg, seq_len=S)
        pt.optimizer.Adam(learning_rate=cs.TRAIN_LR).minimize(avg_loss)
    startup.random_seed = cs.SEED
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = cs._bert_feed(cfg, B, S)

    def step():
        exe.run(main_p, feed=feed, scope=scope, fetch_list=[avg_loss],
                return_numpy=False)

    step()                                   # every GEMM shape met once
    for rep in range(args.steps):
        wall, busy, flash = _trace(step)
        ms = sum(t for _, t in flash.values())
        print(f"{tag} long-context fp32 step B={B} S={S} trace {rep}: wall "
              f"{wall:.1f} ms, device busy {busy:.1f} ms = "
              f"{100 * busy / wall:.1f}%, K10/K11 {ms:.3f} ms = "
              f"{100 * ms / busy:.1f}% of busy {flash} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
