"""Serving passes of the port at BERT-base width, timed, for comparing two
checkouts of the repo on one card.

It builds the kernels and a `ServingEngine(DecoderConfig())` from the
`paddle_tpu_torch` under `--root` (default: this script's directory), serves
one short request to warm the card, then `--passes` times the workload of
`chip_smoke.py`'s serving phase (prompts of 5, 17, 64, 130, 257 and 400
tokens, 16 new tokens each) and prints each pass's tokens/s and the median
of all passes after the first (which meets every GEMM shape new). Run it on
two checkouts in turn, alternating (A B B A ...), each in a process of its
own:

    python3 serving_ab.py --root /path/to/checkout --label parent

Each line ends with the card's name and power limit. `--summarize LOG`
reads such lines back from a log, in the order they ran, and prints each
label's median over its processes and, for the processes paired as they
ran ((1st, 2nd), (3rd, 4th), ...), the second label's rate over the
first's."""
import argparse
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
LENS, NEW = (5, 17, 64, 130, 257, 400), 16


def summarize(log: str) -> None:
    runs = re.findall(r"^serving_ab (\S+): .*median after the first ([0-9.]+)",
                      Path(log).read_text(), re.M)
    labels = list(dict.fromkeys(lbl for lbl, _ in runs))
    if len(labels) != 2:
        raise SystemExit(f"serving_ab: expected two labels in {log}, got {labels}")
    a, b = labels
    for lbl in labels:
        rates = [float(r) for x, r in runs if x == lbl]
        print(f"{lbl}: median of {len(rates)} process medians "
              f"{statistics.median(rates)} tokens/s")
    ratios = []
    for (l1, r1), (l2, r2) in zip(runs[0::2], runs[1::2]):
        if l1 != l2:
            ra, rb = (float(r1), float(r2)) if l1 == a else (float(r2), float(r1))
            ratios.append(rb / ra)
    print(f"{b}/{a} over {len(ratios)} pairs: median {statistics.median(ratios)}, "
          f"{sum(r > 1 for r in ratios)} pairs above 1, range "
          f"{min(ratios)}-{max(ratios)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--summarize", metavar="LOG")
    args = ap.parse_args()
    if args.summarize:
        summarize(args.summarize)
        return 0
    if args.passes < 2:
        ap.error("--passes must be at least 2 (the first pass is not counted)")
    if not torch.cuda.is_available():
        print("serving_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from paddle_tpu_torch.ops.cuda_kernels import _build
    from paddle_tpu_torch.serving import DecoderConfig, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.build_all()
    cfg = DecoderConfig()
    eng = ServingEngine(cfg, device=torch.device("cuda", 0), seed=SEED)
    eng.submit([1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=2)
    eng.run_until_drained()
    rng = np.random.default_rng(SEED)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)] for n in LENS]
    rates = []
    for _ in range(args.passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rates.append(sum(len(eng.result(r)) for r in rids) / wall)
    print(f"serving_ab {args.label}: tokens/s per pass {rates}; median after "
          f"the first {statistics.median(rates[1:])} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
