#!/usr/bin/env python3
"""Times the ways of computing the flat sweep's scores on one CUDA card, for
util.matmul's design at the search precision "default".

    python3 chip_matmul.py

The score tile of one sweep chunk, s = 2 <q, y> - pen, for 10,000 bf16
queries against a chunk of bf16 cache rows (d 128 and 1024), by:

  * f32 addmm: IEEE f32 operands, the bias in the GEMM (the "highest"
    sweep);
  * bf16 addmm: torch.addmm(pen, q, y.T, alpha=2, out_dtype=float32);
  * bf16 mm + bias pass: torch.mm(2 q, y.T, out_dtype=float32), then the
    bias added in place (util.matmul's route: 2 q is exact in bf16);
  * util.matmul itself, at "default" and "highest";

each at a chunk width that is a multiple of 128 (26,880 columns) and at
the odd width 2^28 // 10,000 = 26,843 (and at d 128 also 262,144 columns),
with the device time by CUDA events
(mean of 10 after a warm-up) and the names of the GEMM kernels
torch.profiler saw. Prints one JSON line per case, then the
card's name and power limit. Exits 1 without a CUDA card.
"""

import json
import re
import subprocess
import sys


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_matmul: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torchpq_tpu_torch import util

    def ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def gemm_kernel(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key[:72] for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and re.search(r"gemm|xmma|cutlass|nvjet", e.key, re.I)]
        return names

    gen = torch.Generator(device="cuda").manual_seed(0)
    for d, widths in ((128, (26_880, 26_843, 262_144)),
                      (1024, (26_880, 26_843))):
        q = torch.randn(10_000, d, device="cuda", generator=gen).bfloat16()
        for n in widths:
            y = torch.randn(n, d, device="cuda", generator=gen).bfloat16()
            pen = torch.rand(n, device="cuda", generator=gen) * 100
            bias = -pen[None, :]
            cases = {
                "f32 addmm": lambda: torch.addmm(
                    bias, q.float(), y.float().T, alpha=2.0),
                "bf16 addmm": lambda: torch.addmm(
                    bias, q, y.T, alpha=2.0, out_dtype=torch.float32),
                "bf16 mm + bias pass": lambda: torch.mm(
                    q * 2, y.T, out_dtype=torch.float32).add_(bias),
                "util.matmul default": lambda: util.matmul(
                    q, y, "default", alpha=2.0, bias=bias),
                "util.matmul highest": lambda: util.matmul(
                    q, y, "highest", alpha=2.0, bias=bias),
            }
            for name, fn in cases.items():
                t = ms(fn)
                print(json.dumps(dict(
                    case=name, d=d, nq=q.shape[0], columns=n,
                    ms=round(t, 4),
                    tflop_s=round(2 * q.shape[0] * n * d / t / 1e9, 1),
                    kernel=gemm_kernel(fn))), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.stdout else "?")


if __name__ == "__main__":
    main()
