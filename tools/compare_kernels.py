#!/usr/bin/env python3
"""Time this tree's flash-attention kernels against another copy of their sources, on one card.

    mkdir -p build/other && git archive <commit> diffusion_classifier_tpu_torch/csrc | tar -x -C build/other
    python3 tools/compare_kernels.py build/other/diffusion_classifier_tpu_torch/csrc

The other directory holds a ``flash_attn_fwd.cu`` and a ``flash_attn_bwd.cu``
with the same C entry points (and their headers), such as an earlier
commit's. Both builds are held to the plain versions (bf16 atol/rtol 2e-2)
at each shape before they are timed, in bf16:

- the DiT's shapes, q/k/v as the thirds of one qkv tensor: CUDA events over
  runs of 10 back-to-back calls, in turns this, other, other, this (SDPA
  after them as the yardstick);
- the UNets' and the IPMSA UNet's shapes, separate q/k/v: the profiler's
  device time per call, as ``chip_smoke.py`` phases 9 and 13 time them,
  in the same turns.

Prints the card's name and power limit, a line a shape and direction, and
a JSON record as the last line. Needs one CUDA device and ``nvcc``.
"""

import json
import os
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIT_SHAPES = [(16, 1024, 6, 64), (64, 1024, 6, 64), (1, 1024, 3, 128)]
UNET_SHAPES = [(64, 64, 8, 32), (64, 16, 8, 64), (128, 64, 8, 32), (128, 16, 8, 64),
               (256, 64, 8, 32), (256, 16, 8, 64), (40, 64, 8, 32), (40, 16, 8, 64),
               (8, 256, 8, 64)]
TOL = dict(atol=2e-2, rtol=2e-2)


def event_ms(fn, reps=50, inner=10):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, calls=30):
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / calls / 1e3


def in_turns(timer, fns):
    """Median ms of each of ``fns`` (a dict), timed in the order given and then reversed."""
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            times[name].append(timer(fns[name]))
    return {name: statistics.median(t) for name, t in times.items()}


def main(other_dir):
    if not torch.cuda.is_available():
        print("compare_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from diffusion_classifier_tpu_torch.ops import flash_attention as fa
    from diffusion_classifier_tpu_torch.utils import native

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    other_fwd, other_bwd = fa.FlashAttentionForward(), fa.FlashAttentionBackward()
    other_fwd.source = os.path.join(os.path.abspath(other_dir), "flash_attn_fwd.cu")
    other_bwd.source = os.path.join(os.path.abspath(other_dir), "flash_attn_bwd.cu")
    native.build_all(fa.FLASH_FWD, fa.FLASH_BWD, other_fwd, other_bwd)
    builds = {"this": (fa.FLASH_FWD, fa.FLASH_BWD), "other": (other_fwd, other_bwd)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    record = []
    for shape in DIT_SHAPES + UNET_SHAPES:
        b, s, h, d = shape
        if shape in DIT_SHAPES:
            qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
            q, k, v = (x.view(shape) for x in qkv.split(h * d, dim=-1))
            timer, how = event_ms, "events, 10 back-to-back calls"
        else:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
            timer, how = device_ms, "profiler device time"
        do = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        out, lse = fa.FLASH_FWD(q, k, v, lse=True)
        want_o = fa.flash_attention_reference(q, k, v)
        want_g = fa.flash_attention_bwd_reference(q, k, v, do, out)
        for name, (fwd, bwd) in builds.items():
            torch.testing.assert_close(fwd(q, k, v), want_o, **TOL, msg=lambda m: f"{name} forward {shape}: {m}")
            for g, w in zip(bwd(q, k, v, out, do, lse), want_g):
                torch.testing.assert_close(g, w, **TOL, msg=lambda m: f"{name} backward {shape}: {m}")
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        fwd_ms = in_turns(timer, {n: (lambda f=f: f(q, k, v)) for n, (f, _) in builds.items()})
        fwd_ms["sdpa"] = timer(lambda: F.scaled_dot_product_attention(qh, kh, vh))
        bwd_ms = in_turns(timer, {n: (lambda f=f: f(q, k, v, out, do, lse)) for n, (_, f) in builds.items()})
        for direction, ms in (("forward", fwd_ms), ("backward", bwd_ms)):
            print(f"{shape} bf16 {direction} ({how}): " + ", ".join(f"{n} {t:.4f} ms" for n, t in ms.items())
                  + f"; this/other {ms['this'] / ms['other']:.3f}")
            record.append({"shape": list(shape), "direction": direction, "timer": how, **ms})
    print(json.dumps({"compare_kernels": record, "other": os.path.abspath(other_dir)}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
