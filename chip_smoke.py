#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA flash-attention forward and backward from
``diffusion_classifier_tpu_torch/csrc/`` (one ``nvcc`` each, started
together) and drives the port's two main paths at full width (384 = 6 × 64,
12 layers, 256 px → Haar DWT 128 × 128 × 12 → 1024 tokens) with seeded
random weights and synthetic data: CheXpert DiT-b4 ELBO classification
through ``experiments/chexpert-dit/inference_torch.py``, and DiT-b4 training
through ``experiments/chexpert-dit/train_torch.py``. Phases:

1. device: a CUDA device is required; prints the card's name and power limit;
2. build: compiles both kernels, prints the seconds, ptxas' register use and
   spills, and the ``HMMA`` instructions of every kernel entry from
   ``cuobjdump -sass`` (found beside ``nvcc``); fails if a bf16 entry of the
   forward, dk/dv or dq kernels has none (tensor cores unused);
3. forward kernel vs its plain PyTorch version on the card at the main
   path's shapes, strided q/k/v thirds and ragged and odd sequences in both
   dtypes included, with timings (plain; kernel and SDPA as a yardstick in
   turns: kernel, SDPA, SDPA, kernel, each run 10 calls back to back, and
   again of single calls, which also count the wrapper's host time; the
   host microseconds of one wrapper call) and the bound;
4. the full-width DiT-b4 forward with the kernel vs with the plain
   attention on the same weights: relative L2 ≤ 1e-2, 12 launches;
5. the classify entry point: a seeded checkpoint, ``inference_torch.main()``
   with launch counts and no alignment copy, then classify throughput at
   B=16 and latency at B=1, each with a profiler table;
6. backward kernel vs its plain version at the same kind of shapes, with
   timings (plain; kernel and SDPA's backward in turns, back to back and
   single calls; host microseconds per call) and the bound;
7. full-width DiT-b4 gradients at B=16, kernels vs plain attention on the
   same weights and draws: relative L2 ≤ 2e-2, 12 + 12 launches;
8. the training entry point: ``train_torch.main()`` for one epoch (16 steps
   at B=16) with its eval, launch counts, no alignment copy, a finite loss
   at every step, a checkpoint that ``inference_torch.main()`` reads back;
   then the median step time, images/s and one profiler trace of a warm
   step.

Each path's launch and copy counts are set to 0 just before it runs and read
just after. Any failed check raises and exits non-zero. The second-to-last line
is the kernels' JSON record; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX, and nothing of the JAX package.
"""

import importlib.util
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
KERNELS = {
    "flash_attn_fwd": ("diffusion_classifier_tpu_torch/csrc/flash_attn_fwd.cu",
                       "diffusion_classifier_tpu/ops/flash_attention.py:123"),
    "flash_attn_bwd": ("diffusion_classifier_tpu_torch/csrc/flash_attn_bwd.cu",
                       "diffusion_classifier_tpu/ops/flash_attention.py:304"),
}
# the classify megabatch (16 x 1 class per chunk) and the train batch
DIT_SHAPE = (16, 1024, 6, 64)
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 without
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# ragged last tiles and odd sequences, in bf16 (tensor cores, every head
# dim) as in fp32 (scalar kernels)
RAGGED_CASES = [
    ((2, 200, 2, 32), torch.float32),
    ((2, 200, 2, 64), torch.bfloat16),
    ((1, 65, 1, 128), torch.bfloat16),
    ((3, 77, 2, 32), torch.bfloat16),
]
KERNEL_CASES = [
    (DIT_SHAPE, torch.bfloat16),
    ((2, 1024, 6, 64), torch.float32),
    ((1, 1024, 3, 128), torch.bfloat16),
    *RAGGED_CASES,
]
BWD_CASES = [
    (DIT_SHAPE, torch.bfloat16),
    ((2, 1024, 6, 64), torch.float32),
    ((1, 512, 3, 128), torch.bfloat16),
    *RAGGED_CASES,
]
# repetitions of each turn when a kernel is timed against its library call,
# and the back-to-back calls in each repetition: with one call, the event
# pair also times the host's work in the wrapper while the card waits
TURN_REPS = 50
BACK_TO_BACK = 10
# fp32: the JAX suite's flash tolerance (tests/test_ops.py:66-68); bf16: one
# bf16 ulp of an O(1) output
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-3), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
INFERENCE_CONFIG = {
    "data_path": "synthetic",
    "image_size": 256,
    "image_channels": 3,
    "wavelet_transform": True,
    "patch_size": 4,
    "classes": 2,
    "encoder_type": "DiT",
    "mixed_precision": "bf16",
    "batch_size": 16,
    "evaluation_per_stage": [4],
    "evaluation_batches": 1,
}
# one epoch of the synthetic set's 256 train images: 16 steps at B=16; the
# loss goes to track.jsonl at every step
TRAINING_CONFIG = dict(
    INFERENCE_CONFIG, num_epochs=1, log_every_steps=1, use_comet=True,
    experiment_dir="chexpert-dit-train",
)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_times(fn, reps, warmup=3, inner=1):
    """Milliseconds per call of ``fn()`` in ``reps`` runs of ``inner`` calls, each run timed with CUDA events."""
    for _ in range(warmup):
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
    return times


def cuda_ms(fn, reps=20, warmup=3, inner=1):
    """Median milliseconds per call of ``fn()`` over ``reps`` runs of ``inner`` calls."""
    return statistics.median(cuda_times(fn, reps, warmup, inner))


def in_turns(kernel_fn, library_fn, reps=TURN_REPS, inner=BACK_TO_BACK):
    """``(kernel_ms, library_ms)``: medians over turns kernel, library, library, kernel."""
    times = {kernel_fn: [], library_fn: []}
    for fn in (kernel_fn, library_fn, library_fn, kernel_fn):
        times[fn] += cuda_times(fn, reps, inner=inner)
    return statistics.median(times[kernel_fn]), statistics.median(times[library_fn])


def timed_in_turns(record, kernel_fn, library_fn):
    """Fill ``record`` with the kernel's and the library call's times, device and host.

    ``ms``/``library_ms``: runs of back-to-back calls, which hide the host's
    work between launches; ``call_ms``/``library_call_ms``: single calls, the
    way PRs 1-2 timed, which count it; ``host_us``: the host's microseconds
    per wrapper call, enqueued while the card runs behind.
    """
    record["ms"], record["library_ms"] = in_turns(kernel_fn, library_fn)
    record["call_ms"], record["library_call_ms"] = in_turns(kernel_fn, library_fn, inner=1)
    record["library_ratio"] = record["ms"] / record["library_ms"]
    kernel_fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(TURN_REPS):
        kernel_fn()
    record["host_us"] = (time.perf_counter() - start) / TURN_REPS * 1e6
    torch.cuda.synchronize()


def bound(flops, nbytes, dtype):
    """``(bound_ms, bound_by)``: the larger of the operations' and the bytes' least time."""
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def reset_counts(fa):
    for kernel in (fa.FLASH_FWD, fa.FLASH_BWD):
        kernel.launches = 0
        kernel.copies = 0


def check_no_copies(fa, path):
    copies = (fa.FLASH_FWD.copies, fa.FLASH_BWD.copies)
    print(f"{path} alignment copies: forward {copies[0]}, backward {copies[1]}")
    check(copies == (0, 0), f"{path}: the kernels copied {copies} unaligned inputs")


def strided_qkv(shape, dtype, gen):
    """q, k, v as the three contiguous thirds of one ``[B, S, 3·H·D]`` tensor (the DiT's qkv)."""
    b, s, h, d = shape
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(dtype)
    return [x.view(b, s, h, d) for x in qkv.split(h * d, dim=-1)]


# kernel names by what they compute, for the profiler's summary line
CATEGORIES = (
    ("flash forward", ("flash_fwd",)),
    ("flash backward", ("dkdv", "dq_", "delta")),
    ("matmul", ("gemm", "addmm", "matmul", "cutlass", "xmma", "cublas", "nvjet")),
)


def profile_table(tag, fn):
    """Profile one call of ``fn``; print device time by kernel and by category, return the total ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [
        (e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    total = sum(r[0] for r in rows)
    by_category = dict.fromkeys([c for c, _ in CATEGORIES] + ["other (elementwise, reductions, copies)"], 0.0)
    for ms, _, key in rows:
        category = next((c for c, words in CATEGORIES if any(w in key for w in words)), None)
        by_category[category or "other (elementwise, reductions, copies)"] += ms
    print(f"{tag} profiler: device time {total:.2f} ms in {sum(r[1] for r in rows)} kernels; " + ", ".join(
        f"{c} {ms:.2f} ms ({100 * ms / total:.1f}%)" for c, ms in by_category.items()))
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        print(f"{tag}   {ms:8.3f} ms {100 * ms / total:5.1f}% x{count:<4d} {key[:90]}")
    return total


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(
        f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}"
    )


def entry_name(text):
    """``"dkdv bf16 D=64"`` for a mangled kernel name in ``text``; ``text`` if none."""
    match = re.search(r"(flash_fwd|delta|dkdv|dq)(_mma)?_kernelI(13__nv_bfloat16|f)?Li(\d+)E", text)
    if not match:
        return text.strip()
    name, mma, dtype, dim = match.groups()
    return f"{name} {'f32' if dtype == 'f' else 'bf16'} D={dim}"


def sass_hmma(fa, kernel):
    """``{entry: HMMA count}`` over the kernel entries of ``kernel``'s library (``cuobjdump -sass``)."""
    tool = os.path.join(os.path.dirname(fa._nvcc()), "cuobjdump")
    check(os.path.isfile(tool), f"no cuobjdump beside nvcc: {tool}")
    sass = subprocess.run(
        [tool, "-sass", kernel.library_path()], capture_output=True, text=True, check=True,
        timeout=300,
    ).stdout
    counts, entry = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            entry = entry_name(line.split("Function :", 1)[1])
            counts[entry] = 0
        elif entry is not None and re.search(r"\bHMMA\.", line):
            counts[entry] += 1
    return counts


def phase_build(fa):
    seconds = fa.build_all(fa.FLASH_FWD, fa.FLASH_BWD)
    print(f"[2 build] flash_attn_fwd and flash_attn_bwd built and loaded in {seconds:.2f} s")
    hmma = {}
    for kernel in (fa.FLASH_FWD, fa.FLASH_BWD):
        # ptxas -v: one "Compiling entry function '<mangled name>'" line, then
        # its spills, then its registers
        entry = spill = None
        counts = sass_hmma(fa, kernel)
        for line in kernel.build_log.splitlines():
            if "Compiling entry" in line:
                entry = entry_name(line)
            elif "spill stores" in line:
                spill = re.search(r"(\d+) bytes spill stores", line).group(1)
            elif "Used" in line and "registers" in line and entry:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                print(f"[2 build]   {entry}: {regs} registers, {spill} bytes spilled, {counts.get(entry)} HMMA")
                entry = None
        # every bf16 entry of the attention passes runs on the tensor cores
        tensor_core = {e: n for e, n in counts.items() if e.split()[0] in ("flash_fwd", "dkdv", "dq") and "bf16" in e}
        check(len(tensor_core) == (3 if kernel is fa.FLASH_FWD else 6),
              f"bf16 entries of {kernel.name} in the SASS: {sorted(counts)}")
        check(all(tensor_core.values()), f"bf16 entries of {kernel.name} without HMMA: {tensor_core}")
        hmma[kernel.name] = tensor_core
    return hmma


def phase_kernel(fa):
    gen = torch.Generator(device="cuda").manual_seed(0)
    record = {}
    for shape, dtype in KERNEL_CASES:
        q, k, v = strided_qkv(shape, dtype, gen)
        got = fa.FLASH_FWD(q, k, v)
        torch.cuda.synchronize()
        want = fa.flash_attention_reference(q, k, v)
        check(got.dtype == dtype and got.shape == q.shape, f"output {got.dtype} {got.shape}")
        check(bool(torch.isfinite(got).all()), f"non-finite kernel output at {shape}")
        err = (got.float() - want.float()).abs().max().item()
        print(f"[3 kernel] {shape} {str(dtype)[6:]} strided q/k/v: max |kernel - plain| = {err:.3e} (atol {TOL[dtype]['atol']}, rtol {TOL[dtype]['rtol']})")
        torch.testing.assert_close(got, want, **TOL[dtype])
        if shape == DIT_SHAPE:
            b, s, h, d = shape
            qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            record["max_abs_err"] = err
            record["plain_ms"] = cuda_ms(lambda: fa.flash_attention_reference(q, k, v))
            timed_in_turns(
                record, lambda: fa.FLASH_FWD(q, k, v), lambda: F.scaled_dot_product_attention(qh, kh, vh)
            )
            lse_ms = cuda_ms(lambda: fa.FLASH_FWD(q, k, v, lse=True), reps=TURN_REPS, inner=BACK_TO_BACK)
            record["bound_ms"], record["bound_by"] = bound(
                4 * b * h * s * s * d, 4 * q.numel() * q.element_size(), dtype
            )
            print(f"[3 kernel] {shape} bf16 median: kernel {record['ms']:.4f} ms (with lse {lse_ms:.4f} ms), plain {record['plain_ms']:.4f} ms; in turns of {TURN_REPS} (kernel, SDPA, SDPA, kernel): kernel {record['ms']:.4f} ms, SDPA {record['library_ms']:.4f} ms, kernel/SDPA {record['library_ratio']:.3f}; single calls: kernel {record['call_ms']:.4f} ms, SDPA {record['library_call_ms']:.4f} ms; host {record['host_us']:.1f} us per wrapper call; bound {record['bound_ms']:.4f} ms ({record['bound_by']})")
    return record


def phase_backward(fa):
    gen = torch.Generator(device="cuda").manual_seed(3)
    record = {}
    for shape, dtype in BWD_CASES:
        q, k, v = strided_qkv(shape, dtype, gen)
        do = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        out, lse = fa.FLASH_FWD(q, k, v, lse=True)
        got = fa.FLASH_BWD(q, k, v, out, do, lse)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_reference(q, k, v, do, out)
        errs = []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            check(g.dtype == dtype and g.shape == q.shape, f"{name} {g.dtype} {g.shape}")
            check(bool(torch.isfinite(g).all()), f"non-finite {name} at {shape}")
            errs.append((g.float() - w.float()).abs().max().item())
        print(f"[6 backward] {shape} {str(dtype)[6:]} strided q/k/v: max |kernel - plain| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (atol {TOL[dtype]['atol']}, rtol {TOL[dtype]['rtol']})")
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(g, w, **TOL[dtype], msg=lambda m: f"{name} at {shape}: {m}")
        if shape == DIT_SHAPE:
            b, s, h, d = shape
            record["max_abs_err"] = max(errs)
            record["plain_ms"] = cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, do, out))
            qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
            oh = F.scaled_dot_product_attention(qh, kh, vh)
            doh = do.transpose(1, 2).contiguous()
            timed_in_turns(
                record,
                lambda: fa.FLASH_BWD(q, k, v, out, do, lse),
                lambda: torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True),
            )
            # in: q, k, v, o, dO and the fp32 lse; out: dq, dk, dv
            nbytes = 8 * q.numel() * q.element_size() + lse.numel() * 4
            record["bound_ms"], record["bound_by"] = bound(10 * b * h * s * s * d, nbytes, dtype)
            print(f"[6 backward] {shape} bf16 median: plain {record['plain_ms']:.4f} ms; in turns of {TURN_REPS} (kernel, SDPA, SDPA, kernel): kernel {record['ms']:.4f} ms, SDPA backward {record['library_ms']:.4f} ms, kernel/SDPA {record['library_ratio']:.3f}; single calls: kernel {record['call_ms']:.4f} ms, SDPA backward {record['library_call_ms']:.4f} ms; host {record['host_us']:.1f} us per wrapper call; bound {record['bound_ms']:.4f} ms ({record['bound_by']})")
    return record


def phase_dit(fa, chexpert, config):
    model = chexpert.build_backbone(config)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to("cuda").eval()
    gen = torch.Generator(device="cuda").manual_seed(1)
    b = DIT_SHAPE[0]
    x = torch.randn((b, 128, 128, 12), generator=gen, device="cuda")
    t = torch.randn((b,), generator=gen, device="cuda") * 4
    y = torch.randint(0, 2, (b,), generator=gen, device="cuda")
    with torch.no_grad():
        before = fa.FLASH_FWD.launches
        got = model(x, t, y)
        torch.cuda.synchronize()
        launches = fa.FLASH_FWD.launches - before
        for block in model.blocks:
            block.attn_backend = "xla"  # the plain version, same weights
        want = model(x, t, y)
    check(got.shape == (b, 128, 128, 12) and got.dtype == torch.float32, f"DiT output {got.shape}")
    check(bool(torch.isfinite(got).all()), "non-finite DiT output")
    rel = ((got - want).norm() / want.norm()).item()
    print(f"[4 dit-b4] forward B={b} 1024 tokens bf16: kernel launches {launches}, rel L2 kernel vs plain {rel:.3e} (limit 1e-2)")
    check(launches == 12, f"{launches} kernel launches in one DiT-b4 forward, expected 12")
    check(rel <= 1e-2, f"relative L2 {rel} > 1e-2")


def load_script(name):
    path = os.path.join(REPO, "experiments", "chexpert-dit", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_entry_point(fa, chexpert, config_cls, workdir):
    from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser

    cfg = dict(INFERENCE_CONFIG, project_root=workdir, experiment_dir="chexpert-dit")
    config = config_cls.from_dict(dict(cfg))
    seeded = chexpert.build_engine(config)
    seeded.init_params()
    seeded.save_checkpoint(0)
    del seeded

    inference_torch = load_script("inference_torch")
    os.environ["INFERENCE_CONFIG"] = json.dumps(cfg)
    forwards = [0]

    def count_denoiser(module, args, output):
        if isinstance(module, Denoiser):
            forwards[0] += 1

    hook = torch.nn.modules.module.register_module_forward_hook(count_denoiser)
    try:
        reset_counts(fa)
        metric_output, samples, _ = inference_torch.main([])
        torch.cuda.synchronize()
        launches, bwd_launches = fa.FLASH_FWD.launches, fa.FLASH_BWD.launches
    finally:
        hook.remove()
    print(f"[5 entry] inference_torch.main(): {len(samples)} batches, {forwards[0]} denoiser forwards, {launches} forward kernel launches, {bwd_launches} backward")
    check_no_copies(fa, "[5 entry]")
    check(bwd_launches == 0, f"classification launched the backward {bwd_launches} times")
    check(len(metric_output) == 4, f"metrics {metric_output}")
    check(len(samples) == INFERENCE_CONFIG["evaluation_batches"] + 1, f"{len(samples)} batches")
    for preds in samples:
        check(tuple(preds.shape) == (16,), f"predictions of shape {tuple(preds.shape)}")
        check(bool(((preds >= 0) & (preds < 2)).all()), f"predictions {preds.tolist()}")
    check(launches > 0, "the main path launched no kernel")
    check(launches == 12 * forwards[0], f"{launches} launches for {forwards[0]} forwards")

    engine = chexpert.build_engine(config)
    engine.init_params()
    engine.load_checkpoint(os.path.join(config.experiment_path, "checkpoints"))
    images = torch.rand((16, 256, 256, 3), generator=torch.Generator().manual_seed(2)) * 2 - 1
    images = images.numpy()
    ms16 = cuda_ms(lambda: engine.classify(images), reps=5, warmup=1)
    ms1 = cuda_ms(lambda: engine.classify(images[:1]), reps=10, warmup=2)
    print(f"[5 entry] classify B=16 (4 evals x 2 classes): {ms16:.2f} ms -> {16e3 / ms16:.2f} images/s")
    print(f"[5 entry] classify B=1 latency (4 evals x 2 classes): {ms1:.2f} ms")
    for b, ms in ((16, ms16), (1, ms1)):
        busy = profile_table(f"[5 entry] classify B={b}", lambda: engine.classify(images[:b]))
        print(f"[5 entry] classify B={b}: device busy {busy:.2f} of {ms:.2f} ms median wall, idle ~{100 * max(0.0, 1 - busy / ms):.1f}%")
    return launches


def phase_dit_grads(fa, chexpert, config):
    from diffusion_classifier_tpu_torch.diffusion.schedule import make_schedule_fn
    from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser
    from diffusion_classifier_tpu_torch.engine.steps import make_loss_fn

    backbone = chexpert.build_backbone(config)
    backbone.reset_parameters(torch.Generator().manual_seed(0))
    model = Denoiser(backbone).to("cuda")
    loss_fn = make_loss_fn(
        model, make_schedule_fn(config.schedule, config.noise_d, config.image_size),
        pred_param=config.pred_param, null_token=config.classes,
    )
    gen = torch.Generator(device="cuda").manual_seed(4)
    b = DIT_SHAPE[0]
    x = torch.rand((b, 128, 128, 12), generator=gen, device="cuda") * 2 - 1
    y = torch.randint(0, 2, (b,), generator=gen, device="cuda")
    u, t = torch.rand((b,), generator=gen, device="cuda"), torch.rand((b,), generator=gen, device="cuda")
    eps = torch.randn(x.shape, generator=gen, device="cuda")
    results = []
    for backend in ("auto", "xla"):
        for block in backbone.blocks:
            block.attn_backend = backend
        model.zero_grad(set_to_none=True)
        reset_counts(fa)
        loss = loss_fn(x, y, u, t, eps)
        loss.backward()
        torch.cuda.synchronize()
        launches = (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches)
        if backend == "auto":
            check_no_copies(fa, "[7 dit-b4 grads]")
        grads = torch.cat([p.grad.flatten() for p in model.parameters()])
        results.append((loss.item(), grads, launches))
    (loss_k, g_k, launches), (loss_p, g_p, plain_launches) = results
    rel = ((g_k - g_p).norm() / g_p.norm()).item()
    print(f"[7 dit-b4 grads] loss+backward B={b} bf16: kernel launches fwd {launches[0]} bwd {launches[1]}; loss kernel {loss_k:.6f} plain {loss_p:.6f}; rel L2 of {g_k.numel()} parameter gradients, kernels vs plain, {rel:.3e} (limit 2e-2)")
    check(all(map(math.isfinite, (loss_k, loss_p))) and bool(torch.isfinite(g_k).all()), "non-finite loss or gradient")
    check(launches == (12, 12), f"{launches} launches in one DiT-b4 loss and backward, expected (12, 12)")
    check(plain_launches == (0, 0), f"attn_backend='xla' launched {plain_launches}")
    # bf16 model: the kernels round p and ds to bf16 where the autograd of the
    # plain forward keeps fp32, and the difference compounds over 12 blocks
    # of bf16 activations (the forward alone differs by ~6e-3)
    check(rel <= 2e-2, f"relative L2 of the gradients {rel} > 2e-2")


def phase_train(fa, config_cls, workdir):
    from diffusion_classifier_tpu_torch.data.synthetic import SyntheticDataLoader

    cfg = dict(TRAINING_CONFIG, project_root=workdir)
    train_torch = load_script("train_torch")
    os.environ["TRAINING_CONFIG"] = json.dumps(cfg)
    reset_counts(fa)
    start = time.perf_counter()
    engine = train_torch.main([])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    fwd, bwd = fa.FLASH_FWD.launches, fa.FLASH_BWD.launches
    check_no_copies(fa, "[8 train]")
    config = config_cls.from_dict(dict(cfg))
    steps = 256 // config.batch_size
    exp = config.experiment_path
    with open(os.path.join(exp, "track.jsonl")) as f:
        events = [json.loads(line) for line in f]
    losses = [e["value"] for e in events if e.get("name") == "loss" and e.get("step") is not None]
    print(f"[8 train] train_torch.main(): {len(losses)} steps in {seconds:.1f} s (eval and checkpoint included); launches fwd {fwd} bwd {bwd}; loss first {losses[0]:.5f} last {losses[-1]:.5f}")
    check(len(losses) == steps, f"{len(losses)} logged losses, expected {steps}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    check(bwd == 12 * steps, f"{bwd} backward launches for {steps} steps, expected {12 * steps}")
    check(fwd > 12 * steps, f"{fwd} forward launches: the training and the eval must both run the kernel")
    for name in ("ema_params.pt", "train_state.pt", "experiment_state.json"):
        check(os.path.isfile(os.path.join(exp, "checkpoints", name)), f"no checkpoints/{name}")

    os.environ["INFERENCE_CONFIG"] = json.dumps(dict(cfg, use_comet=False))
    metric_output, samples, _ = load_script("inference_torch").main([])
    check(len(metric_output) == 4 and len(samples) == INFERENCE_CONFIG["evaluation_batches"] + 1,
          f"inference on the trained checkpoint: {metric_output}")
    for preds in samples:
        check(bool(((preds >= 0) & (preds < 2)).all()), f"predictions {preds.tolist()}")
    print(f"[8 train] inference_torch.main() on the trained checkpoint: {[{k: round(v, 4) for k, v in d.items()} for d in metric_output]}")

    # the step alone: CUDA events around warm train steps at B=16
    batch = next(iter(SyntheticDataLoader(
        256, 64, batch_size=config.batch_size, image_size=config.image_size,
        channels=config.image_channels, classes=config.classes, seed=1,
    ).get_train_loader()))
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: engine.train_step(batch), reps=10, warmup=2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[8 train] step B={config.batch_size} median {step_ms:.2f} ms -> {config.batch_size * 1e3 / step_ms:.2f} images/s; peak memory {peak_gb:.2f} GB")

    busy = profile_table("[8 train] one warm step", lambda: engine.train_step(batch))
    print(f"[8 train] step: device busy {busy:.2f} of {step_ms:.2f} ms median wall, idle ~{100 * max(0.0, 1 - busy / step_ms):.1f}%")
    return fwd, bwd


def loaded_from_jax_package():
    root = os.path.join(REPO, "diffusion_classifier_tpu") + os.sep
    return sorted(
        name for name, m in list(sys.modules.items())
        if os.path.abspath(getattr(m, "__file__", None) or os.sep).startswith(root)
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, REPO)
    from diffusion_classifier_tpu_torch.experiments import chexpert_dit as chexpert
    from diffusion_classifier_tpu_torch.ops import flash_attention as fa
    from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

    phase_device()
    hmma = phase_build(fa)
    records = {"flash_attn_fwd": phase_kernel(fa), "flash_attn_bwd": phase_backward(fa)}
    config = ExperimentConfig.from_dict(dict(INFERENCE_CONFIG))
    phase_dit(fa, chexpert, config)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(REPO, "build"))
    try:
        classify_fwd = phase_entry_point(fa, chexpert, ExperimentConfig, workdir)
        phase_dit_grads(fa, chexpert, config)
        train_fwd, train_bwd = phase_train(fa, ExperimentConfig, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    check("jax" not in sys.modules, "jax was imported")
    stray = loaded_from_jax_package()
    check(not stray, f"modules loaded from the JAX package: {stray}")

    launches = {
        "flash_attn_fwd": {"classify": classify_fwd, "train": train_fwd},
        "flash_attn_bwd": {"classify": 0, "train": train_bwd},
    }
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(launches[name].values()),
            "launches_by_path": launches[name],
            **{key: records[name][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_ratio", "call_ms", "library_call_ms", "host_us")},
            "hmma": hmma[name],
        }
        for name, (source, replaces) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    start = time.perf_counter()
    code = main()
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s", file=sys.stderr)
    sys.exit(code)
