#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA flash-attention forward and backward and the fused
LayerNorm and GroupNorm from ``diffusion_classifier_tpu_torch/csrc/`` (one ``nvcc`` each,
started together) and drives the port's main paths at full width with seeded random
weights, on synthetic data and on data-format trees written from a seed:
CheXpert DiT-b4 (384 = 6 × 64, 12 layers, 256 px → Haar DWT 128 × 128 × 12
→ 1024 tokens) ELBO classification and CFG sampling through
``experiments/chexpert-dit/inference_torch.py`` and training through
``experiments/chexpert-dit/train_torch.py``; the CIFAR-10 flagship UNet
(blocks 128/128/256/512, 95.9 M parameters; attention at 64 tokens × D=32
and 16 tokens × D=64) ELBO classification with the shared prefix and CFG
sampling through ``experiments/cifar10/inference_torch.py``, and its
training through ``experiments/cifar10/train_torch.py``; the CheXpert data
path (JPEG loader, decode cache, the CheXpert UNet's train, inference and
OOD entry points, the DiT through the loader); and the IPMSA family (MRI
volume loader, the IPMSA UNet's train, inference and counterfactual
explanation, the IPMSA DiT, the ResNet-50 baseline); multi-process training
and evaluation; and the flagship UNet conditioned on a T5 class table
(``encoder_type 't5'``) through the CIFAR-10 entry points. Phases:

1. device: a CUDA device is required; prints the card's name and power limit;
2. build: compiles both kernels and the fused norms, prints the seconds, ptxas' register use and
   spills, and the ``HGMMA`` (``wgmma``) and ``UTMALDG`` (TMA load)
   instructions of every kernel entry from ``cuobjdump -sass`` (found beside
   ``nvcc``); fails, naming the entry, if a bf16 entry of the forward, dk/dv
   or dq kernels lacks either (the Hopper tensor-core path unused), or if
   the bf16 entries are not the forward's 5 and the backward's 12 tilings;
3. forward kernel vs its plain PyTorch version on the card at the main
   path's shapes (the DiT's 1024 tokens at 16, 32 and 64 rows, the
   classify groups of 1, 2 and 4 evaluations that the card's free memory
   can give, and its OOD run's 64 tokens; the IPMSA UNet's classify tails
   at each group size, its explain tail, its B=1 tails and its B=64 step
   at 256 tokens × 8 × 64; the IPMSA DiT's train batch), strided q/k/v thirds and ragged and odd sequences in both dtypes included (bf16 at every
   head dim at S = 1, 17, 65, 129 and 1000, ``TMA_RAGGED_CASES``; 21 runs at
   the DiT's shape give the same bits), with timings (plain; kernel and SDPA as a yardstick in
   turns: kernel, SDPA, SDPA, kernel, each run 10 calls back to back, and
   again of single calls, which also count the wrapper's host time; the
   host microseconds of one wrapper call) and the bound;
3b. the fused LayerNorm (``csrc/layer_norm.cu``, AdaLN and affine
   epilogues) vs its plain version at ``LN_CASES``: at least 99.9% of the
   bf16 outputs identical, the AdaLN epilogue's roundings exact from the
   kernel's own normalised rows, 21 runs at the DiT's shape bit-identical;
   kernel, plain and ``F.layer_norm`` (a yardstick) ms at the DiT's
   ``[128, 1024, 384]``, TB/s and the bytes' bound; each later path's
   launches by phase, and no input copied on any of them;
3c. the fused GroupNorm (``csrc/group_norm.cu``, with and without its SiLU
   epilogue, eps 1e-5 and 1e-6) vs its plain version at ``GN_CASES``, every
   shape the UNets' no-grad paths launch it at, and group sizes of no
   whole half chunk (``GN_ODD``): at least 99.9% of the bf16 outputs
   identical and none more than 2⁻⁶ of the output's magnitude (at least 1)
   apart, fp32 within 1e-5; 21 runs at the CIFAR cell's largest norm
   bit-identical; kernel, plain chain, plain chain + ``F.silu`` and
   ``F.group_norm`` (a yardstick) ms at that norm (``[1024, 32, 32, 128]``,
   32 groups), TB/s and the bytes' bound; the two-pass kernel and the plain
   chain + ``F.silu`` ms at a CheXpert UNet norm too tall to hold
   (``GN_STREAM_SHAPE``) and its bytes' bound; the
   phases' launches, no input copied, and every shape they launched at
   held here (``kernel_shapes``, ``check_covered``);
4. the full-width DiT-b4 forward with the kernel vs with the plain
   attention on the same weights: relative L2 ≤ 1e-2, 12 launches;
5. the classify entry point: a seeded checkpoint, ``inference_torch.main()``
   with launch counts and no alignment copy, then classify throughput at
   B=16 and latency at B=1, each with a profiler table;
6. backward kernel vs its plain version at the same kind of shapes (the
   IPMSA UNet's B=64 step and the IPMSA DiT's train batch among them, the
   ragged ``TMA_RAGGED_CASES``); 21 runs at the DiT's shape give the same
   bits of dq, dk and dv; with timings (plain; kernel and SDPA's backward in turns, back to back and
   single calls; host microseconds per call) and the bound;
7. full-width DiT-b4 gradients at B=16, kernels vs plain attention on the
   same weights and draws: relative L2 ≤ 2e-2, 12 + 12 launches;
8. the training entry point: ``train_torch.main()`` for one epoch (16 steps
   at B=16) with its eval (the numpy plot function, sampling cut to 8
   steps), launch counts, no alignment copy, a finite loss at every step, a
   checkpoint that ``inference_torch.main()`` reads back; then the median
   step time, images/s and one profiler trace of a warm step;
9. forward kernel vs its plain version at the UNet's shapes, separate
   q/k/v as its projections give them, bf16 and fp32, no alignment copy,
   each timed in turns with SDPA as in phase 3, with the plain version's
   time and the bound;
10. the full-width flagship UNet forward in bf16: kernel vs plain attention
    on the same weights (relative L2 ≤ 1e-2), ``full`` vs tail ∘ encode,
    11 launches a tail and none in the encode;
11. the CIFAR classify entry point: a seeded checkpoint, then (on one val batch)
    ``inference_torch.main()`` at B=64, 4 evaluations × 10 classes, with the
    encode and tail forwards counted against the count that the group size
    and the class chunk give, 11 launches a tail, no alignment copy; the
    group size that the card's free memory gave (``card_eval_group``, held
    to its rule and printed beside the JAX budget's) and the call's peak
    memory against the card's total; classify throughput at B=64 and
    latency at B=1, with a profiler table split into encode and tail; the
    card bytes a megabatch row takes per image element (``row_bytes``: the
    peak at a group of 2 evaluations less 1), which must not exceed
    ``ROW_BYTES_PER_ELEM``, the constant the group size is budgeted with;
12. CFG sampling through both entry points (``classification=false``, 128
    steps, a numpy-only plot function): the CIFAR UNet at B=32 (encode on B
    and tail on 2B each step) and DiT-b4 at B=16 (one 2B forward each
    step), output finite in [-1, 1], forwards and launches counted; then
    samples/s, device time and idle share, and a profiler table of one
    sampling step;
13. backward kernel vs its plain version at the UNet's training shapes
    ((64, 64, 8, 32) and (64, 16, 8, 64), separate q/k/v, bf16 and fp32, no
    alignment copy), timed as in phase 9 against SDPA's backward;
14. one loss and backward of the full-width flagship at B=64, kernels vs
    plain attention: fp32 gradients within 1e-4 (relative L2), bf16 within
    the network's bf16 noise floor (plain bf16 vs plain fp32); launches
    (11, 11), (22, 11) with remat, none with ``attn_backend='xla'``; remat
    gives the same loss and gradients within 1e-6;
15. CIFAR training through ``experiments/cifar10/train_torch.py`` (one
    epoch, 8 steps at B=64, its eval cut to 4 evaluations and 8 sampling
    steps, the numpy plot function): a finite loss a step, 11 backward
    launches a step run from Python (eager, or captured into the step's CUDA
    graph; a replay launches from the graph), the checkpoint files, then ``inference_torch.main()``
    on that checkpoint; then the step alone (10 warm steps at B=64: ms,
    images/s, peak memory, with Adam's moments in fp32 and in bf16) and a
    profiler table of one warm step with the device's idle share;
16. data-format trees under the run's ``build/`` workdir, from fixed seeds:
    CheXpert (``train.csv`` in CheXpert's columns, 246 rows that pass the
    filter and one that each clause drops, grey JPEGs of 320 × 390), 64
    CheXpert JPEGs of 2048 × 2048, MIMIC (64 px JPEGs), PadChest (16-bit
    PNGs) and ISIC (JPEGs);
17. the loader on the host: the filter's split sizes, a train epoch's
    batches from 0 and 4 workers identical bit for bit, and images/s to
    256 px: serial and 4 threads on 320 × 390, on 2048², with
    ``fast_decode``, and the second epoch from the ``DecodeCache``;
18. the CheXpert UNet at full width (220,427,532 parameters; 8 heads × 96
    at 1024 tokens, outside the kernels' gate, so plain attention: 6 calls
    a forward, no flash launch): a forward with tail ∘ encode = full;
    ``experiments/chexpert-unet/train_torch.py`` on the tree (bf16, remat,
    B=16, one epoch), the step alone at B=16 and at B=64 with remat (ms,
    peak memory, device time, idle share); ``inference_torch.py`` on its
    checkpoint (forwards counted, the mistakes file against the
    predictions; the group size, peak memory and bytes a row as in phase
    11), classify at B=16 and B=1 with profiler tables and the kernels of
    an encode and a tail; ``ood_torch.py`` on MIMIC, PadChest
    and ISIC;
19. the CheXpert DiT through the loader: ``train_torch.py`` on the tree (12
    backward launches a step), ``inference_torch.py`` (the mistakes file)
    and ``ood_torch.py`` on MIMIC (64 rows × 64 tokens, the shape phase 3
    checks), 12 forward launches a denoiser forward throughout;
20. IPMSA MRI trees under the workdir, from a seed: 32 samples × 11
    volumes of 32 × 240 × 200 fp32 (FLAIR, CT2F and the brain mask at
    W000/W048/W096, new T2 lesions at W048/W096) as ``.npy`` and as
    ``.npy.lz4``, the three split pickles filtered through a blocklist by
    ``IPMSADataset.remove_condition``;
21. the IPMSA loader on the host (the lz4 decoder built with ``g++`` from
    ``native/lz4dec.cpp`` into ``build/torch_native/``): images/s to 256 ×
    256 × 10 serial and with 4 threads from each format, the pickle cache's
    two epochs, batches identical across all of them; the lz4 decode rate;
22. the IPMSA UNet (408,537,896 parameters): both kernels at its level 3
    (8, 256, 8, 64) bf16 against their plain versions and SDPA, the plain
    route (JAX's ``dot_product_attention`` arithmetic) at (8, 64, 8, 96)
    against the fp32-product reference; a full-width forward with 9 flash
    launches and 10 plain-route calls a tail, none in the encode;
    ``experiments/ipmsa/train_torch.py`` for one epoch on the lz4 tree (B=8),
    the step alone at B=8 and at the config's B=64 (ms, peak memory, idle
    share); ``inference_torch.py`` (4 evaluations × 2 classes; the group
    size, peak memory and bytes a row as in phase 11), classify at B=8 and
    B=1; ``explain_torch.py`` for both forced labels (t = 0.5, 16
    steps); fails if a kernel ran at a shape that phases 3, 6 and 22 did
    not hold against its plain version;
23. the IPMSA DiT (32,955,520 parameters, 1024 tokens × 6 × 64):
    ``ipmsa-dit/train_torch.py`` and ``inference_torch.py`` on the tree, 12
    launches a forward and a backward, every shape held by phases 3 and 6;
24. the ResNet-50 baseline: ``ipmsa-classifier/train_torch.py`` on the
    tree, the step alone at B=8 (ms, images/s, peak memory, idle share),
    ``inference_torch.py`` with its metrics in range;
25. DDP on the card: the CheXpert DiT-b4 at full width, 3 train steps at
    the global B=16 and a classify of one global batch through ``evaluate``
    (Accuracy and F1 synced), first in this process without a group, then
    on two ranks that share the card over gloo (NCCL refuses two ranks on
    one device), 8 rows each, from the same seeds: every rank's losses
    within 1e-3 (bf16) of the one-process run's, the global predictions and
    the synced counters equal, 12 + 12 launches a step a rank, every shape
    held by phases 3 and 6; step ms, peak memory a rank and idle share;
26. FSDP: the same at ``param_sharding='fsdp'`` at world 1 on NCCL (the
    fixed rule ``MP_WORLD``: FSDP2 over gloo with CUDA tensors killed both
    ranks with SIGSEGV on this card), then DDP at world 1 on NCCL, whose
    step against the one-process step is the wrapper's cost; peak memory a
    rank beside DDP's;
27. tensor parallel: the flagship UNet at full width in fp32 on a data 1 ×
    model 2 mesh over gloo (4 of 8 heads a rank), 3 train steps at B=64 and
    a classify (4 evaluations × 10 classes), held to the one-process run
    (losses rtol 1e-4, predictions and counters equal), the attention and
    GEGLU weights sliced in half, the kernels at the head-split shapes
    (``TP_CASES``, held by phases 3 and 6);
28. the entry points under ``torchrun --nproc_per_node=1`` (NCCL, world
    1): ``chexpert-dit/train_torch.py`` on phase 16's tree at
    ``param_sharding='fsdp'`` (12 backward launches a step), its checkpoint
    files read back, ``inference_torch.py`` on them (the mistakes file), and
    ``ipmsa-classifier/train_torch.py`` (ResNet-50) at ``'replicated'``;
29. preemption: two ranks (gloo) train the DiT-b4 through ``train_loop``;
    SIGTERM to both after step 3; both save at one agreed step (only rank 0
    writes) and exit 143; two fresh ranks resume and finish the epoch, and
    the interrupted and resumed losses are those of an uninterrupted run
    within 1e-3;
30. the text-conditioned flagship: a ``[11, 8, 768]`` fp32 class table
    (t5-base's width, ``t5_max_length`` tokens) written as ``.npy`` from a
    seed, the full-width UNet built for it (``encoder_hid_proj`` 768 → 128);
    ``experiments/cifar10/train_torch.py`` for one epoch (8 steps at B=64,
    11 backward launches a step) and the step alone under
    ``profiling.StepTimer``; ``inference_torch.py`` at B=64, 4 evaluations ×
    10 classes (11 flash launches and 11 plain-route cross-attentions over
    the table's 8 tokens a tail; group size and peak memory as in phase
    11); ``encode_text_prompt`` against the table; classify timed with
    ``profiling.timed`` and ``StepTimer``, one call under
    ``profiling.trace``, whose trace must hold CUDA kernel events and the
    tails' flash kernels; CFG sampling of 32 images at 32 steps through
    ``inference_torch.py`` (the null row as the unconditional half), finite
    in [-1, 1]; every kernel shape held by phases 3, 6, 9 and 13;
31. a JAX-written checkpoint: ``tests/data/orbax_dit`` (the JAX package's
    ``save_checkpoint`` of a narrow CheXpert DiT, one 64-wide head at 1024
    tokens, bf16 Adam state; ``tools/make_orbax_fixture.py``) read with the
    port's own zstd, OCDBT and zarr decoders: every leaf's sha256 against
    Orbax's restore, the read's wall time and the decoder's MB/s on the
    host beside the card's name and power limit; then the DiT engine on the
    card loads it through ``inference`` (the EMA alone) in fp32 and bf16,
    and the EMA denoiser's 16 ε-prediction errors (2 images × 2 classes ×
    4 logSNR, inputs from the fixture's seed) are held to the JAX
    reference's (fp32 1e-4, bf16 relative L2 2e-2) with flash forward
    launches > 0, the kernel held to its plain version at every shape.

Phases 25-27 and 29 run their ranks as ``chip_smoke.py --worker`` and
phase 28 its entry points as ``chip_smoke.py --entry`` under ``torchrun``;
each reports its launches, which the kernels' line sums by path. Two ranks
on one card measure the code path and its overhead, not multi-GPU scaling.

Each path's launch and copy counts are set to 0 just before it runs and read
just after. Before each of phases 18-31 the card must hold under 0.5 GB (what
an earlier phase leaves would inflate the phase's peak memory). Any failed
check raises and exits non-zero. The second-to-last line
is the kernels' JSON record; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX, and nothing of the JAX package.
"""

import contextlib
import dataclasses
import gc
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
# the DiT's OOD classify on MIMIC or PadChest: 64 px → DWT 32 × 32 → 64
# tokens at patch 4; 64 rows a forward, two forwards a batch of 16 images at
# 4 evaluations × 2 classes
DIT_OOD_SHAPE = (64, 64, 6, 64)
# the DiT's classify megabatch at the group sizes G = 2 and 4 that a stage of
# 4 evaluations can take on the card (``card_eval_group``, from the free
# memory; ``row_bytes`` runs G = 1 and 2): 16 images x 1 class a chunk x G
# (phase 5, the train eval), DDP's 8 rows a rank x 2 classes x G, and the
# IPMSA DiT's 8 x 2 x G; G = 1 is DIT_SHAPE
DIT_GROUP_SHAPES = [(16 * g, 1024, 6, 64) for g in (2, 4)]
# the CIFAR UNet's attention: level 2 (8x8 tokens, 256 = 8 x 32) and level 3
# and mid (4x4 tokens, 512 = 8 x 64), at the sampler's tail on its CFG pair
# (2 x 32 and 2 x 64 images), at a classify tail of G x 64 images x 1 class
# a chunk (G = 1, 2, 4), and at B=1 of 4 evaluations x 10 classes
UNET_SHAPES = [(64, 64, 8, 32), (64, 16, 8, 64), (128, 64, 8, 32), (128, 16, 8, 64),
               (256, 64, 8, 32), (256, 16, 8, 64), (40, 64, 8, 32), (40, 16, 8, 64)]
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
# the TMA tiles' ragged edges at every head dim (each D its own box width and
# swizzle): one row, under one 64-row box, one row past a box, past two
# boxes (the 128-row tiles), and 1000 (ragged after several ring rounds)
TMA_RAGGED_CASES = [((2, s, 2, d), torch.bfloat16) for d in (32, 64, 128) for s in (1, 17, 65, 129, 1000)]
# the IPMSA paths' other shapes (phases 22-23): the UNet's level 3 (256
# tokens, 8 x 64) in its classify and explain tails (2 x 8 rows), its B=1
# classify tail (2 rows) and its step at the config's B=64; the IPMSA DiT's
# train batch of 8 (1024 tokens, 6 x 64). Phase 22 holds (8, 256, 8, 64).
IP_TAIL_SHAPE = (16, 256, 8, 64)
IP_B1_SHAPE = (2, 256, 8, 64)
# its classify tails at G = 2 (B=8: 32 rows; B=1: 4), beside G = 1 (the
# two above) and G = 4 (IP_B64_SHAPE and IP_SHAPE's rows)
IP_GROUP_SHAPES = [(32, 256, 8, 64), (4, 256, 8, 64)]
IP_B64_SHAPE = (64, 256, 8, 64)
IP_DIT_SHAPE = (8, 1024, 6, 64)
# the CIFAR UNet under tensor parallelism on a model axis of 2 (phase 27):
# 4 of its 8 heads a rank, at the train and classify batch of 64
TP_CASES = [(shape, dtype) for shape in ((64, 64, 4, 32), (64, 16, 4, 64))
            for dtype in (torch.float32, torch.bfloat16)]
# its classify tails (fp32) at the group sizes G = 2 and 4: G x 64 images
TP_CLASSIFY_CASES = [((64 * g, s, 4, d), torch.float32) for g in (2, 4) for s, d in ((64, 32), (16, 64))]
# DiT-XL/2 at 512 px (the dit_xl2_512 benchmark cell): 1,024 tokens of 16
# heads x 72, forward only, in the tournament's megabatches of 1,000 rows
# (stage 1), 350 (stage 2, 7 evaluations x 50 classes) and 240 (stage 3);
# XL_SHAPE is timed. D = 72 pads to 80 inside the kernel, so ragged
# sequences and a single token are held too
XL_SHAPE = (240, 1024, 16, 72)
XL_CASES = [(shape, torch.bfloat16) for shape in (
    (1000, 1024, 16, 72), (350, 1024, 16, 72), XL_SHAPE, (3, 1000, 16, 72), (2, 65, 16, 72),
    (4, 17, 4, 72), (1, 1, 2, 72))]
KERNEL_CASES = [
    (DIT_SHAPE, torch.bfloat16),
    *((shape, torch.bfloat16) for shape in DIT_GROUP_SHAPES),
    (DIT_OOD_SHAPE, torch.bfloat16),
    (IP_TAIL_SHAPE, torch.bfloat16),
    (IP_B1_SHAPE, torch.bfloat16),
    *((shape, torch.bfloat16) for shape in IP_GROUP_SHAPES),
    (IP_B64_SHAPE, torch.bfloat16),
    (IP_DIT_SHAPE, torch.bfloat16),
    ((2, 1024, 6, 64), torch.float32),
    ((1, 1024, 3, 128), torch.bfloat16),
    *TP_CASES,
    *TP_CLASSIFY_CASES,
    *RAGGED_CASES,
    *TMA_RAGGED_CASES,
    *XL_CASES,
]
BWD_CASES = [
    (DIT_SHAPE, torch.bfloat16),
    (IP_B64_SHAPE, torch.bfloat16),
    (IP_DIT_SHAPE, torch.bfloat16),
    ((2, 1024, 6, 64), torch.float32),
    ((1, 512, 3, 128), torch.bfloat16),
    *TP_CASES,
    *RAGGED_CASES,
    *TMA_RAGGED_CASES,
]
# runs of the DiT's shape whose outputs must be the same bits (phases 3, 6)
# the fused LayerNorm (csrc/layer_norm.cu) against its plain version: the
# DiT's classify forward [B·K·G = 128, 1024, 384] and its 32-row forward, the
# CIFAR UNet's transformer blocks at a classify tail (1,024 rows at 8 × 8
# tokens × 256 and 4 × 4 × 512), an odd row count, DiT-B's and the UNets'
# widest rows, a width no multiple of 8 and rows past 256 chunks (the
# two-pass kernel), and fp32
LN_SHAPE = (128, 1024, 384)
LN_CASES = [
    (LN_SHAPE, torch.bfloat16), ((32, 1024, 384), torch.bfloat16),
    ((1024, 64, 256), torch.bfloat16), ((1024, 16, 512), torch.bfloat16),
    ((3, 37, 384), torch.bfloat16), ((4, 256, 768), torch.bfloat16), ((2, 64, 1152), torch.bfloat16),
    ((4, 10, 100), torch.bfloat16), ((2, 8, 4096), torch.bfloat16), ((2, 64, 384), torch.float32),
    ((240, 1024, 1152), torch.bfloat16),  # DiT-XL/2's last-stage megabatch
]
LN_EPS = 1e-5
# the fused GroupNorm (csrc/group_norm.cu) against its plain version at every
# (H, W, C, groups) the UNets' no-grad paths launch it at, one line a UNet
# (square images): the CIFAR flagship (and the t5 UNet) in bf16 and, through
# the tensor-parallel ranks of phase 27, in fp32; the CheXpert UNet at 128 px
# after the DWT; the IPMSA UNet at 128 px. The split resnets' halves take
# half the groups.
GN_UNETS = {
    "cifar": [(32, 128, 32), (32, 128, 16), (16, 128, 32), (16, 128, 16), (16, 384, 32), (8, 128, 32),
              (8, 256, 32), (8, 256, 16), (8, 384, 32), (8, 768, 32), (4, 256, 32), (4, 512, 32),
              (4, 512, 16), (4, 768, 32)],
    "chexpert": [(128, 256, 32), (128, 256, 16), (128, 768, 32), (64, 256, 32), (64, 512, 32), (64, 512, 16),
                 (64, 768, 32), (64, 1280, 32), (32, 512, 32), (32, 768, 32), (32, 768, 16), (32, 1280, 32)],
    "ipmsa": [(128, 128, 32), (128, 128, 16), (128, 384, 32), (64, 128, 32), (64, 256, 32), (64, 256, 16),
              (64, 384, 32), (32, 256, 32), (32, 256, 16), (32, 768, 32), (16, 256, 32), (16, 512, 32),
              (16, 512, 16), (16, 768, 32), (16, 1280, 32), (8, 512, 32), (8, 768, 32), (8, 768, 16),
              (8, 1280, 32)],
}
# group sizes of no whole half chunk, which no path here launches but the kernel
# takes (a partial a channel): diffusers' UNet2DModel widths 224-448-672 (cg 7,
# 14, 21) and SD's 320 (cg 10, two passes at 64 x 64) in 32 groups
GN_ODD = [(32, 224, 32), (16, 448, 32), (8, 672, 32), (64, 320, 32)]
GN_CASES = sorted(
    {((h, h, c, g), torch.bfloat16) for cases in [*GN_UNETS.values(), GN_ODD] for h, c, g in cases}
    | {((h, h, c, g), torch.float32) for h, c, g in GN_UNETS["cifar"] + GN_ODD}, key=str)
GN_SHAPE, GN_GROUPS = (1024, 32, 32, 128), 32  # the CIFAR cell's tail rows at 32 x 32
GN_STREAM_SHAPE = (16, 128, 128, 256)  # the CheXpert UNet's first norms at 128 x 128: two passes
REPEATS = 20
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
# the CIFAR flagship: the bench's cut (4 evaluations of the config's 16) at
# its batch, 2 batches of the synthetic set's 128 val images
CIFAR_CONFIG = {
    "data_path": "synthetic",
    "image_size": 32,
    "classes": 10,
    "encoder_type": "nn",
    "mixed_precision": "bf16",
    "batch_size": 64,
    "evaluation_per_stage": [4],
    "evaluation_batches": 1,
}
SAMPLE_STEPS = 128  # the config default
# one epoch of the synthetic set's 256 train images: 16 steps at B=16; the
# loss goes to track.jsonl at every step; the eval's samples for the plot
# function cut to 8 steps (the config's 128 would add ~5 s)
TRAINING_CONFIG = dict(
    INFERENCE_CONFIG, num_epochs=1, log_every_steps=1, use_comet=True,
    experiment_dir="chexpert-dit-train", sampling_steps=8,
)
# the flagship's training: one epoch of the synthetic set's 512 train images,
# 8 steps at the config's B=64; the eval classifies the 2 val batches at 4
# evaluations (CIFAR_CONFIG) and samples them at 8 steps for the plot
CIFAR_TRAINING_CONFIG = dict(
    CIFAR_CONFIG, num_epochs=1, log_every_steps=1, use_comet=True,
    experiment_dir="cifar10-train", sampling_steps=8,
)
# the backward's UNet shapes: the train batch of 64 at level 2 (64 tokens x
# D=32) and at level 3 and mid (16 tokens x D=64)
UNET_BWD_SHAPES = [(64, 64, 8, 32), (64, 16, 8, 64)]


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
    from diffusion_classifier_tpu_torch.utils import profiling

    for kernel in (fa.FLASH_FWD, fa.FLASH_BWD):
        kernel.launches = 0
        kernel.copies = 0
    profiling.reset_counters()


def python_steps() -> int:
    """Train steps since ``reset_counts`` whose ops ran from Python: eager, or recorded into a CUDA graph.

    A replayed step (``engine/steps.py``) launches its kernels from the
    graph, past the wrappers' launch counters and the forward hooks.
    """
    from diffusion_classifier_tpu_torch.utils import profiling

    c = profiling.counters()
    return c.get("train.eager", 0) + c.get("train.graph.captures", 0)


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
    ("convolution", ("fprop", "dgrad", "wgrad", "conv2d", "convolve", "implicit")),
    ("matmul", ("gemm", "addmm", "matmul", "cutlass", "xmma", "cublas", "nvjet")),
)


def profile_table(tag, fn):
    """Profile one call of ``fn``; print device time by kernel and by category.

    Returns ``(total device ms, {category: ms}, kernels launched)``.
    """
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
    return total, by_category, sum(r[1] for r in rows)


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
    # host libraries the data path may use (read from the installed metadata, not imported)
    from importlib import metadata

    found = {}
    for name in ("numpy", "pillow", "pandas", "matplotlib", "triton"):
        try:
            found[name] = metadata.version(name)
        except metadata.PackageNotFoundError:
            found[name] = "absent"
    print("[1 device] host libraries: " + ", ".join(f"{k} {v}" for k, v in found.items()))


def entry_name(text):
    """``"dkdv bf16 D=64 wg=2"`` for a mangled kernel name in ``text``; ``text`` if none.

    The bf16 ``wgmma`` entries carry their tiling: the forward's K/V tile
    rows (``N=``), the backward passes' consumer warpgroups (``wg=``).
    """
    match = re.search(r"(flash_fwd|delta|dkdv|dq)(_wgmma)?_kernelI(13__nv_bfloat16|f)?Li(\d+)E((?:Li\d+E)*)", text)
    if not match:
        return ln_entry_name(text) or gn_entry_name(text) or text.strip()
    name, wgmma, dtype, dim, rest = match.groups()
    label = f"{name} {'f32' if dtype == 'f' else 'bf16'} D={dim}"
    if wgmma:
        (tiling,) = [int(x) for x in re.findall(r"Li(\d+)E", rest)]
        label += f" N={tiling}" if name == "flash_fwd" else f" wg={tiling}"
    return label


SASS_OPS = {"hgmma": r"\bHGMMA\.", "utmaldg": r"\bUTMALDG\b", "ldg128": r"\bLDG\.E\.128\b",
            "stg128": r"\bSTG\.E\.128\b"}
_LN_TYPES = {"13__nv_bfloat16": "bf16", "f": "f32"}


def ln_entry_name(text):
    """``"layer_norm_rows bf16>bf16 vec=8 lanes=16 chunks=3"`` for a mangled LayerNorm entry in ``text``; None if none."""
    match = re.search(r"(layer_norm_(?:long_)?rows)I(13__nv_bfloat16|f)(S\d*_|13__nv_bfloat16|f)((?:Li\d+E)+)", text)
    if not match:
        return None
    name, tin, tout, ints = match.groups()
    tin = _LN_TYPES[tin]
    tout = tin if tout.startswith("S") else _LN_TYPES[tout]
    values = re.findall(r"Li(\d+)E", ints)
    label = f"{name} {tin}>{tout} vec={values[0]}"
    return label + (f" lanes={values[1]} chunks={values[2]}" if len(values) == 3 else "")


def gn_entry_name(text):
    """``"group_norm_tile bf16 chunks=8 acc=2"`` for a mangled GroupNorm entry in ``text``; None if none."""
    match = re.search(r"(group_norm_(?:tile|stream))I(13__nv_bfloat16|f)((?:Li\d+E)+)", text)
    if not match:
        return None
    name, dtype, ints = match.groups()
    values = re.findall(r"Li(\d+)E", ints)
    chunks = f" chunks={values[0]}" if name == "group_norm_tile" else ""
    return f"{name} {_LN_TYPES[dtype]}{chunks} acc={values[-1]}"


def sass_counts(kernel):
    """``{entry: {"hgmma": n, "utmaldg": n}}`` over ``kernel``'s library (``cuobjdump -sass``).

    ``wgmma`` assembles to ``HGMMA`` and a TMA tile load to ``UTMALDG``.
    """
    from diffusion_classifier_tpu_torch.utils import native

    tool = os.path.join(os.path.dirname(native.find("nvcc")), "cuobjdump")
    check(os.path.isfile(tool), f"no cuobjdump beside nvcc: {tool}")
    sass = subprocess.run(
        [tool, "-sass", kernel.path()], capture_output=True, text=True, check=True,
        timeout=300,
    ).stdout
    counts, entry = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            entry = entry_name(line.split("Function :", 1)[1])
            counts[entry] = dict.fromkeys(SASS_OPS, 0)
        elif entry is not None:
            for op, pattern in SASS_OPS.items():
                counts[entry][op] += bool(re.search(pattern, line))
    return counts


def phase_build(fa):
    from diffusion_classifier_tpu_torch.ops import group_norm as gn
    from diffusion_classifier_tpu_torch.ops import layer_norm as ln
    from diffusion_classifier_tpu_torch.utils import native

    seconds = native.build_all(fa.FLASH_FWD, fa.FLASH_BWD, ln.LAYER_NORM, gn.GROUP_NORM)
    print(f"[2 build] flash_attn_fwd, flash_attn_bwd, layer_norm and group_norm built and loaded in {seconds:.2f} s")
    sass = {}
    for kernel in (fa.FLASH_FWD, fa.FLASH_BWD, ln.LAYER_NORM, gn.GROUP_NORM):
        # ptxas -v: one "Compiling entry function '<mangled name>'" line, then
        # its spills, then its registers (none when the library was built
        # before this process)
        entry = spill = None
        ptxas = {}
        for line in kernel.build_log.splitlines():
            if "Compiling entry" in line:
                entry = entry_name(line)
            elif "spill stores" in line:
                spill = re.search(r"(\d+) bytes spill stores", line).group(1)
            elif "Used" in line and "registers" in line and entry:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                ptxas[entry] = f"{regs} registers, {spill} bytes spilled"
                entry = None
        counts = sass_counts(kernel)
        for entry, ops in counts.items():
            print(f"[2 build]   {entry}: {ptxas.get(entry, 'built earlier')}, "
                  + ", ".join(f"{n} {op.upper()}" for op, n in ops.items()))
        if kernel is ln.LAYER_NORM:
            # every one-pass entry loads its row 16 bytes a lane
            rows = {e: n for e, n in counts.items() if e.startswith("layer_norm_rows")}
            check(len(rows) == 4 * 14, f"one-pass entries of layer_norm in the SASS: {sorted(rows)}")
            lacking = sorted(e for e, n in rows.items() if not n["ldg128"])
            check(not lacking, f"layer_norm entries without 16-byte loads: {lacking}")
            sass[kernel.name] = rows
            continue
        if kernel is gn.GROUP_NORM:
            # every entry (2 types x 4 held chunk counts and the two-pass kernel x 3
            # partial layouts) loads and stores its tile 16 bytes a thread
            entries = {e: n for e, n in counts.items() if e.startswith("group_norm_")}
            check(len(entries) == 2 * 5 * 3, f"entries of group_norm in the SASS: {sorted(entries)}")
            lacking = sorted(e for e, n in entries.items() if not (n["ldg128"] and n["stg128"]))
            check(not lacking, f"group_norm entries without 16-byte loads and stores: {lacking}")
            sass[kernel.name] = entries
            continue
        # every bf16 entry of the attention passes runs wgmma fed by TMA: the
        # forward's 64- and 128-row K/V tilings (64 only at D=128 and the
        # forward-only D=72), the dk/dv and dq passes at 1 and 2 consumer
        # warpgroups, per D
        tensor_core = {e: n for e, n in counts.items() if e.split()[0] in ("flash_fwd", "dkdv", "dq") and "bf16" in e}
        check(len(tensor_core) == (6 if kernel is fa.FLASH_FWD else 12),
              f"bf16 entries of {kernel.name} in the SASS: {sorted(counts)}")
        lacking = sorted(e for e, n in tensor_core.items() if not (n["hgmma"] and n["utmaldg"]))
        check(not lacking, f"bf16 entries of {kernel.name} without HGMMA or UTMALDG: "
              + ", ".join(f"{e} ({tensor_core[e]})" for e in lacking))
        sass[kernel.name] = tensor_core
    return sass


def phase_kernel(fa):
    gen = torch.Generator(device="cuda").manual_seed(0)
    record = {"shapes": []}
    for shape, dtype in KERNEL_CASES:
        q, k, v = strided_qkv(shape, dtype, gen)
        got = fa.FLASH_FWD(q, k, v)
        torch.cuda.synchronize()
        # the plain version's fp32 scores, 64 batch rows at a time (DiT-XL/2's 1,000 rows would take 67 GB)
        want = torch.cat([fa.flash_attention_reference(q[i:i + 64], k[i:i + 64], v[i:i + 64])
                          for i in range(0, shape[0], 64)])
        check(got.dtype == dtype and got.shape == q.shape, f"output {got.dtype} {got.shape}")
        check(bool(torch.isfinite(got).all()), f"non-finite kernel output at {shape}")
        err = (got.float() - want.float()).abs().max().item()
        print(f"[3 kernel] {shape} {str(dtype)[6:]} strided q/k/v: max |kernel - plain| = {err:.3e} (atol {TOL[dtype]['atol']}, rtol {TOL[dtype]['rtol']})")
        torch.testing.assert_close(got, want, **TOL[dtype])
        record["shapes"].append({"shape": list(shape), "dtype": str(dtype)[6:], "qkv": "strided thirds", "max_abs_err": err})
        if shape == DIT_SHAPE:
            b, s, h, d = shape
            # compute-sanitizer refuses the card's sandbox: a race between the
            # TMA ring and the products would show as output bits that move
            same = all(torch.equal(got, fa.FLASH_FWD(q, k, v)) for _ in range(REPEATS))
            print(f"[3 kernel] {shape} bf16 run {REPEATS + 1} times: bit-identical {same}")
            check(same, f"the forward's output differs between runs at {shape}")
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
        if shape == XL_SHAPE:
            # the roofline counts the model's work at D = 72, not the 80 columns the kernel pads to;
            # the plain route (dot_product_attention: fp32 logits) is timed on 16 of the rows
            from diffusion_classifier_tpu_torch.ops.attention import dot_product_attention

            b, s, h, d = shape
            xl = record["xl"] = {"shape": list(shape), "max_abs_err": err}
            q16, k16, v16 = q[:16], k[:16], v[:16]
            xl["plain_ms_16_rows"] = cuda_ms(lambda: dot_product_attention(q16, k16, v16))
            xl["kernel_ms_16_rows"] = cuda_ms(lambda: fa.FLASH_FWD(q16, k16, v16))
            qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            timed_in_turns(xl, lambda: fa.FLASH_FWD(q, k, v), lambda: F.scaled_dot_product_attention(qh, kh, vh))
            xl["bound_ms"], xl["bound_by"] = bound(4 * b * h * s * s * d, 4 * q.numel() * q.element_size(), dtype)
            xl["roofline_pct"] = 100 * xl["bound_ms"] / xl["ms"]
            print(f"[3 kernel] {shape} bf16 (D=72, padded to 80): kernel {xl['ms']:.4f} ms, SDPA {xl['library_ms']:.4f} ms "
                  f"(kernel/SDPA {xl['library_ratio']:.3f}), bound {xl['bound_ms']:.4f} ms ({xl['bound_by']}, "
                  f"{xl['roofline_pct']:.1f}% of it); 16 rows: kernel {xl['kernel_ms_16_rows']:.4f} ms, "
                  f"plain route {xl['plain_ms_16_rows']:.4f} ms")
    return record


def phase_backward(fa):
    gen = torch.Generator(device="cuda").manual_seed(3)
    record = {"shapes": []}
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
        record["shapes"].append({"shape": list(shape), "dtype": str(dtype)[6:], "qkv": "strided thirds", "max_abs_err": max(errs)})
        if shape == DIT_SHAPE:
            b, s, h, d = shape
            same = [all(torch.equal(g, a) for a in again) for g, *again in zip(
                got, *(fa.FLASH_BWD(q, k, v, out, do, lse) for _ in range(REPEATS)))]
            print(f"[6 backward] {shape} bf16 run {REPEATS + 1} times: dq, dk, dv bit-identical {same}")
            check(all(same), f"the backward's gradients differ between runs at {shape}: {same}")
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


def phase_layer_norm():
    """The fused LayerNorm's AdaLN epilogue against its plain version at ``LN_CASES``; times at the DiT's shape."""
    from diffusion_classifier_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(5)
    record = {"shapes": []}
    for shape, dtype in LN_CASES:
        d = shape[-1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.3).to(dtype)
        mods = (torch.randn((shape[0], 6 * d), generator=gen, device="cuda") * 0.5).to(dtype)
        shift, scale = mods[:, :d], mods[:, d:2 * d]  # views of one row, as the DiT's chunks
        w, b = torch.randn(d, generator=gen, device="cuda"), torch.randn(d, generator=gen, device="cuda")
        args = dict(shift=shift, scale=scale, dtype=dtype)
        got = ln.LAYER_NORM(x, LN_EPS, **args)
        torch.cuda.synchronize()
        want = ln.layer_norm_reference(x, LN_EPS, **args)
        check(bool(torch.isfinite(got).all()), f"non-finite layer_norm output at {shape}")
        err = (got.float() - want.float()).abs().max().item()
        same = (got == want).float().mean().item()
        print(f"[3b layer_norm] {shape} {str(dtype)[6:]} AdaLN: identical {100 * same:.4f}%, max |kernel - plain| = {err:.3e}")
        if dtype == torch.bfloat16:
            check(same >= 0.999, f"layer_norm: {same} of the outputs identical at {shape}")
            r = ln.LAYER_NORM(x, LN_EPS, dtype=dtype)
            check(torch.equal(got, r * (1.0 + scale[:, None, :]) + shift[:, None, :]),
                  f"the AdaLN epilogue's roundings differ from the plain chain's at {shape}")
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        affine = ln.LAYER_NORM(x, LN_EPS, weight=w, bias=b, dtype=dtype)
        affine_want = ln.layer_norm_reference(x, LN_EPS, weight=w, bias=b, dtype=dtype)
        affine_same = (affine == affine_want).float().mean().item()
        check(affine_same >= 0.999 or dtype == torch.float32, f"affine: {affine_same} identical at {shape}")
        if dtype == torch.float32:
            torch.testing.assert_close(affine, affine_want, rtol=1e-5, atol=1e-5)
        entry = {"shape": list(shape), "dtype": str(dtype)[6:], "identical": same, "max_abs_err": err,
                 "affine_identical": affine_same}
        if shape in ((1024, 64, 256), (1024, 16, 512)):  # the UNet's affine norms
            entry["affine_ms"] = cuda_ms(lambda: ln.LAYER_NORM(x, LN_EPS, weight=w, bias=b, dtype=dtype))
            entry["affine_plain_ms"] = cuda_ms(
                lambda: ln.layer_norm_reference(x, LN_EPS, weight=w, bias=b, dtype=dtype))
            print(f"[3b layer_norm] {shape} affine: kernel {entry['affine_ms']:.4f} ms, plain {entry['affine_plain_ms']:.4f} ms")
        record["shapes"].append(entry)
        if shape == LN_SHAPE:
            again = all(torch.equal(got, ln.LAYER_NORM(x, LN_EPS, **args)) for _ in range(REPEATS))
            check(again, f"layer_norm's output differs between runs at {shape}")
            record["max_abs_err"] = err
            record["plain_ms"] = cuda_ms(lambda: ln.layer_norm_reference(x, LN_EPS, **args))
            # the yardstick: ATen's own LayerNorm, bf16 in and out, without the modulation
            timed_in_turns(record, lambda: ln.LAYER_NORM(x, LN_EPS, **args),
                           lambda: F.layer_norm(x, (d,), eps=LN_EPS))
            record["none_ms"] = cuda_ms(lambda: ln.LAYER_NORM(x, LN_EPS, dtype=dtype), reps=TURN_REPS,
                                        inner=BACK_TO_BACK)
            # x in, the output out, the scale and shift rows: each byte once
            nbytes = 2 * x.numel() * x.element_size() + 2 * shift.numel() * shift.element_size()
            record["bound_ms"], record["bound_by"] = bound(0, nbytes, dtype)
            record["tb_per_s"] = nbytes / (record["ms"] * 1e-3) / 1e12
            print(f"[3b layer_norm] {shape} bf16 AdaLN run {REPEATS + 1} times: bit-identical {again}; "
                  f"kernel {record['ms']:.4f} ms ({record['tb_per_s']:.3f} TB/s, {100 * record['bound_ms'] / record['ms']:.1f}% of the bound), "
                  f"no epilogue {record['none_ms']:.4f} ms, plain {record['plain_ms']:.4f} ms, "
                  f"F.layer_norm {record['library_ms']:.4f} ms (kernel/F.layer_norm {record['library_ratio']:.3f}); "
                  f"single calls: kernel {record['call_ms']:.4f} ms; host {record['host_us']:.1f} us per wrapper call; "
                  f"bound {record['bound_ms']:.4f} ms ({record['bound_by']})")
    ln.LAYER_NORM.copies = 0  # the paths below must copy nothing
    return record


def phase_group_norm():
    """The fused GroupNorm against its plain version at ``GN_CASES``; times at the CIFAR cell's largest norm and a two-pass one."""
    from diffusion_classifier_tpu_torch.ops import group_norm as gn

    gen = torch.Generator(device="cuda").manual_seed(6)

    def inputs(shape, dtype):
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.3).to(dtype)
        c = shape[-1]
        return x, 1 + 0.05 * torch.randn(c, generator=gen, device="cuda"), 0.02 * torch.randn(c, generator=gen, device="cuda")

    record = {"shapes": []}
    for (h, w, c, g), dtype in GN_CASES:
        x, scale, bias = inputs((2, h, w, c), dtype)
        same, err = 1.0, 0.0
        for eps in (1e-5, 1e-6):
            for silu in (False, True):
                kw = dict(num_groups=g, eps=eps, silu=silu)
                got = gn.GROUP_NORM(x, scale, bias, **kw)
                torch.cuda.synchronize()
                want = gn.group_norm_reference(x, scale, bias, **kw)
                check(bool(torch.isfinite(got).all()), f"non-finite group_norm output at {(h, w, c, g)}")
                worst = (got.float() - want.float()).abs().max().item()
                err = max(err, worst)
                if dtype == torch.bfloat16:
                    same = min(same, (got == want).float().mean().item())
                    # a channel's bf16 w or b across a rounding boundary: about a bf16 ulp of the output
                    check(worst <= 2.0 ** -6 * max(1.0, want.float().abs().max().item()),
                          f"group_norm: max |kernel - plain| {worst:.3e} at {(h, w, c, g)}, eps {eps}, SiLU {silu}")
                else:
                    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        tile = gn.tiling(h * w, c, c // g, x.element_size())
        print(f"[3c group_norm] {(h, w, c)} {g} groups {str(dtype)[6:]} tile {tile}: identical {100 * same:.4f}% (fewest of eps 1e-5/1e-6, SiLU off/on), max |kernel - plain| = {err:.3e}")
        check(same >= 0.999, f"group_norm: {same} of the outputs identical at {(h, w, c, g)}")
        record["shapes"].append({"shape": [h, w, c], "groups": g, "dtype": str(dtype)[6:], "tile": tile,
                                 "identical": same, "max_abs_err": err})
    x, scale, bias = inputs(GN_SHAPE, torch.bfloat16)
    kw = dict(num_groups=GN_GROUPS, eps=1e-5)
    got = gn.GROUP_NORM(x, scale, bias, silu=True, **kw)
    want = gn.group_norm_reference(x, scale, bias, silu=True, **kw)
    record["identical"] = (got == want).float().mean().item()
    record["max_abs_err"] = (got.float() - want.float()).abs().max().item()
    check(record["max_abs_err"] <= 2.0 ** -6 * max(1.0, want.float().abs().max().item()),
          f"group_norm: max |kernel - plain| {record['max_abs_err']:.3e} at {GN_SHAPE}")
    again = all(torch.equal(got, gn.GROUP_NORM(x, scale, bias, silu=True, **kw)) for _ in range(REPEATS))
    check(again, f"group_norm's output differs between runs at {GN_SHAPE}")
    del got, want
    record["plain_ms"] = cuda_ms(lambda: gn.group_norm_reference(x, scale, bias, **kw), reps=10)
    record["plain_silu_ms"] = cuda_ms(lambda: gn.group_norm_reference(x, scale, bias, silu=True, **kw), reps=10)
    # the yardstick: ATen's own GroupNorm on the NCHW view, bf16 affine, without the SiLU
    nchw, scale16, bias16 = x.permute(0, 3, 1, 2), scale.to(torch.bfloat16), bias.to(torch.bfloat16)
    timed_in_turns(record, lambda: gn.GROUP_NORM(x, scale, bias, silu=True, **kw),
                   lambda: F.group_norm(nchw, GN_GROUPS, scale16, bias16, 1e-5))
    record["none_ms"] = cuda_ms(lambda: gn.GROUP_NORM(x, scale, bias, **kw), reps=TURN_REPS, inner=BACK_TO_BACK)
    # x in, the output out, the scale and bias: each byte once
    nbytes = 2 * x.numel() * x.element_size() + 2 * scale.numel() * scale.element_size()
    record["bound_ms"], record["bound_by"] = bound(0, nbytes, torch.bfloat16)
    record["tb_per_s"] = nbytes / (record["ms"] * 1e-3) / 1e12
    print(f"[3c group_norm] {GN_SHAPE} bf16 {GN_GROUPS} groups + SiLU, tile {gn.tiling(1024, 128, 4, 2)}: "
          f"identical {100 * record['identical']:.4f}%, run {REPEATS + 1} times: bit-identical {again}; "
          f"kernel {record['ms']:.4f} ms ({record['tb_per_s']:.3f} TB/s, {100 * record['bound_ms'] / record['ms']:.1f}% of the bound), "
          f"no SiLU {record['none_ms']:.4f} ms, plain {record['plain_ms']:.4f} ms, plain + F.silu {record['plain_silu_ms']:.4f} ms, "
          f"F.group_norm {record['library_ms']:.4f} ms (kernel/F.group_norm {record['library_ratio']:.3f}); "
          f"single calls: kernel {record['call_ms']:.4f} ms; host {record['host_us']:.1f} us per wrapper call; "
          f"bound {record['bound_ms']:.4f} ms ({record['bound_by']})")
    # the two-pass kernel, which reads the tile a second time, from L2 where it is still there
    del x
    x, scale, bias = inputs(GN_STREAM_SHAPE, torch.bfloat16)
    n, h, w, c = GN_STREAM_SHAPE
    tile = gn.tiling(h * w, c, c // GN_GROUPS, 2)
    check(tile[1] == 0, f"group_norm: {GN_STREAM_SHAPE} takes the tile {tile}, not two passes")
    kw = dict(num_groups=GN_GROUPS, eps=1e-5, silu=True)
    stream = {"shape": list(GN_STREAM_SHAPE), "tile": tile}
    stream["ms"], stream["plain_silu_ms"] = in_turns(lambda: gn.GROUP_NORM(x, scale, bias, **kw),
                                                     lambda: gn.group_norm_reference(x, scale, bias, **kw),
                                                     reps=10, inner=2)
    nbytes = 2 * x.numel() * x.element_size() + 2 * scale.numel() * scale.element_size()
    stream["bound_ms"], _ = bound(0, nbytes, torch.bfloat16)
    stream["tb_per_s"] = nbytes / (stream["ms"] * 1e-3) / 1e12
    record["stream"] = stream
    print(f"[3c group_norm] {GN_STREAM_SHAPE} bf16 {GN_GROUPS} groups + SiLU, two passes, tile {tile}: "
          f"kernel {stream['ms']:.4f} ms ({stream['tb_per_s']:.3f} TB/s counting x once, "
          f"{100 * stream['bound_ms'] / stream['ms']:.1f}% of the bound), plain + F.silu {stream['plain_silu_ms']:.4f} ms "
          f"({stream['plain_silu_ms'] / stream['ms']:.2f}x), bound {stream['bound_ms']:.4f} ms (bytes)")
    gn.GROUP_NORM.copies = 0  # the paths below must copy nothing
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


def load_script(name, experiment="chexpert-dit"):
    path = os.path.join(REPO, "experiments", experiment, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{experiment}_{name}", path)
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
        busy, _, _ = profile_table(f"[5 entry] classify B={b}", lambda: engine.classify(images[:b]))
        print(f"[5 entry] classify B={b}: device busy {busy:.2f} of {ms:.2f} ms median wall, idle ~{100 * max(0.0, 1 - busy / ms):.1f}%")
    row_bytes(engine, images, "[5 entry]")
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
    saved = []
    reset_counts(fa)
    start = time.perf_counter()
    # the numpy plot function (the card's machine may lack matplotlib), fed
    # by the eval's sampling pass at the config's cut 8 steps
    engine = train_torch.main([], plot_function=numpy_plotter(saved))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    fwd, bwd = fa.FLASH_FWD.launches, fa.FLASH_BWD.launches
    check_no_copies(fa, "[8 train]")
    check(len(saved) == 1 and os.path.isfile(saved[0]), "the plot function did not run")
    config = config_cls.from_dict(dict(cfg))
    steps = 256 // config.batch_size
    exp = config.experiment_path
    with open(os.path.join(exp, "track.jsonl")) as f:
        events = [json.loads(line) for line in f]
    losses = [e["value"] for e in events if e.get("name") == "loss" and e.get("step") is not None]
    print(f"[8 train] train_torch.main(plot_function=numpy plotter, sampling_steps {cfg['sampling_steps']}): {len(losses)} steps in {seconds:.1f} s (eval, sampling for the plot and checkpoint included); launches fwd {fwd} bwd {bwd}; loss first {losses[0]:.5f} last {losses[-1]:.5f}; plot {saved}")
    check(len(losses) == steps, f"{len(losses)} logged losses, expected {steps}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    ran = python_steps()
    check(bwd == 12 * ran, f"{bwd} backward launches for {ran} steps run from Python, expected {12 * ran}")
    check(fwd > 12 * ran, f"{fwd} forward launches: the training and the eval must both run the kernel")
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

    busy, _, _ = profile_table("[8 train] one warm step", lambda: engine.train_step(batch))
    print(f"[8 train] step: device busy {busy:.2f} of {step_ms:.2f} ms median wall, idle ~{100 * max(0.0, 1 - busy / step_ms):.1f}%")
    return fwd, bwd


def phase_unet_kernel(fa):
    """The forward kernel vs its plain version at the UNet's shapes; returns the per-shape records."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    records = []
    for shape in UNET_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
            reset_counts(fa)
            got = fa.FLASH_FWD(q, k, v)
            torch.cuda.synchronize()
            check(fa.FLASH_FWD.copies == 0, f"the kernel copied an input at {shape}")
            want = fa.flash_attention_reference(q, k, v)
            check(got.dtype == dtype and got.shape == q.shape and bool(torch.isfinite(got).all()),
                  f"output {got.dtype} {got.shape} at {shape}")
            torch.testing.assert_close(got, want, **TOL[dtype])
            b, s, h, d = shape
            record = {"shape": list(shape), "dtype": str(dtype)[6:], "qkv": "separate",
                      "max_abs_err": (got.float() - want.float()).abs().max().item()}
            record["plain_ms"] = cuda_ms(lambda: fa.flash_attention_reference(q, k, v), inner=BACK_TO_BACK)
            qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            timed_in_turns(record, lambda: fa.FLASH_FWD(q, k, v), lambda: F.scaled_dot_product_attention(qh, kh, vh))
            # at these sizes the host sets the pace of back-to-back calls: the
            # profiler gives each one's device time
            record["device_ms"] = device_ms(lambda: fa.FLASH_FWD(q, k, v))
            record["library_device_ms"] = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
            record["plain_device_ms"] = device_ms(lambda: fa.flash_attention_reference(q, k, v))
            record["bound_ms"], record["bound_by"] = bound(
                4 * b * h * s * s * d, 4 * q.numel() * q.element_size(), dtype
            )
            print(f"[9 unet kernel] {shape} {record['dtype']}: max |kernel - plain| {record['max_abs_err']:.3e}; device time kernel {record['device_ms']:.4f} ms, SDPA {record['library_device_ms']:.4f} ms, plain {record['plain_device_ms']:.4f} ms; CUDA events over back-to-back calls kernel {record['ms']:.4f} ms, SDPA {record['library_ms']:.4f} ms (kernel/SDPA {record['library_ratio']:.3f}), plain {record['plain_ms']:.4f} ms; single calls kernel {record['call_ms']:.4f} ms, SDPA {record['library_call_ms']:.4f} ms; host {record['host_us']:.1f} us a call; bound {record['bound_ms']:.5f} ms ({record['bound_by']})")
            records.append(record)
    return records


def count_forwards(calls):
    """A forward hook counting the Denoiser's calls by mode and batch: ``calls[(mode, rows)]``."""
    from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser

    def hook(module, args, output):
        if isinstance(module, Denoiser):
            if isinstance(output, tuple):
                key = ("encode", args[0].shape[0])
            else:
                key = ("tail" if args[0] is None else "full", output.shape[0])
            calls[key] = calls.get(key, 0) + 1

    return torch.nn.modules.module.register_module_forward_hook(hook)


def flagship(cifar, config_cls, mixed_precision):
    """The flagship denoiser (UNet + class embedder) on the card, with the same seeded weights for either precision."""
    from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser
    from diffusion_classifier_tpu_torch.models.encoders import ClassEmbedder
    from diffusion_classifier_tpu_torch.models.layers import reset_parameters

    config = config_cls.from_dict(dict(CIFAR_CONFIG, mixed_precision=mixed_precision))
    dtype = torch.bfloat16 if mixed_precision == "bf16" else torch.float32
    model = Denoiser(cifar.build_backbone(config), ClassEmbedder(10, 128, dtype))
    reset_parameters(model, torch.Generator().manual_seed(0))
    return model.to("cuda").eval()


def set_attn_backend(model, backend):
    from diffusion_classifier_tpu_torch.models.layers import MultiHeadAttention

    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.attn_backend = backend


def device_ms(fn, calls=20):
    """Device milliseconds per call of ``fn()``: the profiler's kernel time over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    return total / 1e3 / calls


def phase_unet_forward(fa, cifar, config_cls):
    """The flagship forward, kernel vs plain attention, in bf16 and in fp32, on the same weights.

    A one-ulp change in the attention output moves this network's bf16
    output by ~1.4% (relative L2): plain attention against SDPA's gives the
    same on the CPU, and each bf16 forward lies ~1.6% from the fp32 one. So
    the bf16 kernel is held to the bf16 noise floor (its distance from the
    plain bf16 forward, and from the fp32 forward, no larger than the plain
    bf16 forward's own distance from fp32), and the fp32 kernel, whose
    rounding is fp32's, to the plain fp32 forward at 1e-4.
    """
    model = flagship(cifar, config_cls, "bf16")
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(6)
    b = 64
    x = torch.rand((b, 32, 32, 3), generator=gen, device="cuda") * 2 - 1
    t = torch.randn((b,), generator=gen, device="cuda") * 4
    y = torch.randint(0, 11, (b,), generator=gen, device="cuda")
    with torch.no_grad():
        reset_counts(fa)
        full = model(x, t, y)
        torch.cuda.synchronize()
        full_launches = fa.FLASH_FWD.launches
        state = model(x, t, None, mode="encode")
        torch.cuda.synchronize()
        encode_launches = fa.FLASH_FWD.launches - full_launches
        tail = model(None, None, y, mode="tail", prefix_state=state)
        torch.cuda.synchronize()
        tail_launches = fa.FLASH_FWD.launches - full_launches - encode_launches
        check_no_copies(fa, "[10 unet]")
        set_attn_backend(model, "xla")  # the plain version, same weights
        before = fa.FLASH_FWD.launches
        plain = model(x, t, y)
        torch.cuda.synchronize()
        check(fa.FLASH_FWD.launches == before, "attn_backend='xla' launched the kernel")
        model32 = flagship(cifar, config_cls, "no")
        reset_counts(fa)
        kernel32 = model32(x, t, y)
        torch.cuda.synchronize()
        launches32 = fa.FLASH_FWD.launches
        set_attn_backend(model32, "xla")
        plain32 = model32(x, t, y)
    check(full.shape == (b, 32, 32, 3) and full.dtype == torch.float32, f"UNet output {full.shape}")
    check(bool(torch.isfinite(full).all()) and bool(torch.isfinite(kernel32).all()), "non-finite UNet output")

    def rel(a, ref):
        return ((a - ref).norm() / ref.norm()).item()

    rel_bf16, floor = rel(full, plain), rel(plain, plain32)
    rel_kernel_fp32, rel32, rel_split = rel(full, plain32), rel(kernel32, plain32), rel(tail, full)
    print(f"[10 unet] flagship {n_params} parameters, forward B={b}: launches bf16 full {full_launches}, encode {encode_launches}, tail {tail_launches}, fp32 full {launches32}; rel L2 bf16 kernel vs bf16 plain {rel_bf16:.3e}, bf16 plain vs fp32 plain {floor:.3e} (the bf16 floor), bf16 kernel vs fp32 plain {rel_kernel_fp32:.3e}; fp32 kernel vs fp32 plain {rel32:.3e} (limit 1e-4); tail(encode) vs full {rel_split:.3e}")
    check(n_params == 95927043, f"{n_params} parameters, the flagship has 95927043")
    check((full_launches, encode_launches, tail_launches, launches32) == (11, 0, 11, 11),
          f"launches full/encode/tail/fp32 {(full_launches, encode_launches, tail_launches, launches32)}, expected 11/0/11/11")
    check(rel_bf16 <= floor, f"bf16 kernel vs plain {rel_bf16} above the bf16 floor {floor}")
    check(rel_kernel_fp32 <= 1.1 * floor, f"bf16 kernel vs fp32 {rel_kernel_fp32} > 1.1 x the floor {floor}")
    check(rel32 <= 1e-4, f"fp32 kernel vs plain: relative L2 {rel32} > 1e-4")
    check(rel_split <= 1e-3, f"tail(encode(x)) differs from the full forward: {rel_split}")


def numpy_plotter(saved):
    """A ``plot_function`` that needs no matplotlib: it saves the first batch of samples as .npy."""
    import numpy as np

    def plot(output_dir, batches, samples, epoch, process_idx):
        path = os.path.join(output_dir, f"samples_{epoch}_{process_idx}.npy")
        np.save(path, np.asarray(samples[0]))
        saved.append(path)
        return path

    return plot


def phase_unet_classify(fa, cifar, config_cls, workdir):
    # one val batch through the entry point (the synthetic set has two)
    cfg = dict(CIFAR_CONFIG, evaluation_batches=0, project_root=workdir, experiment_dir="cifar10")
    config = config_cls.from_dict(dict(cfg))
    seeded = cifar.build_engine(config)
    seeded.init_params()
    seeded.save_checkpoint(0)
    del seeded

    inference_torch = load_script("inference_torch", "cifar10")
    os.environ["INFERENCE_CONFIG"] = json.dumps(cfg)
    calls = {}
    hook = count_forwards(calls)
    try:
        free = before_run()
        reset_counts(fa)
        metric_output, preds, _ = inference_torch.main([])
        torch.cuda.synchronize()
        launches = fa.FLASH_FWD.launches
    finally:
        hook.remove()
    b, c, evals = config.batch_size, config.classes, config.evaluation_per_stage[0]
    n_batches = config.evaluation_batches + 1
    peak_gb = peak_memory("[11 unet classify] inference_torch.main()")
    group = auto_group(calls, b, evals, c, 32 * 32 * 3, free, "[11 unet classify]")
    chunk = config.classify_class_chunk
    chunk = chunk if chunk >= 0 else (1 if b >= 16 else 0)
    cc = chunk if chunk and c % chunk == 0 else c
    want = {("encode", group * b): n_batches * evals // group,
            ("tail", group * b * cc): n_batches * evals // group * (c // cc)}
    print(f"[11 unet classify] inference_torch.main(): {len(preds)} batches of {b}, forwards by (mode, rows) {calls} (expected {want}: G={group}, {c // cc} chunks of {cc} classes), {launches} forward kernel launches, {fa.FLASH_BWD.launches} backward; {metric_output}")
    check_no_copies(fa, "[11 unet classify]")
    check(calls == want, f"forwards {calls}, expected {want}")
    check(launches == 11 * want[("tail", group * b * cc)], f"{launches} launches for {want} forwards")
    check(fa.FLASH_BWD.launches == 0, "classification launched the backward")
    check(len(preds) == n_batches and len(metric_output) == 1, f"{len(preds)} batches, metrics {metric_output}")
    for p in preds:
        check(tuple(p.shape) == (b,) and bool(((p >= 0) & (p < c)).all()), f"predictions {p.tolist()}")

    engine = cifar.build_engine(config)
    engine.init_params()
    engine.load_checkpoint(os.path.join(config.experiment_path, "checkpoints"), train_state=False)
    images = (torch.rand((b, 32, 32, 3), generator=torch.Generator().manual_seed(7)) * 2 - 1).numpy()
    ms64 = cuda_ms(lambda: engine.classify(images), reps=3, warmup=1)
    ms1 = cuda_ms(lambda: engine.classify(images[:1]), reps=10, warmup=2)
    print(f"[11 unet classify] classify B={b} ({evals} evals x {c} classes, shared prefix): {ms64:.2f} ms -> {b * 1e3 / ms64:.2f} images/s")
    print(f"[11 unet classify] classify B=1 latency: {ms1:.2f} ms")
    busy, cats, _ = profile_table("[11 unet classify] classify B=1", lambda: engine.classify(images[:1]))
    print(f"[11 unet classify] classify B=1: device busy {busy:.2f} of {ms1:.2f} ms median wall, idle ~{100 * max(0.0, 1 - busy / ms1):.1f}%; flash forward {cats['flash forward']:.2f} ms ({100 * cats['flash forward'] / busy:.1f}%)")
    # the split: one encode on G·B rows and one tail on G·B·cc (1 class a
    # chunk), as the call runs them; the B=64 call's device time is their
    # sum (a profile of the whole call's kernels costs the run seconds and
    # gave the same)
    rows = group * b
    z = torch.rand((rows, 32, 32, 3), generator=torch.Generator().manual_seed(8)).cuda() * 2 - 1
    lg = torch.zeros((rows,), device="cuda")
    labels = torch.zeros((rows * cc,), dtype=torch.long, device="cuda")
    with torch.no_grad():
        state = engine._encode(z, lg)
        if cc > 1:
            from torch.utils._pytree import tree_map

            state = tree_map(lambda t: t.repeat_interleave(cc, dim=0), state)
        enc_ms, enc, _ = profile_table(f"[11 unet classify] one encode of {rows} rows", lambda: engine._encode(z, lg))
        tail_ms, tail, _ = profile_table(f"[11 unet classify] one tail of {rows * cc} rows", lambda: engine._tail(state, labels))
    n_enc, n_tail = want[("encode", group * b)] // n_batches, want[("tail", group * b * cc)] // n_batches
    busy = n_enc * enc_ms + n_tail * tail_ms
    print(f"[11 unet classify] B={b} split: {n_enc} encodes x {enc_ms:.3f} ms = {n_enc * enc_ms:.2f} ms, {n_tail} tails x {tail_ms:.3f} ms = {n_tail * tail_ms:.2f} ms device time; flash forward {tail['flash forward']:.3f} ms a tail ({100 * tail['flash forward'] / tail_ms:.1f}%), {enc['flash forward']:.3f} ms an encode; classify B={b}: device busy {busy:.2f} of {ms64:.2f} ms median wall, idle ~{100 * max(0.0, 1 - busy / ms64):.1f}%")
    per_elem = row_bytes(engine, images, "[11 unet classify]")
    return launches, {"images_per_s_b64": b * 1e3 / ms64, "latency_ms_b1": ms1, "group": group,
                      "peak_gb": peak_gb, "row_bytes_per_elem": per_elem}


def phase_sampling(fa, cifar, chexpert, config_cls, workdir):
    from torch.utils._pytree import tree_map

    from diffusion_classifier_tpu_torch.diffusion.sampler import TorchSampleDraws, make_sampler

    launches, rates = {}, {}
    cases = (
        ("cifar10", cifar, dict(CIFAR_CONFIG, batch_size=32), 11, True),
        ("chexpert-dit", chexpert, dict(INFERENCE_CONFIG), 12, False),
    )
    for experiment, module, base, per_forward, prefix in cases:
        cfg = dict(base, classification=False, sampling_steps=SAMPLE_STEPS, evaluation_batches=0,
                   project_root=workdir, experiment_dir=f"{experiment}-sample")
        config = config_cls.from_dict(dict(cfg))
        seeded = module.build_engine(config)
        seeded.init_params()
        seeded.save_checkpoint(0)
        del seeded
        tag = f"[12 sample {experiment}]"
        os.environ["INFERENCE_CONFIG"] = json.dumps(cfg)
        calls, saved = {}, []
        hook = count_forwards(calls)
        try:
            reset_counts(fa)
            samples, _ = load_script("inference_torch", experiment).main([], plot_function=numpy_plotter(saved))
            torch.cuda.synchronize()
            n = fa.FLASH_FWD.launches
        finally:
            hook.remove()
        b, steps = config.batch_size, SAMPLE_STEPS + 1  # the noisy steps and the final one
        want = {("encode", b): steps, ("tail", 2 * b): steps} if prefix else {("full", 2 * b): steps}
        out = samples[0]
        print(f"{tag} inference_torch.main(): samples {tuple(out.shape)}, range [{out.min().item():.4f}, {out.max().item():.4f}], forwards {calls} (expected {want}), {n} forward kernel launches, plot {saved}")
        check_no_copies(fa, tag)
        check(len(samples) == 1 and out.shape[0] == b and bool(torch.isfinite(out).all()), "sample shape or values")
        check(out.abs().max().item() <= 1.0, "samples outside [-1, 1]")
        check(calls == want, f"forwards {calls}, expected {want}")
        check(n == per_forward * steps, f"{n} launches for {steps} conditioned forwards")
        check(len(saved) == 1 and os.path.isfile(saved[0]), "the plot function did not run")
        launches[experiment] = n

        engine = module.build_engine(config)
        engine.init_params()
        engine.load_checkpoint(os.path.join(config.experiment_path, "checkpoints"), train_state=False)
        x = next(iter(module.build_data(config).get_test_loader()))["images"]
        ms = cuda_ms(lambda: engine.sample(x), reps=2, warmup=0)  # the entry point's call warmed up
        # one sampling step: a sampler of one noisy step plus the final one,
        # halved (profiling a whole call's 10^5 kernels takes minutes)
        one = make_sampler(
            lambda z, lg, lab: engine.state.ema_model(z, lg, lab), engine.schedule_fn,
            pred_param=config.pred_param, cfg_w=config.cfg_w, null_token=engine.null_token,
            sampling_steps=1, encode_fn=engine._encode, tail_fn=engine._tail,
        )
        xd = engine._images(x)
        labels = torch.zeros((b,), dtype=torch.long, device="cuda")
        draws = TorchSampleDraws(torch.Generator(device="cuda").manual_seed(9))
        step_ms, step, _ = profile_table(f"{tag} two sampling steps (one noisy, the final)", lambda: one(xd, labels, draws))
        busy = step_ms / 2 * steps
        print(f"{tag} one step: {step_ms / 2:.3f} ms device time, flash forward {step['flash forward'] / 2:.3f} ms ({100 * step['flash forward'] / step_ms:.1f}%)")
        print(f"{tag} B={b}, {SAMPLE_STEPS} steps: {ms:.1f} ms -> {b * 1e3 / ms:.2f} samples/s ({SAMPLE_STEPS * 1e3 / ms:.1f} steps/s); device time {busy:.1f} ms ({steps} x one step), idle ~{100 * max(0.0, 1 - busy / ms):.1f}%")
        rates[experiment] = {"samples_per_s": b * 1e3 / ms, "ms": ms, "device_ms": busy}
        if prefix:
            with torch.no_grad():
                lg = torch.zeros((b,), device="cuda")
                state = engine._encode(xd, lg)
                pair = tree_map(lambda a: torch.cat([a, a]), state)
                labels2 = torch.zeros((2 * b,), dtype=torch.long, device="cuda")
                enc_ms, _, _ = profile_table(f"{tag} one encode B={b}", lambda: engine._encode(xd, lg))
                tail_ms, _, _ = profile_table(f"{tag} one tail 2B={2 * b}", lambda: engine._tail(pair, labels2))
            print(f"{tag} step split: encode {enc_ms:.3f} ms, tail {tail_ms:.3f} ms device time")
    return launches, rates


def phase_unet_backward(fa):
    """The backward kernel vs its plain version at the UNet's shapes; returns the per-shape records."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    records = []
    for shape in UNET_BWD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            # separate q, k, v, as to_q/to_k/to_v give them
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
            out, lse = fa.FLASH_FWD(q, k, v, lse=True)
            reset_counts(fa)
            got = fa.FLASH_BWD(q, k, v, out, do, lse)
            torch.cuda.synchronize()
            check(fa.FLASH_BWD.copies == 0, f"the backward copied an input at {shape}")
            want = fa.flash_attention_bwd_reference(q, k, v, do, out)
            errs = []
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                check(g.dtype == dtype and g.shape == q.shape and bool(torch.isfinite(g).all()),
                      f"{name} {g.dtype} {g.shape} at {shape}")
                errs.append((g.float() - w.float()).abs().max().item())
                torch.testing.assert_close(g, w, **TOL[dtype], msg=lambda m: f"{name} at {shape}: {m}")
            b, s, h, d = shape
            record = {"shape": list(shape), "dtype": str(dtype)[6:], "qkv": "separate", "max_abs_err": max(errs)}
            plain = lambda: fa.flash_attention_bwd_reference(q, k, v, do, out)  # noqa: E731
            kernel = lambda: fa.FLASH_BWD(q, k, v, out, do, lse)  # noqa: E731
            record["plain_ms"] = cuda_ms(plain, inner=BACK_TO_BACK)
            qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
            oh = F.scaled_dot_product_attention(qh, kh, vh)
            doh = do.transpose(1, 2).contiguous()
            sdpa = lambda: torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True)  # noqa: E731
            timed_in_turns(record, kernel, sdpa)
            record["device_ms"] = device_ms(kernel)
            record["library_device_ms"] = device_ms(sdpa)
            record["plain_device_ms"] = device_ms(plain)
            # in: q, k, v, o, dO and the fp32 lse; out: dq, dk, dv
            nbytes = 8 * q.numel() * q.element_size() + lse.numel() * 4
            record["bound_ms"], record["bound_by"] = bound(10 * b * h * s * s * d, nbytes, dtype)
            print(f"[13 unet backward] {shape} {record['dtype']}: max |kernel - plain| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (atol {TOL[dtype]['atol']}, rtol {TOL[dtype]['rtol']}); device time kernel {record['device_ms']:.4f} ms, SDPA backward {record['library_device_ms']:.4f} ms, plain {record['plain_device_ms']:.4f} ms; CUDA events over back-to-back calls kernel {record['ms']:.4f} ms, SDPA backward {record['library_ms']:.4f} ms (kernel/SDPA {record['library_ratio']:.3f}), plain {record['plain_ms']:.4f} ms; single calls kernel {record['call_ms']:.4f} ms, SDPA backward {record['library_call_ms']:.4f} ms; host {record['host_us']:.1f} us a call; bound {record['bound_ms']:.5f} ms ({record['bound_by']})")
            records.append(record)
    return records


def phase_unet_grads(fa, cifar, config_cls):
    """One loss and backward of the full-width flagship at B=64: kernels vs plain attention, remat on vs off.

    As phase 10 holds the forward, the bf16 kernel gradients are held to the
    network's own bf16 noise floor, measured here as the distance between
    the plain bf16 and the plain fp32 gradients; fp32 kernel gradients to
    the plain fp32 ones at 1e-4; remat to no remat at 1e-6 in fp32. cuDNN
    runs its deterministic algorithms here (its default backward ones sum
    in a varying order), and a second fp32 run without remat gives the
    run-to-run spread beside the remat distance.
    """
    from diffusion_classifier_tpu_torch.diffusion.schedule import make_schedule_fn
    from diffusion_classifier_tpu_torch.engine.steps import make_loss_fn

    config = config_cls.from_dict(dict(CIFAR_CONFIG))
    schedule = make_schedule_fn(config.schedule, config.noise_d, config.image_size)
    gen = torch.Generator(device="cuda").manual_seed(11)
    b = config.batch_size
    x = torch.rand((b, 32, 32, 3), generator=gen, device="cuda") * 2 - 1
    y = torch.randint(0, 10, (b,), generator=gen, device="cuda")
    u, t = torch.rand((b,), generator=gen, device="cuda"), torch.rand((b,), generator=gen, device="cuda")
    eps = torch.randn(x.shape, generator=gen, device="cuda")
    # (precision, backend, run): "remat" recomputes the blocks, "again" repeats "once"
    runs = [(p, bk, "once") for p in ("bf16", "no") for bk in ("auto", "xla")]
    runs += [("no", "auto", "remat"), ("no", "auto", "again")]
    results, models = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for precision, backend, run in runs:
            if precision not in models:  # the same seeded weights in either precision
                models = {precision: flagship(cifar, config_cls, precision)}
            model = models[precision]
            unet_cfg = dataclasses.replace(model.backbone.config, remat=run == "remat")
            model.backbone.config = unet_cfg
            set_attn_backend(model, backend)
            loss_fn = make_loss_fn(model, schedule, pred_param=config.pred_param, null_token=10)
            model.zero_grad(set_to_none=True)
            reset_counts(fa)
            loss = loss_fn(x, y, u, t, eps)
            loss.backward()
            torch.cuda.synchronize()
            launches = (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches)
            check_no_copies(fa, f"[14 unet grads] {precision} {backend} {run}")
            grads = torch.cat([p.grad.flatten() for p in model.parameters()])
            check(math.isfinite(loss.item()) and bool(torch.isfinite(grads).all()), "non-finite loss or gradient")
            results[precision, backend, run] = (loss.item(), grads, launches)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del models

    def rel(a, ref):
        return ((a - ref).norm() / ref.norm()).item()

    g = {key: r[1] for key, r in results.items()}
    floor = rel(g["bf16", "xla", "once"], g["no", "xla", "once"])
    rel_bf16 = rel(g["bf16", "auto", "once"], g["bf16", "xla", "once"])
    rel32 = rel(g["no", "auto", "once"], g["no", "xla", "once"])
    rel_remat = rel(g["no", "auto", "remat"], g["no", "auto", "once"])
    rel_again = rel(g["no", "auto", "again"], g["no", "auto", "once"])
    loss_off, loss_on = results["no", "auto", "once"][0], results["no", "auto", "remat"][0]
    counts = {" ".join(key): res[2] for key, res in results.items()}
    print(f"[14 unet grads] flagship loss+backward B={b}: launches (fwd, bwd) {counts}; rel L2 of {g['no', 'xla', 'once'].numel()} parameter gradients: bf16 kernel vs bf16 plain {rel_bf16:.3e}, bf16 plain vs fp32 plain {floor:.3e} (the bf16 floor), fp32 kernel vs fp32 plain {rel32:.3e} (limit 1e-4), fp32 remat vs no remat {rel_remat:.3e} (limit 1e-6), fp32 no remat run twice {rel_again:.3e}; fp32 loss remat {loss_on!r}, no remat {loss_off!r}")
    for (precision, backend, run), (_, _, launches) in results.items():
        want = (0, 0) if backend == "xla" else (22, 11) if run == "remat" else (11, 11)
        check(launches == want, f"{precision} {backend} {run}: launches {launches}, expected {want}")
    check(rel_bf16 <= floor, f"bf16 kernel gradients vs plain {rel_bf16} above the bf16 floor {floor}")
    check(rel32 <= 1e-4, f"fp32 kernel gradients vs plain: relative L2 {rel32} > 1e-4")
    check(abs(loss_on - loss_off) <= 1e-6 * abs(loss_off), f"remat changed the loss: {loss_on} vs {loss_off}")
    check(rel_remat <= 1e-6, f"remat changed the gradients: relative L2 {rel_remat} > 1e-6")


def phase_unet_train(fa, cifar, config_cls, workdir):
    """CIFAR training through ``experiments/cifar10/train_torch.py``, inference on its checkpoint, the step alone."""
    from diffusion_classifier_tpu_torch.data.synthetic import SyntheticDataLoader

    cfg = dict(CIFAR_TRAINING_CONFIG, project_root=workdir)
    config = config_cls.from_dict(dict(cfg))
    os.environ["TRAINING_CONFIG"] = json.dumps(cfg)
    saved = []
    reset_counts(fa)
    start = time.perf_counter()
    engine = load_script("train_torch", "cifar10").main([], plot_function=numpy_plotter(saved))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    fwd, bwd = fa.FLASH_FWD.launches, fa.FLASH_BWD.launches
    check_no_copies(fa, "[15 unet train]")
    steps = 512 // config.batch_size
    exp = config.experiment_path
    with open(os.path.join(exp, "track.jsonl")) as f:
        events = [json.loads(line) for line in f]
    losses = [e["value"] for e in events if e.get("name") == "loss" and e.get("step") is not None]
    print(f"[15 unet train] train_torch.main(): cuts: 1 epoch ({steps} steps at B={config.batch_size}), classification eval at {config.evaluation_per_stage[0]} evaluations on {config.evaluation_batches + 1} val batches, sampling_steps {config.sampling_steps} for the plot; {len(losses)} steps in {seconds:.1f} s (eval and checkpoint included); launches fwd {fwd} bwd {bwd}; loss first {losses[0]:.5f} last {losses[-1]:.5f}; plot {saved}")
    check(len(losses) == steps, f"{len(losses)} logged losses, expected {steps}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    ran = python_steps()
    check(bwd == 11 * ran, f"{bwd} backward launches for {ran} steps run from Python, expected {11 * ran}")
    check(fwd > 11 * ran, f"{fwd} forward launches: the training and the eval must both run the kernel")
    check(len(saved) == 1 and os.path.isfile(saved[0]), "the plot function did not run")
    for name in ("ema_params.pt", "train_state.pt", "experiment_state.json"):
        check(os.path.isfile(os.path.join(exp, "checkpoints", name)), f"no checkpoints/{name}")
    del engine
    gc.collect()

    os.environ["INFERENCE_CONFIG"] = json.dumps(dict(cfg, use_comet=False))
    metric_output, preds, _ = load_script("inference_torch", "cifar10").main([])
    check(len(metric_output) == 1 and len(preds) == config.evaluation_batches + 1,
          f"inference on the trained checkpoint: {metric_output}")
    for p in preds:
        check(tuple(p.shape) == (config.batch_size,) and bool(((p >= 0) & (p < 10)).all()),
              f"predictions {p.tolist()}")
    print(f"[15 unet train] inference_torch.main() on the trained checkpoint: {metric_output}")

    # the step alone: CUDA events around warm steps at B=64, Adam's moments in fp32, then bf16
    batch = next(iter(SyntheticDataLoader(
        512, 128, batch_size=config.batch_size, image_size=config.image_size,
        channels=config.image_channels, classes=config.classes, seed=1,
    ).get_train_loader()))
    rates = {}
    gc.collect()
    torch.cuda.empty_cache()
    for state_dtype in ("fp32", "bf16"):
        engine = cifar.build_engine(config_cls.from_dict(dict(cfg, optimizer_state_dtype=state_dtype)))
        engine.init_params()
        engine._build_train_state(total_steps=100)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(lambda: engine.train_step(batch), reps=10, warmup=2)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # between steps: the parameters, the EMA copy and Adam's moments
        resident_gb = torch.cuda.memory_allocated() / 1e9
        tag = f"[15 unet train] step B={config.batch_size}, optimizer state {state_dtype}"
        print(f"{tag}: median {step_ms:.2f} ms -> {config.batch_size * 1e3 / step_ms:.2f} images/s; peak memory {peak_gb:.3f} GB, resident between steps {resident_gb:.3f} GB")
        rates[state_dtype] = {"step_ms": step_ms, "images_per_s": config.batch_size * 1e3 / step_ms,
                              "peak_gb": peak_gb, "resident_gb": resident_gb}
        if state_dtype == "fp32":
            busy, cats, _ = profile_table(f"{tag}, one warm step", lambda: engine.train_step(batch))
            idle = 100 * max(0.0, 1 - busy / step_ms)
            print(f"{tag}: device busy {busy:.2f} of {step_ms:.2f} ms median wall, idle ~{idle:.1f}%; flash forward {cats['flash forward']:.3f} ms, backward {cats['flash backward']:.3f} ms")
            rates[state_dtype].update(device_ms=busy, idle_percent=idle)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return fwd, bwd, rates


# --- the CheXpert data path: data-format trees, the loader, the CheXpert UNet, the DiT on the tree

CHEXPERT_COLUMNS = [
    "Path", "Sex", "Age", "Frontal/Lateral", "AP/PA", "No Finding",
    "Enlarged Cardiomediastinum", "Cardiomegaly", "Lung Opacity", "Lung Lesion", "Edema",
    "Consolidation", "Pneumonia", "Atelectasis", "Pneumothorax", "Pleural Effusion",
    "Pleural Other", "Fracture", "Support Devices",
]
# rows that pass the filter: 120 effusion and 126 no-finding, balanced to 240
# (192 train, 24 valid, 24 test), as CheXpert-v1.0-small's ~320 x 390 JPEGs
TREE_ROWS = (120, 126)
TREE_SIZE = (320, 390)
# CheXpert's full-size scans, for the loader's host rate: 32 of each label
BIG_ROWS, BIG_SIZE = (32, 32), (2048, 2048)
# the CheXpert experiments on the tree: 256 px through the DWT, 2 classes,
# bf16, the JAX bench's batch of 16, 4 loader threads
CX_CONFIG = {
    "image_size": 256, "image_channels": 3, "wavelet_transform": True, "classes": 2,
    "mixed_precision": "bf16", "batch_size": 16, "num_workers": 4, "evaluation_per_stage": [4],
    "evaluation_batches": 0,
}
CX_UNET_PARAMS = 220_427_532  # experiments/chexpert-unet/common.py's backbone at 256 px with DWT
# the UNet's self-attentions a tail: 2 in down level 2, 1 in the mid block, 3 in up level 0
CX_UNET_ATTENTIONS = 6


def radiograph(rng, size):
    """A smooth grey image with grain, uint8 ``[h, w]``: a stand-in for an X-ray."""
    import numpy as np
    from PIL import Image

    w, h = size
    low = Image.fromarray((rng.random((8, 8)) * 255).astype(np.uint8))
    base = np.asarray(low.resize((w, h), Image.BICUBIC), np.float32)
    grain = rng.standard_normal((h, w), dtype=np.float32) * 6
    return np.clip(base + grain, 0, 255).astype(np.uint8)


def write_csv(path, header, rows):
    import csv

    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        writer.writerows(rows)


def write_chexpert_tree(root, counts, size, seed):
    """``train.csv`` in CheXpert's columns and a grey JPEG for each frontal study-1 row.

    ``counts`` = (effusion, no finding) rows that pass the filter, and one
    row for each clause that drops one: a lateral view, a second study, -1
    in either column, both positive, both empty (an empty cell is 0).
    """
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    rows, files = [], []

    def row(i, effusion, no_finding, view="view1_frontal", study="study1"):
        path = f"CheXpert-v1.0-small/train/patient{i:05d}/{study}/{view}.jpg"
        values = dict.fromkeys(CHEXPERT_COLUMNS, "")
        values.update({"Path": path, "Sex": "Female" if i % 2 else "Male", "Age": str(30 + i % 60),
                       "Frontal/Lateral": "Lateral" if "lateral" in view else "Frontal",
                       "AP/PA": "AP", "No Finding": no_finding, "Pleural Effusion": effusion})
        rows.append([values[c] for c in CHEXPERT_COLUMNS])
        if study == "study1" and view == "view1_frontal":
            files.append(path)

    n_effusion, n_no_finding = counts
    for i in range(n_effusion):
        row(i, "1.0", "" if i % 2 else "0.0")
    for i in range(n_effusion, n_effusion + n_no_finding):
        row(i, "" if i % 3 else "0.0", "1.0")
    i = n_effusion + n_no_finding
    for j, (effusion, no_finding, view, study) in enumerate((
        ("1.0", "", "view2_lateral", "study1"), ("1.0", "", "view1_frontal", "study2"),
        ("-1.0", "1.0", "view1_frontal", "study1"), ("1.0", "-1.0", "view1_frontal", "study1"),
        ("1.0", "1.0", "view1_frontal", "study1"), ("", "", "view1_frontal", "study1"),
    )):
        row(i + j, effusion, no_finding, view, study)
    os.makedirs(root, exist_ok=True)
    write_csv(os.path.join(root, "train.csv"), CHEXPERT_COLUMNS, [rows[k] for k in rng.permutation(len(rows))])
    for path in files:
        out = os.path.join(root, *path.split("/")[1:])
        os.makedirs(os.path.dirname(out), exist_ok=True)
        Image.fromarray(radiograph(rng, size), "L").save(out, quality=90)
    return root


def write_ood_trees(root, seed):
    """MIMIC (64 px grey JPEGs), PadChest (16-bit grey PNGs) and ISIC (RGB JPEGs) trees: ``{name: folder}``."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    trees = {name: os.path.join(root, name) for name in ("mimic", "padchest", "isic")}
    # MIMIC: labels 0, 1, empty (0), -1 (dropped): 24 of each class after balancing
    labels = ["0.0", "1.0", "", "-1.0", "1.0"]
    mimic = [(f"mimic-cxr-jpg/files/p1{i:04d}/s{i}/{i}.jpg", labels[i % 5]) for i in range(60)]
    write_csv(os.path.join(_mkdir(trees["mimic"]), "mimic_pa_metadata.csv"), ["image_path", "Pleural Effusion"], mimic)
    for path, _ in mimic:
        out = os.path.join(trees["mimic"], *path.split("/")[2:])
        os.makedirs(os.path.dirname(out), exist_ok=True)
        Image.fromarray(radiograph(rng, (64, 64)), "L").save(out, quality=90)
    # PadChest: 16-bit PNGs, labels 0, 1, empty (0), -1 (dropped), no balancing
    padchest = [(f"{i}.png", ["0", "1", "", "-1"][i % 4]) for i in range(40)]
    write_csv(os.path.join(_mkdir(trees["padchest"]), "padchest-v1.csv"), ["ImageID", "PleuralEffusion"], padchest)
    for name, _ in padchest:
        grey16 = radiograph(rng, (256, 256)).astype(np.uint16) * 257
        Image.fromarray(grey16).save(os.path.join(trees["padchest"], name))
    # ISIC: the pre-balanced CSV; 180 rows leave 18 in the test split
    isic = [(f"ISIC_{i:07d}", i % 2) for i in range(180)]
    _mkdir(os.path.join(trees["isic"], "images"))
    write_csv(os.path.join(trees["isic"], "train_balanced.csv"), ["image_name", "target"], isic)
    for name, _ in isic:
        rgb = np.stack([radiograph(rng, (400, 300)) for _ in range(3)], axis=-1)
        Image.fromarray(rgb, "RGB").save(os.path.join(trees["isic"], "images", f"{name}.jpg"), quality=90)
    return trees


def _mkdir(path):
    os.makedirs(path, exist_ok=True)
    return path


def phase_trees(workdir):
    """Writes the data-format trees under ``workdir``; returns their folders."""
    start = time.perf_counter()
    trees = {
        "chexpert": write_chexpert_tree(os.path.join(workdir, "chexpert"), TREE_ROWS, TREE_SIZE, seed=20),
        "chexpert_2048": write_chexpert_tree(os.path.join(workdir, "chexpert-2048"), BIG_ROWS, BIG_SIZE, seed=21),
        **write_ood_trees(os.path.join(workdir, "ood"), seed=22),
    }
    print(f"[16 trees] data-format trees written in {time.perf_counter() - start:.1f} s: {sorted(trees)}")
    return trees


def host_rate(dataset, workers, batch=16):
    """Images/s of one pass of ``MapDataLoader`` over ``dataset`` (decode, resize, scale, stack) on the host."""
    from diffusion_classifier_tpu_torch.data.loader import MapDataLoader

    loader = MapDataLoader(len(dataset), dataset.__getitem__, batch, shuffle=False, num_workers=workers)
    start, n = time.perf_counter(), 0
    for b in loader:
        n += len(b["prompt"])
    return n / (time.perf_counter() - start)


def phase_loader(trees, workdir):
    """The CheXpert loader on the host: the filter's row counts, images/s, and batches that do not depend on the worker count."""
    import numpy as np
    import PIL

    from diffusion_classifier_tpu_torch.data.chexpert import CheXpertDataLoader, CheXpertDataset

    splits = {s: len(CheXpertDataset(trees["chexpert"], s)) for s in ("train", "valid", "test")}
    check(splits == {"train": 192, "valid": 24, "test": 24}, f"CheXpert splits {splits}")
    serial, pooled = (
        CheXpertDataLoader(True, trees["chexpert"], batch_size=16, num_workers=w, seed=3)
        for w in (0, 4)
    )
    same = True
    for a, b in zip(serial.get_train_loader(), pooled.get_train_loader()):
        same &= all(np.array_equal(a[k], b[k]) for k in ("images", "prompt"))
    check(same, "batches from 0 and 4 workers differ")
    rates = {}
    small = CheXpertDataset(trees["chexpert"], "train")
    rates["320x390_serial"] = host_rate(small, 0)
    rates["320x390_4_workers"] = host_rate(small, 4)
    big = CheXpertDataset(trees["chexpert_2048"], "train")
    rates["2048_serial"] = host_rate(big, 0)
    rates["2048_4_workers"] = host_rate(big, 4)
    rates["2048_4_workers_fast_decode"] = host_rate(CheXpertDataset(trees["chexpert_2048"], "train", fast_decode=True), 4)
    cached = CheXpertDataset(trees["chexpert_2048"], "train", decode_cache_dir=os.path.join(workdir, "decode-cache"))
    rates["2048_4_workers_cache_first_epoch"] = host_rate(cached, 4)
    rates["2048_4_workers_cache_second_epoch"] = host_rate(cached, 4)
    cores = os.cpu_count()
    print(f"[17 loader] CheXpert tree: {sum(splits.values())} rows after the filter and the balancing, splits {splits}; a train epoch's batches from 0 and 4 workers are identical bit for bit: {same}")
    print(f"[17 loader] host images/s to 256 px ({cores} cores, {len(small)} images of {TREE_SIZE[0]}x{TREE_SIZE[1]}, {len(big)} of {BIG_SIZE[0]}x{BIG_SIZE[1]}): " + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))
    return {"images_per_s": rates, "cores": cores, "decode": f"PIL {PIL.__version__}",
            "identical_0_vs_4_workers": same}


@contextlib.contextmanager
def plain_attention_calls():
    """Counts the dispatcher's plain-attention calls (``dot_product_attention``, the route outside the kernels' gate): yields ``[count]``."""
    from diffusion_classifier_tpu_torch.ops import attention as attention_module

    real = attention_module.dot_product_attention
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    attention_module.dot_product_attention = counted
    try:
        yield calls
    finally:
        attention_module.dot_product_attention = real


@contextlib.contextmanager
def kernel_shapes(fa):
    """Records the ``(shape, dtype)`` of q at every call of either attention kernel's wrapper, and
    ``((H, W, C, groups), dtype)`` of x at every call of the GroupNorm kernel's: yields ``{kernel name: set}``."""
    from diffusion_classifier_tpu_torch.ops.group_norm import GROUP_NORM

    seen = {fa.FLASH_FWD.name: set(), fa.FLASH_BWD.name: set(), GROUP_NORM.name: set()}
    real = {}
    for kernel in (fa.FLASH_FWD, fa.FLASH_BWD):
        cls = type(kernel)
        real[cls] = cls.__call__

        def recorded(self, q, *args, _call=cls.__call__, **kwargs):
            seen[self.name].add((tuple(q.shape), q.dtype))
            return _call(self, q, *args, **kwargs)

        cls.__call__ = recorded
    cls = type(GROUP_NORM)
    real[cls] = cls.__call__

    def recorded_norm(self, x, *args, _call=cls.__call__, num_groups, **kwargs):
        seen[self.name].add(((*x.shape[1:], num_groups), x.dtype))
        return _call(self, x, *args, num_groups=num_groups, **kwargs)

    cls.__call__ = recorded_norm
    try:
        yield seen
    finally:
        for cls, call in real.items():
            cls.__call__ = call


def check_covered(fa, seen, tag):
    """Fails if a path launched a kernel at a shape that no kernel check held against its plain version."""
    dtypes = (torch.bfloat16, torch.float32)
    checked = {  # phases 3, 9 and 22; phases 6, 13 and 22; phase 3c
        fa.FLASH_FWD.name: set(KERNEL_CASES) | {(IP_SHAPE, torch.bfloat16)}
        | {(shape, dt) for shape in UNET_SHAPES for dt in dtypes},
        fa.FLASH_BWD.name: set(BWD_CASES) | {(IP_SHAPE, torch.bfloat16)}
        | {(shape, dt) for shape in UNET_BWD_SHAPES for dt in dtypes},
        "group_norm": set(GN_CASES),
    }
    for name, shapes in seen.items():
        print(f"{tag} {name} launched at " + ", ".join(f"{s} {str(d)[6:]}" for s, d in sorted(shapes, key=str)))
        missed = shapes - checked[name]
        check(not missed, f"{tag}: {name} ran at {sorted(missed, key=str)}, which no kernel check covered")


def live_cuda_report(top=6):
    """Prints the live CUDA tensors gc can see (by storage) and, for the largest, who holds them."""
    tensors = [o for o in gc.get_objects() if isinstance(o, torch.Tensor) and o.is_cuda]
    storages = {}  # data pointer -> (bytes, index into tensors)
    for i, t in enumerate(tensors):
        storage = t.untyped_storage()
        storages[storage.data_ptr()] = (storage.nbytes(), i)
    print(f"  {len(tensors)} CUDA tensors visible to gc, {sum(n for n, _ in storages.values()) / 1e9:.3f} GB in {len(storages)} storages")
    engines = [o for o in gc.get_objects() if type(o).__name__ in ("DiffusionClassifier", "Classifier", "Denoiser")]
    print(f"  live engines and denoisers: {[type(o).__name__ for o in engines]}")
    skip = {id(tensors), id(engines)}
    for nbytes, i in sorted(storages.values(), reverse=True)[:top]:
        chain, obj = [], tensors[i]
        for _ in range(6):
            holders = [r for r in gc.get_referrers(obj) if id(r) not in skip and type(r).__name__ != "frame"]
            skip.add(id(holders))
            if not holders:
                break
            obj = holders[0]
            desc = type(obj).__name__
            if isinstance(obj, dict):
                desc += "{" + ", ".join(map(str, list(obj)[:5])) + "}"
            chain.append(desc)
        t = tensors[i]
        print(f"  {nbytes / 1e6:.1f} MB {tuple(t.shape)} {t.dtype}: held by " + " <- ".join(chain))


def released(tag, limit_gb=0.5):
    """Fails unless the card holds almost nothing before a phase: a tensor left from an earlier phase inflates this one's peak memory."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    print(f"{tag} allocated on the card before the phase: {held:.3f} GB")
    if held > limit_gb:
        live_cuda_report()
    check(held <= limit_gb, f"{tag}: {held:.3f} GB still allocated from earlier phases")
    return held


def row_bytes(engine, images, tag):
    """Card bytes a classify megabatch row (image × class × evaluation) takes, per image element.

    The engine's own classify path (its prefix split and class chunk) at 2
    evaluations as one group and as two: the peak memory above what was
    allocated before, its difference over the ``B·K`` rows the second
    group adds. Fails above ``ROW_BYTES_PER_ELEM``, the constant the auto
    group size (``card_eval_group``) budgets with.
    """
    from diffusion_classifier_tpu_torch.diffusion.classify import ROW_BYTES_PER_ELEM, TorchDraws, make_classifier

    cfg = engine.config
    x = engine._images(images)
    b, k, elems = x.shape[0], cfg.classes, math.prod(x.shape[1:])
    labels = torch.zeros((b,), dtype=torch.long, device="cuda")
    peaks = []
    for group in (1, 2):
        fn = make_classifier(
            lambda z, lg, lab: engine.state.ema_model(z, lg, lab), engine.schedule_fn,
            pred_param=cfg.pred_param, num_classes=k, n_stages=1, evaluation_per_stage=(2,),
            n_keep_per_stage=(1,), eval_group=group, class_chunk=cfg.classify_class_chunk,
            encode_fn=engine._encode, tail_fn=engine._tail,
        )
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(x, labels, TorchDraws(torch.Generator(device="cuda").manual_seed(0)))
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
    per_elem = (peaks[1] - peaks[0]) / (b * k) / elems
    print(f"{tag} classify megabatch memory at B={b}, K={k}, {elems} elements an image: peak above the resident {peaks[0] / 1e9:.3f} GB at G=1, {peaks[1] / 1e9:.3f} GB at G=2 -> {per_elem:.1f} bytes a row per image element (ROW_BYTES_PER_ELEM {ROW_BYTES_PER_ELEM})")
    check(per_elem <= ROW_BYTES_PER_ELEM, f"{tag}: {per_elem:.1f} bytes a row per element, above ROW_BYTES_PER_ELEM {ROW_BYTES_PER_ELEM}: the auto group size would overfill the card")
    return per_elem


def auto_group(calls, b, evals, k, elems, free_before, tag):
    """The group size the classifier chose on the card, read from its encode forwards' rows.

    Held to ``card_eval_group`` between the free memory before the run and
    that less 4 GB (the engine's weights and the allocator's blocks come in
    between); printed beside the JAX package's budget.
    """
    from diffusion_classifier_tpu_torch.diffusion.classify import auto_eval_group, card_eval_group

    groups = {rows // b for (mode, rows) in calls if mode == "encode"}
    check(len(groups) == 1, f"{tag}: encode forwards of {sorted(groups)} groups")
    (group,) = groups
    hi = card_eval_group(evals, b, k, elems, free_before)
    lo = card_eval_group(evals, b, k, elems, max(0, free_before - 4e9))
    print(f"{tag} auto group size G={group}: the card's rule gives {lo}-{hi} at {free_before / 1e9:.2f} GB free; the JAX package's budget gives {auto_eval_group(evals, b, k, img_elems=elems)}")
    check(lo <= group <= hi and evals % group == 0, f"{tag}: G={group} outside the card's rule {lo}-{hi}")
    return group


def before_run():
    """Frees what the card caches, zeroes the peak memory; returns the free bytes (``mem_get_info``)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.mem_get_info()[0]


def peak_memory(tag):
    """Prints the peak memory since the last reset against the card's total; returns it in GB."""
    peak = torch.cuda.max_memory_allocated() / 1e9
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    print(f"{tag} peak memory {peak:.3f} GB of the card's {total:.2f} GB")
    return peak


def phase_cx_unet_forward(fa, cx_unet, config_cls):
    """The CheXpert UNet at full width: its parameter count, a forward with no kernel, tail ∘ encode = full."""
    from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser
    from diffusion_classifier_tpu_torch.models.encoders import ClassEmbedder
    from diffusion_classifier_tpu_torch.models.layers import reset_parameters

    config = config_cls.from_dict(dict(CX_CONFIG, encoder_type="nn"))
    model = cx_unet.build_backbone(config)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == CX_UNET_PARAMS, f"{n_params} parameters, the CheXpert UNet has {CX_UNET_PARAMS}")
    model = Denoiser(model, ClassEmbedder(2, 256, torch.bfloat16))
    reset_parameters(model, torch.Generator().manual_seed(0))
    model = model.to("cuda").eval()
    gen = torch.Generator(device="cuda").manual_seed(12)
    b = 16
    x = torch.rand((b, 128, 128, 12), generator=gen, device="cuda") * 2 - 1
    t = torch.randn((b,), generator=gen, device="cuda") * 4
    y = torch.randint(0, 3, (b,), generator=gen, device="cuda")
    with torch.no_grad(), plain_attention_calls() as calls:
        reset_counts(fa)
        full = model(x, t, y)
        torch.cuda.synchronize()
        per_forward = calls[0]
        tail = model(None, None, y, mode="tail", prefix_state=model(x, t, None, mode="encode"))
    rel = ((tail - full).norm() / full.norm()).item()
    launches = (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches)
    print(f"[18 cx-unet] CheXpert UNet {n_params} parameters (backbone), forward B={b} on 128x128x12 bf16: output {tuple(full.shape)}, flash launches {launches}, plain attention calls {per_forward} (8 heads x D=96 at 32x32 = 1024 tokens), tail(encode) vs full rel L2 {rel:.3e}")
    check(full.shape == (b, 128, 128, 12) and bool(torch.isfinite(full).all()), "CheXpert UNet output")
    check(launches == (0, 0), f"the CheXpert UNet launched the flash kernels {launches}: D=96 is outside their gate")
    check(per_forward == CX_UNET_ATTENTIONS, f"{per_forward} plain attention calls a forward, expected {CX_UNET_ATTENTIONS}")
    check(rel <= 1e-3, f"tail(encode(x)) differs from the full forward: {rel}")
    return per_forward


def step_numbers(engine, batch, tag):
    """Median ms of warm train steps, images/s, peak memory and one profiled step's device time."""
    b = len(batch["prompt"])
    engine._build_train_state(total_steps=100)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: engine.train_step(batch), reps=5, warmup=2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    busy, cats, kernels = profile_table(f"{tag}, one warm step", lambda: engine.train_step(batch))
    idle = 100 * max(0.0, 1 - busy / step_ms)
    print(f"{tag}: median {step_ms:.2f} ms -> {b * 1e3 / step_ms:.2f} images/s; peak memory {peak_gb:.3f} GB; device busy {busy:.2f} ms in {kernels} kernels, idle ~{idle:.1f}%")
    return {"step_ms": step_ms, "images_per_s": b * 1e3 / step_ms, "peak_gb": peak_gb,
            "device_ms": busy, "kernels": kernels, "idle_percent": idle}


def phase_cx_unet_train(fa, cx_unet, config_cls, trees, workdir):
    """CheXpert UNet training through ``experiments/chexpert-unet/train_torch.py`` on the tree, then the step alone at B=16 and 64."""
    cfg = dict(CX_CONFIG, encoder_type="nn", data_path=trees["chexpert"], remat=True, num_epochs=1,
               log_every_steps=1, use_comet=True, sampling_steps=4, project_root=workdir,
               experiment_dir="chexpert-unet", decode_cache_dir=os.path.join(workdir, "cx-cache"))
    config = config_cls.from_dict(dict(cfg))
    os.environ["TRAINING_CONFIG"] = json.dumps(cfg)
    saved = []
    reset_counts(fa)
    start = time.perf_counter()
    with plain_attention_calls() as calls:
        engine = load_script("train_torch", "chexpert-unet").main([], plot_function=numpy_plotter(saved))
        torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches)
    steps = 192 // config.batch_size
    exp = config.experiment_path
    with open(os.path.join(exp, "track.jsonl")) as f:
        events = [json.loads(line) for line in f]
    losses = [e["value"] for e in events if e.get("name") == "loss" and e.get("step") is not None]
    print(f"[18 cx-unet train] train_torch.main() on the tree, bf16, remat, B={config.batch_size}: {len(losses)} steps in {seconds:.1f} s (first epoch's decode, eval at 4 evaluations, sampling at {cfg['sampling_steps']} steps for the plot, checkpoint included); flash launches {launches}, plain attention calls {calls[0]}; loss first {losses[0]:.5f} last {losses[-1]:.5f}")
    check(len(losses) == steps and all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(launches == (0, 0), f"the CheXpert UNet launched the flash kernels {launches}")
    check(len(saved) == 1 and os.path.isfile(saved[0]), "the plot function did not run")
    for name in ("ema_params.pt", "train_state.pt", "experiment_state.json"):
        check(os.path.isfile(os.path.join(exp, "checkpoints", name)), f"no checkpoints/{name}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # the step alone: B=16 (the JAX bench's) as configured, B=64 (the config's) with remat
    import numpy as np

    from diffusion_classifier_tpu_torch.data.chexpert import CheXpertDataLoader

    data = CheXpertDataLoader(True, trees["chexpert"], batch_size=16, num_workers=4,
                              decode_cache_dir=cfg["decode_cache_dir"])
    batches = list(data.get_train_loader())[:4]
    big = {k: np.concatenate([b[k] for b in batches]) for k in ("images", "prompt")}
    rates = {}
    for b, remat, batch in ((16, False, batches[0]), (64, True, big)):
        engine = cx_unet.build_engine(config_cls.from_dict(dict(cfg, remat=remat, batch_size=b)))
        engine.init_params()
        rates[f"b{b}{'_remat' if remat else ''}"] = step_numbers(
            engine, batch, f"[18 cx-unet train] step B={b}, remat {remat}")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return rates, launches


def phase_cx_unet_classify(fa, cx_unet, config_cls, trees, workdir):
    """``inference_torch.py`` on the trained checkpoint (mistakes file), classify B=16 and B=1, then ``ood_torch.py`` on the three OOD sets."""
    cfg = dict(CX_CONFIG, encoder_type="nn", data_path=trees["chexpert"], project_root=workdir,
               experiment_dir="chexpert-unet")
    config = config_cls.from_dict(dict(cfg))
    os.environ["INFERENCE_CONFIG"] = json.dumps(cfg)
    forwards = {}
    hook = count_forwards(forwards)
    try:
        free = before_run()
        reset_counts(fa)
        with plain_attention_calls() as calls:
            metric_output, preds, batches = load_script("inference_torch", "chexpert-unet").main([])
            torch.cuda.synchronize()
    finally:
        hook.remove()
    b, evals = config.batch_size, config.evaluation_per_stage[0]
    peak_gb = peak_memory("[18 cx-unet classify] inference_torch.main()")
    group = auto_group(forwards, b, evals, 2, 128 * 128 * 12, free, "[18 cx-unet classify]")
    want = {("encode", group * b): evals // group, ("tail", group * b): evals // group * 2}
    p = torch.cat(preds)
    labels = torch.cat([torch.as_tensor(x["prompt"]) for x in batches])
    with open(os.path.join(config.experiment_path, "mistakes-ddpm-chexpert.txt")) as f:
        mistakes = [line for line in f.read().splitlines() if line]
    print(f"[18 cx-unet classify] inference_torch.main() on the trained checkpoint: {metric_output}; forwards {forwards} (expected {want}: G={group}, 1 class a chunk), flash launches {(fa.FLASH_FWD.launches, fa.FLASH_BWD.launches)}, plain attention calls {calls[0]}; {len(mistakes)} lines in mistakes-ddpm-chexpert.txt for {int((p != labels).sum())} misclassified of {len(p)}")
    check(forwards == want, f"forwards {forwards}, expected {want}")
    check((fa.FLASH_FWD.launches, fa.FLASH_BWD.launches) == (0, 0), "the CheXpert UNet launched a flash kernel")
    check(calls[0] == CX_UNET_ATTENTIONS * want[("tail", group * b)], f"{calls[0]} plain attention calls")
    check(len(p) == b and bool(((p == 0) | (p == 1)).all()), f"predictions {p.tolist()}")
    check(len(mistakes) == int((p != labels).sum()), f"{len(mistakes)} mistakes for {int((p != labels).sum())} misclassified")

    engine = cx_unet.build_engine(config)
    engine.init_params()
    engine.load_checkpoint(os.path.join(config.experiment_path, "checkpoints"), train_state=False)
    images = batches[0]["images"]
    ms16 = cuda_ms(lambda: engine.classify(images), reps=3, warmup=1)
    ms1 = cuda_ms(lambda: engine.classify(images[:1]), reps=5, warmup=1)
    rates = {"images_per_s_b16": b * 1e3 / ms16, "ms_b16": ms16, "latency_ms_b1": ms1}
    for batch, ms in ((b, ms16), (1, ms1)):
        busy, _, kernels = profile_table(f"[18 cx-unet classify] classify B={batch}", lambda: engine.classify(images[:batch]))
        idle = 100 * max(0.0, 1 - busy / ms)
        print(f"[18 cx-unet classify] classify B={batch} ({evals} evals x 2 classes, shared prefix): {ms:.2f} ms median wall -> {batch * 1e3 / ms:.2f} images/s; device busy {busy:.2f} ms in {kernels} kernels, idle ~{idle:.1f}%")
        rates[f"b{batch}"] = {"device_ms": busy, "kernels": kernels, "idle_percent": idle}
    z = engine._images(images)
    lg = torch.zeros((b,), device="cuda")
    with torch.no_grad():
        state = engine._encode(z, lg)
        enc_ms, _, enc_kernels = profile_table(f"[18 cx-unet classify] one encode B={b}", lambda: engine._encode(z, lg))
        tail_ms, _, tail_kernels = profile_table(f"[18 cx-unet classify] one tail B={b}", lambda: engine._tail(state, torch.zeros((b,), dtype=torch.long, device="cuda")))
    print(f"[18 cx-unet classify] B={b}: an encode {enc_ms:.3f} ms in {enc_kernels} kernels, a tail {tail_ms:.3f} ms in {tail_kernels} kernels (device time)")
    rates.update(encode_ms=enc_ms, encode_kernels=enc_kernels, tail_ms=tail_ms, tail_kernels=tail_kernels,
                 group=group, peak_gb=peak_gb, row_bytes_per_elem=row_bytes(engine, images, "[18 cx-unet classify]"))
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    ood = {}
    for name in ("mimic", "padchest", "isic"):
        os.environ["INFERENCE_CONFIG"] = json.dumps(dict(cfg, data_path=trees[name], evaluation_batches=1))
        reset_counts(fa)
        start = time.perf_counter()
        metric_output, preds, batches = load_script("ood_torch", "chexpert-unet").main(["--dataset", name])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        p = torch.cat(preds)
        size = batches[0]["images"].shape[1]
        print(f"[18 cx-unet ood] ood_torch.main(['--dataset', '{name}']): {len(batches)} batches of {batches[0]['images'].shape}, {seconds:.1f} s (engine, checkpoint and loader included); flash launches {(fa.FLASH_FWD.launches, fa.FLASH_BWD.launches)}; {metric_output}")
        check(bool(((p == 0) | (p == 1)).all()) and len(metric_output) == 4, f"{name}: predictions {p.tolist()}")
        check(size == (256 if name == "isic" else 64), f"{name} images of {size} px")
        check((fa.FLASH_FWD.launches, fa.FLASH_BWD.launches) == (0, 0), f"{name}: a flash kernel launched")
        ood[name] = {"seconds": seconds, "batches": len(batches), "px": size}
    return rates, ood


def phase_cx_dit_tree(fa, config_cls, trees, workdir):
    """The CheXpert DiT on the tree: ``train_torch.py``, ``inference_torch.py`` (mistakes file) and ``ood_torch.py`` on MIMIC; both kernels."""
    cfg = dict(CX_CONFIG, encoder_type="DiT", patch_size=4, data_path=trees["chexpert"], num_epochs=1,
               log_every_steps=1, use_comet=True, sampling_steps=4, project_root=workdir,
               experiment_dir="chexpert-dit-tree")
    config = config_cls.from_dict(dict(cfg))
    os.environ["TRAINING_CONFIG"] = json.dumps(cfg)
    launches, saved, forwards = {}, [], {}
    steps = 192 // config.batch_size
    hook = count_forwards(forwards)
    try:
        reset_counts(fa)
        start = time.perf_counter()
        load_script("train_torch").main([], plot_function=numpy_plotter(saved))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        fwd, bwd = fa.FLASH_FWD.launches, fa.FLASH_BWD.launches
        n_forwards = sum(forwards.values())
        with open(os.path.join(config.experiment_path, "track.jsonl")) as f:
            losses = [e["value"] for e in map(json.loads, f) if e.get("name") == "loss" and e.get("step") is not None]
        print(f"[19 dit tree train] train_torch.main() on the tree: {len(losses)} steps in {seconds:.1f} s; denoiser forwards {forwards}; flash launches fwd {fwd} bwd {bwd}; loss first {losses[0]:.5f} last {losses[-1]:.5f}")
        check_no_copies(fa, "[19 dit tree train]")
        check(len(losses) == steps and all(math.isfinite(v) for v in losses), f"losses {losses}")
        ran = python_steps()
        check(bwd == 12 * ran, f"{bwd} backward launches for {ran} steps run from Python, expected {12 * ran}")
        check(fwd == 12 * n_forwards, f"{fwd} forward launches for {n_forwards} denoiser forwards")
        launches["train"] = (fwd, bwd)

        os.environ["INFERENCE_CONFIG"] = json.dumps(dict(cfg, use_comet=False))
        forwards.clear()
        reset_counts(fa)
        metric_output, preds, batches = load_script("inference_torch").main([])
        torch.cuda.synchronize()
        p = torch.cat(preds)
        labels = torch.cat([torch.as_tensor(x["prompt"]) for x in batches])
        with open(os.path.join(config.experiment_path, "mistakes-ddpm-chexpert.txt")) as f:
            mistakes = [line for line in f.read().splitlines() if line]
        n_forwards = sum(forwards.values())
        print(f"[19 dit tree classify] inference_torch.main(): {metric_output}; forwards {forwards}, flash launches {fa.FLASH_FWD.launches}; {len(mistakes)} lines in mistakes-ddpm-chexpert.txt for {int((p != labels).sum())} misclassified of {len(p)}")
        check(fa.FLASH_FWD.launches == 12 * n_forwards and fa.FLASH_BWD.launches == 0, "classify launches")
        check(bool(((p == 0) | (p == 1)).all()) and len(mistakes) == int((p != labels).sum()), "predictions or mistakes file")
        launches["classify"] = fa.FLASH_FWD.launches

        os.environ["INFERENCE_CONFIG"] = json.dumps(dict(cfg, data_path=trees["mimic"], use_comet=False, evaluation_batches=1))
        forwards.clear()
        reset_counts(fa)
        metric_output, preds, batches = load_script("ood_torch").main(["--dataset", "mimic"])
        torch.cuda.synchronize()
        n_forwards = sum(forwards.values())
        p = torch.cat(preds)
        print(f"[19 dit tree ood] ood_torch.main(['--dataset', 'mimic']): {len(batches)} batches of {batches[0]['images'].shape} (64 tokens at patch 4), forwards {forwards}, flash launches {fa.FLASH_FWD.launches}; {metric_output}")
        check(fa.FLASH_FWD.launches == 12 * n_forwards > 0, "OOD launches")
        # phase 3 holds the kernel against its plain version at this shape
        tokens = (batches[0]["images"].shape[1] // 2 // config.patch_size) ** 2
        check(set(forwards) == {("full", DIT_OOD_SHAPE[0])} and tokens == DIT_OOD_SHAPE[1],
              f"OOD forwards {forwards} at {tokens} tokens, phase 3 checked {DIT_OOD_SHAPE}")
        check(bool(((p == 0) | (p == 1)).all()), f"predictions {p.tolist()}")
        launches["ood"] = fa.FLASH_FWD.launches
    finally:
        hook.remove()
    check_no_copies(fa, "[19 dit tree ood]")
    return launches


# --- the IPMSA family: MRI volume trees, the loader, the UNet, the DiT, the ResNet baseline

# the IPMSA experiments at 256 px: 5 slices of W000 FLAIR and CT2F = 10
# channels, 2 classes, bf16 (the ResNet in fp32, as its JAX module), the JAX
# bench's batch of 8 (bench.py:1312), 4 loader threads
IP_CONFIG = {
    "image_size": 256, "image_channels": 10, "slices": 5, "wavelet_transform": True, "classes": 2,
    "mixed_precision": "bf16", "batch_size": 8, "num_workers": 4, "evaluation_per_stage": [4],
    "evaluation_batches": 0, "data_path": "volumes",
}
# volumes [D, H, W]: LORISTransforms' Resize pads H and W to the next power
# of two with the volume's minimum, (pad // 2) a side, so even sides whose
# larger one lies in (128, 256] come out at 256 px; D is cut from a trial
# scan's ~60 slices to 32 (GetSlice keeps the centre 5)
IP_VOLUME = (32, 240, 200)
IP_SPLITS = {"train": 16, "val": 8, "test": 8}
IP_TIMEPOINTS = ("W000", "W048", "W096")
IP_UNET_PARAMS = 408_537_896  # experiments/ipmsa/common.py's backbone at 256 px, 10 channels, DWT
IP_DIT_PARAMS = 32_955_520  # experiments/ipmsa-dit/common.py's at patch 4
# the UNet's attention at B=8: level 3 (16 x 16 = 256 tokens, 512 = 8 x 64)
# on the flash kernels, level 4 and the mid block (8 x 8 = 64 tokens, 768 =
# 8 x 96) on the plain route; self-attentions a forward: 4 down + 5 up at
# level 3, 4 down + 5 up at level 4 and 1 in the mid block, all in the tail
IP_SHAPE = (8, 256, 8, 64)
IP_PLAIN_SHAPE = (8, 64, 8, 96)
IP_FLASH_A_TAIL, IP_PLAIN_A_TAIL = 9, 10
IP_EXPLAIN_STEPS = 16  # the config's 128 sampling steps cut to 16 over [0.5, 0]


def write_ipmsa_trees(root, seed):
    """MRI volume trees (``.npy`` and ``.npy.lz4``, the same arrays), the split pickles and a blocklist.

    Samples alternate active (new T2 lesions in the centre slab at W048 or
    W096) and inactive. The index holds ``{split}_dataset.pkl`` with paths
    relative to ``$DATA_PATH`` and no extension, as the trial's index does;
    ``IPMSADataset.remove_condition`` with the blocklist writes the
    ``_filtered`` pickles the experiments read. Returns the folders and the
    byte and file counts.
    """
    import pickle

    import numpy as np

    from diffusion_classifier_tpu_torch.data.ipmsa import IPMSADataset

    rng = np.random.default_rng(seed)
    d, h, w = IP_VOLUME
    zz, yy, xx = np.meshgrid(*(np.linspace(-1, 1, n, dtype=np.float32) for n in IP_VOLUME), indexing="ij")
    brain = ((zz / 1.2) ** 2 + yy**2 + xx**2 < 0.8).astype(np.float32)
    roots = {fmt: _mkdir(os.path.join(root, f"volumes-{fmt}")) for fmt in ("npy", "lz4")}
    split_dir = _mkdir(os.path.join(root, "split"))
    template = {
        "FLAIR": [["MRI_AND_LABEL", "FLAIR", tp] for tp in IP_TIMEPOINTS],
        "CT2F": [["MRI_AND_LABEL", "CT2F", tp] for tp in IP_TIMEPOINTS],
        "NEWT2": [["MRI_AND_LABEL", "NEWT2", tp] for tp in IP_TIMEPOINTS[1:]],
        "MASK": [["MRI_AND_LABEL", "MASK", tp] for tp in IP_TIMEPOINTS],
        "AGE": [["CLINICAL", "AGE"]],
    }
    n, files, nbytes = 0, 0, 0
    for split, count in IP_SPLITS.items():
        entries = {}
        for i in range(count):
            rel_dir = os.path.join(f"trial{n % 3}", f"patient{n:04d}")
            for r in roots.values():
                _mkdir(os.path.join(r, rel_dir))
            entry = {"MRI_AND_LABEL": {k: {} for k in ("FLAIR", "CT2F", "NEWT2", "MASK")},
                     "CLINICAL": {"AGE": float(30 + n)}}
            for key in ("FLAIR", "CT2F", "NEWT2", "MASK"):
                for t, tp in enumerate(IP_TIMEPOINTS):
                    if key == "NEWT2" and t == 0:
                        continue
                    if key == "FLAIR":
                        vol = (rng.random(IP_VOLUME, dtype=np.float32) * 40 + 60 * (1 + zz)) * brain
                    elif key == "MASK":
                        vol = brain
                    elif key == "CT2F":
                        vol = (rng.random(IP_VOLUME, dtype=np.float32) > 0.995) * brain
                    else:
                        vol = np.zeros(IP_VOLUME, np.float32)
                        if n % 2 == 0 and t == 1 + n % 4 // 2:
                            vol[d // 2, h // 2 - 4: h // 2 + 4, w // 2: w // 2 + 6] = 1.0
                    rel = os.path.join(rel_dir, f"{key.lower()}_{tp}")
                    entry["MRI_AND_LABEL"][key][tp] = rel
                    data = io_npy(vol.astype(np.float32))
                    for fmt, r in roots.items():
                        body = data if fmt == "npy" else lz4_stored_frame(data)
                        with open(os.path.join(r, rel + (".npy" if fmt == "npy" else ".npy.lz4")), "wb") as f:
                            f.write(body)
                        files += 1
                        nbytes += len(body)
            entries[f"{split}{i:03d}"] = entry
            n += 1
        with open(os.path.join(split_dir, f"{split}_dataset.pkl"), "wb") as f:
            pickle.dump({"dataset_dict": entries, "item_template": template}, f)
    # a blocklist line names <x>/<trial>/<patient>/... by the absolute-path
    # parts 3 and 4 of a volume; this one names a pair no sample has
    blocklist = os.path.join(split_dir, "blocklist.txt")
    with open(blocklist, "w") as f:
        f.write("x/trial9/patient9999/flair\n")
    os.environ["DATA_PATH"] = roots["npy"]
    kept = {}
    for split in IP_SPLITS:
        ds = IPMSADataset(os.path.join(split_dir, f"{split}_dataset.pkl"))
        ds.remove_condition(blocklist, name="filtered")
        kept[split] = len(ds)
    check(kept == IP_SPLITS, f"remove_condition kept {kept}")
    return {"roots": roots, "split": split_dir, "files": files, "bytes": nbytes}


def io_npy(arr):
    import io

    import numpy as np

    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def lz4_stored_frame(data):
    """``data`` as an LZ4 frame of stored 4 MB blocks with its content size (no lz4 package here)."""
    import struct

    out = [struct.pack("<I", 0x184D2204), bytes([0x48, 0x70]), struct.pack("<Q", len(data)), b"\x00"]
    for i in range(0, len(data), 4 << 20):
        chunk = data[i: i + (4 << 20)]
        out += [struct.pack("<I", len(chunk) | 0x80000000), chunk]
    out.append(struct.pack("<I", 0))
    return b"".join(out)


def phase_ipmsa_trees(workdir):
    start = time.perf_counter()
    tree = write_ipmsa_trees(os.path.join(workdir, "ipmsa"), seed=30)
    print(f"[20 ipmsa trees] {tree['files']} volume files, {tree['bytes'] / 1e9:.3f} GB (.npy and .npy.lz4 of the same {sum(IP_SPLITS.values())} samples x 11 volumes of {IP_VOLUME} fp32), split pickles {IP_SPLITS} filtered through a blocklist, in {time.perf_counter() - start:.1f} s")
    return tree


def ipmsa_experiment(tree, workdir, name):
    """``project_root``/``experiment_dir`` for an IPMSA experiment whose ``split/`` is the tree's."""
    exp = _mkdir(os.path.join(workdir, name))
    link = os.path.join(exp, "split")
    if not os.path.exists(link):
        os.symlink(tree["split"], link)
    return {"project_root": workdir, "experiment_dir": name}


def phase_ipmsa_loader(tree, workdir):
    """The IPMSA loader on the host: images/s serial and with 4 threads from .npy and .npy.lz4, the pickle cache, batch identity."""
    import numpy as np

    from diffusion_classifier_tpu_torch.data.ipmsa import IPMSADataset, _IPMSABatcher, make_default_transform
    from diffusion_classifier_tpu_torch.utils import lz4io

    index = os.path.join(tree["split"], "val_dataset_filtered.pkl")
    transform = make_default_transform(5)

    def epoch(fmt, workers, cache_dir=None):
        os.environ["DATA_PATH"] = tree["roots"][fmt]
        ds = IPMSADataset(index, cache_dir=cache_dir)
        ds.set_transform(transform)
        start = time.perf_counter()
        batches = list(_IPMSABatcher(ds, 8, False, 0, num_workers=workers))
        return batches, len(ds) / (time.perf_counter() - start)

    rates, runs = {}, {}
    for fmt in ("npy", "lz4"):
        for workers in (0, 4):
            runs[fmt, workers], rates[f"{fmt}_{workers}_workers"] = epoch(fmt, workers)
    cache = os.path.join(workdir, "ipmsa-cache")
    runs["cache", 1], rates["lz4_4_workers_cache_first_epoch"] = epoch("lz4", 4, cache)
    runs["cache", 2], rates["lz4_4_workers_cache_second_epoch"] = epoch("lz4", 4, cache)
    want = runs["npy", 0]
    same = all(
        len(b) == len(want) and all(np.array_equal(x[k], y[k]) for x, y in zip(b, want) for k in ("images", "prompt"))
        for b in runs.values()
    )
    check(same, "IPMSA batches differ between formats, worker counts or the cache")
    images = want[0]["images"]
    check(images.shape == (8, 256, 256, 10) and images.dtype == np.float32, f"IPMSA images {images.shape}")
    labels = np.concatenate([b["prompt"] for b in want])
    check(0 < labels.sum() < len(labels), f"IPMSA labels {labels.tolist()}")
    # the lz4 decode alone: one FLAIR volume's frame, decoded in memory
    path = os.path.join(tree["roots"]["lz4"], "trial0", "patient0000", "flair_W000.npy.lz4")
    with open(path, "rb") as f:
        frame = f.read()
    lz4io.decompress(frame)
    reps = 20
    start = time.perf_counter()
    for _ in range(reps):
        out = lz4io.decompress(frame)
    decode_mb_s = reps * len(out) / 1e6 / (time.perf_counter() - start)
    print(f"[21 ipmsa loader] val split, {len(want) * 8} samples to {images.shape[1:]} (decode 11 volumes of {IP_VOLUME}, GetSlice, Denoise, Resize, BlurLabel3D, Normalize), host images/s ({os.cpu_count()} cores): " + ", ".join(f"{k} {v:.2f}" for k, v in rates.items()) + f"; batches identical across formats, worker counts and the cache: {same}; lz4 decode {decode_mb_s:.0f} MB/s ({len(out) / 1e6:.1f} MB a volume, stored blocks); labels {labels.tolist()}")
    return {"images_per_s": rates, "lz4_decode_mb_s": decode_mb_s, "identical": same,
            "lz4_library": lz4io.library_path()}


def phase_ipmsa_kernels(fa):
    """The kernels at the IPMSA UNet's level 3 (8, 256, 8, 64) bf16 and the plain route at (8, 64, 8, 96) bf16."""
    from diffusion_classifier_tpu_torch.ops.attention import dot_product_attention

    gen = torch.Generator(device="cuda").manual_seed(40)
    dtype = torch.bfloat16
    b, s, h, d = IP_SHAPE
    q, k, v, do = (torch.randn(IP_SHAPE, generator=gen, device="cuda").to(dtype) for _ in range(4))
    reset_counts(fa)
    out, lse = fa.FLASH_FWD(q, k, v, lse=True)
    grads = fa.FLASH_BWD(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    check(fa.FLASH_FWD.copies == 0 and fa.FLASH_BWD.copies == 0, "the kernels copied an input at the IPMSA shape")
    want = fa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(out, want, **TOL[dtype])
    want_grads = fa.flash_attention_bwd_reference(q, k, v, do, out)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
        torch.testing.assert_close(g, w, **TOL[dtype], msg=lambda m: f"{name} at {IP_SHAPE}: {m}")
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    fwd = {"shape": list(IP_SHAPE), "dtype": "bfloat16", "qkv": "separate", "path": "ipmsa unet level 3",
           "max_abs_err": (out.float() - want.float()).abs().max().item()}
    fwd["plain_ms"] = cuda_ms(lambda: fa.flash_attention_reference(q, k, v), inner=BACK_TO_BACK)
    timed_in_turns(fwd, lambda: fa.FLASH_FWD(q, k, v), lambda: F.scaled_dot_product_attention(qh, kh, vh))
    fwd["device_ms"] = device_ms(lambda: fa.FLASH_FWD(q, k, v))
    fwd["library_device_ms"] = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    fwd["bound_ms"], fwd["bound_by"] = bound(4 * b * h * s * s * d, 4 * q.numel() * q.element_size(), dtype)
    bwd = {"shape": list(IP_SHAPE), "dtype": "bfloat16", "qkv": "separate", "path": "ipmsa unet level 3",
           "max_abs_err": max((g.float() - w.float()).abs().max().item() for g, w in zip(grads, want_grads))}
    kernel = lambda: fa.FLASH_BWD(q, k, v, out, do, lse)  # noqa: E731
    bwd["plain_ms"] = cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, do, out), inner=BACK_TO_BACK)
    qg, kg, vg = (x.clone().requires_grad_() for x in (qh, kh, vh))
    og = F.scaled_dot_product_attention(qg, kg, vg)
    dog = do.transpose(1, 2).contiguous()
    sdpa = lambda: torch.autograd.grad(og, (qg, kg, vg), dog, retain_graph=True)  # noqa: E731
    timed_in_turns(bwd, kernel, sdpa)
    bwd["device_ms"] = device_ms(kernel)
    bwd["library_device_ms"] = device_ms(sdpa)
    bwd["bound_ms"], bwd["bound_by"] = bound(10 * b * h * s * s * d, 8 * q.numel() * q.element_size() + lse.numel() * 4, dtype)
    for tag, r in (("forward", fwd), ("backward", bwd)):
        print(f"[22 ipmsa kernels] {tag} {IP_SHAPE} bf16: max |kernel - plain| {r['max_abs_err']:.3e} (atol/rtol 2e-2); device time kernel {r['device_ms']:.4f} ms, SDPA {r['library_device_ms']:.4f} ms; CUDA events back to back kernel {r['ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms (kernel/SDPA {r['library_ratio']:.3f}), plain {r['plain_ms']:.4f} ms; single calls kernel {r['call_ms']:.4f} ms; host {r['host_us']:.1f} us a call; bound {r['bound_ms']:.5f} ms ({r['bound_by']})")

    # the route outside the gate: JAX's dot_product_attention arithmetic, held
    # to the kernels' fp32-product yardstick within the bf16 noise floor
    q, k, v = (torch.randn(IP_PLAIN_SHAPE, generator=gen, device="cuda").to(dtype) for _ in range(3))
    got = dot_product_attention(q, k, v)
    yard = fa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(got, yard, **TOL[dtype])
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    plain = {"shape": list(IP_PLAIN_SHAPE), "dtype": "bfloat16",
             "max_abs_err_vs_fp32_product_reference": (got.float() - yard.float()).abs().max().item(),
             "ms": cuda_ms(lambda: dot_product_attention(q, k, v), inner=BACK_TO_BACK),
             "reference_ms": cuda_ms(lambda: fa.flash_attention_reference(q, k, v), inner=BACK_TO_BACK),
             "sdpa_ms": cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), inner=BACK_TO_BACK)}
    print(f"[22 ipmsa plain route] {IP_PLAIN_SHAPE} bf16 dot_product_attention: max |route - fp32-product reference| {plain['max_abs_err_vs_fp32_product_reference']:.3e} (atol/rtol 2e-2); {plain['ms']:.4f} ms a call back to back, the fp32-product reference {plain['reference_ms']:.4f} ms, SDPA {plain['sdpa_ms']:.4f} ms")
    return fwd, bwd, plain


def ipmsa_denoiser(ip, config_cls, b=8):
    from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser
    from diffusion_classifier_tpu_torch.models.encoders import ClassEmbedder
    from diffusion_classifier_tpu_torch.models.layers import reset_parameters

    model = ip.build_backbone(config_cls.from_dict(dict(IP_CONFIG, encoder_type="nn")))
    n_params = sum(p.numel() for p in model.parameters())
    model = Denoiser(model, ClassEmbedder(2, 256, torch.bfloat16))
    reset_parameters(model, torch.Generator().manual_seed(0))
    return model.to("cuda").eval(), n_params


def phase_ipmsa_unet_forward(fa, ip, config_cls):
    """The IPMSA UNet at full width: parameters, launches and plain calls a forward (full, encode, tail), tail ∘ encode = full."""
    model, n_params = ipmsa_denoiser(ip, config_cls)
    gen = torch.Generator(device="cuda").manual_seed(41)
    b = IP_SHAPE[0]
    x = torch.rand((b, 128, 128, 40), generator=gen, device="cuda") * 2 - 1
    t = torch.randn((b,), generator=gen, device="cuda") * 4
    y = torch.randint(0, 3, (b,), generator=gen, device="cuda")
    counts = {}
    with torch.no_grad():
        for mode in ("full", "encode", "tail"):
            reset_counts(fa)
            with plain_attention_calls() as calls:
                if mode == "full":
                    full = model(x, t, y)
                elif mode == "encode":
                    state = model(x, t, None, mode="encode")
                else:
                    tail = model(None, None, y, mode="tail", prefix_state=state)
                torch.cuda.synchronize()
            counts[mode] = (fa.FLASH_FWD.launches, calls[0])
    check_no_copies(fa, "[22 ipmsa unet]")
    rel = ((tail - full).norm() / full.norm()).item()
    print(f"[22 ipmsa unet] IPMSA UNet {n_params} parameters (backbone), forward B={b} on 128x128x40 bf16: (flash launches, plain-route calls) {counts}; tail(encode) vs full rel L2 {rel:.3e}")
    check(n_params == IP_UNET_PARAMS, f"{n_params} parameters, the IPMSA UNet has {IP_UNET_PARAMS}")
    want = (IP_FLASH_A_TAIL, IP_PLAIN_A_TAIL)
    check(counts == {"full": want, "encode": (0, 0), "tail": want}, f"launches and plain calls {counts}")
    check(full.shape == (b, 128, 128, 40) and bool(torch.isfinite(full).all()), "IPMSA UNet output")
    check(rel <= 1e-3, f"tail(encode(x)) differs from the full forward: {rel}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_ipmsa_unet_train(fa, ip, config_cls, tree, workdir):
    """``experiments/ipmsa/train_torch.py`` for one epoch on the tree, then the step alone."""
    cfg = dict(IP_CONFIG, encoder_type="nn", num_epochs=1, log_every_steps=1, use_comet=True,
               sampling_steps=4, **ipmsa_experiment(tree, workdir, "ipmsa-unet"))
    os.environ["DATA_PATH"] = tree["roots"]["lz4"]
    os.environ["TRAINING_CONFIG"] = json.dumps(cfg)
    config = config_cls.from_dict(dict(cfg))
    saved = []
    reset_counts(fa)
    start = time.perf_counter()
    with plain_attention_calls() as calls:
        engine = load_script("train_torch", "ipmsa").main([], plot_function=numpy_plotter(saved))
        torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches, calls[0])
    steps = IP_SPLITS["train"] // config.batch_size
    with open(os.path.join(config.experiment_path, "track.jsonl")) as f:
        losses = [e["value"] for e in map(json.loads, f) if e.get("name") == "loss" and e.get("step") is not None]
    print(f"[22 ipmsa unet train] train_torch.main() on the .npy.lz4 tree, bf16, B={config.batch_size}: {len(losses)} steps in {seconds:.1f} s (decode, eval at 4 evaluations, plot sampling at 4 steps, checkpoint included); (flash forward, flash backward, plain-route calls) {launches}; loss first {losses[0]:.5f} last {losses[-1]:.5f}")
    check(len(losses) == steps and all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(launches[1] == IP_FLASH_A_TAIL * python_steps(),
          f"{launches[1]} backward launches for {python_steps()} steps run from Python")
    check(len(saved) == 1, "the plot function did not run")
    for name in ("ema_params.pt", "train_state.pt", "experiment_state.json"):
        check(os.path.isfile(os.path.join(config.experiment_path, "checkpoints", name)), f"no checkpoints/{name}")
    # the step alone, on the trained engine's parameters: at the run's B=8
    # (the JAX bench's), then at the config's B=64 without remat (the tree's
    # train batch 8 times over: the tree holds 16 training samples)
    import numpy as np

    batch = next(iter(ip.build_data(config).get_train_loader()))
    rates = {"b8": step_numbers(engine, batch, "[22 ipmsa unet train] step B=8")}
    big = {k: np.concatenate([batch[k]] * 8) for k in ("images", "prompt")}
    rates["b64"] = step_numbers(engine, big, "[22 ipmsa unet train] step B=64, remat False")
    del engine, batch, big
    gc.collect()
    torch.cuda.empty_cache()
    return rates, launches


def phase_ipmsa_unet_classify(fa, ip, config_cls, tree, workdir):
    """``inference_torch.py`` on the trained checkpoint (B=8, 4 evaluations x 2 classes), classify B=8 and B=1, then ``explain_torch.py``."""
    import numpy as np

    cfg = dict(IP_CONFIG, encoder_type="nn", **ipmsa_experiment(tree, workdir, "ipmsa-unet"))
    os.environ["DATA_PATH"] = tree["roots"]["lz4"]
    os.environ["INFERENCE_CONFIG"] = json.dumps(cfg)
    config = config_cls.from_dict(dict(cfg))
    forwards = {}
    hook = count_forwards(forwards)
    try:
        free = before_run()
        reset_counts(fa)
        with plain_attention_calls() as calls:
            metric_output, preds, batches = load_script("inference_torch", "ipmsa").main([])
            torch.cuda.synchronize()
    finally:
        hook.remove()
    b, evals = config.batch_size, config.evaluation_per_stage[0]
    peak_gb = peak_memory("[22 ipmsa unet classify] inference_torch.main()")
    group = auto_group(forwards, b, evals, 2, 128 * 128 * 40, free, "[22 ipmsa unet classify]")
    chunk = 1 if b >= 16 else 2  # class_chunk -1: one class a tail from B=16, both below
    tails = evals // group * 2 // chunk
    want = {("encode", group * b): evals // group, ("tail", group * b * chunk): tails}
    p = torch.cat(preds)
    launches = fa.FLASH_FWD.launches
    print(f"[22 ipmsa unet classify] inference_torch.main() on the trained checkpoint: {metric_output}; forwards {forwards} (expected {want}), flash launches {launches}, plain-route calls {calls[0]}")
    check(forwards == want, f"forwards {forwards}, expected {want}")
    check(launches == IP_FLASH_A_TAIL * tails and calls[0] == IP_PLAIN_A_TAIL * tails, f"launches {launches}, plain calls {calls[0]}")
    check(len(p) == b and bool(((p == 0) | (p == 1)).all()) and len(metric_output) == 4, f"predictions {p.tolist()}")
    check_no_copies(fa, "[22 ipmsa unet classify]")

    engine = ip.build_engine(config)
    engine.init_params()
    engine.load_checkpoint(os.path.join(config.experiment_path, "checkpoints"), train_state=False)
    images = batches[0]["images"]
    ms8 = cuda_ms(lambda: engine.classify(images), reps=3, warmup=1)
    ms1 = cuda_ms(lambda: engine.classify(images[:1]), reps=5, warmup=1)
    rates = {"images_per_s_b8": b * 1e3 / ms8, "ms_b8": ms8, "latency_ms_b1": ms1}
    busy, _, kernels = profile_table(f"[22 ipmsa unet classify] classify B={b}", lambda: engine.classify(images))
    rates["b8"] = {"device_ms": busy, "kernels": kernels, "idle_percent": 100 * max(0.0, 1 - busy / ms8)}
    print(f"[22 ipmsa unet classify] classify B={b} ({evals} evals x 2 classes, shared prefix): {ms8:.2f} ms median wall -> {b * 1e3 / ms8:.2f} images/s, device busy {busy:.2f} ms in {kernels} kernels, idle ~{rates['b8']['idle_percent']:.1f}%; B=1 {ms1:.2f} ms")
    rates.update(group=group, peak_gb=peak_gb,
                 row_bytes_per_elem=row_bytes(engine, images, "[22 ipmsa unet classify]"))
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # the counterfactual explanation: both forced labels on the test batch
    os.environ["INFERENCE_CONFIG"] = json.dumps(dict(cfg, sampling_steps=IP_EXPLAIN_STEPS))
    saved = []
    reset_counts(fa)
    start = time.perf_counter()
    out = load_script("explain_torch", "ipmsa").main([], plot_function=numpy_plotter(saved))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    explain = {"seconds_both_labels": seconds, "sampling_steps": IP_EXPLAIN_STEPS, "flash_launches": fa.FLASH_FWD.launches}
    for label in (True, False):
        (sample,), (batch,) = out[label]
        check(sample.shape == (b, 128, 128, 40) and bool(torch.isfinite(sample).all()), f"explain {label} samples")
        check(float(sample.abs().max()) <= 1.0, f"explain {label} samples outside [-1, 1]")
        check(bool((np.asarray(batch["prompt"]) == int(label)).all()), f"explain {label}: prompts not forced")
    diff = (out[True][0][0] - out[False][0][0]).abs().mean().item()
    print(f"[22 ipmsa explain] explain_torch.main(): active and inactive, {b} test images each re-noised to t=0.5 and sampled back over {IP_EXPLAIN_STEPS} steps, in {seconds:.1f} s together (engines, checkpoint and loader included); flash launches {fa.FLASH_FWD.launches} (9 a tail, one tail on 2B a step, {IP_EXPLAIN_STEPS + 1} steps a label); samples finite in [-1, 1]; mean |active - inactive| {diff:.4f}; {len(saved)} plots")
    # the sampler runs sampling_steps + 1 denoiser steps (the last to t = 0)
    check(len(saved) == 2 and fa.FLASH_FWD.launches == 2 * (IP_EXPLAIN_STEPS + 1) * IP_FLASH_A_TAIL,
          f"explain launches {fa.FLASH_FWD.launches}")
    return rates, explain, launches


def phase_ipmsa_dit(fa, config_cls, tree, workdir):
    """The IPMSA DiT: ``ipmsa-dit/train_torch.py`` on the tree, then ``inference_torch.py``; 12 launches a forward and a backward."""
    from diffusion_classifier_tpu_torch.experiments import ipmsa_dit

    cfg = dict(IP_CONFIG, encoder_type="DiT", patch_size=4, num_epochs=1, log_every_steps=1, use_comet=True,
               sampling_steps=4, **ipmsa_experiment(tree, workdir, "ipmsa-dit"))
    os.environ["DATA_PATH"] = tree["roots"]["npy"]
    os.environ["TRAINING_CONFIG"] = json.dumps(cfg)
    config = config_cls.from_dict(dict(cfg))
    with torch.device("meta"):
        n_params = sum(p.numel() for p in ipmsa_dit.build_backbone(config).parameters())
    check(n_params == IP_DIT_PARAMS, f"{n_params} parameters, the IPMSA DiT has {IP_DIT_PARAMS}")
    forwards = {}
    hook = count_forwards(forwards)
    try:
        reset_counts(fa)
        start = time.perf_counter()
        load_script("train_torch", "ipmsa-dit").main([], plot_function=numpy_plotter([]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        fwd, bwd, n_forwards = fa.FLASH_FWD.launches, fa.FLASH_BWD.launches, sum(forwards.values())
        steps = IP_SPLITS["train"] // config.batch_size
        with open(os.path.join(config.experiment_path, "track.jsonl")) as f:
            losses = [e["value"] for e in map(json.loads, f) if e.get("name") == "loss" and e.get("step") is not None]
        print(f"[23 ipmsa dit] {n_params} parameters; train_torch.main() on the .npy tree (128x128x40 at patch 4: 1024 tokens x 6 x 64): {len(losses)} steps in {seconds:.1f} s; denoiser forwards {forwards}; flash launches fwd {fwd} bwd {bwd}; loss first {losses[0]:.5f} last {losses[-1]:.5f}")
        check_no_copies(fa, "[23 ipmsa dit train]")
        check(len(losses) == steps and all(math.isfinite(v) for v in losses), f"losses {losses}")
        check(bwd == 12 * python_steps() and fwd == 12 * n_forwards,
              f"launches fwd {fwd} for {n_forwards} forwards, bwd {bwd} for {python_steps()} steps run from Python")
        launches = {"train": (fwd, bwd)}

        os.environ["INFERENCE_CONFIG"] = json.dumps(dict(cfg, use_comet=False))
        forwards.clear()
        reset_counts(fa)
        metric_output, preds, batches = load_script("inference_torch", "ipmsa-dit").main([])
        torch.cuda.synchronize()
        n_forwards = sum(forwards.values())
        p = torch.cat(preds)
        print(f"[23 ipmsa dit classify] inference_torch.main(): {metric_output}; forwards {forwards}, flash launches {fa.FLASH_FWD.launches}")
        check(fa.FLASH_FWD.launches == 12 * n_forwards > 0 and fa.FLASH_BWD.launches == 0, "classify launches")
        check(bool(((p == 0) | (p == 1)).all()) and len(metric_output) == 4, f"predictions {p.tolist()}")
        launches["classify"] = fa.FLASH_FWD.launches
    finally:
        hook.remove()
    check_no_copies(fa, "[23 ipmsa dit classify]")
    return launches


def phase_ipmsa_resnet(fa, config_cls, tree, workdir):
    """The ResNet-50 baseline: ``ipmsa-classifier/train_torch.py`` on the tree, the step alone, ``inference_torch.py``."""
    import numpy as np

    from diffusion_classifier_tpu_torch.experiments import ipmsa_classifier

    cfg = dict(IP_CONFIG, variant="resnet50", mixed_precision="no", num_epochs=1, use_comet=True,
               learning_rate=1e-4, lr_warmup_steps=1, **ipmsa_experiment(tree, workdir, "ipmsa-classifier"))
    os.environ["DATA_PATH"] = tree["roots"]["npy"]
    os.environ["TRAINING_CONFIG"] = json.dumps(cfg)
    config = config_cls.from_dict(dict(cfg))
    reset_counts(fa)
    start = time.perf_counter()
    engine = load_script("train_torch", "ipmsa-classifier").main([])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    n_params = sum(p.numel() for p in engine.model.parameters())
    with open(os.path.join(config.experiment_path, "track.jsonl")) as f:
        events = [json.loads(line) for line in f]
    train_loss = [e["value"] for e in events if e.get("name") == "train_loss"]
    print(f"[24 resnet] ResNet-50 + head, {n_params} parameters, fp32: train_torch.main() on the .npy tree, 1 epoch of {IP_SPLITS['train'] // 8} steps at B=8 in {seconds:.1f} s (decode, eval, checkpoint included); train loss {train_loss}")
    check(len(train_loss) == 1 and math.isfinite(train_loss[0]), f"train loss {train_loss}")
    check(os.path.isfile(os.path.join(config.experiment_path, "checkpoints", "classifier_state.pt")), "no classifier checkpoint")
    check((fa.FLASH_FWD.launches, fa.FLASH_BWD.launches) == (0, 0), "the ResNet launched a flash kernel")
    check(engine.model.backbone.bn1.running_var.device.type == "cuda", "the ResNet is not on the card")
    batch = next(iter(ipmsa_classifier.build_data(config).get_train_loader()))
    engine._build_train_step(total_steps=100)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: engine.train_step(batch), reps=5, warmup=2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    busy, _, kernels = profile_table("[24 resnet] one warm step B=8", lambda: engine.train_step(batch))
    rates = {"step_ms": step_ms, "images_per_s": 8e3 / step_ms, "peak_gb": peak_gb, "device_ms": busy,
             "kernels": kernels, "idle_percent": 100 * max(0.0, 1 - busy / step_ms)}
    print(f"[24 resnet] step B=8 at 256x256x10: median {step_ms:.2f} ms -> {rates['images_per_s']:.2f} images/s; peak memory {peak_gb:.3f} GB; device busy {busy:.2f} ms in {kernels} kernels, idle ~{rates['idle_percent']:.1f}%")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    os.environ["INFERENCE_CONFIG"] = json.dumps(dict(cfg, use_comet=False))
    val_loss, metric_output = load_script("inference_torch", "ipmsa-classifier").main([])
    values = [v for d in metric_output for v in d.values()]
    print(f"[24 resnet] inference_torch.main(): val_loss {val_loss:.4f}, {metric_output}")
    check(math.isfinite(val_loss) and len(metric_output) == 4 and all(0.0 <= v <= 1.0 for v in values),
          f"val loss {val_loss}, metrics {metric_output}")
    rates["val_loss"] = val_loss
    return rates


# --- multi-process (phases 25-29): torch.distributed on the one card

# Which world each mode runs at on this one card is a fixed rule, from a probe
# on it (torch 2.11.0+cu128): NCCL refuses two ranks on one device, so the
# 2-rank modes use gloo with CUDA tensors. DDP's all-reduce and the tensor-
# parallel collectives run so; FSDP2 over gloo with CUDA tensors killed both
# ranks with SIGSEGV in its first step, so FSDP runs at world 1 on NCCL.
MP_WORLD = {"ddp": (2, "gloo"), "fsdp": (1, "nccl"), "tp": (2, "gloo")}
# the CheXpert DiT-b4 at full width (INFERENCE_CONFIG: 256 px, DWT, 1024
# tokens, bf16) at the global B=16, 8 rows a rank at world 2; the default
# warmup (500 steps) keeps 3 steps' learning rate near 0, so the compared
# runs take the same weights into classify
MP_DIT_CONFIG = dict(INFERENCE_CONFIG, evaluation_batches=0, experiment_dir="mp-dit")
# the flagship UNet at full width, B=64, in fp32: a bf16 row-parallel layer
# rounds each rank's partial product before the sum, which moves near-tied
# class errors; fp32 holds the tensor-parallel run to the one-process run
MP_UNET_CONFIG = dict(CIFAR_CONFIG, mixed_precision="no", experiment_dir="mp-unet")
MP_STEPS = 3  # compared train steps
MP_TIMED = 3  # warm steps timed after them
TP_SHAPES = sorted({shape for shape, _ in TP_CASES})
# phase 29: one epoch of the synthetic set's 256 images at B=16 (16 steps);
# SIGTERM after rank 0 logs step 3
PREEMPT_CONFIG = dict(INFERENCE_CONFIG, num_epochs=1, log_every_steps=1, experiment_dir="mp-preempt")
PREEMPT_AFTER = 3


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank, world, port):
    return dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                WORLD_SIZE=str(world), LOCAL_RANK=str(rank), PYTHONUNBUFFERED="1")


def start_ranks(kind, world, workdir):
    """``world`` processes of ``chip_smoke.py --worker kind workdir``, each logging to ``rank<r>.log``."""
    port = free_port()
    procs = []
    for rank in range(world):
        log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", kind, workdir],
            env=rank_env(rank, world, port), cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
        ))
        log.close()
    return procs


def stop_ranks(procs, timeout):
    """Waits for every rank until the deadline, then kills what is left; returns the exit codes."""
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs]


def log_tail(workdir, rank, n=3000):
    with open(os.path.join(workdir, f"rank{rank}.log"), errors="replace") as f:
        return f.read()[-n:]


def run_ranks(kind, tag, world, backend, workdir, inputs, timeout=600):
    """Runs ``kind`` on ``world`` ranks over ``backend``; fails unless every rank exits 0; returns their outputs."""
    wd = _mkdir(os.path.join(workdir, f"ranks-{tag}"))
    torch.save(dict(inputs, backend=backend), os.path.join(wd, "inputs.pt"))
    start = time.perf_counter()
    rcs = stop_ranks(start_ranks(kind, world, wd), timeout)
    for rank, rc in enumerate(rcs):
        check(rc == 0, f"{tag}: rank {rank} exited {rc}:\n{log_tail(wd, rank)}")
    print(f"{tag} {world} rank(s) over {backend} on one card: {time.perf_counter() - start:.1f} s, processes included")
    return [torch.load(os.path.join(wd, f"out{r}.pt"), weights_only=False) for r in range(world)]


def mp_inputs(size, channels, classes, batch, seed):
    """``MP_STEPS`` global train batches and one val batch, from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def draw():
        return (rng.uniform(-1, 1, (batch, size, size, channels)).astype(np.float32),
                rng.integers(0, classes, batch).astype(np.int32))

    return {"batches": [draw() for _ in range(MP_STEPS)], "val": draw()}


def mp_run(kind, config, inputs, device, mesh=None):
    """The compared run of phases 25-27: ``MP_STEPS`` train steps and a classify through ``evaluate``, then the timed steps.

    Each rank feeds its rows of the global batches. Launches and kernel
    shapes are counted from 0 over the compared run.
    """
    from diffusion_classifier_tpu_torch.data.loader import ArrayDataLoader
    from diffusion_classifier_tpu_torch.engine import DiffusionClassifier
    from diffusion_classifier_tpu_torch.experiments import chexpert_dit, cifar10
    from diffusion_classifier_tpu_torch.ops import flash_attention as fa
    from diffusion_classifier_tpu_torch.utils.metrics import F1, Accuracy

    family = chexpert_dit if kind == "dit" else cifar10
    engine = DiffusionClassifier(family.build_backbone(config), config, device=device, mesh=mesh)
    engine.init_params()
    engine._build_train_state(MP_STEPS + MP_TIMED + 4)
    pl = engine.state.placement

    def local(x, y):
        b = x.shape[0] // pl.data_count
        return {"images": x[pl.data_index * b:(pl.data_index + 1) * b],
                "prompt": y[pl.data_index * b:(pl.data_index + 1) * b]}

    out = {"placement": {"mode": pl.mode, "fsdp": pl.fsdp, "ddp": pl._ddp is not None,
                         "tp_slices": len(pl.tp_slices), "data": (pl.data_index, pl.data_count)}}
    reset_counts(fa)
    with kernel_shapes(fa) as seen:
        out["losses"] = [float(engine.train_step(local(x, y))) for x, y in inputs["batches"]]
        torch.cuda.synchronize()
        out["train_launches"] = (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches)
        out["copies"] = (fa.FLASH_FWD.copies, fa.FLASH_BWD.copies)
        reset_counts(fa)
        vx, vy = inputs["val"]
        metrics = [Accuracy("accuracy"), F1("f1")]
        preds, _, _ = engine.evaluate(ArrayDataLoader(vx, vy, vx.shape[0], shuffle=False),
                                      metrics=metrics, classification=True)
        torch.cuda.synchronize()
        out["classify_launches"] = (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches)
    out["shapes"] = {name: sorted(s, key=str) for name, s in seen.items()}
    for m in metrics:
        m.sync_across_processes(engine._data_group)
    out["preds"] = [p.numpy() for p in preds]
    out["counters"] = {m.name: dict(m.counters) for m in metrics}
    batch = local(*inputs["batches"][0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["step_ms"] = cuda_ms(lambda: engine.train_step(batch), reps=MP_TIMED, warmup=1)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    busy, _, kernels = profile_table(f"[{kind} {pl.mode}] one warm step", lambda: engine.train_step(batch))
    out["device_ms"], out["kernels"] = busy, kernels
    out["idle_percent"] = 100 * max(0.0, 1 - busy / out["step_ms"])
    if pl.tp_slices:
        attn = engine.denoiser.backbone.mid_attn_0.blocks[0]
        out["local_to_q"] = tuple(attn.attn1.to_q.weight.shape)
        out["local_proj_in"] = tuple(attn.ff.proj_in.weight.shape)
    del engine, pl
    gc.collect()
    torch.cuda.empty_cache()
    return out


def hold_to_one_process(tag, outs, ref, rtol):
    """Every rank's losses within ``rtol`` of the one-process run's; the global predictions and synced counters equal."""
    for rank, out in enumerate(outs):
        rel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], ref["losses"]))
        print(f"{tag} rank {rank}: losses {[round(v, 6) for v in out['losses']]} vs one process {[round(v, 6) for v in ref['losses']]} (max rel {rel:.2e}, limit {rtol}); counters {out['counters']}; launches train {out['train_launches']} classify {out['classify_launches']}; step {out['step_ms']:.2f} ms, peak {out['peak_gb']:.3f} GB, idle ~{out['idle_percent']:.1f}%")
        check(rel <= rtol, f"{tag} rank {rank}: losses {out['losses']} vs {ref['losses']}")
        check(out["counters"] == ref["counters"], f"{tag} rank {rank}: counters {out['counters']} vs {ref['counters']}")
        check(out["copies"] == (0, 0), f"{tag} rank {rank}: alignment copies {out['copies']}")
    data_count = outs[0]["placement"]["data"][1]
    # the ranks of one model group hold the same rows: each such group's
    # data ranks, in order, hold the global batch
    model_count = len(outs) // data_count
    for m in range(model_count):
        group = outs[m::model_count]
        for i, want in enumerate(ref["preds"]):
            got = [int(v) for r in group for v in r["preds"][i]]
            check(got == [int(v) for v in want], f"{tag}: predictions {got} vs one process {want.tolist()}")


def covered(fa, tag, outs):
    seen = {name: set() for name in outs[0]["shapes"]}
    for out in outs:
        for name, shapes in out["shapes"].items():
            seen[name] |= {(tuple(s), d) for s, d in shapes}
    check_covered(fa, seen, tag)


def mp_summary(outs, ref=None):
    keys = ("step_ms", "peak_gb", "device_ms", "kernels", "idle_percent")
    summary = {"per_rank": [{k: out[k] for k in keys} for out in outs]}
    if ref is not None:
        summary["one_process"] = {k: ref[k] for k in keys}
    return summary


def launches_of(outs):
    return (sum(o["train_launches"][0] + o["classify_launches"][0] for o in outs),
            sum(o["train_launches"][1] for o in outs))


def phase_mp_dit(fa, config_cls, workdir):
    """Phases 25-26: the DiT-b4 under DDP (world 2, gloo) and FSDP and DDP at world 1 (NCCL), held to one process."""
    import numpy as np

    config = config_cls.from_dict(dict(MP_DIT_CONFIG, project_root=workdir))
    inputs = mp_inputs(256, 3, 2, 16, seed=40)
    ref = mp_run("dit", config, inputs, "cuda")
    print(f"[25 ddp] one process (no group): losses {ref['losses']}, predictions {np.concatenate(ref['preds']).tolist()}, counters {ref['counters']}; step B=16 {ref['step_ms']:.2f} ms, peak {ref['peak_gb']:.3f} GB, idle ~{ref['idle_percent']:.1f}%")
    released("[25 ddp]")
    world, backend = MP_WORLD["ddp"]
    ddp = run_ranks("dit", "[25 ddp]", world, backend, workdir, dict(
        inputs, configs=[dict(MP_DIT_CONFIG, project_root=workdir, param_sharding="replicated")]))
    ddp = [o[0] for o in ddp]
    check(all(o["placement"]["ddp"] and not o["placement"]["fsdp"] for o in ddp), f"placements {[o['placement'] for o in ddp]}")
    check(all(o["train_launches"] == (12 * MP_STEPS, 12 * MP_STEPS) for o in ddp), "DDP train launches")
    hold_to_one_process("[25 ddp]", ddp, ref, rtol=1e-3)
    covered(fa, "[25 ddp]", ddp)
    released("[26 fsdp]")
    world, backend = MP_WORLD["fsdp"]
    # FSDP (phase 26), then DDP at the same world 1 on NCCL: the wrapper's cost against the one-process step
    fsdp, ddp1 = run_ranks("dit", "[26 fsdp]", world, backend, workdir, dict(
        inputs, configs=[dict(MP_DIT_CONFIG, project_root=workdir, param_sharding=mode)
                         for mode in ("fsdp", "replicated")]))[0]
    check(fsdp["placement"]["fsdp"] and not fsdp["placement"]["ddp"], f"placement {fsdp['placement']}")
    check(ddp1["placement"]["ddp"], f"placement {ddp1['placement']}")
    hold_to_one_process("[26 fsdp]", [fsdp], ref, rtol=1e-3)
    hold_to_one_process("[26 ddp world 1]", [ddp1], ref, rtol=1e-3)
    covered(fa, "[26 fsdp]", [fsdp, ddp1])
    print(f"[26 fsdp] peak memory a rank: FSDP at world 1 {fsdp['peak_gb']:.3f} GB, DDP at world 2 {[round(o['peak_gb'], 3) for o in ddp]} GB, one process {ref['peak_gb']:.3f} GB")
    print(f"[26 ddp wrapper] DiT-b4 B=16 step at world 1 on NCCL: DDP {ddp1['step_ms']:.2f} ms vs no group {ref['step_ms']:.2f} ms ({100 * (ddp1['step_ms'] / ref['step_ms'] - 1):+.1f}%)")
    return {
        "ddp_world2_gloo": mp_summary(ddp, ref), "fsdp_world1_nccl": mp_summary([fsdp]),
        "ddp_world1_nccl": mp_summary([ddp1]),
        "launches": {"ddp": launches_of(ddp), "fsdp": launches_of([fsdp]), "ddp_world1": launches_of([ddp1])},
    }


def phase_mp_tp(fa, config_cls, workdir):
    """Phase 27: the flagship UNet at data 1 × model 2 (tensor parallel), held to one process."""
    config = config_cls.from_dict(dict(MP_UNET_CONFIG, project_root=workdir))
    inputs = mp_inputs(32, 3, 10, 64, seed=41)
    ref = mp_run("unet", config, inputs, "cuda")
    released("[27 tp]")
    world, backend = MP_WORLD["tp"]
    outs = run_ranks("unet", "[27 tp]", world, backend, workdir, dict(
        inputs, mesh=(1, 2), configs=[dict(MP_UNET_CONFIG, project_root=workdir, param_sharding="tp")]))
    outs = [o[0] for o in outs]
    for out in outs:
        print(f"[27 tp] placement {out['placement']}: mid transformer to_q {out['local_to_q']}, GEGLU proj_in {out['local_proj_in']} a rank")
        check(out["placement"]["tp_slices"] > 0 and out["local_to_q"] == (256, 512) and out["local_proj_in"] == (2048, 512),
              f"tensor-parallel slices {out['placement']} {out['local_to_q']} {out['local_proj_in']}")
    hold_to_one_process("[27 tp]", outs, ref, rtol=1e-4)
    covered(fa, "[27 tp]", outs)
    seen = {tuple(s) for out in outs for s, _ in out["shapes"][fa.FLASH_FWD.name]}
    check(set(TP_SHAPES) <= seen, f"[27 tp]: the forward ran at {sorted(seen)}, not at the head-split shapes {TP_SHAPES}")
    return {"tp_unet_world2_gloo": mp_summary(outs, ref), "launches": {"tp": launches_of(outs)}}


def entry_main(experiment, script, outfile):
    """``chip_smoke.py --entry``: runs an entry point's ``main`` in this (torchrun) process and records its launches."""
    sys.path.insert(0, REPO)
    from diffusion_classifier_tpu_torch.ops import flash_attention as fa

    reset_counts(fa)
    saved = []
    module = load_script(script, experiment)
    kwargs = {"plot_function": numpy_plotter(saved)} if experiment != "ipmsa-classifier" else {}
    result = module.main([], **kwargs)
    torch.cuda.synchronize()
    import torch.distributed as dist

    out = {"launches": (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches),
           "world": dist.get_world_size() if dist.is_initialized() else 0,
           "backend": dist.get_backend() if dist.is_initialized() else None}
    if script == "inference_torch" and experiment != "ipmsa-classifier":
        out["metrics"] = result[0]
    torch.save(out, outfile)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def torchrun(tag, experiment, script, workdir, env, timeout=600):
    outfile = os.path.join(workdir, f"{experiment}-{script}.pt")
    log = os.path.join(workdir, f"{experiment}-{script}.log")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=1", f"--master_port={free_port()}",
           os.path.abspath(__file__), "--entry", experiment, script, outfile]
    start = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, env=dict(os.environ, **env), cwd=REPO, stdout=f, stderr=subprocess.STDOUT)
    rc = stop_ranks([proc], timeout)[0]
    with open(log, errors="replace") as f:
        text = f.read()
    check(rc == 0, f"{tag}: torchrun {experiment}/{script}.py exited {rc}:\n{text[-3000:]}")
    out = torch.load(outfile, weights_only=False)
    print(f"{tag} torchrun --nproc_per_node=1 experiments/{experiment}/{script}.py: {time.perf_counter() - start:.1f} s, world {out['world']} on {out['backend']}, flash launches {out['launches']}")
    check(out["world"] == 1 and out["backend"] == "nccl", f"{tag}: not a NCCL group at world 1: {out}")
    return out


def read_back(tag, folder, names):
    """Loads every checkpoint file of ``folder``; fails on a missing file or a non-finite tensor."""
    for name in names:
        path = os.path.join(folder, name)
        check(os.path.isfile(path), f"{tag}: no {path}")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        tensors = []

        def walk(x):
            if isinstance(x, torch.Tensor):
                tensors.append(x)
            elif isinstance(x, dict):
                for v in x.values():
                    walk(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    walk(v)

        walk(payload)
        check(tensors and all(bool(torch.isfinite(t.float()).all()) for t in tensors if t.is_floating_point()),
              f"{tag}: {name} holds no tensor or a non-finite one")
        print(f"{tag} read back {name}: {len(tensors)} tensors, {sum(t.numel() for t in tensors)} elements, finite")


def phase_mp_entry(fa, config_cls, trees, ip_tree, workdir):
    """Phase 28: the entry points under ``torchrun`` at world 1 on NCCL: the CheXpert DiT at FSDP, the ResNet-50 at DDP."""
    cfg = dict(CX_CONFIG, encoder_type="DiT", patch_size=4, data_path=trees["chexpert"], num_epochs=1,
               sampling_steps=4, project_root=workdir, experiment_dir="mp-entry-dit", param_sharding="fsdp")
    config = config_cls.from_dict(dict(cfg))
    launches = {}
    out = torchrun("[28 entry]", "chexpert-dit", "train_torch", workdir, {"TRAINING_CONFIG": json.dumps(cfg)})
    steps = 192 // config.batch_size
    check(out["launches"][1] == 12 * steps, f"[28 entry] {out['launches'][1]} backward launches for {steps} steps")
    launches["dit_train"] = out["launches"]
    read_back("[28 entry]", os.path.join(config.experiment_path, "checkpoints"),
              ("ema_params.pt", "train_state.pt"))
    out = torchrun("[28 entry]", "chexpert-dit", "inference_torch", workdir, {"INFERENCE_CONFIG": json.dumps(cfg)})
    check(out["launches"][0] > 0 and out["launches"][1] == 0, f"[28 entry] classify launches {out['launches']}")
    check(len(out["metrics"]) == 4, f"[28 entry] metrics {out['metrics']}")
    check(os.path.isfile(os.path.join(config.experiment_path, "mistakes-ddpm-chexpert.txt")), "[28 entry] no mistakes file")
    launches["dit_classify"] = out["launches"]
    rcfg = dict(IP_CONFIG, variant="resnet50", mixed_precision="no", num_epochs=1, learning_rate=1e-4,
                lr_warmup_steps=1, param_sharding="replicated",
                **ipmsa_experiment(ip_tree, workdir, "mp-entry-resnet"))
    out = torchrun("[28 entry]", "ipmsa-classifier", "train_torch", workdir,
                   {"TRAINING_CONFIG": json.dumps(rcfg), "DATA_PATH": ip_tree["roots"]["npy"]})
    check(out["launches"] == (0, 0), f"[28 entry] the ResNet launched {out['launches']}")
    read_back("[28 entry]", os.path.join(workdir, "mp-entry-resnet", "checkpoints"), ("classifier_state.pt",))
    return launches


def preempt_worker(inputs, rank):
    """Phase 29's rank: ``train_loop`` on the synthetic set, its losses and saves logged; the resume also runs the uninterrupted epoch."""
    from diffusion_classifier_tpu_torch.experiments import chexpert_dit
    from diffusion_classifier_tpu_torch.ops import flash_attention as fa
    from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

    log = {"losses": [], "saved_at": [], "writes": []}
    real_save = torch.save

    def counted(obj, f, *a, **k):
        log["writes"].append(str(f))
        return real_save(obj, f, *a, **k)

    def run(cfg, record):
        config = ExperimentConfig.from_dict(dict(cfg))
        engine = chexpert_dit.build_engine(config, device="cuda:0")
        step, save = engine.train_step, engine.save_checkpoint

        def train_step(batch, **kw):
            loss = step(batch, **kw)
            record["losses"].append(float(loss))
            return loss

        def save_checkpoint(*a, **k):
            record["saved_at"].append(engine.state.step)
            return save(*a, **k)

        engine.train_step, engine.save_checkpoint = train_step, save_checkpoint
        data = chexpert_dit.build_data(config)
        engine.train_loop(data.get_train_loader(), data.get_val_loader())
        return engine

    reset_counts(fa)
    torch.save = counted
    try:
        run(inputs["config"], log)
        if inputs["config"].get("resume"):
            full = {"losses": [], "saved_at": [], "writes": []}
            run(dict(inputs["config"], resume=False, experiment_dir="mp-preempt-full"), full)
            log["full_losses"] = full["losses"]
    finally:
        torch.save = real_save
        log["launches"] = (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches)
        torch.save(log, os.path.join(inputs["dir"], f"out{rank}.pt"))


def phase_mp_preempt(fa, workdir):
    """Phase 29: SIGTERM to both ranks mid-epoch; both save at one step, the resume continues to the uninterrupted run."""
    import signal

    world, backend = MP_WORLD["ddp"]
    wd = _mkdir(os.path.join(workdir, "ranks-[29 preempt]"))
    cfg = dict(PREEMPT_CONFIG, project_root=workdir)
    torch.save({"config": cfg, "dir": wd, "backend": backend}, os.path.join(wd, "inputs.pt"))
    procs = start_ranks("preempt", world, wd)
    try:
        deadline, seen = time.time() + 300, False
        while time.time() < deadline and not seen and all(p.poll() is None for p in procs):
            time.sleep(0.2)
            seen = f"step {PREEMPT_AFTER}/" in log_tail(wd, 0, 100000)
        check(seen, f"[29 preempt] training never logged step {PREEMPT_AFTER}:\n{log_tail(wd, 0)}")
        for p in procs:  # the orchestrator signals every rank
            p.send_signal(signal.SIGTERM)
        rcs = stop_ranks(procs, 300)
    finally:
        stop_ranks(procs, 1)
    check(rcs == [128 + signal.SIGTERM] * world, f"[29 preempt] exit codes {rcs}:\n{log_tail(wd, 0)}\n{log_tail(wd, 1)}")
    logs = [torch.load(os.path.join(wd, f"out{r}.pt"), weights_only=False) for r in range(world)]
    saved = logs[0]["saved_at"]
    steps = 256 // cfg["batch_size"]
    print(f"[29 preempt] SIGTERM after step {PREEMPT_AFTER}: saved at steps {[log['saved_at'] for log in logs]}; checkpoint files written by rank {[len(log['writes']) for log in logs]}")
    check(len(saved) == 1 and all(log["saved_at"] == saved for log in logs), "[29 preempt] the ranks saved at different steps")
    check(PREEMPT_AFTER <= saved[0] < steps, f"[29 preempt] saved at step {saved[0]}")
    check(logs[0]["writes"] and not any(log["writes"] for log in logs[1:]), "[29 preempt] a rank other than 0 wrote")
    check("Preemption notice: saving checkpoint at synced step" in log_tail(wd, 0, 100000), "[29 preempt] no preemption notice")
    torch.save({"config": dict(cfg, resume=True), "dir": wd, "backend": backend}, os.path.join(wd, "inputs.pt"))
    start = time.perf_counter()
    rcs = stop_ranks(start_ranks("preempt", world, wd), 600)
    check(rcs == [0] * world, f"[29 preempt] resume exit codes {rcs}:\n{log_tail(wd, 0)}")
    resumed = [torch.load(os.path.join(wd, f"out{r}.pt"), weights_only=False) for r in range(world)]
    for log, res in zip(logs, resumed):
        got, want = log["losses"] + res["losses"], res["full_losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"[29 preempt] resumed {len(res['losses'])} steps after step {saved[0]} in {time.perf_counter() - start:.1f} s (the uninterrupted epoch included): interrupted + resumed losses vs uninterrupted, max rel {rel:.2e} (limit 1e-3)")
        check(len(got) == len(want) == steps, f"[29 preempt] {len(got)} steps, uninterrupted {len(want)}")
        check(all(map(math.isfinite, got)) and rel <= 1e-3, f"[29 preempt] losses {got} vs {want}")
    return {"saved_at": saved[0], "launches": (sum(r["launches"][0] for r in logs + resumed),
                                               sum(r["launches"][1] for r in logs + resumed))}


# --- the text-conditioned ('t5') UNet (phase 30)

# a [classes + 1, S, D] class table as a frozen T5 encoder gives it: t5-base's
# width 768 (the config's default t5_path) and the config's t5_max_length of
# 8 tokens; random from T5_SEED (the repository holds no T5 weights)
T5_TABLE = (11, 8, 768)
T5_SEED = 30
T5_SAMPLE_STEPS = 32  # the config's 128 cut to 32, to keep the script within its time
# the flagship's transformer blocks a tail: 2 + 2 down (levels 2, 3), 1 in
# the mid block, 3 + 3 up; each runs one self-attention (the kernel) and one
# cross-attention over the table's 8 tokens (S_kv != S_q: the plain route)
UNET_BLOCKS_A_TAIL = 11


def trace_kernels(path):
    """``(CUDA kernel events, their device ms)`` of a Chrome trace that ``profiling.trace`` wrote."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    return events, sum(e.get("dur", 0) for e in events) / 1e3


def phase_t5(fa, cifar, config_cls, workdir):
    """Phase 30: the flagship UNet conditioned on a T5 class table, through the CIFAR-10 entry points."""
    import numpy as np

    from diffusion_classifier_tpu_torch.utils import profiling

    tag = "[30 t5]"
    table = np.random.default_rng(T5_SEED).standard_normal(T5_TABLE).astype(np.float32)
    path = os.path.join(workdir, "t5_table.npy")
    np.save(path, table)
    cfg = dict(CIFAR_TRAINING_CONFIG, encoder_type="t5", t5_table_path=path, project_root=workdir,
               experiment_dir="cifar10-t5")
    config = config_cls.from_dict(dict(cfg))
    with torch.device("meta"):
        backbone = cifar.build_backbone(config)
    n_params = sum(p.numel() for p in backbone.parameters())
    proj = tuple(backbone.encoder_hid_proj.weight.shape)
    print(f"{tag} the flagship UNet built for a {list(T5_TABLE)} table: {n_params} parameters, context {backbone.context_tokens} x {backbone.context_dim}, encoder_hid_proj {proj}")
    check((backbone.context_tokens, backbone.context_dim) == T5_TABLE[1:] and proj == (128, 768),
          f"{tag} the backbone's context {backbone.context_tokens} x {backbone.context_dim}, projection {proj}")
    del backbone
    out = {}

    with kernel_shapes(fa) as seen:
        # training: train_torch.py for one epoch (8 steps at B=64), its eval included
        os.environ["TRAINING_CONFIG"] = json.dumps(cfg)
        saved = []
        reset_counts(fa)
        engine, seconds = profiling.timed(load_script("train_torch", "cifar10").main, [],
                                          plot_function=numpy_plotter(saved))
        fwd, bwd = fa.FLASH_FWD.launches, fa.FLASH_BWD.launches
        check_no_copies(fa, f"{tag} train")
        steps = 512 // config.batch_size
        with open(os.path.join(config.experiment_path, "track.jsonl")) as f:
            events = [json.loads(line) for line in f]
        losses = [e["value"] for e in events if e.get("name") == "loss" and e.get("step") is not None]
        print(f"{tag} train_torch.main(): {len(losses)} steps at B={config.batch_size} in {seconds:.1f} s (eval and checkpoint included); launches fwd {fwd} bwd {bwd}; loss first {losses[0]:.5f} last {losses[-1]:.5f}")
        check(len(losses) == steps and all(math.isfinite(v) for v in losses), f"{tag} losses {losses}")
        ran = python_steps()
        check(bwd == UNET_BLOCKS_A_TAIL * ran, f"{tag} {bwd} backward launches for {ran} steps run from Python")
        check(fwd > UNET_BLOCKS_A_TAIL * ran and len(saved) == 1, f"{tag} {fwd} forward launches, plots {saved}")
        batch = next(iter(cifar.build_data(config).get_train_loader()))
        timer = profiling.StepTimer()
        for i in range(10):
            if i < 2:  # warm-up
                engine.train_step(batch)
                continue
            with timer.measure():
                engine.train_step(batch)
        step = timer.summary()
        print(f"{tag} train step B={config.batch_size} (StepTimer, {step['steps']} warm steps): p50 {1e3 * step['p50_s']:.2f} ms, mean {1e3 * step['mean_s']:.2f} ms, p95 {1e3 * step['p95_s']:.2f} ms -> {config.batch_size / step['p50_s']:.2f} images/s")
        out["train"] = {"launches": (fwd, bwd), "step": step}
        del engine

        # classify: inference_torch.py on the trained checkpoint at the bench's cut
        icfg = dict(cfg, use_comet=False, evaluation_batches=0)
        os.environ["INFERENCE_CONFIG"] = json.dumps(icfg)
        calls = {}
        hook = count_forwards(calls)
        try:
            free = before_run()
            reset_counts(fa)
            with plain_attention_calls() as plain:
                metric_output, preds, _ = load_script("inference_torch", "cifar10").main([])
                torch.cuda.synchronize()
        finally:
            hook.remove()
        launches = fa.FLASH_FWD.launches
        peak_gb = peak_memory(f"{tag} inference_torch.main()")
        b, c, evals = config.batch_size, config.classes, config.evaluation_per_stage[0]
        group = auto_group(calls, b, evals, c, 32 * 32 * 3, free, tag)
        tails = evals // group * c  # one class a tail at B=64
        want = {("encode", group * b): evals // group, ("tail", group * b): tails}
        print(f"{tag} inference_torch.main(): {metric_output}; forwards {calls} (expected {want}); flash launches {launches} ({UNET_BLOCKS_A_TAIL} a tail), plain-route calls {plain[0]} ({UNET_BLOCKS_A_TAIL} cross-attentions a tail)")
        check(calls == want, f"{tag} forwards {calls}, expected {want}")
        check(launches == UNET_BLOCKS_A_TAIL * tails, f"{tag} {launches} flash launches for {tails} tails")
        check(plain[0] == UNET_BLOCKS_A_TAIL * tails, f"{tag} {plain[0]} plain-route calls for {tails} tails")
        check(fa.FLASH_BWD.launches == 0, f"{tag} classification launched the backward")
        check_no_copies(fa, f"{tag} classify")
        check(len(preds) == 1 and len(metric_output) == 1, f"{tag} {len(preds)} batches, {metric_output}")
        check(tuple(preds[0].shape) == (b,) and bool(((preds[0] >= 0) & (preds[0] < c)).all()),
              f"{tag} predictions {preds[0].tolist()}")
        out["classify"] = {"launches": launches, "plain_calls": plain[0], "group": group, "peak_gb": peak_gb}

        engine = cifar.build_engine(config_cls.from_dict(dict(icfg)))
        engine.init_params()
        engine.load_checkpoint(os.path.join(config.experiment_path, "checkpoints"), train_state=False)
        context = engine.encode_text_prompt(np.arange(c + 1))
        check(tuple(context.shape) == T5_TABLE and context.dtype == torch.bfloat16
              and torch.equal(context.cpu(), torch.from_numpy(table).to(torch.bfloat16)),
              f"{tag} encode_text_prompt gave {tuple(context.shape)} {context.dtype}")
        images = (torch.rand((b, 32, 32, 3), generator=torch.Generator().manual_seed(31)) * 2 - 1).numpy()
        engine.classify(images)  # warm
        _, seconds = profiling.timed(engine.classify, images)
        timers = {b: profiling.StepTimer(), 1: profiling.StepTimer()}
        for rows, reps in ((b, 3), (1, 5)):
            for _ in range(reps):
                with timers[rows].measure():
                    engine.classify(images[:rows])
        ms = {rows: 1e3 * t.summary()["p50_s"] for rows, t in timers.items()}
        with profiling.trace(os.path.join(workdir, "t5-trace")) as prof:
            engine.classify(images)
        kernels, busy = trace_kernels(prof.trace_path)
        flash = sum("flash_fwd" in e["name"] for e in kernels)
        print(f"{tag} classify B={b} ({evals} evals x {c} classes, G={group}): profiling.timed {1e3 * seconds:.2f} ms; StepTimer p50 {ms[b]:.2f} ms -> {b * 1e3 / ms[b]:.2f} images/s; B=1 p50 {ms[1]:.2f} ms; profiling.trace: {len(kernels)} CUDA kernel events, {flash} flash forward, device busy {busy:.2f} of {ms[b]:.2f} ms, idle ~{100 * max(0.0, 1 - busy / ms[b]):.1f}%")
        check(kernels, f"{tag} the trace holds no CUDA kernel event")
        check(flash == UNET_BLOCKS_A_TAIL * tails, f"{tag} {flash} flash kernels in the trace for {tails} tails")
        out["classify"].update(images_per_s_b64=b * 1e3 / ms[b], latency_ms_b1=ms[1], timed_ms=1e3 * seconds,
                               trace_kernels=len(kernels), device_ms=busy,
                               row_bytes_per_elem=row_bytes(engine, images, tag))
        del engine

        # CFG sampling of one batch of 32 through inference_torch.py
        os.environ["INFERENCE_CONFIG"] = json.dumps(
            dict(icfg, classification=False, batch_size=32, sampling_steps=T5_SAMPLE_STEPS))
        calls, saved = {}, []
        hook = count_forwards(calls)
        try:
            reset_counts(fa)
            with plain_attention_calls() as plain:
                (samples, _), seconds = profiling.timed(
                    load_script("inference_torch", "cifar10").main, [], plot_function=numpy_plotter(saved))
        finally:
            hook.remove()
        n = T5_SAMPLE_STEPS + 1  # the noisy steps and the final one
        want = {("encode", 32): n, ("tail", 64): n}
        s = samples[0]
        print(f"{tag} sampling B=32, {T5_SAMPLE_STEPS} steps (CFG with the table's null row): {seconds:.2f} s with the engine and checkpoint; samples {tuple(s.shape)} in [{s.min().item():.4f}, {s.max().item():.4f}]; forwards {calls}; flash launches {fa.FLASH_FWD.launches}, plain-route calls {plain[0]}")
        check(calls == want, f"{tag} sampling forwards {calls}, expected {want}")
        check(fa.FLASH_FWD.launches == UNET_BLOCKS_A_TAIL * n and plain[0] == UNET_BLOCKS_A_TAIL * n,
              f"{tag} sampling launches {fa.FLASH_FWD.launches}, plain calls {plain[0]}")
        check(s.shape == (32, 32, 32, 3) and bool(torch.isfinite(s).all()) and s.abs().max().item() <= 1.0,
              f"{tag} samples {tuple(s.shape)}")
        check(len(saved) == 1, f"{tag} the plot function did not run")
        out["sample"] = {"launches": fa.FLASH_FWD.launches, "seconds": seconds}
    check_covered(fa, seen, tag)
    return out


# phase 31: the JAX package's Orbax checkpoint of a narrow CheXpert DiT
# (tools/make_orbax_fixture.py), committed under tests/data/orbax_dit
ORBAX_FIXTURE = os.path.join(REPO, "tests", "data", "orbax_dit")
ORBAX_DECODE_REPS = 20  # passes over the fixture's chunks when the decoder's rate is timed
# fp32 on both sides, differing in summation order: the DiT parity tests'
# atol/rtol 1e-4 (tests/test_torch_dit.py); bf16 against JAX's fp32: their
# relative L2 2e-2
ORBAX_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": 2e-2}


def orbax_eval_rows(ref):
    """``tools/make_orbax_fixture.py``'s 16 rows (image, class, logSNR index) and their inputs, from its seed."""
    import numpy as np

    rng = np.random.default_rng(ref["eval_seed"])
    images = rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
    noise = rng.standard_normal((2, len(ref["logsnr"]), 128, 128, 12)).astype(np.float32)
    rows = [(i, c, k) for i in range(2) for c in range(ref["dit"]["num_classes"])
            for k in range(len(ref["logsnr"]))]
    return images, noise, rows


def orbax_errors(engine, ref):
    """The EMA denoiser's ε-prediction MSE per (image, class, logSNR) row, on the card."""
    from diffusion_classifier_tpu_torch.diffusion.process import pred_to_eps
    from diffusion_classifier_tpu_torch.diffusion.schedule import alpha_sigma
    from diffusion_classifier_tpu_torch.ops.wavelet import haar_dwt2

    images, noise, rows = orbax_eval_rows(ref)
    x0 = haar_dwt2(torch.from_numpy(images).cuda()) / 2.0  # the engine's DWT
    lam = torch.tensor([ref["logsnr"][k] for _, _, k in rows], device="cuda")
    alpha, sigma = alpha_sigma(lam)
    x = torch.stack([x0[i] for i, _, _ in rows])
    eps = torch.stack([torch.from_numpy(noise[i, k]) for i, _, k in rows]).cuda()
    z = alpha[:, None, None, None] * x + sigma[:, None, None, None] * eps
    labels = torch.tensor([c for _, c, _ in rows], device="cuda")
    with torch.no_grad():
        pred = engine.state.ema_model(z, lam, labels).float()
    eps_hat = pred_to_eps(pred, z, alpha, sigma, ref["pred_param"])
    return ((eps_hat - eps) ** 2).mean(dim=(1, 2, 3)).double().cpu()


def phase_orbax(fa, config_cls):
    """Phase 31: a JAX-written Orbax checkpoint read with the port's own decoders, served on the card."""
    import hashlib

    import numpy as np

    from diffusion_classifier_tpu_torch.engine import DiffusionClassifier
    from diffusion_classifier_tpu_torch.experiments.chexpert_dit import build_data
    from diffusion_classifier_tpu_torch.models.dit import DiT, DiTConfig
    from diffusion_classifier_tpu_torch.utils import orbax_reader, zstd

    tag = "[31 orbax]"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    with open(os.path.join(ORBAX_FIXTURE, "reference.json")) as f:
        ref = json.load(f)
    build = time.perf_counter()
    zstd.decompress(bytes.fromhex("28b52ffd2000010000"))  # g++ builds the decoder at first use
    build = time.perf_counter() - build
    # 1. every leaf decoded and held to the sha256 of Orbax's restore
    state_dir = orbax_reader.resolve_state_dir(os.path.join(ORBAX_FIXTURE, "checkpoints"))
    start = time.perf_counter()
    with orbax_reader.OrbaxCheckpoint(state_dir) as ckpt:
        leaves = {name: ckpt.read_array(name) for name in filter(None, ckpt.leaves.values())}
        stored = ckpt.store.bytes_read
        frames = [bytes(ckpt.store.read(k)) for k in ckpt.store.keys() if not k.endswith(".zarray")]
    read_s = time.perf_counter() - start
    decoded = sum(t.numel() * t.element_size() for t in leaves.values())
    digests = {name: hashlib.sha256((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
               .hexdigest() for name, t in leaves.items()}
    bad = sorted(n for n in ref["leaves"] if digests.get(n) != ref["leaves"][n])
    check(not bad and set(digests) == set(ref["leaves"]), f"{tag} leaves that differ from Orbax's restore: {bad}")
    # 2. the decoder alone over the fixture's chunk frames
    outs = [np.empty(len(zstd.decompress(fr)), np.uint8) for fr in frames]
    start = time.perf_counter()
    for _ in range(ORBAX_DECODE_REPS):
        for fr, out in zip(frames, outs):
            zstd.decompress_into(fr, out)
    decode_s = time.perf_counter() - start
    out_bytes = ORBAX_DECODE_REPS * sum(o.nbytes for o in outs)
    mb_s = out_bytes / decode_s / 1e6
    print(f"{tag} {smi}: {len(leaves)} leaves, {decoded} bytes decoded from {stored} stored, read in {read_s * 1e3:.1f} ms wall (open, B-tree walk, decode); zstd decoder {mb_s:.1f} MB/s of output on the host over {len(frames)} chunk frames x {ORBAX_DECODE_REPS}; g++ build {build:.1f} s; every sha256 equals Orbax's")
    # 3. the engine on the card: load_checkpoint -> inference, then the 16 errors, per dtype
    result = {"leaves": len(leaves), "stored_bytes": stored, "decoded_bytes": decoded, "read_ms": read_s * 1e3,
              "zstd_mb_s": mb_s, "card": smi, "launches": 0}
    want = torch.tensor(np.asarray(ref["errors"], np.float64).reshape(-1))
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        config = config_cls.from_dict(dict(
            ref["config"], mixed_precision="no" if dtype == torch.float32 else "bf16", batch_size=4,
            evaluation_per_stage=[4], evaluation_batches=1, project_root=os.path.dirname(ORBAX_FIXTURE),
            experiment_dir=os.path.basename(ORBAX_FIXTURE)))
        engine = DiffusionClassifier(DiT(DiTConfig(**ref["dit"]), dtype=dtype), config, device="cuda")
        reset_counts(fa)
        with kernel_shapes(fa) as seen:
            val_samples, _ = engine.inference(build_data(config).get_test_loader(), classification=True)
            got = orbax_errors(engine, ref)
        torch.cuda.synchronize()
        launches = fa.FLASH_FWD.launches
        check(launches > 0, f"{tag} {name}: no flash forward launch serving the JAX checkpoint")
        check(engine.state.step == 0, f"{tag} inference read the train state (step {engine.state.step})")
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape, f"{tag} {name} errors {got}")
        if dtype == torch.float32:
            err = (got - want).abs().max().item()
            print(f"{tag} {name}: {launches} flash forward launches (inference + 16 errors); max |port - JAX| of the 16 errors {err:.3e} (atol/rtol 1e-4); errors {[round(e, 6) for e in got.tolist()]}")
            torch.testing.assert_close(got, want, **ORBAX_TOL[name])
        else:
            rel = ((got - want).norm() / want.norm()).item()
            print(f"{tag} {name}: {launches} flash forward launches; relative L2 of the 16 errors vs JAX's fp32 {rel:.3e} (limit 2e-2)")
            check(rel < ORBAX_TOL[name], f"{tag} bf16 errors {rel:.3e} from JAX's")
        result["launches"] += launches
        result[f"{name}_launches"] = launches
        # the kernel at every shape this path gave it, against its plain version
        gen = torch.Generator(device="cuda").manual_seed(31)
        for shape, dt in sorted(seen[fa.FLASH_FWD.name], key=str):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt) for _ in range(3))
            out = fa.FLASH_FWD(q, k, v)
            torch.testing.assert_close(out, fa.flash_attention_reference(q, k, v), **TOL[dt])
            print(f"{tag} kernel at {shape} {str(dt)[6:]}: held to the plain version (atol/rtol {TOL[dt]['atol']})")
        del engine, val_samples
    return result


def worker_main(kind, workdir):
    """``chip_smoke.py --worker kind workdir``: one rank of phases 25-27 and 29."""
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from diffusion_classifier_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    device = init_distributed(device="cuda:0", backend=inputs["backend"])
    rank = dist.get_rank()
    if kind == "preempt":
        preempt_worker(inputs, rank)
    else:
        outs = []
        for cfg in inputs["configs"]:
            mesh = make_mesh(*inputs["mesh"], device_type="cuda") if inputs.get("mesh") else None
            outs.append(mp_run(kind, ExperimentConfig.from_dict(dict(cfg)), inputs, device, mesh))
        torch.save(outs, os.path.join(workdir, f"out{rank}.pt"))
    dist.destroy_process_group()
    return 0


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
    from diffusion_classifier_tpu_torch.experiments import chexpert_unet as cx_unet
    from diffusion_classifier_tpu_torch.experiments import cifar10 as cifar
    from diffusion_classifier_tpu_torch.experiments import ipmsa as ip
    from diffusion_classifier_tpu_torch.ops import flash_attention as fa
    from diffusion_classifier_tpu_torch.ops import group_norm as gn
    from diffusion_classifier_tpu_torch.ops import layer_norm as ln
    from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

    phase_device()
    sass = phase_build(fa)
    records = {"flash_attn_fwd": phase_kernel(fa), "flash_attn_bwd": phase_backward(fa)}
    ln_record = phase_layer_norm()
    gn_record = phase_group_norm()
    # the fused norms' launches on each path of this process, by phase
    ln_launches, gn_launches, norm_seen = {}, {}, [(ln.LAYER_NORM.launches, gn.GROUP_NORM.launches)]

    def norm_mark(path):
        ln_launches[path] = ln.LAYER_NORM.launches - norm_seen[-1][0]
        gn_launches[path] = gn.GROUP_NORM.launches - norm_seen[-1][1]
        norm_seen.append((ln.LAYER_NORM.launches, gn.GROUP_NORM.launches))

    config = ExperimentConfig.from_dict(dict(INFERENCE_CONFIG))
    phase_dit(fa, chexpert, config)
    norm_mark("dit_forward")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(REPO, "build"))
    try:
        classify_fwd = phase_entry_point(fa, chexpert, ExperimentConfig, workdir)
        norm_mark("dit_classify")
        phase_dit_grads(fa, chexpert, config)
        norm_mark("dit_grads")
        train_fwd, train_bwd = phase_train(fa, ExperimentConfig, workdir)
        norm_mark("dit_train")
        # every shape the UNets' no-grad forwards launch the GroupNorm kernel at (phases 10-18)
        with kernel_shapes(fa) as seen:
            records["flash_attn_fwd"]["shapes"] += phase_unet_kernel(fa)
            phase_unet_forward(fa, cifar, ExperimentConfig)
            norm_mark("unet_forward")
            unet_classify_fwd, unet_rates = phase_unet_classify(fa, cifar, ExperimentConfig, workdir)
            norm_mark("unet_classify")
            sample_fwd, sample_rates = phase_sampling(fa, cifar, chexpert, ExperimentConfig, workdir)
            norm_mark("sampling")
            records["flash_attn_bwd"]["shapes"] += phase_unet_backward(fa)
            phase_unet_grads(fa, cifar, ExperimentConfig)
            norm_mark("unet_grads")
            unet_train_fwd, unet_train_bwd, unet_train_rates = phase_unet_train(
                fa, cifar, ExperimentConfig, workdir
            )
            norm_mark("unet_train")
            trees = phase_trees(workdir)
            loader_rates = phase_loader(trees, workdir)
            held = {"18 cx-unet": released("[18 cx-unet]")}
            cx_attention = phase_cx_unet_forward(fa, cx_unet, ExperimentConfig)
            held["18 cx-unet train"] = released("[18 cx-unet train]")
            cx_train_rates, cx_train_launches = phase_cx_unet_train(fa, cx_unet, ExperimentConfig, trees, workdir)
            held["18 cx-unet classify"] = released("[18 cx-unet classify]")
            cx_classify_rates, cx_ood = phase_cx_unet_classify(fa, cx_unet, ExperimentConfig, trees, workdir)
            norm_mark("chexpert_unet")
        check_covered(fa, {gn.GROUP_NORM.name: seen[gn.GROUP_NORM.name]}, "[10-18 unet]")
        held["19 dit tree"] = released("[19 dit tree]")
        dit_tree = phase_cx_dit_tree(fa, ExperimentConfig, trees, workdir)
        norm_mark("dit_tree")
        ip_tree = phase_ipmsa_trees(workdir)
        ip_loader = phase_ipmsa_loader(ip_tree, workdir)
        held["22 ipmsa"] = released("[22 ipmsa]")
        with kernel_shapes(fa) as seen:
            ip_fwd, ip_bwd, ip_plain = phase_ipmsa_kernels(fa)
            records["flash_attn_fwd"]["shapes"].append(ip_fwd)
            records["flash_attn_bwd"]["shapes"].append(ip_bwd)
            ip_forward = phase_ipmsa_unet_forward(fa, ip, ExperimentConfig)
            held["22 ipmsa unet train"] = released("[22 ipmsa unet train]")
            ip_train_rates, ip_train = phase_ipmsa_unet_train(fa, ip, ExperimentConfig, ip_tree, workdir)
            held["22 ipmsa unet classify"] = released("[22 ipmsa unet classify]")
            ip_classify_rates, ip_explain, ip_classify = phase_ipmsa_unet_classify(
                fa, ip, ExperimentConfig, ip_tree, workdir)
            norm_mark("ipmsa_unet")
        check_covered(fa, seen, "[22 ipmsa]")
        held["23 ipmsa dit"] = released("[23 ipmsa dit]")
        with kernel_shapes(fa) as seen:
            ip_dit = phase_ipmsa_dit(fa, ExperimentConfig, ip_tree, workdir)
            norm_mark("ipmsa_dit")
        check_covered(fa, seen, "[23 ipmsa dit]")
        held["24 resnet"] = released("[24 resnet]")
        ip_resnet = phase_ipmsa_resnet(fa, ExperimentConfig, ip_tree, workdir)
        held["25 ddp"] = released("[25 ddp] before the one-process run")
        mp_dit = phase_mp_dit(fa, ExperimentConfig, workdir)
        held["27 tp"] = released("[27 tp] before the one-process run")
        mp_tp = phase_mp_tp(fa, ExperimentConfig, workdir)
        held["28 entry"] = released("[28 entry]")
        mp_entry = phase_mp_entry(fa, ExperimentConfig, trees, ip_tree, workdir)
        held["29 preempt"] = released("[29 preempt]")
        mp_preempt = phase_mp_preempt(fa, workdir)
        norm_mark("multi_process_parent")
        held["30 t5"] = released("[30 t5]")
        t5 = phase_t5(fa, cifar, ExperimentConfig, workdir)
        norm_mark("t5")
        held["31 orbax"] = released("[31 orbax]")
        orbax = phase_orbax(fa, ExperimentConfig)
        norm_mark("orbax")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"[layer_norm] launches by path: {ln_launches}; copies {ln.LAYER_NORM.copies}")
    check(ln.LAYER_NORM.copies == 0, f"the paths copied {ln.LAYER_NORM.copies} inputs of layer_norm")
    check(ln_launches["dit_classify"] > 0 and ln_launches["unet_classify"] > 0,
          f"a classify path never launched layer_norm: {ln_launches}")
    print(f"[group_norm] launches by path: {gn_launches}; copies {gn.GROUP_NORM.copies}")
    check(gn.GROUP_NORM.copies == 0, f"the paths copied {gn.GROUP_NORM.copies} inputs of group_norm")
    check(all(gn_launches[p] > 0 for p in ("unet_forward", "unet_classify", "sampling", "chexpert_unet", "ipmsa_unet"))
          and gn_launches["unet_grads"] == 0 and gn_launches["dit_classify"] == 0,
          f"group_norm launched off the UNets' no-grad paths, or not on one: {gn_launches}")
    check("jax" not in sys.modules, "jax was imported")
    stray = loaded_from_jax_package()
    check(not stray, f"modules loaded from the JAX package: {stray}")

    launches = {
        "flash_attn_fwd": {
            "classify": classify_fwd, "train": train_fwd, "unet_classify": unet_classify_fwd,
            "unet_sample": sample_fwd["cifar10"], "dit_sample": sample_fwd["chexpert-dit"],
            "unet_train": unet_train_fwd, "dit_tree_train": dit_tree["train"][0],
            "dit_tree_classify": dit_tree["classify"], "dit_tree_ood": dit_tree["ood"],
            "chexpert_unet": cx_train_launches[0], "ipmsa_unet_train": ip_train[0],
            "ipmsa_unet_classify": ip_classify, "ipmsa_explain": ip_explain["flash_launches"],
            "ipmsa_dit_train": ip_dit["train"][0], "ipmsa_dit_classify": ip_dit["classify"],
            "ddp_world2": mp_dit["launches"]["ddp"][0], "fsdp_world1": mp_dit["launches"]["fsdp"][0],
            "ddp_world1": mp_dit["launches"]["ddp_world1"][0], "tp_unet_world2": mp_tp["launches"]["tp"][0],
            "torchrun_dit_train": mp_entry["dit_train"][0], "torchrun_dit_classify": mp_entry["dit_classify"][0],
            "preempt_world2": mp_preempt["launches"][0],
            "t5_train": t5["train"]["launches"][0], "t5_classify": t5["classify"]["launches"],
            "t5_sample": t5["sample"]["launches"], "orbax_dit_inference": orbax["launches"],
        },
        "flash_attn_bwd": {
            "classify": 0, "train": train_bwd, "unet_train": unet_train_bwd,
            "dit_tree_train": dit_tree["train"][1], "chexpert_unet": cx_train_launches[1],
            "ipmsa_unet_train": ip_train[1], "ipmsa_dit_train": ip_dit["train"][1],
            "ddp_world2": mp_dit["launches"]["ddp"][1], "fsdp_world1": mp_dit["launches"]["fsdp"][1],
            "ddp_world1": mp_dit["launches"]["ddp_world1"][1], "tp_unet_world2": mp_tp["launches"]["tp"][1],
            "torchrun_dit_train": mp_entry["dit_train"][1], "torchrun_dit_classify": mp_entry["dit_classify"][1],
            "preempt_world2": mp_preempt["launches"][1],
            "t5_train": t5["train"]["launches"][1],
        },
    }
    print(json.dumps({"paths": {
        "unet_classify": unet_rates, "sample": sample_rates, "unet_train": unet_train_rates,
        "chexpert_loader": loader_rates,
        "chexpert_unet": {"plain_attention_calls_a_forward": cx_attention, "classify": cx_classify_rates,
                          "train_step": cx_train_rates, "ood": cx_ood},
        "chexpert_dit_tree_launches": dit_tree,
        "ipmsa_loader": ip_loader,
        "ipmsa_unet": {"plain_route_d96": ip_plain, "a_forward": ip_forward, "train_step": ip_train_rates,
                       "train_launches": ip_train, "classify": ip_classify_rates, "explain": ip_explain},
        "ipmsa_dit_launches": ip_dit,
        "ipmsa_resnet50": ip_resnet,
        "multi_process": {
            "worlds": {mode: {"world": w, "backend": b} for mode, (w, b) in MP_WORLD.items()},
            **{k: v for k, v in mp_dit.items() if k != "launches"},
            **{k: v for k, v in mp_tp.items() if k != "launches"},
            "preempt_saved_at_step": mp_preempt["saved_at"],
        },
        "t5_unet": {"train_step": t5["train"]["step"], "classify": t5["classify"],
                    "sample_seconds": t5["sample"]["seconds"]},
        "orbax_checkpoint": {k: v for k, v in orbax.items() if k != "launches"},
        "allocated_gb_before_phase": held,
    }}))
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
                "library_ratio", "call_ms", "library_call_ms", "host_us", "shapes")},
            **{op: {entry: n[op] for entry, n in sass[name].items()} for op in ("hgmma", "utmaldg")},
        }
        for name, (source, replaces) in KERNELS.items()
    ] + [{
        "name": "layer_norm",
        "route": "cuda",
        "source": "diffusion_classifier_tpu_torch/csrc/layer_norm.cu",
        "replaces": None,
        "launches": sum(ln_launches.values()),
        "launches_by_path": ln_launches,
        **{key: ln_record[key] for key in (
            "max_abs_err", "ms", "none_ms", "tb_per_s", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_ratio", "call_ms", "library_call_ms", "host_us", "shapes")},
        **{op: {entry: n[op] for entry, n in sass["layer_norm"].items()} for op in ("ldg128", "stg128")},
    }, {
        "name": "group_norm",
        "route": "cuda",
        "source": "diffusion_classifier_tpu_torch/csrc/group_norm.cu",
        "replaces": None,
        "launches": sum(gn_launches.values()),
        "launches_by_path": gn_launches,
        **{key: gn_record[key] for key in (
            "identical", "max_abs_err", "ms", "none_ms", "tb_per_s", "plain_ms", "plain_silu_ms", "bound_ms",
            "bound_by", "library_ms", "library_ratio", "call_ms", "library_call_ms", "host_us", "shapes")},
        **{op: {entry: n[op] for entry, n in sass["group_norm"].items()} for op in ("ldg128", "stg128")},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":  # one rank of phases 25-27, 29
        sys.exit(worker_main(*sys.argv[2:4]))
    if len(sys.argv) > 1 and sys.argv[1] == "--entry":  # phase 28, under torchrun
        sys.exit(entry_main(*sys.argv[2:5]))
    start = time.perf_counter()
    code = main()
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s", file=sys.stderr)
    sys.exit(code)
