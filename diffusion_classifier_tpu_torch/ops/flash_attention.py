"""Flash attention: the hand-written CUDA kernels, their plain versions, the autograd Function.

Port of ``diffusion_classifier_tpu/ops/flash_attention.py``. The TPU file has
two forward kernels, ``_flash_fused_heads`` (``:123``) and ``_flash_bh``
(``:154``), and a backward ``_flash_bwd`` (``:304``) in two layouts
(``_bwd_kernel_lanes`` ``:244`` and ``_bwd_kernel_bh`` ``:264``). Hopper needs
no layout split: one CUDA source per direction computes each for every shape
:func:`supports` admits.

- ``csrc/flash_attn_fwd.cu`` — the forward, online softmax over streamed K/V
  tiles; optionally also the fp32 row logsumexp the backward reads.
- ``csrc/flash_attn_bwd.cu`` — the backward, FA2-style: δ = rowsum(dO∘O),
  then one pass per K/V tile for dk/dv and one per q tile for dq, no atomics.

At the DiT's (16, 1024, 6, 64) both do hundreds of flops per byte moved,
above the H100's ~295 flop/byte bf16 ridge: they are compute-bound. bf16
runs on Hopper's tensor cores: warp-specialised blocks whose producer warp
loads tiles by TMA into a ring of shared-memory stages and whose consumer
warpgroups run ``wgmma`` (helpers and the host's tensor maps in
``csrc/flash_sm90.cuh``); fp32, which has no exact tensor-core product, runs
on scalar-FMA kernels (the sources say more).

- :func:`flash_attention_reference` / :func:`flash_attention_bwd_reference`
  — the plain PyTorch versions, op for op like ``_softmax_pv`` and
  ``_bwd_one_head``. CPU tensors take them, and the kernels are held to them
  on the card.
- :class:`FlashAttention` — the ``torch.autograd.Function``: the kernels on
  CUDA tensors, the plain versions on CPU tensors. :func:`flash_attention`
  goes through it. A CUDA tensor launches the kernel or raises; nothing
  falls back.
- ``FLASH_FWD`` / ``FLASH_BWD`` — the kernel objects (``kernel.CudaKernel``):
  each ``launches`` counts its wrapper's launches, and ``copies`` the bf16
  inputs it had to copy because no TMA tensor map can read them
  (:func:`_mappable`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .kernel import DTYPE_CODES, CudaKernel, aligned16, records_graph

__all__ = [
    "FLASH_BWD",
    "FLASH_FWD",
    "FlashAttention",
    "flash_attention",
    "flash_attention_bwd_reference",
    "flash_attention_reference",
    "supports",
]

_LOG2_E = 1.4426950408889634

#: head dims with a forward and a backward entry, in both dtypes
_DIMS = (32, 64, 128)
#: head dims with a bf16 forward entry alone (DiT-XL/2's 72, padded to 80 inside the kernel)
_FWD_ONLY_DIMS = (72,)


def supports(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """True if the kernels take these shapes: equal 4-D ``[B, S, H, D]``, D ∈ {32, 64, 128}.

    D = 72 is taken in bf16 where no autograd graph is recorded: the forward
    has an entry for it and the backward none, so a D = 72 attention that
    will be differentiated (or is fp32) stays on the plain route.

    The TPU gates also required ``S % 128 == 0`` and ``S ≤ 4096`` (forward),
    ``S ≤ 1024`` (backward); those came from Mosaic's (8, 128) tiling and
    the VMEM budget. The CUDA kernels mask their ragged last tiles and stream
    K/V, so they need none of them.
    """
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        return False
    d = q.shape[-1]
    if d in _FWD_ONLY_DIMS:
        return q.dtype == torch.bfloat16 and not records_graph(q, k, v)
    return d in _DIMS


def _mappable(x: torch.Tensor) -> bool:
    """True if the bf16 kernels can read ``x`` through a TMA tensor map.

    :func:`~.kernel.aligned16` over the batch, sequence and head strides,
    and those strides nonzero (a broadcast view has no tensor map). The
    q/k/v thirds of the DiT's fused qkv projection pass.
    """
    strides = x.stride()[:3]
    return aligned16(x, 3) and (0 not in strides or all(n == 1 for n, st in zip(x.shape, strides) if not st))


def _mapped(kernel: CudaKernel, *tensors: torch.Tensor) -> list:
    """The inputs, each bf16 one that fails :func:`_mappable` copied (and counted in ``kernel.copies``)."""
    return [kernel.copy(x) if x.dtype == torch.bfloat16 and not _mappable(x) else x for x in tensors]


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Non-causal attention over ``[B, S, H, D]`` in ``_softmax_pv``'s arithmetic.

    fp32 scores from upcast q (pre-scaled by ``log2(e)/√D``) and k; exp2
    against the row max; p rounded to ``v.dtype`` for the P·V product, which
    sums in fp32; ``1/l`` applied to the output; result in ``q.dtype``.
    """
    d = q.shape[-1]
    c = (1.0 / d**0.5) * _LOG2_E
    qf = (q.to(torch.float32) * c).transpose(1, 2)  # [B, H, S, D]
    kf = k.to(torch.float32).transpose(1, 2)
    s = qf @ kf.transpose(-1, -2)  # [B, H, S, S]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    # a product of two v.dtype values is exact in fp32: an fp32 matmul on
    # the rounded p is the TPU's bf16 MXU product with an fp32 accumulator
    pv = p.to(v.dtype).to(torch.float32)
    o = pv @ v.to(torch.float32).transpose(1, 2)
    return (o / l).transpose(1, 2).to(q.dtype)


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    o: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of attention over ``[B, S, H, D]`` in ``_bwd_one_head``'s arithmetic.

    p is recomputed from fp32 scores (q upcast and scaled by ``log2(e)/√D``,
    exp2, normalised); ``dv = (p rounded to do.dtype)ᵀ·dO`` and ``dp = dO·vᵀ``
    sum in fp32; ``ds = p∘(dp − δ)`` is rounded to ``q.dtype`` before
    ``dq = scale·ds·k`` and ``dk = scale·dsᵀ·q``; outputs in the input dtype.

    δ is ``rowsum(dO∘O)`` from the forward output ``o`` (computed here when
    not given), the form the CUDA kernel uses. It equals the TPU kernel's
    ``rowsum(p∘dp)`` in exact arithmetic; in bf16 ``o`` is rounded, which
    moves δ by about one bf16 ulp of ``|O|·|dO|``.
    """
    d = q.shape[-1]
    scale = 1.0 / d**0.5
    if o is None:
        o = flash_attention_reference(q, k, v)
    qf, kf, vf, dof, of = (
        x.to(torch.float32).transpose(1, 2) for x in (q, k, v, do, o)
    )  # [B, H, S, D]
    s = (qf * (scale * _LOG2_E)) @ kf.transpose(-1, -2)  # [B, H, S, S]
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    dv = p.to(do.dtype).to(torch.float32).transpose(-1, -2) @ dof
    dp = dof @ vf.transpose(-1, -2)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).to(torch.float32)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    return tuple(
        g.transpose(1, 2).to(x.dtype) for g, x in ((dq, q), (dk, k), (dv, v))
    )


def _check_inputs(tensors: dict, ref: torch.Tensor) -> None:
    for name, x in tensors.items():
        if x.device.type != "cuda" or x.device != ref.device:
            raise ValueError(f"{name} must be on q's CUDA device, got {x.device}")
        if x.dtype != ref.dtype or x.dtype not in DTYPE_CODES:
            raise ValueError(
                f"{name} dtype {x.dtype}: the tensors must share float32 or bfloat16"
            )
        if x.shape != ref.shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != q's {tuple(ref.shape)}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dim, strides {x.stride()}")


class FlashAttentionForward(CudaKernel):
    """The forward kernel; ``lse=True`` also returns the fp32 row logsumexp ``[B, H, S]``."""

    def __init__(self):
        super().__init__(
            "flash_attn_fwd",
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 5
            + [ctypes.c_int64] * 12
            + [ctypes.c_float, ctypes.c_void_p],
        )

    def __call__(self, q, k, v, *, lse: bool = False):
        """Launch on CUDA tensors ``[B, S, H, D]``; raises on anything the kernel does not take."""
        _check_inputs({"q": q, "k": k, "v": v}, q)
        if not supports(q, k, v):
            raise ValueError(
                f"unsupported shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                f"v{tuple(v.shape)}: need equal [B, S, H, D] with D in 32/64/128, "
                "or 72 in bf16 without a graph"
            )
        q, k, v = _mapped(self, q, k, v)
        b, s, h, d = q.shape
        out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
        stats = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if lse else None
        self.launch(
            q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            stats.data_ptr() if lse else None,
            DTYPE_CODES[q.dtype], b, s, h, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            (1.0 / math.sqrt(d)) * _LOG2_E,
        )
        return (out, stats) if lse else out


class FlashAttentionBackward(CudaKernel):
    """The backward kernel: ``(dq, dk, dv)`` from q, k, v, the output, its gradient and the lse."""

    def __init__(self):
        super().__init__(
            "flash_attn_bwd",
            [ctypes.c_void_p] * 10
            + [ctypes.c_int] * 5
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
        )

    def __call__(self, q, k, v, o, do, lse):
        """Launch on CUDA tensors ``[B, S, H, D]`` and ``lse [B, H, S]`` fp32; raises on bad input."""
        _check_inputs({"q": q, "k": k, "v": v, "o": o, "do": do}, q)
        if not supports(q, k, v) or q.shape[-1] not in _DIMS:
            raise ValueError(
                f"unsupported shapes q{tuple(q.shape)}: need [B, S, H, D] with D in 32/64/128"
            )
        b, s, h, d = q.shape
        if (
            lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (b, h, s) or not lse.is_contiguous()
        ):
            raise ValueError(
                f"lse must be a contiguous float32 [{b}, {h}, {s}] on {q.device}, got "
                f"{lse.dtype} {tuple(lse.shape)} on {lse.device}"
            )
        q, k, v, o, do = _mapped(self, q, k, v, o, do)
        grads = [torch.empty_like(x, memory_format=torch.contiguous_format) for x in (q, k, v)]
        delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        strides = (ctypes.c_int64 * 24)(
            *(st for x in (q, k, v, o, do, *grads) for st in x.stride()[:3])
        )
        self.launch(
            q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(g.data_ptr() for g in grads),
            DTYPE_CODES[q.dtype], b, s, h, d, strides,
            1.0 / math.sqrt(d), (1.0 / math.sqrt(d)) * _LOG2_E,
        )
        return tuple(grads)


FLASH_FWD = FlashAttentionForward()
FLASH_BWD = FlashAttentionBackward()


class FlashAttention(torch.autograd.Function):
    """Attention whose forward and backward are the CUDA kernels on CUDA tensors.

    CPU tensors take the two plain versions, so the CPU tests hold the
    backward's arithmetic against JAX. The forward saves q, k, v, its output
    and (on CUDA, when a gradient is needed) the row logsumexp; the
    backward returns one gradient per input, and autograd sums them into a
    fused qkv tensor whose thirds q, k, v were.
    """

    @staticmethod
    def forward(ctx, q, k, v):
        lse = None
        if q.device.type == "cpu":
            out = flash_attention_reference(q, k, v)
        elif any(ctx.needs_input_grad):
            out, lse = FLASH_FWD(q, k, v, lse=True)
        else:
            out = FLASH_FWD(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            return flash_attention_bwd_reference(q, k, v, do, out)
        if do.stride(-1) != 1:
            do = do.contiguous()
        return FLASH_BWD(q, k, v, out, do, lse)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable non-causal attention over ``[B, S, H, D]``; returns ``q.dtype``.

    CPU tensors take the plain versions; CUDA tensors launch the kernels or
    raise.
    """
    return FlashAttention.apply(q, k, v)
