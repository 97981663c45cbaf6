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
- ``FLASH_FWD`` / ``FLASH_BWD`` — the kernel objects: each built at first use
  with ``nvcc`` (``-gencode arch=compute_90a,code=sm_90a``) into
  ``build/torch_kernels/<source hash>/``, loaded with ``ctypes``; each
  ``launches`` counts its wrapper's launches, and ``copies`` the bf16 inputs
  it had to copy because they failed :func:`_aligned16`. :func:`build_all`
  compiles both at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import time

import torch

__all__ = [
    "FLASH_BWD",
    "FLASH_FWD",
    "FlashAttention",
    "build_all",
    "flash_attention",
    "flash_attention_bwd_reference",
    "flash_attention_reference",
    "supports",
]

_LOG2_E = 1.4426950408889634
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# a C entry point's return at or above this is a tensor-map encode that
# failed: this plus its CUresult (``kEncodeError`` in csrc/flash_sm90.cuh)
_ENCODE_ERROR = 100000


#: head dims with a forward and a backward entry, in both dtypes
_DIMS = (32, 64, 128)
#: head dims with a bf16 forward entry alone (DiT-XL/2's 72, padded to 80 inside the kernel)
_FWD_ONLY_DIMS = (72,)


def _records_graph(*tensors: "torch.Tensor | None") -> bool:
    """True if autograd records a graph through any of ``tensors`` (None entries aside)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


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
        return q.dtype == torch.bfloat16 and not _records_graph(q, k, v)
    return d in _DIMS


def _aligned16(x: torch.Tensor) -> bool:
    """True if the bf16 kernels can read ``x`` through a TMA tensor map.

    The base address and every batch, sequence and head stride (in bytes)
    must be multiples of 16, and those strides nonzero (a broadcast view has
    no tensor map); the stride of a dimension of size 1 is never used. The
    q/k/v thirds of the DiT's fused qkv projection pass.
    """
    if x.data_ptr() % 16:
        return False
    return all(
        size == 1 or (stride != 0 and (stride * x.element_size()) % 16 == 0)
        for size, stride in zip(x.shape[:3], x.stride()[:3])
    )


def _launch_error(name: str, code: int) -> str:
    """The message for a C entry point's nonzero return: a launch's ``cudaError_t`` or an encode's ``CUresult``."""
    if code >= _ENCODE_ERROR:
        return f"{name}: cuTensorMapEncodeTiled failed with CUresult {code - _ENCODE_ERROR}"
    return f"{name} launch failed: cudaError {code}"


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


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "flash-attention kernels are built from source at first use"
    )


class CudaKernel:
    """One ``csrc/<name>.cu``: built at first use into a ``ctypes`` library, launches counted."""

    def __init__(self, name: str, argtypes: list):
        self.name = name
        self.source = os.path.join(_PKG_DIR, "csrc", f"{name}.cu")
        self.launches = 0
        self.copies = 0
        self.build_log = ""
        self._argtypes = argtypes
        self._lib = None

    def library_path(self) -> str:
        """``build/torch_kernels/<hash>/lib<name>.so``, hashed over the source, the headers and the flags."""
        digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
        csrc = os.path.dirname(self.source)
        headers = sorted(n for n in os.listdir(csrc) if n.endswith(".cuh"))
        for path in (self.source, *(os.path.join(csrc, n) for n in headers)):
            with open(path, "rb") as f:
                digest.update(f.read())
        return os.path.join(BUILD_ROOT, digest.hexdigest()[:16], f"lib{self.name}.so")

    def _aligned(self, *tensors: torch.Tensor) -> list:
        """The inputs, each bf16 one that fails :func:`_aligned16` copied (and counted)."""
        out = []
        for x in tensors:
            if x.dtype == torch.bfloat16 and not _aligned16(x):
                x = torch.empty_like(x, memory_format=torch.contiguous_format).copy_(x)
                self.copies += 1
            out.append(x)
        return out

    def _compile(self):
        """Start ``nvcc`` unless this source is built; returns ``(process, tmp_path)`` or None."""
        if self._lib is not None:
            return None
        path = self.library_path()
        if os.path.isfile(path):
            return None
        nvcc = _nvcc()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, "-o", tmp, self.source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        return proc, tmp

    def _finish(self, job) -> None:
        """Wait for ``job`` (from :meth:`_compile`), then load the library."""
        if job is not None:
            proc, tmp = job
            self.build_log, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {self.source} ({proc.returncode}):\n{self.build_log}"
                )
            os.replace(tmp, self.library_path())  # atomic: a concurrent build wins or loses whole
        if self._lib is None:
            lib = ctypes.CDLL(self.library_path())
            fn = getattr(lib, self.name)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._lib = lib

    def build(self) -> float:
        """Compile (unless a build of this source exists) and load; returns seconds spent."""
        return 0.0 if self._lib is not None else build_all(self)

    def _launch(self, *args) -> None:
        err = getattr(self._lib, self.name)(*args)
        if err != 0:
            raise RuntimeError(_launch_error(self.name, err))
        self.launches += 1


def build_all(*kernels: CudaKernel) -> float:
    """Build the kernels with one ``nvcc`` each, all started together; returns seconds spent."""
    start = time.perf_counter()
    jobs = []
    try:
        for kernel in kernels:
            jobs.append(kernel._compile())
        for kernel, job in zip(kernels, jobs):
            kernel._finish(job)
    finally:  # after a failure, stop the other compilers and drop their partial files
        for job in jobs:
            if job is not None:
                proc, tmp = job
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.remove(tmp)
    return time.perf_counter() - start


def _check_inputs(tensors: dict, ref: torch.Tensor) -> None:
    for name, x in tensors.items():
        if x.device.type != "cuda" or x.device != ref.device:
            raise ValueError(f"{name} must be on q's CUDA device, got {x.device}")
        if x.dtype != ref.dtype or x.dtype not in _DTYPE_CODES:
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
        self.build()
        q, k, v = self._aligned(q, k, v)
        b, s, h, d = q.shape
        out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
        stats = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if lse else None
        with torch.cuda.device(q.device):
            self._launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                stats.data_ptr() if lse else None,
                _DTYPE_CODES[q.dtype], b, s, h, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3],
                (1.0 / math.sqrt(d)) * _LOG2_E,
                torch.cuda.current_stream().cuda_stream,
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
        self.build()
        q, k, v, o, do = self._aligned(q, k, v, o, do)
        grads = [torch.empty_like(x, memory_format=torch.contiguous_format) for x in (q, k, v)]
        delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        strides = (ctypes.c_int64 * 24)(
            *(st for x in (q, k, v, o, do, *grads) for st in x.stride()[:3])
        )
        with torch.cuda.device(q.device):
            self._launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), *(g.data_ptr() for g in grads),
                _DTYPE_CODES[q.dtype], b, s, h, d, strides,
                1.0 / math.sqrt(d), (1.0 / math.sqrt(d)) * _LOG2_E,
                torch.cuda.current_stream().cuda_stream,
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
