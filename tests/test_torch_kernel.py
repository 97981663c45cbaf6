"""The kernels' one home: the native build path (``utils/native.py``) and the kernel object (``ops/kernel.py``).

CPU tests of what surrounds every hand-written kernel: the hashed library
path of both compilers, the 16-byte alignment test, the flash wrappers'
counted copies, the launch error and an import that needs no nvcc. This
file imports neither jax nor the JAX package, so the card's machine runs it
without ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel.py
"""

import os
import subprocess
import sys

import pytest
import torch

from diffusion_classifier_tpu_torch.ops import flash_attention as fa
from diffusion_classifier_tpu_torch.ops import kernel
from diffusion_classifier_tpu_torch.utils import native

torch.set_num_threads(1)


def test_aligned16_passes_the_qkv_thirds_and_fails_an_offset_view():
    b, s, h, d = 2, 16, 2, 64
    qkv = torch.zeros((b, s, 3 * h * d), dtype=torch.bfloat16)
    assert all(kernel.aligned16(x.view(b, s, h, d), 3) for x in qkv.split(h * d, dim=-1))
    assert not kernel.aligned16(qkv[..., 1 : 1 + h * d].view(b, s, h, d), 3)  # 2 bytes off
    assert not kernel.aligned16(qkv[:, :, : h * d - 8].unflatten(-1, (h, d - 4)), 3)  # head stride 60
    assert kernel.aligned16(qkv[:1, :1, : h * d].reshape(1, 1, h, d), 3)


def test_aligned16_passes_a_broadcast_view_which_mappable_refuses():
    # a stride of 0 is a multiple of 16, but TMA maps need real strides: flash's own rule refuses it
    b, s, h, d = 2, 16, 2, 64
    k = torch.zeros((b, 1, h, d), dtype=torch.bfloat16)
    assert kernel.aligned16(k.expand(b, s, h, d), 3)
    assert fa._mappable(k) and not fa._mappable(k.expand(b, s, h, d))
    fwd = kernel.CudaKernel("flash_attn_fwd", [])
    (out,) = fa._mapped(fwd, k.expand(b, s, h, d))
    assert fwd.copies == 1 and fa._mappable(out) and out.stride()[1] == h * d


def test_launch_error_tells_an_encode_from_a_launch():
    encode = kernel.launch_error("flash_attn_fwd", kernel.ENCODE_ERROR + 1)  # CUDA_ERROR_INVALID_VALUE
    assert encode == "flash_attn_fwd: cuTensorMapEncodeTiled failed with CUresult 1"
    assert kernel.launch_error("flash_attn_bwd", 9) == "flash_attn_bwd launch failed: cudaError 9"


# each compiler hashes the headers of its own kind beside the source
@pytest.mark.parametrize("source,header,root", [
    ("flash_attn_fwd.cu", "flash_sm90.cuh", "torch_kernels"),
    ("zstd_dec.cpp", "zstd_dec.h", "torch_native"),
], ids=["nvcc", "g++"])
def test_library_path_hashes_the_shared_header(tmp_path, source, header, root):
    (tmp_path / source).write_text("// source\n")
    (tmp_path / header).write_text("// helpers\n")
    lib = native.Library(str(tmp_path / source), "decoder")
    first = lib.path()
    assert first == lib.path()
    assert first.split(os.sep)[-3::2] == [root, "libdecoder.so"]  # <root>/<hash>/lib<name>.so
    (tmp_path / header).write_text("// helpers, edited\n")
    assert lib.path() != first  # an edited header rebuilds


def test_wrapper_copies_and_counts_only_unaligned_bf16_inputs():
    fwd = kernel.CudaKernel("flash_attn_fwd", [])
    b, s, h, d = 2, 16, 2, 64
    qkv = torch.randn((b, s, 3 * h * d + 1)).to(torch.bfloat16)
    third = qkv[..., : h * d].view(b, s, h, d)  # row stride 385: unaligned
    aligned = torch.zeros((b, s, h, d), dtype=torch.bfloat16)
    fp32 = third.float()[:, :, :, 1:]  # fp32 never takes the aligned path
    out = fa._mapped(fwd, third, aligned, fp32)
    assert fwd.copies == 1
    assert out[0] is not third and fa._mappable(out[0]) and torch.equal(out[0], third)
    assert out[1] is aligned and out[2] is fp32


def test_kernel_module_imports_without_nvcc():
    code = (
        "import os, sys; os.environ['PATH'] = ''; os.environ.pop('CUDA_HOME', None); "
        "import diffusion_classifier_tpu_torch.ops.flash_attention as fa; "
        "import diffusion_classifier_tpu_torch.ops.group_norm as gn; "
        "import diffusion_classifier_tpu_torch.ops.layer_norm as ln; "
        "kernels = (fa.FLASH_FWD, fa.FLASH_BWD, ln.LAYER_NORM, gn.GROUP_NORM); "
        "assert all(k._lib is None and k.launches == 0 and k.copies == 0 for k in kernels); "
        "assert 'jax' not in sys.modules"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.dirname(fa.__file__))),
    )
    assert proc.returncode == 0, proc.stderr
