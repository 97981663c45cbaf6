"""The CUDA flash-attention kernels on the card, against their plain PyTorch versions.

Every test here is marked ``gpu`` and skips without a CUDA device: the
kernels have no CPU mode. This file imports neither jax nor the JAX package,
so the machine with the card runs it without ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import math

import pytest
import torch

from diffusion_classifier_tpu_torch.ops import flash_attention as fa
from diffusion_classifier_tpu_torch.ops.attention import attention, dot_product_attention

pytestmark = pytest.mark.gpu

# fp32: the JAX suite's flash tolerance (tests/test_ops.py:66-68); bf16: one
# bf16 ulp of an O(1) output
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-3), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# ragged last tiles and odd sequences on the tensor-core (bf16) kernels, at
# every head dim: chip_smoke.py phases 3 and 6
BF16_RAGGED = [
    ((2, 200, 2, 64), torch.bfloat16),
    ((1, 65, 1, 128), torch.bfloat16),
    ((3, 77, 2, 32), torch.bfloat16),
]
# the UNet's training shapes (chip_smoke.py phase 13): 64 tokens x D=32 and
# 16 tokens x D=64 at B=64; S=16 is shorter than one of the bf16 backward's
# 32-row streamed tiles and than its two 16-row bands a warp
UNET_BWD = [(64, 64, 8, 32), (64, 16, 8, 64)]
# the backward's shapes: chip_smoke.py phases 6 and 13, and a ragged
# sequence shorter than 16 rows on the tensor cores
BWD_CASES = [
    ((16, 1024, 6, 64), torch.bfloat16),
    ((2, 1024, 6, 64), torch.float32),
    ((1, 512, 3, 128), torch.bfloat16),
    ((2, 200, 2, 32), torch.float32),  # ragged last tiles
    *BF16_RAGGED,
    *((shape, dtype) for shape in UNET_BWD for dtype in (torch.bfloat16, torch.float32)),
    ((3, 9, 2, 64), torch.bfloat16),
    ((2, 256, 8, 64), torch.bfloat16),  # the IPMSA UNet's level 3: 16 x 16 tokens, 8 heads x 64
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _strided_qkv(shape, dtype, gen):
    b, s, h, d = shape
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(dtype)
    return [x.view(b, s, h, d) for x in qkv.split(h * d, dim=-1)]


@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((2, 1024, 6, 64), torch.bfloat16),
        ((2, 1024, 6, 64), torch.float32),
        ((1, 512, 3, 128), torch.bfloat16),
        ((2, 200, 2, 32), torch.float32),
        ((1, 65, 1, 128), torch.float32),
        ((2, 256, 4, 32), torch.bfloat16),
        ((64, 64, 6, 64), torch.bfloat16),  # the DiT's OOD classify at 64 px
        ((2, 256, 8, 64), torch.bfloat16),  # the IPMSA UNet's level 3
        *BF16_RAGGED,
    ],
)
def test_kernel_matches_plain_version(cuda, shape, dtype):
    q, k, v = _strided_qkv(shape, dtype, cuda)
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got, fa.flash_attention_reference(q, k, v), **TOL[dtype])


# the UNet's short sequences (16 tokens: shorter than one 64-row K/V tile,
# and most q warps without a row; 64 tokens at D=32: one tile), with q, k, v
# separate projections as the UNet's to_q/to_k/to_v give them
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 16, 8, 64), (2, 64, 8, 32), (3, 16, 2, 32)])
def test_kernel_matches_plain_version_at_unet_shapes(cuda, shape, dtype):
    q, k, v = (torch.randn(shape, generator=cuda, device="cuda").to(dtype) for _ in range(3))
    before = fa.FLASH_FWD.launches, fa.FLASH_FWD.copies
    got = attention(q, k, v, backend="auto")
    torch.cuda.synchronize()
    assert (fa.FLASH_FWD.launches - before[0], fa.FLASH_FWD.copies - before[1]) == (1, 0)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got, fa.flash_attention_reference(q, k, v), **TOL[dtype])


@pytest.mark.parametrize("shape,dtype", BWD_CASES[1:])
def test_forward_lse_is_the_row_logsumexp_in_log2(cuda, shape, dtype):
    q, k, v = _strided_qkv(shape, dtype, cuda)
    out, lse = fa.FLASH_FWD(q, k, v, lse=True)
    torch.testing.assert_close(out, fa.FLASH_FWD(q, k, v), rtol=0, atol=0)
    c = math.log2(math.e) / math.sqrt(shape[-1])
    s = (q.float() * c).transpose(1, 2) @ k.float().transpose(1, 2).transpose(-1, -2)
    want = torch.logsumexp(s * math.log(2.0), dim=-1) / math.log(2.0)
    assert lse.shape == (shape[0], shape[2], shape[1]) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("shape,dtype", BWD_CASES)
def test_backward_kernel_matches_plain_version(cuda, shape, dtype):
    q, k, v = _strided_qkv(shape, dtype, cuda)
    do = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    out, lse = fa.FLASH_FWD(q, k, v, lse=True)
    got = fa.FLASH_BWD(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(q, k, v, do, out)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == q.shape, name
        torch.testing.assert_close(g, w, **TOL[dtype], msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", UNET_BWD)
def test_backward_kernel_matches_plain_version_at_unet_shapes(cuda, shape, dtype):
    # separate q, k, v through the dispatcher, as the UNet's projections give them
    q, k, v = (torch.randn(shape, generator=cuda, device="cuda").to(dtype).requires_grad_() for _ in range(3))
    do = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    before = (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches, fa.FLASH_FWD.copies, fa.FLASH_BWD.copies)
    out = attention(q, k, v, backend="auto")
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    after = (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches, fa.FLASH_FWD.copies, fa.FLASH_BWD.copies)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 0, 0)
    want = fa.flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(), do, out.detach())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, **TOL[dtype], msg=lambda m: f"{name}: {m}")


def test_flagship_remat_launches_each_forward_twice_with_the_same_gradients(cuda):
    import dataclasses

    from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser
    from diffusion_classifier_tpu_torch.experiments.cifar10 import build_backbone
    from diffusion_classifier_tpu_torch.models.encoders import ClassEmbedder
    from diffusion_classifier_tpu_torch.models.layers import reset_parameters
    from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

    torch.backends.cudnn.allow_tf32 = False
    model = Denoiser(build_backbone(ExperimentConfig(mixed_precision="no")), ClassEmbedder(10, 128))
    reset_parameters(model, torch.Generator().manual_seed(0))
    model = model.cuda()
    x = torch.rand((4, 32, 32, 3), generator=cuda, device="cuda") * 2 - 1
    t, y = torch.randn((4,), generator=cuda, device="cuda"), torch.tensor([0, 3, 9, 10], device="cuda")
    grads = []
    for remat in (False, True):
        model.backbone.config = dataclasses.replace(model.backbone.config, remat=remat)
        model.zero_grad(set_to_none=True)
        before = (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches)
        model(x, t, y).square().mean().backward()
        torch.cuda.synchronize()
        # 11 attention blocks: each forward runs again in the backward under remat
        assert (fa.FLASH_FWD.launches - before[0], fa.FLASH_BWD.launches - before[1]) == (
            (22, 11) if remat else (11, 11)
        )
        grads.append(torch.cat([p.grad.flatten() for p in model.parameters()]))
    assert ((grads[1] - grads[0]).norm() / grads[0].norm()).item() <= 1e-6


@pytest.mark.parametrize("shape", [(2, 200, 2, 64), (16, 1024, 6, 64)])
def test_backward_kernel_is_deterministic(cuda, shape):
    q, k, v = _strided_qkv(shape, torch.bfloat16, cuda)
    do = torch.randn(q.shape, generator=cuda, device="cuda").to(q.dtype)
    out, lse = fa.FLASH_FWD(q, k, v, lse=True)
    first = fa.FLASH_BWD(q, k, v, out, do, lse)
    for a, b in zip(first, fa.FLASH_BWD(q, k, v, out, do, lse)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,dtype", [BWD_CASES[3], ((2, 256, 2, 64), torch.bfloat16)])
def test_function_gradients_match_plain_autograd(cuda, shape, dtype):
    b, s, h, d = shape
    qkv = torch.randn((b, s, 3 * h * d), generator=cuda, device="cuda").to(dtype)
    do = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_reference):
        x = qkv.clone().requires_grad_()
        q, k, v = (t.view(b, s, h, d) for t in x.split(h * d, dim=-1))
        before = (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches)
        fn(q, k, v).backward(do)
        launched = (fa.FLASH_FWD.launches - before[0], fa.FLASH_BWD.launches - before[1])
        assert launched == ((1, 1) if fn is fa.flash_attention else (0, 0))
        grads.append(x.grad)
    # the fused qkv tensor gets the three thirds' gradients side by side
    torch.testing.assert_close(grads[0], grads[1], **TOL[dtype])


def test_unaligned_bf16_view_is_copied_not_refused(cuda):
    b, s, h, d = 2, 200, 2, 64
    flat = torch.randn(b * s * h * d + 1, generator=cuda, device="cuda").to(torch.bfloat16)
    q = flat[1:].view(b, s, h, d)  # 2 bytes past a 16-byte boundary
    k, v = _strided_qkv((b, s, h, d), torch.bfloat16, cuda)[1:]
    assert not fa._aligned16(q) and fa._aligned16(k) and fa._aligned16(v)
    do = torch.randn(q.shape, generator=cuda, device="cuda").to(q.dtype)
    before = fa.FLASH_FWD.copies, fa.FLASH_BWD.copies
    out, lse = fa.FLASH_FWD(q, k, v, lse=True)
    grads = fa.FLASH_BWD(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    assert (fa.FLASH_FWD.copies - before[0], fa.FLASH_BWD.copies - before[1]) == (1, 1)
    torch.testing.assert_close(out, fa.flash_attention_reference(q, k, v), **TOL[q.dtype])
    for name, g, w in zip(("dq", "dk", "dv"), grads, fa.flash_attention_bwd_reference(q, k, v, do, out)):
        torch.testing.assert_close(g, w, **TOL[q.dtype], msg=lambda m: f"{name}: {m}")


def test_dispatcher_routes_cuda_tensors_to_the_kernel(cuda):
    q, k, v = _strided_qkv((1, 256, 2, 64), torch.bfloat16, cuda)
    for backend, launched in (("auto", 1), ("pallas", 1), ("xla", 0)):
        before = fa.FLASH_FWD.launches
        attention(q, k, v, backend=backend)
        assert fa.FLASH_FWD.launches - before == launched, backend
    d16 = torch.zeros((1, 64, 2, 16), device="cuda")
    before = fa.FLASH_FWD.launches
    attention(d16, d16, d16, backend="auto")  # outside the gate: plain version
    assert fa.FLASH_FWD.launches == before


def test_wrapper_raises_instead_of_falling_back(cuda):
    q, k, v = _strided_qkv((1, 128, 2, 64), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa.FLASH_FWD(q.transpose(1, 3).contiguous().transpose(1, 3), k, v)
    with pytest.raises(ValueError, match="dtype"):
        fa.FLASH_FWD(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="unsupported"):
        fa.FLASH_FWD(q[..., :48], k[..., :48], v[..., :48])


def test_backward_wrapper_raises_on_bad_input(cuda):
    q, k, v = _strided_qkv((1, 128, 2, 64), torch.float32, cuda)
    out, lse = fa.FLASH_FWD(q, k, v, lse=True)
    before = fa.FLASH_BWD.launches
    with pytest.raises(ValueError, match="lse"):
        fa.FLASH_BWD(q, k, v, out, out, lse[:, :1])
    with pytest.raises(ValueError, match="lse"):
        fa.FLASH_BWD(q, k, v, out, out, lse.to(torch.bfloat16))
    with pytest.raises(ValueError, match="dtype"):
        fa.FLASH_BWD(q, k, v, out, out.to(torch.bfloat16), lse)
    with pytest.raises(ValueError, match="CUDA"):
        fa.FLASH_BWD(q, k, v, out, out.cpu(), lse)
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa.FLASH_BWD(q, k, v, out, out.transpose(1, 3).contiguous().transpose(1, 3), lse)
    assert fa.FLASH_BWD.launches == before


# --- the CheXpert UNet: 8 heads x 96 at 1024 tokens, outside the kernels' gate


@pytest.mark.parametrize("shape", [(2, 1024, 8, 96), (8, 64, 8, 96)])  # CheXpert UNet; IPMSA UNet level 4
def test_d96_attention_takes_the_plain_route_on_the_card(cuda, shape):
    q, k, v = (torch.randn(shape, generator=cuda, device="cuda").to(torch.bfloat16) for _ in range(3))
    before = fa.FLASH_FWD.launches
    got = attention(q, k, v, backend="auto")
    assert fa.FLASH_FWD.launches == before
    torch.testing.assert_close(got, dot_product_attention(q, k, v), rtol=0, atol=0)
    # against the kernels' yardstick: the bf16 noise floor (one bf16 ulp of an O(1) output)
    torch.testing.assert_close(got, fa.flash_attention_reference(q, k, v), **TOL[torch.bfloat16])


def test_resnet_batchnorm_statistics_on_the_card_match_the_cpu(cuda):
    from diffusion_classifier_tpu_torch.models.resnet import ResNet2D

    model = ResNet2D("resnet18", in_channels=10)
    model.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn((4, 64, 64, 10), generator=torch.Generator().manual_seed(1))
    gpu = ResNet2D("resnet18", in_channels=10)
    gpu.load_state_dict(model.state_dict())
    gpu = gpu.cuda()
    torch.backends.cudnn.allow_tf32 = False
    for _ in range(2):
        want = model(x, train=True)
        got = gpu(x.cuda(), train=True)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for name, value in model.state_dict().items():
        if "running_" in name:
            torch.testing.assert_close(gpu.state_dict()[name].cpu(), value, rtol=1e-5, atol=1e-6,
                                       msg=lambda m: f"{name}: {m}")


def test_chexpert_unet_trains_on_the_card_without_the_kernels(cuda):
    import dataclasses

    from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser
    from diffusion_classifier_tpu_torch.experiments.chexpert_unet import build_backbone
    from diffusion_classifier_tpu_torch.models.encoders import ClassEmbedder
    from diffusion_classifier_tpu_torch.models.layers import reset_parameters
    from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

    config = ExperimentConfig(image_size=256, wavelet_transform=True, classes=2, mixed_precision="bf16")
    model = Denoiser(build_backbone(config), ClassEmbedder(2, 256, torch.bfloat16))
    model.backbone.config = dataclasses.replace(model.backbone.config, remat=True)
    reset_parameters(model, torch.Generator().manual_seed(0))
    model = model.cuda()
    x = torch.rand((2, 128, 128, 12), generator=cuda, device="cuda") * 2 - 1
    t, y = torch.randn((2,), generator=cuda, device="cuda"), torch.tensor([1, 2], device="cuda")
    before = (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches)
    loss = model(x, t, y).square().mean()
    loss.backward()
    torch.cuda.synchronize()
    assert (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches) == before
    assert torch.isfinite(loss) and all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_debug_nans_check_on_the_card(cuda):
    from diffusion_classifier_tpu_torch.engine.steps import check_finite

    ok = torch.randn((4, 4), generator=cuda, device="cuda")
    check_finite("finite", [ok, ok.sum()])
    with pytest.raises(FloatingPointError, match="non-finite values in a NaN"):
        check_finite("a NaN", [ok, ok.sum() * float("nan")])


def test_ddp_over_gloo_on_the_card_matches_one_process(cuda, tmp_path):
    """Two ranks share the card over gloo (NCCL refuses two ranks on one device): 3 DDP steps of the tiny DiT.

    Held to the one-process run on the card, on the engine's global draws:
    losses rtol 1e-5, parameters rtol 1e-5 / atol 2e-6, but the key third
    of each qkv bias (a gradient zero in exact arithmetic, which Adam turns
    into steps of ~lr either way) at 2·lr.
    """
    import numpy as np

    import _torch_mp as mp

    rng = np.random.default_rng(5)
    batches = [(rng.uniform(-1, 1, (4, 32, 32, 4)).astype(np.float32), rng.integers(0, 3, 4).astype(np.int32))
               for _ in range(mp.TRAIN_STEPS)]
    torch.save({"batches": batches}, tmp_path / "inputs.pt")
    procs = mp.spawn("dit-cuda", tmp_path)
    ref = mp.dit_engine(tmp_path / "one", device="cuda")
    ref.init_params()
    ref._build_train_state(mp.TRAIN_STEPS)
    losses = [float(ref.train_step({"images": x, "prompt": y})) for x, y in batches]
    params = {k: v.cpu() for k, v in ref.state.model.state_dict().items()}
    outs = mp.collect(procs, tmp_path, timeout=300)
    lr = mp.DIT_CONFIG["learning_rate"]
    for out in outs:
        assert out["ddp"] and out["launches"][0] > 0 and out["launches"][1] > 0
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
        for name, want in params.items():
            got, want = out["params"][name].numpy(), want.numpy()
            if name.endswith("qkv.bias"):
                key = slice(got.shape[0] // 3, 2 * got.shape[0] // 3)
                np.testing.assert_allclose(got[key], want[key], rtol=0, atol=2 * lr)
                got, want = np.delete(got, key), np.delete(want, key)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6, err_msg=name)


def test_classify_auto_group_follows_the_cards_free_memory(cuda):
    """``eval_group=0`` on the card: each stage's G is ``card_eval_group`` of the free memory; a target gives JAX's."""
    from diffusion_classifier_tpu_torch.diffusion.classify import (
        TorchDraws,
        auto_eval_group,
        card_eval_group,
        make_classifier,
    )
    from diffusion_classifier_tpu_torch.diffusion.schedule import make_schedule_fn

    class Seen(TorchDraws):
        def __init__(self):
            super().__init__(torch.Generator(device="cuda").manual_seed(0))
            self.groups = []

        def noise(self, stage, n_stages, group_idx, n_groups, t_shape, eps_shape):
            self.groups.append(t_shape[0])
            return super().noise(stage, n_stages, group_idx, n_groups, t_shape, eps_shape)

    b, c, n = 64, 10, 16  # the CIFAR classify's batch and classes, the config's 16 evaluations
    x = torch.zeros((b, 32, 32, 3), device="cuda")
    labels = torch.zeros(b, dtype=torch.long, device="cuda")
    for target in (None, 512):
        fn = make_classifier(
            lambda z, lg, lab: torch.zeros_like(z), make_schedule_fn("cosine", 64, 32), pred_param="v",
            num_classes=c, n_stages=1, evaluation_per_stage=(n,), n_keep_per_stage=(1,),
            megabatch_target=target,
        )
        torch.cuda.synchronize()
        free = torch.cuda.mem_get_info()[0]
        draws = Seen()
        fn(x, labels, draws)
        want = auto_eval_group(n, b, c, 512, 3072) if target else card_eval_group(n, b, c, 3072, free)
        assert draws.groups == [want] * (n // want)
    # 80 GB free holds the whole stage at once, where the JAX budget takes 1 evaluation a group
    assert card_eval_group(n, b, c, 3072, free) == n and auto_eval_group(n, b, c, 512, 3072) == 1
