"""The benchmark's operation counts, from shapes, against the figures counted over the port's modules."""

import pytest

from portbench import core
from portbench.counts import chexpert_dit_b4, cifar10_unet


def test_dit_b4_row():
    c = chexpert_dit_b4.counts(core.find("configs", "chexpert_dit_b4"))
    assert c["full"] == pytest.approx(63.14e9, rel=5e-4)
    # q·kᵀ and P·V at 1,024 tokens, 384 wide, 12 layers: 31% of the row
    assert c["attention_flops"] == 4 * 1024**2 * 384 * 12
    assert c["attention_bytes"] == 4 * 1024 * 384 * 2 * 12


def test_cifar_unet_encode_tail_full():
    c = cifar10_unet.counts(core.find("configs", "cifar10_unet"))
    assert c["encode"] == pytest.approx(1.61e9, rel=5e-3)
    assert c["tail"] == pytest.approx(8.66e9, rel=5e-4)
    assert c["full"] == pytest.approx(10.27e9, rel=5e-4)
    assert c["full"] == c["encode"] + c["tail"]
