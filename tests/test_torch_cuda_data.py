"""The on-disk image path on an NVIDIA GPU against its CPU run.

Every test here needs the card and skips without one; the file imports
neither jax nor the JAX package (the CPU path is pinned against the
reference in test_torch_data.py):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_data.py

* The augmentation of a uint8 batch on the card equals the CPU's bit for
  bit (cifar10's pad-crop and flip, imagenet's flip), and so does the
  normalised bfloat16 batch.
* Batches made on the prefetcher's side stream and read on the default
  stream at once equal the CPU's batches of the same store and seed, at
  depth 2 and inline: the consumer waits for each upload.
"""

import pytest
import torch

from ddlbench_tpu_torch.config import DATASETS
from ddlbench_tpu_torch.data import ondisk
from ddlbench_tpu_torch.data.prefetch import Prefetcher

pytestmark = [pytest.mark.torchport, pytest.mark.cuda]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CPU path is pinned against "
                    "JAX in test_torch_data.py)")
    return torch.device("cuda")


@pytest.mark.parametrize("name,hwc", [("cifar10", (32, 32, 3)),
                                      ("imagenet", (224, 224, 3))])
def test_card_augment_is_the_cpus(dev, name, hwc):
    g = torch.Generator().manual_seed(0)
    imgs = torch.randint(0, 256, (64, *hwc), generator=g, dtype=torch.uint8)
    table = ondisk.normalize_table().to(torch.bfloat16)
    for epoch, step in ((0, 0), (1, 3), (5, 9)):
        key = ondisk.augment_key(3, epoch, 10, step)
        want = ondisk.augment_u8(imgs, key, **ondisk.AUGMENT[name])
        got = ondisk.augment_u8(imgs.to(dev), key, **ondisk.AUGMENT[name])
        assert torch.equal(got.cpu(), want)
        assert torch.equal(table.to(dev)[got.int()].cpu(),
                           table[want.int()])


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetched_batches_wait_for_their_upload(dev, tmp_path, depth):
    spec = DATASETS["imagenet"]
    kw = dict(seed=2, dtype=torch.bfloat16, train_count=6 * 64,
              test_count=64)
    card = ondisk.OnDiskData(str(tmp_path), spec, 64, dev, **kw)
    host = ondisk.OnDiskData(str(tmp_path), spec, 64, torch.device("cpu"),
                             **kw)
    try:
        stream = Prefetcher(card, depth=depth).stream(1)
        for step, (x, y) in enumerate(stream):
            assert x.is_contiguous(memory_format=torch.channels_last)
            # read on the default stream at once, then compared
            got = (x.float() * 1).cpu(), y.cpu()
            want = host.batch(1, step)
            assert torch.equal(got[0], want[0].float()), step
            assert torch.equal(got[1], want[1]), step
        assert stream.steps == 6
    finally:
        card.close()
        host.close()
