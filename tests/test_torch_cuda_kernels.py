"""The port's hand-written CUDA kernels (ops/csrc/paged_attention.cu) held
against their plain PyTorch versions on an NVIDIA GPU.

Every test here needs the card and skips without one. This file imports
neither jax nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance (max abs error) 1e-4 for float32 and bfloat16 pools alike: the
query and output are float32, and the kernel only sums in another order
than the plain einsum.
"""

import pytest
import torch

import ddlbench_tpu_torch.ops.paged_decode as port

pytestmark = [pytest.mark.torchport, pytest.mark.cuda]

ROWS, H, PAGE, NPG, N_PAGES = 8, 8, 16, 16, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode; their plain versions are pinned against JAX in "
                    "test_torch_paged_decode.py)")
    return torch.device("cuda")


def _case(dev, qtype, ktype, dh, C, seed):
    g = torch.Generator().manual_seed(seed)
    shape = (N_PAGES, PAGE, H, dh)
    cache = {"pool_k": torch.randn(*shape, generator=g).to(dev, ktype),
             "pool_v": torch.randn(*shape, generator=g).to(dev, ktype),
             "table": torch.randint(1, N_PAGES, (ROWS, NPG), generator=g,
                                    dtype=torch.int32).to(dev)}
    if C is None:
        q = torch.randn(ROWS, H, dh, generator=g).to(dev, qtype)
        pos = torch.randint(0, NPG * PAGE, (ROWS,), generator=g)
    else:
        q = torch.randn(ROWS, H, C, dh, generator=g).to(dev, qtype)
        pos = torch.randint(0, (NPG * PAGE - C) // PAGE + 1, (ROWS,),
                            generator=g) * PAGE
    return q, cache, pos.to(dev, torch.int32)


def _both(q, cache, pos, npl, C):
    if C is None:
        return (port.paged_attention(q, cache, pos, npl, PAGE),
                port._paged_attention_ref(q, cache, pos, npl, PAGE))
    return (port.paged_chunk_attention(q, cache, pos, npl, PAGE),
            port._paged_chunk_attention_ref(q, cache, pos, npl, PAGE))


@pytest.mark.parametrize("ktype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,npl", [(None, 1), (None, 3), (None, 16),
                                   (16, 1), (16, 3), (16, 16), (256, 16)])
def test_kernels_match_plain_versions(dev, ktype, C, npl):
    q, cache, pos = _case(dev, torch.float32, ktype, 64, C, seed=npl)
    got, want = _both(q, cache, pos, npl, C)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    err = (got - want).abs().max().item()
    assert err <= 1e-4, err


def test_inactive_rows_read_the_scratch_slot(dev):
    """Rows routed to slot 0 at position 0 (the engine's inactive decode
    rows) read the scratch page like any other."""
    q, cache, pos = _case(dev, torch.float32, torch.float32, 64, None, 7)
    cache["table"][4:] = port.SCRATCH_SLOT
    pos[4:] = 0
    got, want = _both(q, cache, pos, NPG, None)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4


def test_launch_counters_count_kernel_launches_only(dev):
    q, cache, pos = _case(dev, torch.float32, torch.float32, 64, 16, 9)
    before = (port.paged_attention.launches,
              port.paged_chunk_attention.launches)
    port.paged_chunk_attention(q, cache, pos, NPG, PAGE)
    port._paged_chunk_attention_ref(q, cache, pos, NPG, PAGE)
    port.paged_chunk_attention(q.cpu(), {k: v.cpu() for k, v in
                                         cache.items()}, pos.cpu(), NPG,
                               PAGE)
    assert (port.paged_attention.launches,
            port.paged_chunk_attention.launches) == (before[0],
                                                     before[1] + 1)


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, cache, pos = _case(dev, torch.float32, torch.float32, 64, None, 11)
    with pytest.raises(ValueError, match="contiguous"):
        port.paged_attention(q.transpose(0, 1), cache, pos, NPG, PAGE)
    with pytest.raises(ValueError, match="npages_live"):
        port.paged_attention(q, cache, pos, NPG + 1, PAGE)
    with pytest.raises(ValueError, match="float32"):
        port.paged_attention(q.bfloat16(), cache, pos, NPG, PAGE)
    q32, cache32, pos32 = _case(dev, torch.float32, torch.float32, 32, None,
                                11)
    with pytest.raises(ValueError, match="head dim"):
        port.paged_attention(q32, cache32, pos32, NPG, PAGE)
