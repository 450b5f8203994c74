"""The port's hand-written CUDA kernels (ops/csrc/paged_attention.cu,
ops/csrc/flash_attention.cu) held against their plain PyTorch versions on
an NVIDIA GPU.

Every test here needs the card and skips without one. This file imports
neither jax nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance (max abs error) 1e-4 for the paged kernels over float32 and
bfloat16 pools alike: the query and output are float32, and the kernel only
sums in another order than the plain einsum. The flash kernels: 1e-4 max
abs in float32, and on the lse in bfloat16. On the bfloat16 outputs, each
row (one query's or key's dh values) within 2^-6 of its own L2 norm in L2
error: four bfloat16 unit roundoffs (2^-8), for the output's rounding and
the kernels' rounding of P and dS to bfloat16 before the products they feed
(the reference's bfloat16 path does the same; the plain versions keep them
in float32). A per-row bound, unlike one scaled by the tensor's largest
value, also catches a fault confined to a few rows, such as a dropped tail
key tile. A row under 1e-3 of the mean row norm (a fully masked query, a
key no query sees: 0 in both) is measured against that floor.
"""

import pytest
import torch

import ddlbench_tpu_torch.ops.flash_attention as fa
import ddlbench_tpu_torch.ops.paged_decode as port

pytestmark = [pytest.mark.torchport, pytest.mark.cuda]

ROWS, H, PAGE, NPG, N_PAGES = 8, 8, 16, 16, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode; their plain versions are pinned against JAX in "
                    "test_torch_paged_decode.py and "
                    "test_torch_flash_attention.py)")
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


# (B, H, Tq, Tk, q_offset, k_offset, prefix_len)
FLASH_CASES = [
    (16, 8, 1024, 1024, 0, 0, 0),   # causal, lmbench's main-path shape
    (2, 8, 256, 256, 0, 0, 0),      # causal, whole tiles
    (2, 8, 130, 130, 0, 0, 0),      # tail tiles
    (1, 8, 70, 150, 80, 0, 0),      # a query block at an offset
    (1, 8, 100, 100, 0, 0, 37),     # prefix-LM, prefix inside a tile
    (1, 8, 96, 96, 0, 30, 0),       # key offset: early rows fully masked
]


def _flash_case(dev, dtype, B, H, Tq, Tk, seed):
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(B, H, Tq, 64, generator=g).to(dev, dtype)
             for _ in range(2))
    k, v = (torch.randn(B, H, Tk, 64, generator=g).to(dev, dtype)
            for _ in range(2))
    return q, k, v, do


def _row_rel_err(got, want):
    """Worst row's L2 error over its L2 norm, floored at 1e-3 of the mean
    row norm."""
    d = (got.float() - want.float()).norm(dim=-1)
    r = want.float().norm(dim=-1)
    floor = max(1e-3 * r.mean().item(), 1e-30)
    return (d / r.clamp(min=floor)).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain_versions(dev, dtype, case):
    B, H, Tq, Tk, qo, ko, pre = case
    q, k, v, do = _flash_case(dev, dtype, B, H, Tq, Tk, sum(case))
    o, lse = fa.flash_fwd(q, k, v, qo, ko, pre)
    o_ref, lse_ref = fa._flash_fwd_ref(q, k, v, qo, ko, pre)
    delta = (do.float() * o_ref.float()).sum(-1)
    got = [o, fa.flash_dq(q, k, v, do, lse_ref, delta, qo, ko, pre),
           *fa.flash_dkv(q, k, v, do, lse_ref, delta, qo, ko, pre)]
    want = [o_ref, fa._flash_dq_ref(q, k, v, do, lse_ref, delta, qo, ko, pre),
            *fa._flash_dkv_ref(q, k, v, do, lse_ref, delta, qo, ko, pre)]
    torch.cuda.synchronize()
    seen = lse_ref > -1e29  # rows that see at least one key
    assert (lse[~seen] < -1e29).all()
    assert (lse - lse_ref)[seen].abs().max().item() <= 1e-4
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        if dtype == torch.float32:
            err = (a - b).abs().max().item()
            assert err <= 1e-4, (name, err)
        else:
            err = _row_rel_err(a, b)
            assert err <= 2.0 ** -6, (name, err)


def test_flash_launch_counters_count_kernel_launches_only(dev):
    q, k, v, do = _flash_case(dev, torch.bfloat16, 1, 8, 64, 64, 3)
    counters = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)
    before = [f.launches for f in counters]
    q.requires_grad_()
    fa.flash_attention(q, k, v).backward(do)
    o, lse = fa._flash_fwd_ref(q.detach(), k, v)
    fa._flash_dq_ref(q.detach(), k, v, do, lse, lse * 0)
    fa.flash_attention(q.detach().cpu(), k.cpu(), v.cpu())
    assert [f.launches for f in counters] == [n + 1 for n in before]


def test_flash_wrapper_refuses_what_the_kernels_do_not_take(dev):
    q, k, v, _ = _flash_case(dev, torch.float32, 1, 2, 32, 32, 4)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="mixed dtypes"):
        fa.flash_fwd(q, k.bfloat16(), v.bfloat16())
