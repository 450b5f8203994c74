"""The port's hand-written CUDA kernels (ops/csrc/paged_attention.cu,
ops/csrc/flash_attention.cu, ops/csrc/fused_xent.cu) held against their
plain PyTorch versions on an NVIDIA GPU.

Every test here needs the card and skips without one. This file imports
neither jax nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance (max abs error) 1e-4 for the paged kernels over float32,
bfloat16 and int8 pools alike: the query and output are float32, the int8
rows are dequantised (int8 * scale) as in the plain version, and the kernel
only sums in another order than the plain einsum. Two planted int8 faults
(the K scale ignored, each page's scales read from the next slot) must fail
that check. The flash kernels: 1e-4 max abs in float32, and on the lse in
bfloat16. On the bfloat16 outputs, each row (one query's or key's dh
values) within 2^-6 of its own L2 norm in L2 error: four bfloat16 unit
roundoffs (2^-8), for the output's rounding and the kernels' rounding of
P and dS to bfloat16 before the products they feed (the reference's
bfloat16 path does the same; the plain versions keep them in float32). A
per-row bound, unlike one scaled by the tensor's largest value, also
catches a fault confined to a few rows, such as a dropped tail key tile. A
row under 1e-3 of the mean row norm (a fully masked query, a
key no query sees: 0 in both) is measured against that floor.

The fused LM-head kernels, in both types: each row's lse and gold logit
within 1e-4, its zsum within 1e-5 of (1 + the row's sum of |z|); the
products of bfloat16 inputs are exact in float32, so only the order of the
float32 sums differs. In float32 the argmax exact, dh and dW within 1e-4
max abs; in bfloat16 each dh row and each dW column within 2^-6 relative L2
(dz and the outputs rounded to bfloat16, as above), and an argmax mismatch
only at a near-tie (the two top logits within 1e-3).
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import pytest
import torch

import ddlbench_tpu_torch.ops.flash_attention as fa
import ddlbench_tpu_torch.ops.fused_xent as fx
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


VERIFY_C = 5  # the verify pass at K = 4: the pending token + 4 drafts


def _int8_case(dev, C, seed, aligned=True):
    """An int8 pool holding random rows as the port's own chunk write
    quantises them (real scale sidecars), with a case's table, query and
    positions; ``aligned=False`` gives per-row unaligned starts (the
    verify pass)."""
    q, f32, pos = _case(dev, torch.float32, torch.float32, 64, C, seed)
    pool = port.serve_pool_init(N_PAGES, PAGE, H, 64, torch.int8, dev)
    pool["kv_u"] = port.kv_u_table(1, N_PAGES * PAGE, H, 64, dev)
    every = {**pool, "table": torch.arange(N_PAGES, dtype=torch.int32,
                                           device=dev)[None]}
    n = N_PAGES * PAGE
    port.paged_table_chunk_write(every, f32["pool_k"].reshape(1, n, H, 64),
                                 f32["pool_v"].reshape(1, n, H, 64), 0, PAGE)
    cache = {k: pool[k] for k in ("pool_k", "pool_v", "scale_k", "scale_v")}
    cache["table"] = f32["table"]
    if not aligned:
        g = torch.Generator().manual_seed(seed)
        pos = torch.randint(0, NPG * PAGE - C + 1, (ROWS,), generator=g,
                            dtype=torch.int32).to(dev)
    return q, cache, pos


@pytest.mark.parametrize("C,npl,aligned", [
    (None, 1, True), (None, 3, True), (None, 16, True),
    (16, 1, True), (16, 3, True), (16, 16, True), (256, 16, True),
    (VERIFY_C, 3, False), (VERIFY_C, 16, False)])
def test_int8_kernels_match_plain_versions(dev, C, npl, aligned):
    q, cache, pos = _int8_case(dev, C, 20 + npl, aligned)
    n0 = (port.paged_attention.launches_int8,
          port.paged_chunk_attention.launches_int8)
    got, want = _both(q, cache, pos, npl, C)
    torch.cuda.synchronize()
    assert got.shape == q.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4
    grew = (port.paged_attention.launches_int8 - n0[0],
            port.paged_chunk_attention.launches_int8 - n0[1])
    assert grew == ((1, 0) if C is None else (0, 1))


@pytest.mark.parametrize("C", [VERIFY_C, 16])
def test_verify_shape_float32_matches_plain_version(dev, C):
    q, cache, _ = _case(dev, torch.float32, torch.float32, 64, C, 31)
    g = torch.Generator().manual_seed(C)
    pos = torch.randint(0, NPG * PAGE - C + 1, (ROWS,), generator=g,
                        dtype=torch.int32).to(dev)
    got, want = _both(q, cache, pos, NPG, C)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("fault", ["k_scale_ignored",
                                   "scales_from_next_slot"])
@pytest.mark.parametrize("C", [None, VERIFY_C])
def test_int8_check_rejects_planted_faults(dev, fault, C):
    """The 1e-4 check must reject the plain version over a faulty int8
    pool: the K scale ignored (scale 1), or every page's scales read from
    the next slot."""
    q, cache, pos = _int8_case(dev, C, 41, aligned=C is None)
    got, _ = _both(q, cache, pos, NPG, C)
    if fault == "k_scale_ignored":
        bad = {**cache, "scale_k": torch.ones_like(cache["scale_k"])}
    else:
        bad = {**cache, "scale_k": cache["scale_k"].roll(-1, 0),
               "scale_v": cache["scale_v"].roll(-1, 0)}
    _, planted = _both(q, bad, pos, NPG, C)
    torch.cuda.synchronize()
    assert (got - planted).abs().max().item() > 1e-4


def _chunk_case(dev, ktype, page, npl, C, seed, aligned=True, n_slots=None):
    """A pool of ``page``-position pages (int8: written by the port's own
    quantising chunk write), a table drawn with replacement from slots
    1 .. ``n_slots`` (default: every non-scratch slot), a float32 chunk
    query and per-row starts, page-aligned or not."""
    g = torch.Generator().manual_seed(seed)
    shape = (N_PAGES, page, H, 64)
    pk = torch.randn(*shape, generator=g).to(dev)
    pv = torch.randn(*shape, generator=g).to(dev)
    if ktype == torch.int8:
        pool = port.serve_pool_init(N_PAGES, page, H, 64, torch.int8, dev)
        pool["kv_u"] = port.kv_u_table(1, N_PAGES * page, H, 64, dev)
        n = N_PAGES * page
        port.paged_table_chunk_write(
            {**pool, "table": torch.arange(N_PAGES, dtype=torch.int32,
                                           device=dev)[None]},
            pk.reshape(1, n, H, 64), pv.reshape(1, n, H, 64), 0, page)
        cache = {k: pool[k] for k in ("pool_k", "pool_v", "scale_k",
                                      "scale_v")}
    else:
        cache = {"pool_k": pk.to(ktype), "pool_v": pv.to(ktype)}
    cache["table"] = torch.randint(1, n_slots or N_PAGES, (ROWS, npl + 1),
                                   generator=g, dtype=torch.int32).to(dev)
    q = torch.randn(ROWS, H, C, 64, generator=g).to(dev)
    if aligned:
        pos = torch.randint(0, max(1, (npl * page - C) // page + 1), (ROWS,),
                            generator=g) * page
    else:
        pos = torch.randint(0, max(1, npl * page - C + 1), (ROWS,),
                            generator=g)
    return q, cache, pos.to(dev, torch.int32)


# (page, npl, C, page-aligned starts): a single query, partial last query
# tiles (C 17, 33), npl 9 (not a multiple of the 8 warps), pages of 32 (two
# 16-key chunks) and of 8 (one partial chunk)
CHUNK_EDGES = [(16, 16, 1, False), (16, 16, 17, True), (16, 16, 33, False),
               (16, 9, 16, True), (16, 9, 33, False), (32, 3, 33, False),
               (32, 5, 17, True), (8, 9, 1, False), (8, 16, 33, True),
               (8, 9, 5, False)]


@pytest.mark.parametrize("ktype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("page,npl,C,aligned", CHUNK_EDGES)
def test_chunk_kernel_edge_shapes_match_plain_version(dev, ktype, page, npl,
                                                      C, aligned):
    q, cache, pos = _chunk_case(dev, ktype, page, npl, C, 60 + C + npl,
                                aligned)
    got = port.paged_chunk_attention(q, cache, pos, npl, page)
    want = port._paged_chunk_attention_ref(q, cache, pos, npl, page)
    torch.cuda.synchronize()
    assert got.shape == q.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("ktype", [torch.float32, torch.int8])
@pytest.mark.parametrize("C,aligned", [(16, True), (256, True),
                                       (VERIFY_C, False)])
def test_chunk_kernel_reruns_are_bitwise_equal(dev, ktype, C, aligned):
    """The warps' states merge in a fixed order: a rerun gives the same
    bits."""
    q, cache, pos = _chunk_case(dev, ktype, PAGE, NPG, C, 70 + C, aligned)
    first = port.paged_chunk_attention(q, cache, pos, NPG, PAGE)
    again = port.paged_chunk_attention(q, cache, pos, NPG, PAGE)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.parametrize("ktype", [torch.float32, torch.int8])
def test_chunk_kernel_reads_pages_past_its_staged_table(dev, ktype):
    """Pages of one position and 2 100 live pages: the block stages the
    first 2 048 table entries and looks the later ones up in device
    memory; every row's chunk ends past entry 2 048."""
    npl, C = 2100, 16
    q, cache, _ = _chunk_case(dev, ktype, 1, npl, C, 91)
    pos = torch.tensor([npl - C - 5 * r for r in range(ROWS)],
                       dtype=torch.int32, device=dev)
    got = port.paged_chunk_attention(q, cache, pos, npl, 1)
    want = port._paged_chunk_attention_ref(q, cache, pos, npl, 1)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("ktype", [torch.float32, torch.int8])
def test_chunk_kernel_rows_sharing_slots_match_plain_version(dev, ktype):
    """Every row's table drawn with replacement from three slots: rows
    (and pages of one row) share slots, as prefix-cache binds make them."""
    q, cache, pos = _chunk_case(dev, ktype, PAGE, NPG, 33, 81, False,
                                n_slots=4)
    got = port.paged_chunk_attention(q, cache, pos, NPG, PAGE)
    want = port._paged_chunk_attention_ref(q, cache, pos, NPG, PAGE)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


def _decode_case(dev, ktype, page, npl, key, seed):
    """A decode query over ``_chunk_case``'s pools and table: row 0 on the
    last live page, row 1 on page 0 (warps 1-7 walk nothing), the others on
    random live pages; each row on its page's first or last key."""
    q, cache, _ = _chunk_case(dev, ktype, page, npl, 1, seed)
    g = torch.Generator().manual_seed(seed)
    pages = torch.randint(0, npl, (ROWS,), generator=g)
    pages[0], pages[1] = npl - 1, 0
    pos = pages * page + (0 if key == "first" else page - 1)
    return q[:, :, 0].contiguous(), cache, pos.to(dev, torch.int32)


# (page, npl, the key of its page each row's position is on)
DECODE_EDGES = [(16, 16, "last"), (16, 16, "first"), (16, 9, "last"),
                (16, 1, "first"), (8, 9, "first"), (8, 16, "last"),
                (32, 9, "last"), (32, 16, "first"), (32, 1, "last")]


@pytest.mark.parametrize("ktype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("page,npl,key", DECODE_EDGES)
def test_decode_kernel_edge_shapes_match_plain_version(dev, ktype, page, npl,
                                                       key):
    q, cache, pos = _decode_case(dev, ktype, page, npl, key, 100 + npl + page)
    got = port.paged_attention(q, cache, pos, npl, page)
    want = port._paged_attention_ref(q, cache, pos, npl, page)
    torch.cuda.synchronize()
    assert got.shape == q.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("ktype", [torch.float32, torch.int8])
def test_decode_kernel_reruns_are_bitwise_equal(dev, ktype):
    """The warps' states merge in a fixed order: a rerun gives the same
    bits."""
    q, cache, pos = _decode_case(dev, ktype, PAGE, NPG, "last", 110)
    first = port.paged_attention(q, cache, pos, NPG, PAGE)
    again = port.paged_attention(q, cache, pos, NPG, PAGE)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.parametrize("ktype", [torch.float32, torch.int8])
def test_decode_kernel_reads_pages_past_its_staged_table(dev, ktype):
    """Pages of one position and 2 100 live pages: the block stages the
    first 2 048 table entries and looks the later ones up in device
    memory; every row's position is past entry 2 048."""
    npl = 2100
    q, cache, _ = _decode_case(dev, ktype, 1, npl, "first", 120)
    pos = torch.tensor([npl - 1 - 7 * r for r in range(ROWS)],
                       dtype=torch.int32, device=dev)
    got = port.paged_attention(q, cache, pos, npl, 1)
    want = port._paged_attention_ref(q, cache, pos, npl, 1)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


def test_int8_wrapper_refuses_a_pool_without_its_sidecars(dev):
    q, cache, pos = _int8_case(dev, None, 51)
    with pytest.raises(ValueError, match="sidecar"):
        port.paged_attention(q, {k: v for k, v in cache.items()
                                 if not k.startswith("scale")}, pos, NPG,
                             PAGE)
    with pytest.raises(ValueError, match="scale_k"):
        port.paged_attention(q, {**cache, "scale_k": cache["scale_k"][:-1]},
                             pos, NPG, PAGE)


# (B, H, Tq, Tk, q_offset, k_offset, prefix_len)
FLASH_CASES = [
    (16, 8, 1024, 1024, 0, 0, 0),   # causal, lmbench's main-path shape
    (2, 8, 256, 256, 0, 0, 0),      # causal, whole tiles
    (2, 8, 130, 130, 0, 0, 0),      # tail tiles
    (1, 8, 70, 150, 80, 0, 0),      # a query block at an offset
    (1, 8, 100, 100, 0, 0, 37),     # prefix-LM, prefix inside a tile
    (1, 8, 96, 96, 0, 30, 0),       # key offset: early rows fully masked
    (64, 8, 256, 256, 0, 0, 128),   # seq2seq_s: the prefix ends on a tile
    (2, 8, 960, 960, 0, 0, 0),      # a multiple of 64, not of 128
    (2, 8, 48, 1000, 952, 0, 0),    # under one warpgroup of rows, offset
    (16, 8, 512, 512, 512, 0, 0),   # sp's ring at world 2: a visible block
    (16, 8, 512, 512, 0, 0, 0),     # and a diagonal one
    (64, 8, 64, 64, 0, 64, 128),    # seq2seq_s's prefix ring at world 4:
                                    # a block above the diagonal, seen
                                    # through the prefix only
]
RING_CASES = FLASH_CASES[-3:]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", RING_CASES)
def test_flash_attention_lse_matches_plain_version(dev, dtype, case):
    """flash_attention_lse on the kernels against its plain version on the
    rings' three block shapes under random cotangents of o and of the lse
    (the lse's shifts delta), at the bars above: float32 end to end (o,
    lse, dq, dk, dv); bfloat16 o and lse, and the backward kernels on the
    plain forward's lse and shifted delta (the row bar assumes shared
    residuals, as test_flash_kernels_match_plain_versions's: a row that
    sees few keys has a dq that is almost only the shift)."""
    B, H, Tq, Tk, qo, ko, pre = case
    q, k, v, do = _flash_case(dev, dtype, B, H, Tq, Tk, sum(case) + 1)
    g_lse = torch.randn(B, H, Tq, generator=torch.Generator().manual_seed(
        7)).to(dev)
    outs = []
    for fn in (fa.flash_attention_lse, fa.flash_attention_lse_plain):
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        o, lse = fn(qg, kg, vg, qo, ko, pre)
        outs.append((o, lse, *torch.autograd.grad((o, lse), (qg, kg, vg),
                                                  (do, g_lse))))
    (o, lse, *grads), (o_ref, lse_ref, *grads_ref) = outs
    if dtype == torch.bfloat16:
        delta = (do.float() * o_ref.float()).sum(-1) - g_lse
        grads = [fa.flash_dq(q, k, v, do, lse_ref, delta, qo, ko, pre),
                 *fa.flash_dkv(q, k, v, do, lse_ref, delta, qo, ko, pre)]
        grads_ref = [
            fa._flash_dq_ref(q, k, v, do, lse_ref, delta, qo, ko, pre),
            *fa._flash_dkv_ref(q, k, v, do, lse_ref, delta, qo, ko, pre)]
    torch.cuda.synchronize()
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    for name, a, b in zip(("o", "dq", "dk", "dv"), (o, *grads),
                          (o_ref, *grads_ref)):
        assert a.dtype == dtype and torch.isfinite(a).all(), name
        if dtype == torch.float32:
            err = (a - b).abs().max().item()
            assert err <= 1e-4, (name, err)
        else:
            err = _row_rel_err(a, b)
            assert err <= 2.0 ** -6, (name, err)


@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[6]])
def test_flash_dq_reruns_are_bitwise_equal(dev, case):
    """dQ takes no atomics: two runs on the same inputs give the same bits
    (lmbench's shape, and seq2seq_s's prefix case)."""
    B, H, Tq, Tk, qo, ko, pre = case
    q, k, v, do = _flash_case(dev, torch.bfloat16, B, H, Tq, Tk, sum(case))
    o, lse = fa.flash_fwd(q, k, v, qo, ko, pre)
    delta = (do.float() * o.float()).sum(-1)
    runs = [fa.flash_dq(q, k, v, do, lse, delta, qo, ko, pre)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("mode", [0, 1])
def test_wgmma_operand_forms_match_matmul(dev, mode):
    """The two wgmma forms the bf16 forward and dK/dV kernels issue, on one
    64 x 64 x 64 tile loaded by TMA with the 128-byte swizzle: mode 0, a b^T
    with both operands K-major in shared memory (the score products);
    mode 1, a b with a from registers and b MN-major (P V, P^T dO, dS^T Q).
    bf16 products are exact in float32; only the order of the sums
    differs."""
    from ddlbench_tpu_torch.ops import _build

    g = torch.Generator().manual_seed(12 + mode)
    a, b = (torch.randn(64, 64, generator=g).to(dev, torch.bfloat16)
            for _ in range(2))
    c = torch.empty(64, 64, device=dev)
    lib = _build.library("flash_attention")
    _build.check(lib, lib.ddl_wgmma_tile_test(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), mode,
        torch.cuda.current_stream().cuda_stream), "wgmma_tile_test")
    want = a.float() @ (b.float().T if mode == 0 else b.float())
    torch.cuda.synchronize()
    assert (c - want).abs().max().item() <= 1e-4


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


# (N, D, V, smoothing, masking): masking "every5" masks rows 0, 5, 10, ...;
# "synthmt" the positions < 127 of each 256-row segment; "all" every row
FX_CASES = [
    (1000, 64, 1000, 0.0, "every5"),    # tail rows and a tail vocab tile
    (1000, 64, 1000, 0.1, "every5"),
    (512, 768, 504, 0.1, "every5"),     # the widest head the kernels take
    (70, 16, 40, 0.1, "every5"),        # less than one tile each way
    (2048, 512, 4096, 0.1, "synthmt"),
    (300, 64, 200, 0.1, "all"),
    (1000, 768, 1000, 0.1, "synthmt"),  # D 768 (scores in halves), ragged
    (1000, 32, 1000, 0.1, "every5"),    # D 32 (transformer_t)
    (40, 32, 136, 0.0, "every5"),       # N < 64, V a multiple of 8 only
    (1100, 576, 2056, 0.1, "every5"),   # D 576: the narrowest in halves
    (700, 320, 520, 0.1, "synthmt"),    # an odd D chunk count
]


def _fx_case(dev, dtype, N, D, V, masking, seed, zero_head=False):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(N, D, generator=g).to(dev, dtype)
    w = (torch.randn(D, V, generator=g) * 0.05).to(dev, dtype)
    if zero_head:
        w.zero_()
    labels = torch.randint(0, V, (N,), generator=g)
    pos = torch.arange(N)
    if masking == "every5":
        labels[::5] = -1
    elif masking == "synthmt":
        labels[pos % 256 < 127] = -1
    elif masking == "all":
        labels[:] = -1
    return h, w, labels.to(dev)


def _col_rel_err(got, want):
    return _row_rel_err(got.T, want.T)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FX_CASES)
def test_fused_xent_kernels_match_plain_versions(dev, dtype, case):
    N, D, V, s, masking = case
    h, w, labels = _fx_case(dev, dtype, N, D, V, masking, seed=N + D + V)
    coef = torch.tensor([0.7 + 0.3, 0.7 * (1 - s) + 0.3, 0.7 * s / V],
                        device=dev)
    got = fx.fxent_fwd(h, w, labels)
    want = fx._fxent_fwd_ref(h, w, labels)
    lse = want[0]
    dh = fx.fxent_dh(h, w, labels, lse, coef)
    dw = fx.fxent_dw(h, w, labels, lse, coef)
    dh_ref = fx._fxent_dh_ref(h, w, labels, lse, coef)
    dw_ref = fx._fxent_dw_ref(h, w, labels, lse, coef)
    torch.cuda.synchronize()
    assert dh.dtype == dw.dtype == dtype
    assert dh.shape == h.shape and dw.shape == w.shape
    for t in (*got[:3], dh, dw):
        assert torch.isfinite(t.float()).all()
    assert (got[0] - want[0]).abs().max().item() <= 1e-4
    assert (got[1] - want[1]).abs().max().item() <= 1e-4
    scale = (h.float() @ w.float()).abs().sum(-1)
    assert ((got[2] - want[2]).abs() <= 1e-5 * scale + 1e-5).all()
    if masking == "all":
        assert torch.count_nonzero(dh) == 0 and torch.count_nonzero(dw) == 0
        return
    if dtype == torch.float32:
        assert torch.equal(got[3], want[3])
        assert (dh - dh_ref).abs().max().item() <= 1e-4
        assert (dw - dw_ref).abs().max().item() <= 1e-4
    else:
        z = h.float() @ w.float()
        top2 = z.topk(2, -1).values
        near_tie = (top2[:, 0] - top2[:, 1]) <= 1e-3
        assert not ((got[3] != want[3]) & ~near_tie).any()
        assert _row_rel_err(dh, dh_ref) <= 2.0 ** -6
        assert _col_rel_err(dw, dw_ref) <= 2.0 ** -6


@pytest.mark.parametrize("D", [32, 512, 768])
def test_fused_xent_backward_reruns_are_bitwise_equal(dev, D):
    """dh and dW take no atomics: two runs on the same inputs give the same
    bits."""
    h, w, labels = _fx_case(dev, torch.bfloat16, 1000, D, 2048, "synthmt",
                            seed=D)
    coef = torch.tensor([1.0, 0.9, 0.1 / 2048], device=dev)
    lse = fx._fxent_fwd_ref(h, w, labels)[0]
    runs = [(fx.fxent_dh(h, w, labels, lse, coef),
             fx.fxent_dw(h, w, labels, lse, coef)) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("D", [32, 512, 768])
def test_fused_xent_forward_reruns_are_bitwise_equal(dev, D):
    """The forward's two warpgroups merge their statistics in a fixed
    order: two runs on the same inputs give the same bits in all four
    outputs."""
    h, w, labels = _fx_case(dev, torch.bfloat16, 1000, D, 2048, "synthmt",
                            seed=D + 1)
    runs = [fx.fxent_fwd(h, w, labels) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_fx_wgmma_operand_forms_match_matmul(dev, mode):
    """The wgmma forms the bf16 dh and dW kernels issue, on one 64 x 64 x
    64 tile loaded by TMA (2-D tensor maps, 128-byte swizzle): mode 0, a b
    with a K-major and b MN-major from shared memory (dh's scores); mode 1,
    a b^T with a from registers and b K-major (dh's product); mode 2, a^T
    b^T with a MN-major and b K-major from shared memory (dW's transposed
    scores); modes 3 and 4, modes 0 and 2 in two N 32 halves, each reading
    half of b (the scores past D 512). dW's product is the flash kernels'
    register form (test_wgmma_operand_forms_match_matmul, mode 1)."""
    from ddlbench_tpu_torch.ops import _build

    g = torch.Generator().manual_seed(22 + mode)
    a, b = (torch.randn(64, 64, generator=g).to(dev, torch.bfloat16)
            for _ in range(2))
    c = torch.empty(64, 64, device=dev)
    lib = _build.library("fused_xent")
    _build.check(lib, lib.ddl_fx_wgmma_tile_test(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), mode,
        torch.cuda.current_stream().cuda_stream), "fx_wgmma_tile_test")
    af, bf = a.float(), b.float()
    want = {0: af @ bf, 1: af @ bf.T, 2: af.T @ bf.T, 3: af @ bf,
            4: af.T @ bf.T}[mode]
    torch.cuda.synchronize()
    assert (c - want).abs().max().item() <= 1e-4


def test_fused_xent_float32_takes_any_vocabulary(dev):
    """The float32 kernels take a vocabulary that is no multiple of 8 (the
    bfloat16 ones refuse it: test below)."""
    h, w, labels = _fx_case(dev, torch.float32, 300, 64, 1003, "every5", 8)
    coef = torch.tensor([1.0, 0.9, 0.1 / 1003], device=dev)
    got = fx.fxent_fwd(h, w, labels)
    want = fx._fxent_fwd_ref(h, w, labels)
    lse = want[0]
    dh = fx.fxent_dh(h, w, labels, lse, coef)
    dw = fx.fxent_dw(h, w, labels, lse, coef)
    torch.cuda.synchronize()
    assert (got[0] - want[0]).abs().max().item() <= 1e-4
    assert torch.equal(got[3], want[3])
    dh_ref = fx._fxent_dh_ref(h, w, labels, lse, coef)
    dw_ref = fx._fxent_dw_ref(h, w, labels, lse, coef)
    assert (dh - dh_ref).abs().max().item() <= 1e-4
    assert (dw - dw_ref).abs().max().item() <= 1e-4


def test_fused_xent_zero_head_counts_label_zero_rows(dev):
    """W = 0: all logits tie, the argmax is class 0 in every row."""
    h, w, labels = _fx_case(dev, torch.bfloat16, 1000, 64, 1000, "every5",
                            seed=5, zero_head=True)
    labels[1::7] = 0
    lse, gold, zsum, amax = fx.fxent_fwd(h, w, labels)
    assert (amax == 0).all() and (gold == 0).all() and (zsum == 0).all()
    _, _, correct = fx.loss_sums(lse, gold, zsum, amax, labels, 0.0, 1000)
    assert int(correct) == int(((labels == 0)).sum())


def test_fused_xent_launch_counters_count_kernel_launches_only(dev):
    h, w, labels = _fx_case(dev, torch.bfloat16, 256, 64, 512, "every5", 6)
    counters = (fx.fxent_fwd, fx.fxent_dh, fx.fxent_dw)
    before = [f.launches for f in counters]
    ht, wt = h.clone().requires_grad_(), w.clone().requires_grad_()
    obj, ce, _ = fx.fused_linear_xent(ht, wt, labels, 0.1)
    (obj + ce).backward()
    lse = fx._fxent_fwd_ref(h, w, labels)[0]
    fx._fxent_dh_ref(h, w, labels, lse, torch.ones(3, device=dev))
    fx.fused_linear_xent_eval(h, w, labels)
    fx.fused_linear_xent(h.cpu(), w.cpu(), labels.cpu())
    assert [f.launches for f in counters] == [n + 1 for n in before]


def test_fused_xent_wrapper_refuses_what_the_kernels_do_not_take(dev):
    h, w, labels = _fx_case(dev, torch.float32, 64, 32, 100, "every5", 7)
    with pytest.raises(ValueError, match="multiple of 16"):
        fx.fxent_fwd(h[:, :24].contiguous(), w[:24], labels)
    with pytest.raises(ValueError, match="KERNEL_MAX_D"):
        big = torch.zeros(64, 784, device=dev)
        fx.fxent_fwd(big, torch.zeros(784, 100, device=dev), labels)
    with pytest.raises(ValueError, match="mixed devices"):
        fx.fxent_fwd(h, w, labels.cpu())
    with pytest.raises(ValueError, match="mixed dtypes"):
        fx.fxent_fwd(h, w.bfloat16(), labels)
    with pytest.raises(ValueError, match="integer"):
        fx.fxent_fwd(h, w, labels.float())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fx.fxent_fwd(h.half(), w.half(), labels)
    with pytest.raises(ValueError, match="multiple of 8"):
        fx.fxent_fwd(h.bfloat16(), w[:, :99].bfloat16(), labels)


def test_transformer_t_trains_through_lmbench_on_the_plain_attention(dev):
    """transformer_t's head dim 8 is not the flash kernels': lmbench's
    ``auto`` cell takes the plain attention, counted in its row, and the
    fused-head kernels (D 32)."""
    from ddlbench_tpu_torch.tools import lmbench

    args = lmbench.build_parser().parse_args(
        ["-m", "transformer_t", "-b", "synthtext", "--batch-size", "2",
         "--steps", "2", "--warmup", "1", "--configs", "auto"])
    before = fx.fxent_dw.launches
    row = lmbench.run_config(args, "auto", False, dev)
    assert row["plain_launches"] > 0 and row["platform"] == "gpu"
    assert row["tokens_per_sec"] > 0
    assert fx.fxent_dw.launches > before


def test_transformer_t_serves_through_servebench_on_the_plain_paged_ops(dev):
    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.tools import servebench

    args = servebench.build_parser().parse_args(
        ["-m", "transformer_t", "-b", "synthtext", "--policies",
         "continuous", "--arrival", "closed", "--requests", "4",
         "--max-len", "64", "--seed", "0"])
    model = get_model(args.model, args.benchmark, seed=0).to(dev)
    (row, _, _), = servebench.run(args, model, dev)
    assert row["completed"] == 4 and row["plain_launches"] > 0


def test_forced_flash_raises_on_head_dim_8(dev):
    from ddlbench_tpu_torch.models.transformer import (causal_attention,
                                                       set_attention_backend)

    q = torch.zeros(1, 4, 16, 8, dtype=torch.bfloat16, device=dev)
    set_attention_backend("flash")
    try:
        with pytest.raises(ValueError, match="flash kernels do not take"):
            causal_attention(q, q, q)
    finally:
        set_attention_backend("auto")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("needs", ["dh", "dw"])
def test_fused_xent_one_sided_backward_matches_plain(dev, dtype, needs):
    """The pipelines' split backward (parallel/pipeline_rt.py): with only
    h needing its gradient the head's backward launches the dh kernel
    alone (a B event), with only w the dW kernel alone (a W event); each
    is held to the plain version's gradient on the same inputs, at the
    tolerances of the module docstring."""
    h, w, labels = _fx_case(dev, dtype, 1000, 512, 2048, "synthmt", 11)
    s = 0.1
    ht = h.clone().requires_grad_(needs == "dh")
    wt = w.clone().requires_grad_(needs == "dw")
    before = (fx.fxent_dh.launches, fx.fxent_dw.launches)
    obj = fx.fused_linear_xent(ht, wt, labels, s)[0]
    (got,) = torch.autograd.grad(obj, [ht if needs == "dh" else wt])
    torch.cuda.synchronize()
    assert (fx.fxent_dh.launches - before[0],
            fx.fxent_dw.launches - before[1]) == (
        (1, 0) if needs == "dh" else (0, 1))
    lse = fx._fxent_fwd_ref(h, w, labels)[0]
    V = w.shape[1]
    coef = torch.tensor([1.0, 1.0 - s, s / V], device=dev)
    ref = (fx._fxent_dh_ref if needs == "dh" else fx._fxent_dw_ref)(
        h, w, labels, lse, coef)
    assert got.dtype == dtype and got.shape == ref.shape
    if dtype == torch.float32:
        assert (got - ref).abs().max().item() <= 1e-4
    elif needs == "dh":
        assert _row_rel_err(got, ref) <= 2.0 ** -6
    else:
        assert _col_rel_err(got, ref) <= 2.0 ** -6


def test_zero_bubble_splits_the_head_kernels_on_the_card(dev):
    """transformer_t (T 32, vocab 64; head dim 8 takes the plain
    attention, the fused head D 32 its kernels) under gpipe zero-bubble
    on two stages of the one card: dh and dW launch once per microbatch
    each, and the step's loss and parameters agree with the same step on
    the CPU (float32: rtol 1e-4, atol 1e-6, the kernels sum in other
    orders than the plain versions)."""
    import copy

    from ddlbench_tpu_torch.config import DatasetSpec, RunConfig
    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.parallel.pipeline_rt import (
        ScheduledPipelineStrategy)

    spec = DatasetSpec("tinylm", (32,), 64, 1000, 100, kind="tokens")
    cfg = RunConfig(benchmark="synthtext", arch="transformer_t",
                    strategy="gpipe", num_devices=2,
                    pipe_schedule="zero-bubble", micro_batch_size=2,
                    num_microbatches=4, compute_dtype="float32")
    model = get_model("transformer_t", spec, seed=0)
    g = torch.Generator().manual_seed(3)
    seq = torch.randint(0, 64, (8, 33), generator=g)
    x, y = seq[:, :-1], seq[:, 1:]
    out = {}
    for where in ("cpu", "cuda"):
        d = torch.device(where)
        s = ScheduledPipelineStrategy(copy.deepcopy(model).to(d), cfg,
                                      [d, d])
        s.init()
        before = (fx.fxent_dh.launches, fx.fxent_dw.launches)
        loss = float(s.train_step(x.to(d), y.to(d), 0.05)["loss"])
        launched = (fx.fxent_dh.launches - before[0],
                    fx.fxent_dw.launches - before[1])
        out[where] = (loss, s.materialize_params(), launched)
    assert out["cuda"][2] == (4, 4) and out["cpu"][2] == (0, 0)
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-4)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                               atol=1e-6)


def test_flops_profile_is_one_graph_with_the_kernels_on_and_off(dev):
    """profiler/profile.py's flops count runs on the meta device through
    the plain attention path: transformer_s on the card, whose attention
    operands the flash kernels take, gives the CPU's graph under every
    backend."""
    from ddlbench_tpu_torch.models.transformer import set_attention_backend
    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.profiler.profile import profile_model

    model = get_model("transformer_s", "synthtext", seed=0)
    want = str(profile_model(model, 2, mode="flops"))
    model = model.to(dev)
    try:
        for backend in ("flash", "xla", "auto"):
            set_attention_backend(backend)
            assert str(profile_model(model, 2, mode="flops")) == want
    finally:
        set_attention_backend("auto")


def test_time_profile_runs_the_flash_kernels(dev):
    """A time profile on the card times every block through the flash
    kernels (forward, then forward + backward) and leaves the model's
    parameters as they were."""
    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.profiler.profile import profile_model

    model = get_model("transformer_s", "synthtext", seed=0).to(dev)
    before = [p.detach().clone() for p in model.parameters()]
    f0, q0 = fa.flash_fwd.launches, fa.flash_dq.launches
    g = profile_model(model, 1, mode="time", repeats=2)
    assert fa.flash_fwd.launches - f0 == 2 * 4 * 8
    assert fa.flash_dq.launches - q0 == 4 * 8
    blocks = [n for n in g.nodes.values() if n.node_desc.startswith("block")]
    assert len(blocks) == 8 and all(
        n.forward_compute_time > 0 and n.backward_compute_time > 0
        for n in blocks)
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
