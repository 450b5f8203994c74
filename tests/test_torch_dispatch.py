"""The card's dispatch between the port's kernels and their plain paths,
on the CPU.

The attention and paged kernel modules each have one predicate,
``kernel_takes``, that says from devices, shapes and dtypes alone whether
its kernels take a set of tensors. On CUDA tensors, ``"auto"`` attention
takes the flash kernels exactly when the predicate holds and the plain
einsum otherwise (the reference's ``_flash_dispatch`` takes its XLA path
for shapes its kernel does not take), counting each such call; a forced
``"flash"`` raises. The serving passes dispatch the paged ops the same
way. The fused head has no plain path on the card: its wrappers raise on
what its kernels refuse. No card is needed: a stand-in that reports a CUDA
device is enough for the predicates and the dispatch functions, which
read nothing else.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import pytest
import torch

import ddlbench_tpu_torch.models.transformer as tr
import ddlbench_tpu_torch.ops.flash_attention as fa
import ddlbench_tpu_torch.ops.fused_xent as fx
import ddlbench_tpu_torch.ops.paged_decode as pd

pytestmark = pytest.mark.torchport

CUDA = torch.device("cuda", 0)
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


class OnCard:
    """Stands in for a CUDA tensor: a device, a shape, a dtype."""

    def __init__(self, shape, dtype=torch.float32, device=CUDA):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = device

    def dim(self):
        return len(self.shape)

    def numel(self):
        return self.shape.numel()


def _qkv(dh, dtype, T=16):
    return [OnCard((2, 4, T, dh), dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [8, 64])
def test_flash_kernel_takes(dh, dtype):
    want = dh == fa.KERNEL_DH and dtype != torch.float16
    assert fa.kernel_takes(*_qkv(dh, dtype)) is want
    # the same tensors on the CPU: never the kernels
    cpu = [torch.zeros(2, 4, 16, dh, dtype=dtype) for _ in range(3)]
    assert fa.kernel_takes(*cpu) is False


def test_flash_kernel_takes_refuses_mixed_operands():
    q, k, v = _qkv(64, torch.bfloat16)
    assert not fa.kernel_takes(q, OnCard(k.shape, torch.float32), v)
    assert not fa.kernel_takes(q, k, OnCard((2, 4, 8, 64), torch.bfloat16))
    assert not fa.kernel_takes(q, OnCard(k.shape, torch.bfloat16,
                                         torch.device("cpu")), v)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [8, 64])
def test_paged_kernel_takes(dh, dtype):
    """The paged kernels take a float32 query of head dim 64 over a
    float32, bfloat16 or int8 pool; the query's dtype decides here."""
    cache = {"pool_k": OnCard((9, 4, 4, dh), torch.float32)}
    want = dh == pd.KERNEL_DH and dtype == torch.float32
    assert pd.kernel_takes(OnCard((2, 4, dh), dtype), cache) is want
    for pool in (torch.bfloat16, torch.int8, torch.float16):
        cache = {"pool_k": OnCard((9, 4, 4, dh), pool)}
        assert pd.kernel_takes(OnCard((2, 4, dh)), cache) is (
            dh == pd.KERNEL_DH and pool != torch.float16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [24, 32, 512, 784])
def test_fused_head_wrappers_raise_where_the_kernels_refuse(D, dtype):
    """The fused head has no plain path on the card: each kernel wrapper
    takes a CUDA tensor to its kernel or raises, before anything builds."""
    takes = (D % 16 == 0 and D <= fx.KERNEL_MAX_D
             and dtype != torch.float16)
    lse, coef = OnCard((128,)), OnCard((3,))
    for V in (1000, 1001):  # a bfloat16 vocabulary must be a multiple of 8
        args = (OnCard((128, D), dtype), OnCard((D, V), dtype),
                OnCard((128,), torch.int32))
        if takes and (V % 8 == 0 or dtype == torch.float32):
            fx._check_kernel_args("fxent_dh", *args, lse, coef)
            continue
        for wrapper in (fx.fxent_fwd, fx.fxent_dh, fx.fxent_dw):
            with pytest.raises(ValueError):
                wrapper(*args, *(() if wrapper is fx.fxent_fwd
                                 else (lse, coef)))


@pytest.fixture
def backend():
    yield tr.set_attention_backend
    tr.set_attention_backend("auto")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_auto_takes_the_plain_path_for_head_dim_8_on_the_card(backend,
                                                              dtype):
    """transformer_t's dh 8 on CUDA: ``auto`` takes the plain einsum and
    counts the call; dh 64 takes the kernels and counts nothing."""
    backend("auto")
    before = fa.flash_attention.plain_launches
    assert tr._use_flash(*_qkv(8, dtype)) is False
    assert fa.flash_attention.plain_launches == before + 1
    assert tr._use_flash(*_qkv(64, dtype)) is True
    assert fa.flash_attention.plain_launches == before + 1


def test_forced_flash_raises_for_head_dim_8_on_the_card(backend):
    backend("flash")
    with pytest.raises(ValueError, match="flash kernels do not take"):
        tr._use_flash(*_qkv(8, torch.bfloat16))
    with pytest.raises(ValueError, match="flash kernels do not take"):
        tr._use_flash(*_qkv(64, torch.float16))
    assert tr._use_flash(*_qkv(64, torch.bfloat16)) is True


def test_dispatch_on_the_cpu_is_unchanged(backend):
    """CPU tensors: ``auto`` and ``xla`` take the einsum and ``flash`` the
    wrappers' plain versions, whatever the head dim; nothing is counted."""
    before = fa.flash_attention.plain_launches
    cpu = [torch.zeros(1, 2, 8, 8) for _ in range(3)]
    for mode, want in (("auto", False), ("xla", False), ("flash", True)):
        backend(mode)
        assert tr._use_flash(*cpu) is want
    backend("xla")
    assert tr._use_flash(*_qkv(64, torch.bfloat16)) is False
    assert fa.flash_attention.plain_launches == before


@pytest.mark.parametrize("auto,fn,plain", [
    (pd.paged_attention_auto, "paged_attention", "_paged_attention_ref"),
    (pd.paged_chunk_attention_auto, "paged_chunk_attention",
     "_paged_chunk_attention_ref"),
])
def test_paged_auto_takes_the_plain_version_where_the_kernel_refuses(
        monkeypatch, auto, fn, plain):
    """The serving passes' paged ops: a CUDA query of head dim 8 goes to the
    plain version and is counted; head dim 64 goes to the kernel wrapper."""
    calls = []

    def kernel(*args):
        calls.append("kernel")
        return "kernel"

    kernel.plain_launches = 0
    monkeypatch.setattr(pd, fn, kernel)
    monkeypatch.setattr(pd, plain, lambda *args: calls.append("plain")
                        or "plain")
    for dh, want in ((8, "plain"), (64, "kernel")):
        cache = {"pool_k": OnCard((9, 4, 4, dh))}
        assert auto(OnCard((2, 4, dh)), cache, 3, 1, 4) == want
    assert calls == ["plain", "kernel"]
    assert kernel.plain_launches == 1


def test_paged_auto_on_the_cpu_is_the_wrapper(monkeypatch):
    calls = []

    def kernel(*args):
        calls.append("wrapper")
        return "wrapper"

    kernel.plain_launches = 0
    monkeypatch.setattr(pd, "paged_attention", kernel)
    q = torch.zeros(2, 4, 8)
    assert pd.paged_attention_auto(
        q, {"pool_k": torch.zeros(9, 4, 4, 8)}, 3, 1, 4) == "wrapper"
    assert kernel.plain_launches == 0
