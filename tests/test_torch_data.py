"""The port's real-data path held against the JAX reference on the CPU.

* The native loader (the same C++ source, built by each package its own
  way) yields the same bytes for the same store and seed, shuffled and
  not, across an epoch boundary; both generators write the same store.
* The MNIST IDX, CIFAR-10 pickle and ImageFolder imports and the digits
  export write byte-equal files.
* ``threefry.split``, ``randint`` and ``bernoulli`` equal ``jax.random``'s
  bit for bit over several keys, shapes and spans.
* ``OnDiskData`` batches equal the reference's: the augmented uint8 batch
  bitwise, the normalised float32 batch exactly (the port's is NCHW), for
  cifar10 (pad-crop + flip), imagenet (flip) and mnist (none), and the
  normalisation table equals the reference's jitted formula on every
  byte. Three planted faults (the flip over H, an exclusive randint upper
  bound, the key per (epoch, step) pair) must change the batch.
* The prefetcher keeps order, counts the stall, re-raises a producer's
  exception within a time limit, joins its thread on close, and a batch
  stays as it was after ``depth + 2`` further batches, where the loader's
  ring handed over without a copy would not.
* A missing PIL and a failed loader build raise.
"""

import gzip
import itertools
import json
import os
import pickle
import struct
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddlbench_tpu.config import DATASETS as JAX_DATASETS
from ddlbench_tpu.config import DatasetSpec as JaxSpec
from ddlbench_tpu.data import digits as jdigits
from ddlbench_tpu.data import imagefolder as jimf
from ddlbench_tpu.data import native_loader as jnl
from ddlbench_tpu.data.ondisk import OnDiskData as JaxOnDisk
from ddlbench_tpu.data.ondisk import _augment_u8, _normalize

from ddlbench_tpu_torch.config import DATASETS, DatasetSpec
from ddlbench_tpu_torch.data import digits as tdigits
from ddlbench_tpu_torch.data import imagefolder as timf
from ddlbench_tpu_torch.data import native_loader as tnl
from ddlbench_tpu_torch.data import ondisk
from ddlbench_tpu_torch.data.prefetch import Prefetcher
from ddlbench_tpu_torch.ops import threefry

pytestmark = pytest.mark.torchport

CPU = torch.device("cpu")
TINY = dict(name="tinyset", image_size=(8, 8, 3), num_classes=5,
            train_size=40, test_size=16)


def _files_equal(a, b, names=("images.bin", "labels.bin")):
    for n in names:
        assert open(os.path.join(a, n), "rb").read() == \
            open(os.path.join(b, n), "rb").read(), n


def _meta(d):
    meta = json.load(open(os.path.join(d, "meta.json")))
    meta.pop("source", None)
    return meta


# ---- the native loader ----------------------------------------------------

@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The same tiny store written by both generators."""
    root = tmp_path_factory.mktemp("stores")
    out = {}
    for pkg, mod, spec in (("jax", jnl, JaxSpec(**TINY)),
                           ("port", tnl, DatasetSpec(**TINY))):
        out[pkg] = mod.generate_dataset(str(root / pkg), spec, "train",
                                        seed=7, threads=2)
    return out


def test_generators_write_the_same_store(stores):
    _files_equal(stores["jax"], stores["port"])
    assert _meta(stores["jax"]) == _meta(stores["port"])


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_yields_the_reference_bytes(stores, shuffle):
    """16-row batches over a 40-sample store: the third batch starts the
    next epoch (a fresh shuffle); seven batches cross two boundaries."""
    jl = jnl.NativeDataLoader(stores["jax"], 16, seed=3, shuffle=shuffle)
    tl = tnl.NativeDataLoader(stores["port"], 16, seed=3, shuffle=shuffle)
    assert tl.steps_per_epoch == jl.steps_per_epoch == 2
    arrays = (np.empty((16, 8, 8, 3), np.uint8), np.empty(16, np.int32))
    try:
        for i in range(7):
            ji, jy = (a.copy() for a in jl.next())
            if i % 2:  # tensors and numpy arrays take the batch alike
                ti, ty = tl.next(into=(torch.empty(16, 8, 8, 3,
                                                   dtype=torch.uint8),
                                       torch.empty(16, dtype=torch.int32)))
                ti, ty = ti.numpy(), ty.numpy()
            else:
                ti, ty = tl.next(into=arrays)
            assert np.array_equal(ji, ti) and np.array_equal(jy, ty), i
    finally:
        jl.close()
        tl.close()


def test_loader_refuses_wrong_buffers(stores):
    tl = tnl.NativeDataLoader(stores["port"], 16, seed=3)
    try:
        with pytest.raises(ValueError, match="buffers"):
            tl.next(into=(torch.empty(16, 8, 8, 3, dtype=torch.int32),
                          torch.empty(16, dtype=torch.int32)))
        with pytest.raises(ValueError, match="buffers"):
            tl.next(into=(torch.empty(16, 8, 3, 8, dtype=torch.uint8)
                          .transpose(2, 3),
                          torch.empty(16, dtype=torch.int32)))
    finally:
        tl.close()


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    bad = tmp_path / "dataloader.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(tnl, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native loader build failed"
                       ) as err:
        tnl.build(bad)
    assert "dataloader.cpp" in str(err.value)  # g++'s own message
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="native loader build failed"):
        tnl.build(bad)


# ---- ingest ---------------------------------------------------------------

def _write_idx(root, prefix, images, labels, gz=False):
    op = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    with op(os.path.join(root, f"{prefix}-images-idx3-ubyte{suffix}"),
            "wb") as f:
        f.write(struct.pack(">BBBB3I", 0, 0, 8, 3, *images.shape))
        f.write(images.tobytes())
    with op(os.path.join(root, f"{prefix}-labels-idx1-ubyte{suffix}"),
            "wb") as f:
        f.write(struct.pack(">BBBBI", 0, 0, 8, 1, len(labels)))
        f.write(labels.tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_idx_import_is_byte_equal(tmp_path, gz):
    rng = np.random.default_rng(0)
    src = tmp_path / "src"
    src.mkdir()
    for prefix, n in (("train", 12), ("t10k", 5)):
        _write_idx(str(src), prefix,
                   rng.integers(0, 256, (n, 28, 28), dtype=np.uint8),
                   rng.integers(0, 10, n, dtype=np.uint8), gz)
    for split in ("train", "test"):
        j = jimf.import_mnist_idx(str(src), str(tmp_path / "j" / split),
                                  split, (28, 28, 1))
        t = timf.import_mnist_idx(str(src), str(tmp_path / "t" / split),
                                  split, (28, 28, 1))
        _files_equal(j, t)
        assert _meta(j) == _meta(t)


def test_cifar_import_is_byte_equal(tmp_path):
    rng = np.random.default_rng(1)
    src = tmp_path / "cifar-10-batches-py"
    src.mkdir()
    for name, n in [(f"data_batch_{i}", 3) for i in range(1, 6)] + [
            ("test_batch", 4)]:
        with open(src / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, f)
    for split in ("train", "test"):
        j = jimf.import_cifar10(str(tmp_path), str(tmp_path / "j" / split),
                                split, (32, 32, 3))
        t = timf.import_cifar10(str(tmp_path), str(tmp_path / "t" / split),
                                split, (32, 32, 3))
        _files_equal(j, t)
        assert _meta(j) == _meta(t)


def _imagefolder(root, size, mode, n_classes=3, per_class=3):
    from PIL import Image

    rng = np.random.default_rng(2)
    for c in range(n_classes):
        d = os.path.join(root, f"class_{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            arr = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
            Image.fromarray(arr, "RGB").convert(mode).save(
                os.path.join(d, f"img_{i}.png"))


@pytest.mark.parametrize("size,mode,hwc", [((28, 28), "L", (28, 28, 1)),
                                           ((40, 36), "RGB", (28, 28, 1)),
                                           ((20, 24), "RGB", (32, 32, 3))])
def test_imagefolder_import_is_byte_equal(tmp_path, size, mode, hwc):
    _imagefolder(str(tmp_path / "src"), size, mode)
    j = jimf.import_imagefolder(str(tmp_path / "src"), str(tmp_path / "j"),
                                hwc, 10)
    t = timf.import_imagefolder(str(tmp_path / "src"), str(tmp_path / "t"),
                                hwc, 10)
    _files_equal(j, t)
    assert _meta(j) == _meta(t)


def test_resolve_split_finds_the_same_layouts(tmp_path):
    """The reference's ImageFolder layout (<dir>/<name>/val/class_x)
    imported into the cache; a second call reuses it; nothing
    recognisable is None."""
    spec, jspec = DATASETS["cifar10"], JAX_DATASETS["cifar10"]
    _imagefolder(str(tmp_path / "d" / "cifar10" / "val"), (32, 32), "RGB")
    t = timf.resolve_split(str(tmp_path / "d"), spec, "test")
    assert t.endswith(os.path.join("_imported", "cifar10", "test"))
    assert timf.resolve_split(str(tmp_path / "d"), spec, "test") == t
    j = jimf.import_imagefolder(str(tmp_path / "d" / "cifar10" / "val"),
                                str(tmp_path / "j"), (32, 32, 3), 10)
    _files_equal(j, t)
    assert timf.resolve_split(str(tmp_path / "empty"), spec, "train") is None
    assert jimf.resolve_split(str(tmp_path / "empty"), jspec,
                              "train") is None
    assert [timf.normalize_split(s) for s in ("val", "Valid", "train")] == \
        ["test", "test", "train"]
    with pytest.raises(ValueError, match="unknown split"):
        timf.normalize_split("dev")


def test_missing_pil_raises_naming_it(tmp_path, monkeypatch):
    _imagefolder(str(tmp_path / "src"), (28, 28), "L")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        timf.import_imagefolder(str(tmp_path / "src"), str(tmp_path / "t"),
                                (28, 28, 1), 10)
    spec = DATASETS["mnist"]
    (tmp_path / "d" / "mnist").mkdir(parents=True)
    os.rename(tmp_path / "src", tmp_path / "d" / "mnist" / "train")
    with pytest.raises(ImportError, match="PIL"):
        ondisk.OnDiskData(str(tmp_path / "d"), spec, 4, CPU,
                          train_count=8, test_count=4)


def test_digits_export_is_byte_equal(tmp_path):
    j = jdigits.export_digits_idx(str(tmp_path / "j"))
    t = tdigits.export_digits_idx(str(tmp_path / "t"))
    _files_equal(j, t, tdigits.NAMES)


# ---- threefry -------------------------------------------------------------

KEYS = [(0, 0), (1, 3), (7, 1000), (2 ** 31 + 5, 12345)]


def _keys(seed, data):
    return (jax.random.fold_in(jax.random.key(seed), data),
            threefry.fold_in(threefry.prng_key(seed), data))


@pytest.mark.parametrize("seed,data", KEYS)
def test_split_matches_jax(seed, data):
    jk, tk = _keys(seed, data)
    for n in (2, 3):
        want = np.asarray(jax.random.key_data(jax.random.split(jk, n)))
        got = [(int(a), int(b)) for a, b in threefry.split(tk, n)]
        assert [tuple(int(v) for v in row) for row in want] == got


@pytest.mark.parametrize("seed,data", KEYS)
@pytest.mark.parametrize("shape,lo,hi", [
    ((128, 2), 0, 9), ((5,), 0, 2), ((3, 4), -3, 1000), ((7,), 5, 5),
    ((64,), 0, 70_000), ((64,), 0, 2 ** 31 - 1), ((33,), -2 ** 31,
                                                    2 ** 31 - 1)])
def test_randint_matches_jax(seed, data, shape, lo, hi):
    jk, tk = _keys(seed, data)
    want = np.asarray(jax.random.randint(jk, shape, lo, hi))
    assert np.array_equal(threefry.randint(tk, shape, lo, hi).numpy(), want)


@pytest.mark.parametrize("seed,data", KEYS)
@pytest.mark.parametrize("p,shape", [(0.5, (128,)), (0.3, (4, 5)),
                                     (0.9, (1,))])
def test_bernoulli_matches_jax(seed, data, p, shape):
    jk, tk = _keys(seed, data)
    want = np.asarray(jax.random.bernoulli(jk, p, shape))
    assert np.array_equal(threefry.bernoulli(tk, p, shape).numpy(), want)


# ---- OnDiskData -----------------------------------------------------------

def test_normalize_table_is_the_reference_formula():
    u = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    want = np.asarray(_normalize(jnp.asarray(u), jnp.zeros(1, jnp.int32),
                                 "float32")[0]).ravel()
    assert np.array_equal(ondisk.normalize_table().numpy(), want)
    want16 = np.asarray(_normalize(jnp.asarray(u), jnp.zeros(1, jnp.int32),
                                   "bfloat16")[0]).astype(np.float32)
    got16 = ondisk.normalize_table().to(torch.bfloat16).float().numpy()
    assert np.array_equal(got16, want16.ravel())


def _flip_over_h(imgs, key, pad, flip):
    k_crop, k_flip = threefry.split(key)
    m = threefry.bernoulli(k_flip, 0.5, (imgs.shape[0],))
    return torch.where(m[:, None, None, None], imgs.flip(1), imgs)


def _exclusive_randint(imgs, key, pad, flip):
    real = threefry.randint
    threefry.randint = lambda k, s, lo, hi: real(k, s, lo, hi - 1)
    try:
        return ondisk.augment_u8(imgs, key, pad, flip)
    finally:
        threefry.randint = real


AUG_CASES = {"cifar10": (32, 32, 3), "imagenet": (224, 224, 3)}


@pytest.mark.parametrize("name", sorted(AUG_CASES))
def test_augment_is_bitwise_the_reference(name):
    """B 16 over several (epoch, step) keys, against _augment_u8; the
    planted faults must differ."""
    pol = ondisk.AUGMENT[name]
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (16, *AUG_CASES[name]), dtype=np.uint8)
    faults = {"flip_over_h": _flip_over_h}
    if pol["pad"]:
        faults["exclusive_randint"] = _exclusive_randint
    caught = {f: False for f in faults}
    for epoch, step, steps in ((0, 0, 5), (1, 3, 5), (2, 4, 7), (7, 0, 1)):
        jkey = jax.random.fold_in(jax.random.key(11), epoch * steps + step)
        want = np.asarray(_augment_u8(jnp.asarray(imgs), jkey, pol["pad"],
                                      pol["flip"]))
        key = ondisk.augment_key(11, epoch, steps, step)
        got = ondisk.augment_u8(torch.from_numpy(imgs), key, **pol)
        assert got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), want), (epoch, step)
        for f, fn in faults.items():
            caught[f] |= not np.array_equal(
                fn(torch.from_numpy(imgs), key, **pol).numpy(), want)
    assert all(caught.values()), caught
    # the key is per epoch * steps + step: (1, 0) with 5 steps is (0, 5)
    assert torch.equal(
        torch.stack(ondisk.augment_key(11, 1, 5, 0)),
        torch.stack(ondisk.augment_key(11, 0, 5, 5)))
    assert not torch.equal(
        torch.stack(ondisk.augment_key(11, 1, 5, 0)),
        torch.stack(ondisk.augment_key(11, 0, 7, 1)))


@pytest.mark.parametrize("name,B", [("cifar10", 8), ("imagenet", 2),
                                    ("mnist", 8)])
def test_ondisk_batches_equal_the_reference(tmp_path, name, B):
    """Both packages over the stores each generates (byte-equal), three
    training batches and one test batch: labels equal, the float32 batch
    exactly equal (NHWC against the port's NCHW)."""
    spec, jspec = DATASETS[name], JAX_DATASETS[name]
    kw = dict(train_count=3 * B, test_count=B)
    jd = JaxOnDisk(str(tmp_path / "j"), jspec, B, seed=5, **kw)
    td = ondisk.OnDiskData(str(tmp_path / "t"), spec, B, CPU, seed=5, **kw)
    try:
        assert td.steps_per_epoch() == jd.steps_per_epoch() == 3
        for epoch, step, train in ((1, 0, True), (1, 1, True), (1, 2, True),
                                   (1, 0, False)):
            jx, jy = jd.batch(epoch, step, train=train)
            tx, ty = td.batch(epoch, step, train=train)
            assert tx.shape == (B, *np.moveaxis(np.asarray(jx), -1,
                                               1).shape[1:])
            assert tx.dtype == torch.float32 and ty.dtype == torch.int64
            assert np.array_equal(ty.numpy(), np.asarray(jy))
            assert np.array_equal(tx.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jx)), (epoch, step, train)
    finally:
        jd.close()
        td.close()


def test_ondisk_compute_dtype_and_no_augment(tmp_path):
    spec = DATASETS["cifar10"]
    kw = dict(train_count=8, test_count=4, seed=2)
    a = ondisk.OnDiskData(str(tmp_path), spec, 4, CPU, **kw)
    b = ondisk.OnDiskData(str(tmp_path), spec, 4, CPU, augment=False,
                          dtype=torch.bfloat16, **kw)
    try:
        imgs, labels = a.raw()
        imgs2, labels2 = b.raw()
        assert torch.equal(imgs, imgs2) and torch.equal(labels, labels2)
        x = b.prepare(imgs2, labels2, 0, 0)[0]
        assert x.dtype == torch.bfloat16
        plain = ondisk.normalize_table()[imgs.long()].permute(0, 3, 1, 2)
        assert torch.equal(x, plain.to(torch.bfloat16))
        assert not torch.equal(a.prepare(imgs, labels, 0, 0)[0], plain)
    finally:
        a.close()
        b.close()


def test_ondisk_refuses_token_stores_and_wrong_shapes(tmp_path):
    # token stores are ported: a generated synthtext store serves the two
    # next-token shifts of each sample's ids
    toks = ondisk.OnDiskData(str(tmp_path), DATASETS["synthtext"], 2, CPU,
                             train_count=4, test_count=2)
    try:
        x, y = toks.batch(0, 0)
        assert x.shape == y.shape == (2, 1024) and x.dtype == torch.int64
        assert torch.equal(x[:, 1:], y[:, :-1])
        assert 0 <= int(x.min()) and int(x.max()) < 32_768
    finally:
        toks.close()
    tnl.generate_dataset(str(tmp_path), DatasetSpec(
        "cifar10", (16, 16, 3), 10, 8, 8), "train", count=8)
    with pytest.raises(ValueError, match="shape"):
        ondisk.OnDiskData(str(tmp_path), DATASETS["cifar10"], 2, CPU)


# ---- the prefetcher -------------------------------------------------------

class _Source:
    """Batches (epoch, step) as tensors, with an optional delay and a step
    that raises."""

    device = CPU

    def __init__(self, steps=6, delay=0.0, fail_at=None):
        self.steps, self.delay, self.fail_at = steps, delay, fail_at

    def steps_per_epoch(self, train=True):
        return self.steps

    def batch(self, epoch, step, train=True):
        if step == self.fail_at:
            raise ValueError(f"bad batch {step}")
        time.sleep(self.delay)
        return torch.tensor([epoch, step]), torch.tensor([int(train)])


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_prefetcher_keeps_order_and_joins(depth):
    """Two epochs, then eight streams consumed at once, with the
    interpreter switching threads every microsecond: each stream's
    batches in order, every producer joined."""
    before = threading.active_count()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        p = Prefetcher(_Source(), depth=depth)
        for epoch in (1, 2):
            got = [(int(x[0]), int(x[1]), int(y[0]))
                   for x, y in p.stream(epoch, train=epoch == 1)]
            assert got == [(epoch, s, int(epoch == 1)) for s in range(6)]
        streams = [Prefetcher(_Source(steps=50), depth=depth).stream(e)
                   for e in range(8)]
        got = [[] for _ in streams]
        for _ in range(50):
            for i, stream in enumerate(streams):
                got[i].append(int(next(stream)[0][1]))
        assert got == [list(range(50))] * 8
        for stream in streams:
            stream.close()
    finally:
        sys.setswitchinterval(interval)
    assert threading.active_count() == before


def test_prefetcher_counts_the_stall():
    """A source slower than the step: the loop waits about the source's
    time per batch; a fast source ahead of a slow step: about none."""
    slow = Prefetcher(_Source(steps=4, delay=0.05), depth=2).stream(1)
    for _ in slow:
        pass
    assert slow.stall_s >= 0.15 and slow.stall_ms == slow.stall_s * 1e3
    fast = Prefetcher(_Source(steps=4), depth=2).stream(1)
    for _ in fast:
        time.sleep(0.05)
    assert fast.stall_s < 0.05
    inline = Prefetcher(_Source(steps=3, delay=0.02), depth=0).stream(1)
    for _ in inline:
        pass
    assert inline.stall_s >= 0.06


@pytest.mark.parametrize("depth", [0, 2])
def test_producer_exception_reaches_the_consumer(depth):
    before = threading.active_count()
    stream = Prefetcher(_Source(fail_at=3), depth=depth).stream(1)
    t0 = time.monotonic()
    got = []
    with pytest.raises((RuntimeError, ValueError), match="bad batch 3"):
        for x, _ in stream:
            got.append(int(x[1]))
    assert time.monotonic() - t0 < 10
    assert got == [0, 1, 2]
    stream.close()
    assert threading.active_count() == before


def test_close_mid_epoch_joins_the_producer():
    before = threading.active_count()
    stream = Prefetcher(_Source(steps=100), depth=2).stream(1)
    next(stream)
    time.sleep(0.05)  # the producer now waits on a full queue
    stream.close()
    stream.close()
    assert threading.active_count() == before


def _copy_free(data, depth):
    """The planted fault: the reference's ring of ``max(2, depth + 1)``
    buffer pairs handed over without a copy, each pair refilled on its
    next turn."""
    loader = data._loaders["train"]
    ring = [(torch.empty(loader.shape, dtype=torch.uint8),
             torch.empty(loader.batch_size, dtype=torch.int32))
            for _ in range(max(2, depth + 1))]
    turn = itertools.count()

    def raw(train=True):
        return loader.next(into=ring[next(turn) % len(ring)])
    return raw


@pytest.mark.parametrize("depth", [1, 2])
def test_a_batch_outlives_the_loader_ring(tmp_path, depth):
    """Batch 0 of a stream, held while ``depth + 2`` more are drawn
    through the prefetcher, still equals a fresh loader's batch 0; the
    ring handed over without a copy does not."""
    spec = DATASETS["cifar10"]
    kw = dict(train_count=32, test_count=4, seed=4, augment=False)

    def held(fault):
        data = ondisk.OnDiskData(str(tmp_path), spec, 4, CPU, **kw)
        if fault:
            data.raw = _copy_free(data, depth)
        raws = []
        real = data.prepare

        def keep(imgs, labels, *a, **k):
            raws.append(imgs)
            return real(imgs, labels, *a, **k)

        data.prepare = keep
        stream = Prefetcher(data, depth=depth).stream(1)
        first = next(stream)
        for _ in range(depth + 2):
            next(stream)
        stream.close()
        data.close()
        return raws[0].clone(), first

    fresh = ondisk.OnDiskData(str(tmp_path), spec, 4, CPU, **kw)
    want = fresh.raw()[0]
    fresh.close()
    got, _ = held(False)
    assert torch.equal(got, want)
    got, _ = held(True)
    assert not torch.equal(got, want)
