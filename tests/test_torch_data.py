"""The port's shard loader (``lycoris_tpu_torch/data.py`` and its copy of
``native/loader.cpp``) against the JAX package's (``lycoris_tpu/data.py``):
shards written by the port's ``utils/safetensors_io`` in F32, F16 and BF16,
the same headers, the native epoch equal to its plain version and to the
JAX ``ShardDataset`` epoch as multisets (the native loader hands batches
over in the order its workers finish them), BF16 bits kept, the last
partial batch dropped, the errors, and a failed ``g++`` build that raises.

The JAX epochs run its numpy data plane (its native library is not asked
for), so this file never builds the JAX package's library while
``tests/test_data.py`` may be building it in another worker.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from lycoris_tpu import data as jdata
from lycoris_tpu_torch import data as tdata
from lycoris_tpu_torch.utils import safetensors_io

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
N_SHARDS, PER_SHARD, SHAPE = 3, 10, (4, 8, 8)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """{dtype name: (directory, [each item's bytes])}: 3 shards of 10 latents
    (4, 8, 8) a dtype, with a tensor of another key beside them."""
    g = torch.Generator().manual_seed(0)
    out = {}
    for name, dtype in DTYPES.items():
        d = tmp_path_factory.mktemp(f"shards_{name}")
        items = []
        for s in range(N_SHARDS):
            sd = {f"latents_{s}_{i}": torch.randn(SHAPE, generator=g).to(dtype)
                  for i in range(PER_SHARD)}
            items += [_bytes(t) for t in sd.values()]
            sd["caption_ids"] = torch.arange(7, dtype=torch.int64)
            safetensors_io.save_file(sd, str(d / f"shard-{s}.safetensors"), {"shard": str(s)})
        out[name] = (str(d), items)
    return out


def _bytes(t) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def _items(batches) -> list:
    """Each item's bytes, over torch or numpy batches."""
    out = []
    for b in batches:
        raw = b.contiguous().view(torch.uint8).numpy() if isinstance(b, torch.Tensor) else b
        out += [row.tobytes() for row in np.ascontiguousarray(raw).reshape(len(b), -1)]
    return out


def _no_jax_native(monkeypatch):
    monkeypatch.setattr(jdata._NativeLib, "get", classmethod(lambda cls: None))


@pytest.mark.parametrize("name", list(DTYPES))
def test_header_matches_jax(shards, name):
    d, _ = shards[name]
    for f in sorted(os.listdir(d)):
        path = os.path.join(d, f)
        got = tdata.parse_safetensors_header(path)
        assert got == jdata.parse_safetensors_header(path)
        shard = f[len("shard-"):-len(".safetensors")]
        assert got[1] > 8 and got[0][f"latents_{shard}_0"]["dtype"] == name
        assert got[0]["__metadata__"]["shard"] == shard


@pytest.mark.parametrize("name", list(DTYPES))
def test_native_epoch_matches_plain_and_jax(shards, name, monkeypatch):
    """The native epoch (seed 7, batch 4): the plain version's batches as a
    multiset, the JAX epoch's items as a multiset, and each record once; the
    plain version is the JAX numpy data plane batch for batch."""
    _no_jax_native(monkeypatch)
    d, items = shards[name]
    ds = tdata.ShardDataset.from_dir(d, key_prefix="latents")
    assert (len(ds), ds.shape, ds.dtype) == (30, SHAPE, DTYPES[name])
    native = list(ds.epoch(batch_size=4, seed=7))
    plain = list(ds.epoch_plain(batch_size=4, seed=7))
    jds = jdata.ShardDataset.from_dir(d, key_prefix="latents")
    jax_batches = list(jds.epoch(batch_size=4, seed=7))
    assert len(native) == len(plain) == len(jax_batches) == 7
    assert all(b.shape == (4, *SHAPE) and b.dtype == DTYPES[name] for b in native)
    assert sorted(_items([b]) for b in native) == sorted(_items([b]) for b in plain)
    assert sorted(_items(native)) == sorted(_items(jax_batches))
    assert [_items([b]) for b in plain] == [_items([b]) for b in jax_batches]
    got = _items(native)
    assert len(set(got)) == len(got) == 28 and set(got) <= set(items)


def test_bf16_bits_survive(shards):
    """BF16 batches come out as torch.bfloat16 with every item's bits, over
    a whole epoch (batch 5: 6 batches, no remainder)."""
    d, items = shards["BF16"]
    ds = tdata.ShardDataset.from_dir(d, key_prefix="latents")
    batches = list(ds.epoch(batch_size=5, seed=1, n_threads=3, queue_depth=2))
    assert all(b.dtype == torch.bfloat16 for b in batches)
    assert sorted(_items(batches)) == sorted(items)


@pytest.mark.parametrize("batch,want", [(4, 7), (5, 6), (7, 4), (30, 1), (31, 0)])
def test_drop_remainder(shards, batch, want):
    ds = tdata.ShardDataset.from_dir(shards["F32"][0], key_prefix="latents")
    native = list(ds.epoch(batch_size=batch, seed=2))
    assert len(native) == len(list(ds.epoch_plain(batch_size=batch, seed=2))) == want
    assert len(set(_items(native))) == want * batch


def test_errors(tmp_path):
    """An empty directory raises FileNotFoundError, a shard of another shape
    or dtype ValueError, as in the JAX package (which does not check dtypes)."""
    with pytest.raises(FileNotFoundError):
        tdata.ShardDataset.from_dir(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        jdata.ShardDataset.from_dir(str(tmp_path))
    safetensors_io.save_file({"latents_a": torch.zeros(SHAPE)}, str(tmp_path / "a.safetensors"))
    safetensors_io.save_file({"latents_b": torch.zeros(4, 8, 9)}, str(tmp_path / "b.safetensors"))
    with pytest.raises(ValueError, match="shape"):
        tdata.ShardDataset.from_dir(str(tmp_path))
    with pytest.raises(ValueError, match="shape"):
        jdata.ShardDataset.from_dir(str(tmp_path))
    os.remove(tmp_path / "b.safetensors")
    safetensors_io.save_file({"latents_c": torch.zeros(SHAPE, dtype=torch.float16)},
                             str(tmp_path / "c.safetensors"))
    with pytest.raises(ValueError, match="dtype"):
        tdata.ShardDataset.from_dir(str(tmp_path))


def test_failed_build_raises(shards, tmp_path, monkeypatch):
    """With no library built and ``g++`` failing, the epoch raises (there is
    no fallback); the library is built under ``build/``, never in the
    package directory."""
    assert tdata.build().parent == tdata.BUILD_DIR
    assert tdata.BUILD_DIR.parts[-2:] == ("build", "native")
    assert sorted(os.listdir(tdata.SOURCE.parent)) == ["loader.cpp"]

    def failing(cmd, **kw):
        assert cmd[0] == "g++"
        return subprocess.CompletedProcess(cmd, 1, "", "loader.cpp: error: no compiler")

    monkeypatch.setattr(tdata.subprocess, "run", failing)
    monkeypatch.setattr(tdata, "BUILD_DIR", tmp_path / "build" / "native")
    monkeypatch.setattr(tdata, "_LIB", None)
    ds = tdata.ShardDataset.from_dir(shards["F32"][0], key_prefix="latents")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        next(ds.epoch(batch_size=4))
    assert not any((tmp_path / "build" / "native").iterdir())
