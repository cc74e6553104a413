"""The port's native trajectory store (`metaworld_tpu_torch.native`) against
the JAX package's (`metaworld_tpu.native`): the same framing byte for byte,
files written by either package read bit for bit by the other, the ring's
drop count, and the port's build in its own `_build/` directory."""

import numpy as np
import pytest
import torch

from metaworld_tpu import native as jnative
from metaworld_tpu_torch import native
from metaworld_tpu_torch.physics import _build


def _records(n=6):
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        out.append({
            "obs": rng.standard_normal((8, 39)).astype(np.float32),
            "action": rng.uniform(-1, 1, (8, 4)).astype(np.float32),
            "reward": np.full(8, float(i)),
            "done": rng.uniform(size=8) > 0.5,
            "step": np.array(i, dtype=np.int64),       # 0-d
            "ids": np.arange(6, dtype=np.int32).reshape(2, 3)[:, ::2],  # strided
        })
    return out


def _framed(rec):
    """What the framing stores: each array made contiguous, a 0-d array
    as shape (1,) (numpy's ascontiguousarray; both packages alike)."""
    return {k: np.ascontiguousarray(v) for k, v in rec.items()}


def _assert_same(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


def test_pack_bytes_equal_the_jax_pack():
    for rec in _records(3):
        assert native._pack(rec) == jnative._pack(rec)
        _assert_same(native._unpack(native._pack(rec)),
                     jnative._unpack(jnative._pack(rec)))
        _assert_same(native._unpack(native._pack(rec)), _framed(rec))


def test_tensors_pack_as_their_arrays():
    rec = _records(1)[0]
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in rec.items()}
    assert native._pack(tensors) == jnative._pack(rec)


@pytest.mark.parametrize("writer, reader", [
    ("port", "jax"), ("jax", "port"), ("port", "port")])
def test_files_cross_read_bit_for_bit(tmp_path, writer, reader):
    recs = _records()
    path = tmp_path / "d.ts"
    W = native.TrajectoryWriter if writer == "port" else jnative.TrajectoryWriter
    R = native.TrajectoryReader if reader == "port" else jnative.TrajectoryReader
    with W(str(path), capacity_mb=4) as w:
        for rec in recs:
            assert w.write(rec)
        w.flush()
        stats = w.stats()
    assert stats["pushed"] == len(recs) and stats["dropped"] == 0
    assert stats["bytes_written"] == path.stat().st_size
    back = list(R(str(path)))
    assert len(back) == len(recs)
    for a, b in zip(recs, back):
        _assert_same(_framed(a), b)


def test_full_ring_counts_a_drop(tmp_path):
    big = {"obs": np.zeros(300_000, np.float32)}  # 1.2 MB into a 1 MiB ring
    small = {"obs": np.zeros(10, np.float32)}
    with native.TrajectoryWriter(str(tmp_path / "d.ts"), capacity_mb=1) as w:
        assert not w.write(big)
        assert w.write(small)
        w.flush()
        stats = w.stats()
    assert stats == {"pushed": 1, "dropped": 1,
                     "bytes_written": 16 + len(native._pack(small))}
    assert len(list(native.TrajectoryReader(str(tmp_path / "d.ts")))) == 1


def test_bad_path_and_corrupt_file_raise(tmp_path):
    with pytest.raises(OSError):
        native.TrajectoryWriter(str(tmp_path / "missing" / "d.ts"))
    bad = tmp_path / "bad.ts"
    bad.write_bytes(b"\0" * 32)
    with pytest.raises(ValueError):
        list(native.TrajectoryReader(str(bad)))


def test_store_builds_into_the_ports_build_dir():
    lib = _build.build_gxx("libmw_trajstore", [native.SOURCE], native.SOURCE,
                           native.GXX_FLAGS)
    assert lib.parent == _build.BUILD
    assert native.SOURCE.parent.parent == _build.PKG
    assert native.SOURCE.read_text() != ""
