"""The port's Flax checkpoint reader (``models.read_flax_msgpack``) against
``flax.serialization.msgpack_restore``: the same tree, the same keys and
every array equal bit for bit (tolerance 0), on the committed checkpoints
and on trees that reach every msgpack type Flax writes."""
import os

import numpy as np
import pytest
from flax import serialization

from scrfd_arcface_facerecognition_tpu_torch.models import read_flax_msgpack

_CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "checkpoints", "decisions")


def assert_same_tree(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want, equal_nan=True), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.mark.parametrize("name", ["det_500m.msgpack", "w600k_mbf.msgpack"])
def test_reads_the_committed_checkpoints_as_flax_does(name):
    with open(os.path.join(_CKPT, name), "rb") as f:
        data = f.read()
    want = serialization.msgpack_restore(data)
    assert set(want) == {"params", "batch_stats"}
    assert_same_tree(read_flax_msgpack(data), want)


def test_reads_every_type_flax_writes():
    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "f64": rng.normal(size=(70,)),
        "ints": {"u8": rng.integers(0, 256, (5, 2), dtype=np.uint8),
                 "i64": np.arange(-3, 300, dtype=np.int64),
                 "empty": np.zeros((0, 3), np.int32)},
        "scalars": {"np_f32": np.float32(1.5), "np_i16": np.int16(-7)},
        "python": {"small": 5, "neg": -3, "neg_big": -40_000,
                   "big": 2 ** 40, "float": 0.25, "yes": True, "no": False,
                   "none": None, "text": "x" * 40, "long": "y" * 70_000},
        "bin": b"\x00\x01" * 200,
        "nan": np.array([np.nan, np.inf, -0.0], np.float32),
        "big_map": {f"k{i}": np.full((2,), i, np.int8) for i in range(20)},
    }
    data = serialization.msgpack_serialize(tree)
    assert_same_tree(read_flax_msgpack(data),
                     serialization.msgpack_restore(data))


def test_reads_chunked_leaves(monkeypatch):
    """Leaves past Flax's chunk size arrive as chunk maps and are joined."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(300, dtype=np.float32).reshape(10, 30),
            "small": np.ones((4,), np.float32)}
    data = serialization.msgpack_serialize(tree)
    got = read_flax_msgpack(data)
    assert_same_tree(got, serialization.msgpack_restore(data))
    assert np.array_equal(got["w"], tree["w"])


def test_trailing_bytes_and_unknown_extensions_raise():
    data = serialization.msgpack_serialize({"a": np.ones(2, np.float32)})
    with pytest.raises(ValueError, match="past the tree"):
        read_flax_msgpack(data + b"\x00")
    with pytest.raises(ValueError, match="extension type 2"):
        read_flax_msgpack(serialization.msgpack_serialize({"c": 1 + 2j}))
