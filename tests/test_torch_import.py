"""The port stands alone: it imports neither JAX, Flax nor the JAX package,
and its entry points never fall back to the CPU on their own."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_REPO, "scrfd_arcface_facerecognition_tpu_torch")
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
              "scrfd_arcface_facerecognition_tpu")


def test_import_leaves_no_jax_in_sys_modules():
    code = (
        "import pkgutil, sys\n"
        "import scrfd_arcface_facerecognition_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    __import__(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {_FORBIDDEN!r})\n"
        "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_of_the_port_imports_jax_flax_or_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(_PKG)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(_REPO, "chip_smoke.py"))
    assert len(files) > 15
    names = {os.path.relpath(p, _PKG) for p in files}
    for mod in ("gallery/store.py", "gallery/dedup.py", "gallery/pq.py",
                "gallery/pq_adc.py", "gallery/auto.py", "runtime/native.py",
                "ops/warp_params.py", "tools/exp_warp2.py",
                "tools/exp_pallas_conv.py", "models/onnx_proto.py",
                "models/config_from_graph.py", "models/onnx_import.py"):
        assert mod in names, mod
    for path in files:
        bad = set(_imported_roots(path)) & set(_FORBIDDEN)
        assert not bad, (path, bad)


def test_entry_points_raise_without_cuda(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch import (
        Detector, Embedder, FacePipeline, resolve_device)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (FacePipeline, Detector, Embedder,
                 lambda: resolve_device("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert resolve_device("cpu").type == "cpu"


def test_gallery_entry_points_raise_without_cuda(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch.gallery import (
        AutoGallery, GalleryStore, PQCodec, PQGallery, duplicate_groups)
    from scrfd_arcface_facerecognition_tpu_torch.gallery import dedup

    codec = PQCodec(torch.zeros((4, 16, 2)))            # on the CPU
    rows = np.eye(4, 8, dtype=np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (GalleryStore, AutoGallery, lambda: PQGallery(codec),
                 lambda: PQCodec.from_centroids(np.zeros((4, 16, 2))),
                 lambda: PQCodec.train(rows, m=4, k=2, iters=1),
                 lambda: duplicate_groups(rows, 0.9),
                 lambda: dedup.find_duplicate_pairs_blocked(rows, 0.9)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert PQGallery(codec, capacity=4, device="cpu").device.type == "cpu"


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """Checks that run before any launch (here on 'meta' tensors, which
    no kernel can take): devices other than cpu/cuda raise."""
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align_crops

    frames = torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        warp_align_crops(frames, torch.empty((1, 2, 3), device="meta"),
                         torch.empty((1,), dtype=torch.int32, device="meta"))
