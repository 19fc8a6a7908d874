"""The port stands alone: it imports neither JAX, Flax nor the JAX package,
nor cv2 at module level (the card's machine has no cv2), and its entry
points never fall back to the CPU on their own."""
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
        "new = ('apps.face_analysis', 'apps.clustering', 'apps.verification',\n"
        "       'apps.quality', 'apps.metadata_db', 'apps.json_storage',\n"
        "       'utils.config', 'runtime.microbatch', 'runtime.video',\n"
        "       'utils.drawing', 'apps.realtime', 'models.onnx_exec',\n"
        "       'models.graph_models', 'models.preflight',\n"
        "       'runtime.decode_pool', 'apps.multistream', 'apps.dualstream',\n"
        "       'apps.webui', 'apps.webapp', 'models.onnx_write',\n"
        "       'models.onnx_export', 'models.checkpoints', 'train',\n"
        "       'train.schedules', 'train.arcface_train',\n"
        "       'tools.train_arcface', 'tools.export_onnx',\n"
        "       'train.state', 'train.scrfd_train', 'train.detection_data',\n"
        "       'utils.profiling', 'tools.train_scrfd', 'parallel',\n"
        "       'parallel.mesh', 'parallel.data_parallel',\n"
        "       'parallel.sharded_gallery', 'parallel.disagg')\n"
        "bad += [m for m in new if p.__name__ + '.' + m not in sys.modules]\n"
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
                "tools/exp_pallas_conv.py", "tools/conv3x3_ablate.py",
                "tools/pq_adc_ablate.py",
                "models/onnx_proto.py",
                "models/config_from_graph.py", "models/onnx_import.py",
                "apps/face_analysis.py", "apps/clustering.py",
                "apps/verification.py", "apps/quality.py",
                "apps/metadata_db.py", "apps/json_storage.py",
                "apps/__init__.py", "utils/config.py", "utils/__init__.py",
                "runtime/microbatch.py", "runtime/video.py",
                "runtime/__init__.py", "utils/drawing.py",
                "apps/realtime.py", "models/onnx_exec.py",
                "models/graph_models.py", "models/preflight.py",
                "runtime/decode_pool.py", "apps/multistream.py",
                "apps/dualstream.py", "apps/webui.py", "apps/webapp.py",
                "models/onnx_write.py", "models/onnx_export.py",
                "models/checkpoints.py", "train/__init__.py",
                "train/schedules.py", "train/arcface_train.py",
                "tools/train_arcface.py", "tools/export_onnx.py",
                "train/state.py", "train/scrfd_train.py",
                "train/detection_data.py", "utils/profiling.py",
                "tools/train_scrfd.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/data_parallel.py",
                "parallel/sharded_gallery.py", "parallel/disagg.py"):
        assert mod in names, mod
    for path in files:
        bad = set(_imported_roots(path)) & set(_FORBIDDEN)
        assert not bad, (path, bad)


def _module_level_roots(path):
    """The roots a module imports when it is imported: every import
    statement outside a function body."""
    tree = ast.parse(open(path).read(), path)

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                for a in child.names:
                    yield a.name.split(".")[0]
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module.split(".")[0]
            yield from walk(child)
    return set(walk(tree))


def test_no_module_of_the_port_imports_cv2_at_module_level():
    files = [os.path.join(d, f) for d, _, fs in os.walk(_PKG)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(_REPO, "chip_smoke.py"))
    for path in files:
        assert "cv2" not in _module_level_roots(path), path
    # the loader, the video opener, the drawing and the realtime app's
    # reader / writer / display keep their cv2 inside functions
    for mod in (("apps", "clustering.py"), ("runtime", "video.py"),
                ("utils", "drawing.py"), ("apps", "realtime.py"),
                ("apps", "dualstream.py"), ("apps", "webapp.py"),
                ("train", "detection_data.py")):
        src = os.path.join(_PKG, *mod)
        assert "cv2" in set(_imported_roots(src)), mod
        assert "cv2" not in _module_level_roots(src), mod
    code = ("import sys\n"
            "import scrfd_arcface_facerecognition_tpu_torch.apps\n"
            "import scrfd_arcface_facerecognition_tpu_torch.runtime\n"
            "import scrfd_arcface_facerecognition_tpu_torch.utils\n"
            "print('cv2' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False", out.stdout


def test_the_decode_pool_and_the_runtime_import_without_torch():
    """A fresh interpreter importing the decode pool (what a decode
    worker imports) or the runtime package loads no torch; the package's
    exports still load on first use."""
    code = ("import sys\n"
            "import scrfd_arcface_facerecognition_tpu_torch.runtime.decode_pool\n"
            "import scrfd_arcface_facerecognition_tpu_torch.runtime as r\n"
            "print('torch' in sys.modules, hasattr(r, 'DecodePool'))\n"
            "from scrfd_arcface_facerecognition_tpu_torch import FacePipeline\n"
            "import scrfd_arcface_facerecognition_tpu_torch as p\n"
            "print('torch' in sys.modules, FacePipeline.__name__,\n"
            "      set(p.__all__) <= set(dir(p)))\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["False True",
                                          "True FacePipeline True"], out.stdout


def test_parallel_package_loads_its_exports_lazily_and_raises_without_cuda(
        monkeypatch):
    """``parallel`` has the JAX package's exports, imports no torch until
    one is used, and its mesh helpers take the CUDA cards by default: with
    none they raise, they never mesh over the CPU on their own."""
    code = ("import sys\n"
            "import scrfd_arcface_facerecognition_tpu_torch.parallel as p\n"
            "print('torch' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False"], out.stdout
    from scrfd_arcface_facerecognition_tpu import parallel as jpar
    from scrfd_arcface_facerecognition_tpu_torch import parallel
    from scrfd_arcface_facerecognition_tpu_torch.parallel import Slot

    assert set(jpar.__all__) <= set(parallel.__all__)
    for name in parallel.__all__:
        assert getattr(parallel, name) is not None, name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    card = [Slot(0, torch.device("cuda", 0)), Slot(1, torch.device("cuda",
                                                                   0))]
    for make in (parallel.make_mesh, parallel.split_devices,
                 parallel.card_slots,
                 lambda: parallel.make_hybrid_mesh((1,), ("model",)),
                 lambda: parallel.device_slots("cuda", 4),
                 lambda: parallel.make_mesh(devices=card),
                 lambda: parallel.DisaggPipeline(object(), card[:1],
                                                 card[1:])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert parallel.local_device_count() == 0


def test_package_exports_are_the_same_names_loaded_lazily():
    import scrfd_arcface_facerecognition_tpu_torch as p
    from scrfd_arcface_facerecognition_tpu_torch import apps, gallery, pipeline

    assert sorted(p.__all__) == sorted([
        "resolve_device", "FacePipeline", "Detector", "Embedder",
        "AutoGallery", "GalleryStore", "FaceAnalysis", "SmartFaceEngine",
        "FaceComparison"])
    assert p.FacePipeline is pipeline.FacePipeline
    assert p.GalleryStore is gallery.GalleryStore
    assert p.SmartFaceEngine is apps.SmartFaceEngine
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        p.nope
    from scrfd_arcface_facerecognition_tpu_torch import runtime

    assert hasattr(runtime, "DecodePool")
    for name in ("WebApp", "make_server", "run_web_server", "multistream",
                 "dualstream", "webapp"):
        assert hasattr(apps, name), name


def test_entry_points_raise_without_cuda(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch import (
        Detector, Embedder, FaceAnalysis, FaceComparison, FacePipeline,
        SmartFaceEngine, ops, resolve_device)
    from scrfd_arcface_facerecognition_tpu_torch.apps import (
        dualstream, multistream, realtime, run_web_server)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    weights = ["--det-weight", "det_500m.onnx", "--rec-weight",
               "w600k_mbf.onnx"]
    multi_args = multistream.parse_args(["--sources", "a.mp4"] + weights)
    dual_args = dualstream.parse_args(["--source1", "a.mp4", "--source2",
                                       "b.mp4"] + weights)
    # the app builds its pipeline (on the card) before it opens anything
    app_args = realtime.parse_args(["--det-weight", "det_500m.onnx",
                                    "--rec-weight", "w600k_mbf.onnx",
                                    "--source", "missing.mp4"])
    from scrfd_arcface_facerecognition_tpu_torch.models import (
        build_arcface, onnx_model)
    from scrfd_arcface_facerecognition_tpu_torch.models.scrfd import (
        build_scrfd)
    from scrfd_arcface_facerecognition_tpu_torch.train import (
        ArcFaceTrainer, SCRFDTrainer)
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        export_onnx, train_arcface, train_scrfd)

    for make in (FacePipeline, Detector, Embedder, FaceAnalysis,
                 lambda: Detector(onnx_path="det_500m.onnx"),
                 lambda: Embedder(onnx_path="w600k_mbf.onnx"),
                 lambda: FacePipeline(det_onnx="det_500m.onnx",
                                      rec_onnx="w600k_mbf.onnx"),
                 lambda: FaceAnalysis(det_onnx="det_500m.onnx",
                                      rec_onnx="w600k_mbf.onnx"),
                 lambda: onnx_model("det_500m.onnx"),
                 lambda: SmartFaceEngine(config={}, app=object()),
                 lambda: FaceComparison(config={}, app=object(),
                                        log_file=None),
                 lambda: resolve_device("cuda"),
                 lambda: ops.anchor_centers(4, 4, 8),
                 lambda: ops.scrfd_anchor_table((64, 64)),
                 lambda: realtime.run(app_args),
                 lambda: multistream.run(multi_args),
                 lambda: dualstream.run(dual_args),
                 lambda: run_web_server(port=0),
                 lambda: ArcFaceTrainer(model=build_arcface("w600k_mbf"),
                                        num_classes=4),
                 lambda: train_arcface.main(["--synthetic", "1"]),
                 lambda: SCRFDTrainer(model=build_scrfd("det_500m")),
                 lambda: train_scrfd.main(["--synthetic", "1"]),
                 lambda: export_onnx.main(["--variant", "w600k_mbf",
                                           "--out", os.devnull])):
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
