"""Train -> checkpoint -> export -> serve through the port's CLIs, on the CPU.

A tiny MobileFaceNet (512-d, the pipeline's gallery width) trains two
synthetic steps with ``tools.train_arcface``; ``tools.export_onnx``
exports its checkpoint and verifies it (cosine >= 1 - 1e-4); the file
passes ``preflight_graph``, imports bit-equal to the checkpoint's
variables, and with an exported tiny detector drives ``FacePipeline``
(as ``tests/test_onnx_export.py`` does in JAX): embeddings through the
executor within cosine 0.9999 of the trained module's, the faces equal to
the pipeline on the native modules.
"""
import numpy as np
import pytest
import torch

from scrfd_arcface_facerecognition_tpu_torch.models import arcface as TA
from scrfd_arcface_facerecognition_tpu_torch.models import scrfd as TS
from scrfd_arcface_facerecognition_tpu_torch.models.checkpoints import (
    load_inference_variables)
from scrfd_arcface_facerecognition_tpu_torch.models.init_utils import (
    seeded_init_)
from scrfd_arcface_facerecognition_tpu_torch.models.onnx_export import (
    export_scrfd)
from scrfd_arcface_facerecognition_tpu_torch.models.onnx_import import (
    import_into_module)
from scrfd_arcface_facerecognition_tpu_torch.models.onnx_proto import load_onnx
from scrfd_arcface_facerecognition_tpu_torch.models.preflight import (
    preflight_graph)
from scrfd_arcface_facerecognition_tpu_torch.models.weights import (
    _leaves, variables_from_module)
from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
    Detector, Embedder, FacePipeline)
from scrfd_arcface_facerecognition_tpu_torch.tools import (
    export_onnx, train_arcface)
from torch_cores import shared_cores  # noqa: F401

pytestmark = pytest.mark.usefixtures("shared_cores")

TINY512 = TA.ArcFaceConfig(name="tiny512", arch="mobilefacenet",
                           mbf_blocks=(1, 1, 1, 1), mbf_scale=1, emb_dim=512)
TINY_DET = TS.SCRFDConfig("tiny_det", 8, (1, 1, 1, 1), (8, 8, 16, 16),
                          neck_filters=8, head_stacks=2, head_filters=16)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("loop")
    mp = pytest.MonkeyPatch()
    mp.setitem(TA.ARCFACE_CONFIGS, "w600k_mbf", TINY512)
    try:
        ckpt = train_arcface.main([
            "--synthetic", "2", "--batch", "4", "--num-classes", "8",
            "--sample-rate", "0.5", "--lr", "0.1", "--device", "cpu",
            "--out", str(d / "ckpt")])
        onnx = export_onnx.main(["--variant", "w600k_mbf", "--checkpoint",
                                 ckpt, "--out", str(d / "rec.onnx"),
                                 "--verify", "--device", "cpu"])
    finally:
        mp.undo()
    return ckpt, onnx, d


def test_the_cli_checkpoint_exports_and_imports_bit_equal(trained):
    ckpt, onnx, _ = trained
    assert ckpt.endswith("step_2.pt")
    assert preflight_graph(onnx, "rec")
    got = dict(_leaves(import_into_module(
        lambda: TA.arcface_from_config(TINY512), load_onnx(onnx),
        (1, 3, 112, 112))))
    want = dict(_leaves(load_inference_variables(ckpt)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_the_exported_pair_drives_the_face_pipeline(trained):
    ckpt, onnx, d = trained
    det_module = seeded_init_(TS.SCRFDNet(TINY_DET), 4)
    det_path = str(d / "det.onnx")
    export_scrfd(det_module, path=det_path)
    kw = dict(input_size=(64, 64), conf_thres=0.0, pre_nms=16, max_det=2,
              device="cpu")
    variables = load_inference_variables(ckpt)
    pipes = [FacePipeline(
        detector=Detector("tiny", onnx_path=det_path, **kw),
        embedder=Embedder("tiny", onnx_path=onnx, device="cpu"),
        gallery_capacity=8, device="cpu"), FacePipeline(
        detector=Detector(config=TINY_DET,
                          variables=variables_from_module(det_module), **kw),
        embedder=Embedder(config=TINY512, variables=variables,
                          device="cpu"),
        gallery_capacity=8, device="cpu")]
    rng = np.random.default_rng(9)
    gallery = rng.normal(size=(3, 512)).astype(np.float32)
    frames = rng.integers(0, 255, size=(2, 48, 64, 3), dtype=np.uint8)
    outs = []
    for pipe in pipes:
        pipe.set_gallery(gallery, ["a", "b", "c"])
        outs.append(pipe(frames))
    graph, native = outs
    assert graph.embeddings.shape == (2, 2, 512)
    assert torch.equal(graph.valid, native.valid)
    assert bool(graph.valid.any())
    np.testing.assert_allclose(graph.boxes.numpy(), native.boxes.numpy(),
                               atol=1e-2)
    v = graph.valid
    cos = torch.nn.functional.cosine_similarity(graph.embeddings[v],
                                                native.embeddings[v])
    assert float(cos.min()) >= 0.9999
    assert torch.equal(graph.match_idx[v], native.match_idx[v])


def test_data_without_a_reader_fails_at_once(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *a, **k)

    (tmp_path / "id0").mkdir()
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(SystemExit, match="cv2"):
        train_arcface.main(["--data", str(tmp_path), "--device", "cpu"])
