"""Multi-slot dry run: one step of every sharded path at tiny shapes.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.dryrun_multichip \
        [--slots 8] [--device cpu]

The port's counterpart of the JAX repository's
``__graft_entry__.dryrun_multichip``, with its shapes and its assertions,
on ``n_slots`` slots of one device (``parallel.device_slots``; slots may
share a device, as JAX's virtual devices do):

- one ArcFace step over a ('data', 'model') mesh, DP x TP (dp = 2 from 4
  slots), the class matrix in column shards;
- the Partial FC step, 6 classes a 'model' slot, half of them sampled;
- one SCRFD step over a ('data',) mesh of every slot, BatchNorm over the
  global batch;
- ``FacePipeline`` on frames sharded over the 'data' slots;
- ``DisaggPipeline``: detection on half the slots, embedding and the
  row-sharded gallery on the other half, two batches streamed;
- ``ShardedGallery`` searches over a ('model',) mesh and over a hybrid
  ('replica', 'model') mesh.

Each asserts what JAX's asserts: finite losses, the step count at 1,
``match_sim`` of shape (n, 2), finite embeddings. Runs on the card unless
``device="cpu"``; the pipelines warp their crops with K1 there.
"""
import argparse
import sys

import numpy as np


def dryrun_multichip(n_slots: int, device=None) -> dict:
    import torch

    from .. import parallel
    from ..device import resolve_device
    from ..models.arcface import ArcFaceConfig, MobileFaceNet
    from ..models.scrfd import SCRFDConfig, SCRFDNet
    from ..parallel.sharded_gallery import RowShards
    from ..pipeline import Detector, Embedder, FacePipeline
    from ..train import (ArcFaceTrainer, SCRFDLossConfig, SCRFDTrainer,
                         synthetic_detection_batch)

    dev = resolve_device(device)
    slots = parallel.device_slots(dev, n_slots)
    first = slots[0].device
    dp = 2 if n_slots >= 4 else 1
    tp = n_slots // dp
    mesh = parallel.make_mesh((dp, tp), ("data", "model"), devices=slots)
    rng = np.random.default_rng(0)

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(
            a.transpose(0, 3, 1, 2))).to(first)

    # --- one ArcFace step, DP x TP ---------------------------------------
    cfg = ArcFaceConfig(name="dryrun", arch="mobilefacenet",
                        mbf_blocks=(1, 1, 1, 1), mbf_scale=1, emb_dim=64)
    trainer = ArcFaceTrainer(model=MobileFaceNet(cfg), num_classes=4 * tp,
                             mesh=mesh, emb_dim=64)
    state = trainer.init_state(0)
    images = nchw(rng.normal(size=(2 * dp, 112, 112, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 4 * tp, size=2 * dp)).to(first)
    state, loss = trainer.train_step(state, images, labels)
    if not np.isfinite(float(loss)):
        raise AssertionError(f"non-finite train loss: {loss}")
    if int(state.step) != 1:
        raise AssertionError(f"step {state.step} after one step")

    # --- Partial FC: sampled softmax over the sharded class matrix -------
    pfc = ArcFaceTrainer(model=MobileFaceNet(cfg), num_classes=6 * tp,
                         mesh=mesh, emb_dim=64, sample_rate=0.5)
    pfc_state = pfc.init_state(2)
    pfc_labels = torch.from_numpy(rng.integers(0, 6 * tp,
                                               size=2 * dp)).to(first)
    pfc_state, pfc_loss = pfc.train_step(pfc_state, images, pfc_labels)
    if not np.isfinite(float(pfc_loss)):
        raise AssertionError(f"non-finite Partial FC loss: {pfc_loss}")

    # --- one SCRFD step, DP over every slot ------------------------------
    det_mesh = parallel.make_mesh((n_slots,), ("data",), devices=slots)
    det_cfg = SCRFDConfig("dryrun_det", 8, (1, 1, 1, 1), (8, 8, 16, 16),
                          neck_filters=8, head_stacks=1, head_filters=16)
    det_trainer = SCRFDTrainer(model=SCRFDNet(det_cfg), mesh=det_mesh,
                               loss_cfg=SCRFDLossConfig(input_size=(64, 64)))
    det_state = det_trainer.init_state(1)
    det_images, *det_gt = synthetic_detection_batch(
        rng, batch=n_slots, input_size=(64, 64), max_gt=2)
    det_state, det_loss, det_metrics = det_trainer.train_step(
        det_state, nchw(det_images),
        *[torch.from_numpy(a).to(first) for a in det_gt])
    if not np.isfinite(float(det_loss)):
        raise AssertionError(f"non-finite det loss: {det_loss}")
    if int(det_state.step) != 1:
        raise AssertionError(f"det step {det_state.step} after one step")

    # --- the serving pipeline on frames sharded over the 'data' slots ----
    pipe = FacePipeline(
        detector=Detector(config=det_cfg, conf_thres=0.0, iou_thres=0.4,
                          pre_nms=8, max_det=2, seed=0, input_size=(64, 64),
                          device=dev),
        embedder=Embedder(config=cfg, seed=1, device=dev),
        similarity_thresh=0.3, gallery_capacity=8, device=dev)
    pipe.set_gallery(rng.normal(size=(4, cfg.emb_dim)).astype(np.float32),
                     [f"p{i}" for i in range(4)])
    frames = torch.from_numpy(rng.integers(
        0, 255, size=(n_slots, 48, 64, 3), dtype=np.uint8)).to(first)
    out = pipe(parallel.shard_frames(frames, det_mesh))
    if tuple(out.match_sim.shape) != (n_slots, 2):
        raise AssertionError(f"match_sim {tuple(out.match_sim.shape)}, "
                             f"want ({n_slots}, 2)")
    if not bool(torch.isfinite(out.embeddings).all()):
        raise AssertionError("non-finite embeddings from the sharded frames")

    # --- detect | embed disaggregated, the gallery row-sharded -----------
    if n_slots >= 2:
        pipe.set_gallery(rng.normal(size=(3, cfg.emb_dim)).astype(
            np.float32), ["a", "b", "c"])
        server = parallel.DisaggPipeline(
            pipe, *parallel.split_devices(devices=slots), shard_gallery=True)
        batches = [rng.integers(0, 255, size=(n_slots, 48, 64, 3),
                                dtype=np.uint8) for _ in range(2)]
        douts = list(server.process_stream(iter(batches), depth=1))
        if len(douts) != 2:
            raise AssertionError(f"{len(douts)} disagg outputs, want 2")
        if not bool(torch.isfinite(douts[0].embeddings).all()):
            raise AssertionError("non-finite disagg embeddings")
        if not isinstance(server._gallery_placed(), RowShards):
            raise AssertionError("the disagg gallery is not row-sharded")

    # --- sharded gallery searches ----------------------------------------
    gmesh = parallel.make_mesh((n_slots,), ("model",), devices=slots)
    gallery = rng.normal(size=(n_slots * 4, 512)).astype(np.float32)
    scores, _ = parallel.ShardedGallery(gallery, gmesh, axis="model").search(
        rng.normal(size=(3, 512)).astype(np.float32), k=5)
    if scores.shape != (3, 5) or not np.isfinite(scores).all():
        raise AssertionError(f"sharded search scores {scores.shape}")
    if n_slots >= 4:
        hmesh = parallel.make_hybrid_mesh((n_slots // 2,), ("model",),
                                          num_slices=2, devices=slots)
        s2, _ = parallel.ShardedGallery(gallery, hmesh, axis="model").search(
            rng.normal(size=(2, 512)).astype(np.float32), k=4)
        if s2.shape != (2, 4) or not np.isfinite(s2).all():
            raise AssertionError(f"hybrid-mesh search scores {s2.shape}")

    said = (f"dryrun_multichip({n_slots}) on {dev}: arcface train_step "
            f"loss={float(loss):.4f} (partial-FC loss={float(pfc_loss):.4f}), "
            f"scrfd train_step loss={float(det_loss):.4f} "
            f"(n_pos={int(det_metrics['n_pos'])}), DP inference ok, disagg "
            f"serving ok, sharded search ok on mesh {mesh.shape} + "
            f"{gmesh.shape}")
    print(said)
    return dict(loss=float(loss), pfc_loss=float(pfc_loss),
                det_loss=float(det_loss), said=said)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.slots, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
