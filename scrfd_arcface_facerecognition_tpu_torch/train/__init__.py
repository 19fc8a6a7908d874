"""Training on one card or over a mesh, both halves of the model stack:

- the ArcFace embedder (arcface_train.py): margin softmax with Partial FC,
  BN statistics as Flax moves them, per-block remat;
- the SCRFD detector (scrfd_train.py): ATSS assignment over the whole
  batch, Quality Focal / DIoU / landmark smooth-L1 losses, the JAX
  trainer's initializers; its data (detection_data.py: WIDER annotations,
  letterboxed static-shape batches, VOC AP).

Both update with optax's clipped SGD with momentum, written out once
(state.py), on the learning-rate schedules of schedules.py. Both take a
``mesh=`` (``parallel.make_mesh``): the ArcFace step DP x TP over
('data', 'model'), the class matrix in column shards; the SCRFD step DP
over ('data',); a data slot's forward in a thread of its own, BatchNorm
over the global batch (state.py ``DataSlots``, ``parallel/collectives.py``)."""

from .arcface_train import (
    ArcFaceTrainer, TrainState, arcface_margin_logits, evaluate_embedder,
    partial_fc_from_scores, partial_fc_sample, softmax_xent,
    verification_metrics,
)
from .detection_data import (
    Annotation, average_precision, batches_from_annotations,
    evaluate_detector, letterbox_example, parse_wider_annotations,
    read_image,
)
from .schedules import make_lr_schedule
from .scrfd_train import (
    SCRFDLossConfig, SCRFDTrainer, SCRFDTrainState, atss_assign, diou_loss,
    init_detector_, pairwise_iou, quality_focal_loss, scrfd_loss, smooth_l1,
    synthetic_detection_batch,
)
from .state import sgd_update_, state_gaps, state_parts, state_tensors

__all__ = ["ArcFaceTrainer", "TrainState", "arcface_margin_logits",
           "partial_fc_from_scores", "partial_fc_sample",
           "verification_metrics", "evaluate_embedder", "softmax_xent",
           "SCRFDTrainer", "SCRFDTrainState", "SCRFDLossConfig",
           "scrfd_loss", "atss_assign", "diou_loss", "quality_focal_loss",
           "pairwise_iou", "smooth_l1", "init_detector_",
           "synthetic_detection_batch", "Annotation",
           "parse_wider_annotations", "batches_from_annotations",
           "letterbox_example", "average_precision", "evaluate_detector",
           "read_image", "sgd_update_", "state_parts", "state_tensors",
           "state_gaps", "make_lr_schedule"]
