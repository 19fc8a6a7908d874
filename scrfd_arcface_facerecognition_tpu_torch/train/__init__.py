"""Training on one card: the ArcFace embedder trainer (margin softmax with
Partial FC, optax's clipped SGD with momentum written out, BN statistics
as Flax moves them, per-block remat) and its learning-rate schedules.
The SCRFD detector's trainer and the multi-device trainers are not
ported yet."""

from .arcface_train import (
    ArcFaceTrainer, TrainState, arcface_margin_logits, evaluate_embedder,
    partial_fc_from_scores, partial_fc_sample, softmax_xent, state_gaps,
    state_parts, state_tensors, verification_metrics,
)
from .schedules import make_lr_schedule

__all__ = ["ArcFaceTrainer", "TrainState", "arcface_margin_logits",
           "partial_fc_from_scores", "partial_fc_sample",
           "verification_metrics", "evaluate_embedder", "softmax_xent",
           "state_parts", "state_tensors", "state_gaps", "make_lr_schedule"]
