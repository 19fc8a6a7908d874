"""SCRFD detector training, on one card or data-parallel over a mesh: ATSS
assignment and the Quality Focal / DIoU / landmark smooth-L1 losses.

The port of the JAX package's ``train/scrfd_train.py``. It follows the
SCRFD paper's recipe (arXiv:2105.04714): Quality Focal Loss on the
scores (target: the IoU of the decoded prediction with its assigned face,
detached), DIoU on the decoded boxes, smooth-L1 on the five landmark
offsets in stride units, and an ATSS assigner (arXiv:1912.02424: the
top-k anchors by centre distance on each level, an IoU threshold of mean
+ std over those candidates, centres inside the face).

Everything is static-shape and batched: ground truth arrives as (B, M,
...) padded tensors with a validity mask, and the assignment is one dense
(B, M, N) computation over the whole batch (N anchors at the training
resolution; JAX ``vmap``s it over the images). Top-k takes ``lax.top_k``'s
tie order (``ops.nms.stable_top_k``): the two anchors of a location share
its centre, so the centre distances tie in pairs on every level. The
clips and the ``maximum`` / ``minimum`` calls are ``torch.maximum`` /
``torch.minimum``, which give half the gradient to each side of a tie as
``jnp.maximum`` and ``jnp.clip`` do (``clamp`` gives all of it to one).

The update is optax's chain, shared with the ArcFace trainer
(``state.sgd_update_``); the BatchNorm statistics move once a step, as
Flax moves them (``models/layers.py``).

``mesh=None`` trains on one device. With a ('data',) mesh the step is the
JAX trainer's sharded one, which GSPMD keeps equal to the global-batch
step: the batch splits over the slots (B must divide by them), each runs
the detector on its part in a thread of its own (``parallel.collectives``;
a copy of the weights on each other device, ``state.DataSlots``), its
BatchNorm over the global batch, ATSS on its own images; the three loss
terms' sums and their counts ``n_pos`` / ``n_kps`` are added over the
slots before the division (``scrfd_loss_sums``), so the loss and the
metrics are the whole batch's; one backward, one update. A fresh state takes the JAX
trainer's initializers (``init_detector_``), not the serving side's
``seeded_init_``. Checkpoints are ``torch.save`` files of the detector's
Flax-layout ``{"params", "batch_stats"}`` tensors, which
``models.checkpoints.load_inference_variables`` and ``tools.export_onnx
--checkpoint`` read.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import math
import os
from typing import (Any, Dict, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.checkpoints import tensor_tree
from ..models.layers import set_compute_dtype
from ..models.scrfd import SCRFDHead
from ..models.weights import variables_from_module
from ..ops.anchors import (SCRFD_NUM_ANCHORS, SCRFD_STRIDES,
                           _anchor_centers_np)
from ..ops.decode import distance2bbox
from ..ops.nms import stable_top_k
from ..parallel.collectives import ordered_sum
from ..stages import span
from .state import (DataSlots, check_trainable, module_from, placed_module,
                    sgd_update_)

# the JAX head's initializers (models/scrfd.py): N(0, 0.01^2) kernels on the
# cls / box / kps convs, the cls bias at the prior p = 0.01
HEAD_STD = 0.01
CLS_PRIOR_BIAS = -4.595


def _maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.maximum(x, x.new_full((), c))


def _minimum(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.minimum(x, x.new_full((), c))


# --------------------------------------------------------------------------
# geometry helpers
# --------------------------------------------------------------------------

def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., M, 4) x (..., N, 4) -> (..., M, N) IoU (x1y1x2y2, no +1)."""
    x1 = torch.maximum(boxes1[..., :, None, 0], boxes2[..., None, :, 0])
    y1 = torch.maximum(boxes1[..., :, None, 1], boxes2[..., None, :, 1])
    x2 = torch.minimum(boxes1[..., :, None, 2], boxes2[..., None, :, 2])
    y2 = torch.minimum(boxes1[..., :, None, 3], boxes2[..., None, :, 3])
    inter = _maximum(x2 - x1, 0.0) * _maximum(y2 - y1, 0.0)
    a1 = ((boxes1[..., 2] - boxes1[..., 0])
          * (boxes1[..., 3] - boxes1[..., 1]))[..., :, None]
    a2 = ((boxes2[..., 2] - boxes2[..., 0])
          * (boxes2[..., 3] - boxes2[..., 1]))[..., None, :]
    return inter / _maximum(a1 + a2 - inter, 1e-9)


def diou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distance-IoU loss per box pair (..., 4) -> (...)."""
    x1 = torch.maximum(pred[..., 0], target[..., 0])
    y1 = torch.maximum(pred[..., 1], target[..., 1])
    x2 = torch.minimum(pred[..., 2], target[..., 2])
    y2 = torch.minimum(pred[..., 3], target[..., 3])
    inter = _maximum(x2 - x1, 0.0) * _maximum(y2 - y1, 0.0)
    ap = (pred[..., 2] - pred[..., 0]) * (pred[..., 3] - pred[..., 1])
    at = (target[..., 2] - target[..., 0]) * (target[..., 3] - target[..., 1])
    iou = inter / _maximum(ap + at - inter, 1e-9)
    # squared centre distance over the squared enclosing-box diagonal
    pcx = (pred[..., 0] + pred[..., 2]) * 0.5
    pcy = (pred[..., 1] + pred[..., 3]) * 0.5
    tcx = (target[..., 0] + target[..., 2]) * 0.5
    tcy = (target[..., 1] + target[..., 3]) * 0.5
    rho2 = (pcx - tcx) ** 2 + (pcy - tcy) ** 2
    ex1 = torch.minimum(pred[..., 0], target[..., 0])
    ey1 = torch.minimum(pred[..., 1], target[..., 1])
    ex2 = torch.maximum(pred[..., 2], target[..., 2])
    ey2 = torch.maximum(pred[..., 3], target[..., 3])
    c2 = (ex2 - ex1) ** 2 + (ey2 - ey1) ** 2
    return 1.0 - iou + rho2 / _maximum(c2, 1e-9)


def quality_focal_loss(p: torch.Tensor, q: torch.Tensor,
                       beta: float = 2.0) -> torch.Tensor:
    """QFL in probability space: |q - p|^beta * BCE(p, q).

    q is the quality target (assigned IoU at positives, 0 elsewhere). The
    head emits post-sigmoid scores, so the loss clips p to (1e-6, 1 -
    1e-6) instead of working on logits."""
    p = _minimum(_maximum(p, 1e-6), 1.0 - 1e-6)
    bce = -(q * torch.log(p) + (1.0 - q) * torch.log(1.0 - p))
    return torch.abs(q - p) ** beta * bce


def smooth_l1(x: torch.Tensor, beta: float = 1.0 / 9.0) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


# --------------------------------------------------------------------------
# ATSS assignment (static shapes, the whole batch at once)
# --------------------------------------------------------------------------

def atss_assign(gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                centers: torch.Tensor, anchor_boxes: torch.Tensor,
                level_sizes: Sequence[int], topk: int = 9
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign anchors to ground-truth boxes, every image of a batch.

    gt_boxes (B, M, 4); gt_valid (B, M) bool; centers (N, 2); anchor_boxes
    (N, 4); level_sizes: anchors per FPN level (summing to N). Returns
    (assigned (B, N) int64, the face's index or -1; assigned_iou (B, N)).

    Per face and level the top-k anchors by centre distance (ties: the
    lower index) are candidates; their IoUs give the threshold mean + std;
    a candidate above it whose centre lies inside the face claims it; an
    anchor claimed by several faces goes to the one of highest IoU (ties:
    the lower face index). The assignment reads only the ground truth and
    the anchors, never the predictions.
    """
    iou = pairwise_iou(gt_boxes, anchor_boxes)                   # (B, M, N)
    gcx = (gt_boxes[..., 0] + gt_boxes[..., 2]) * 0.5
    gcy = (gt_boxes[..., 1] + gt_boxes[..., 3]) * 0.5
    dist = torch.sqrt((centers[:, 0] - gcx[..., None]) ** 2
                      + (centers[:, 1] - gcy[..., None]) ** 2)   # (B, M, N)

    # the top-k closest anchors of each level -> candidate mask (B, M, N)
    cand = []
    start = 0
    for n_l in level_sizes:
        d_l = dist[..., start:start + n_l]
        _, idx = stable_top_k(-d_l, min(topk, n_l))
        cand.append(torch.zeros_like(d_l, dtype=torch.bool).scatter_(
            -1, idx, True))
        start += n_l
    cand = torch.cat(cand, dim=-1)
    n_cand = cand.sum(dim=-1).clamp_min(1).to(iou.dtype)         # (B, M)

    # the adaptive IoU threshold: mean + std over each face's candidates
    mean = torch.where(cand, iou, 0.0).sum(dim=-1) / n_cand
    var = (torch.where(cand, (iou - mean[..., None]) ** 2, 0.0).sum(dim=-1)
           / n_cand)
    thr = mean + torch.sqrt(var)

    # the anchor's centre inside the face
    cx, cy = centers[:, 0], centers[:, 1]
    inside = ((cx >= gt_boxes[..., 0, None]) & (cx <= gt_boxes[..., 2, None])
              & (cy >= gt_boxes[..., 1, None])
              & (cy <= gt_boxes[..., 3, None]))
    pos = cand & inside & (iou >= thr[..., None]) & gt_valid[..., None]

    # an anchor claimed twice goes to the face of highest IoU
    claim_iou = torch.where(pos, iou, -1.0)                      # (B, M, N)
    best_gt = claim_iou.argmax(dim=-2)                           # (B, N)
    best_iou = claim_iou.amax(dim=-2)
    assigned = torch.where(best_iou > 0.0, best_gt,
                           torch.full_like(best_gt, -1))
    return assigned, _maximum(best_iou, 0.0)


# --------------------------------------------------------------------------
# loss over head outputs
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SCRFDLossConfig:
    input_size: Tuple[int, int] = (640, 640)
    strides: Tuple[int, ...] = tuple(SCRFD_STRIDES)
    num_anchors: int = SCRFD_NUM_ANCHORS
    num_kps: int = 5
    topk: int = 9
    anchor_scales: Tuple[float, ...] = (4.0, 8.0)  # side = stride * scale
    cls_weight: float = 1.0
    box_weight: float = 2.0
    kps_weight: float = 0.1


@functools.lru_cache(maxsize=16)
def _anchor_boxes(cfg: SCRFDLossConfig
                  ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, ...]]:
    """(centers (N, 2), boxes (N, 4), per-level sizes) as numpy f32."""
    h, w = cfg.input_size
    centers = np.concatenate([
        _anchor_centers_np(h // s, w // s, s, cfg.num_anchors)
        for s in cfg.strides])
    sides = np.concatenate([
        np.tile(np.asarray(cfg.anchor_scales[:cfg.num_anchors],
                           np.float32) * s,
                (h // s) * (w // s))
        for s in cfg.strides
    ])
    boxes = np.stack([centers[:, 0] - sides / 2, centers[:, 1] - sides / 2,
                      centers[:, 0] + sides / 2, centers[:, 1] + sides / 2],
                     axis=1)
    level_sizes = tuple((h // s) * (w // s) * cfg.num_anchors
                        for s in cfg.strides)
    return centers, boxes, level_sizes


@functools.lru_cache(maxsize=16)
def _anchor_tensors(cfg: SCRFDLossConfig, device: torch.device,
                    dtype: torch.dtype):
    """(centers, boxes, each anchor's stride (N,)) on ``device``: one upload
    per (config, device, dtype)."""
    centers, boxes, level_sizes = _anchor_boxes(cfg)
    stride_rep = np.concatenate([np.full(n_l, s, np.float32) for n_l, s in
                                 zip(level_sizes, cfg.strides)])
    return tuple(torch.from_numpy(a).to(device, dtype)
                 for a in (centers, boxes, stride_rep))


def scrfd_loss(outputs: Mapping[str, List[torch.Tensor]],
               gt_boxes: torch.Tensor, gt_kps: torch.Tensor,
               gt_valid: torch.Tensor, cfg: SCRFDLossConfig,
               gt_kps_valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total detection loss for a batch.

    outputs: the SCRFDNet head dict (per-stride lists; scores post-sigmoid,
    bbox / kps predictions in stride units). gt_boxes (B, M, 4) pixels;
    gt_kps (B, M, 5, 2); gt_valid (B, M); gt_kps_valid (B, M): faces with
    unlabeled landmarks (WIDER flag -1) keep their cls and box loss but
    leave the kps term (None: every valid face is labeled). Returns (loss,
    metrics {"cls", "box", "kps", "n_pos"}), all on the outputs' device.
    """
    return scrfd_loss_from_sums(
        scrfd_loss_sums(outputs, gt_boxes, gt_kps, gt_valid, cfg,
                        gt_kps_valid), cfg)


def scrfd_loss_from_sums(sums: Mapping[str, torch.Tensor],
                         cfg: SCRFDLossConfig
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and its metrics from ``scrfd_loss_sums``' sums and counts
    (one batch's, or a meshed step's added over its slots): each term over
    its count, at least 1."""
    n_pos = sums["n_pos"].clamp_min(1).to(sums["cls"].dtype)
    n_kps = sums["n_kps"].clamp_min(1).to(sums["cls"].dtype)
    cls_loss = sums["cls"] / n_pos
    box_loss = sums["box"] / n_pos
    kps_loss = sums["kps"] / n_kps
    loss = (cfg.cls_weight * cls_loss + cfg.box_weight * box_loss
            + cfg.kps_weight * kps_loss)
    return loss, {"cls": cls_loss, "box": box_loss, "kps": kps_loss,
                  "n_pos": sums["n_pos"]}


def scrfd_loss_sums(outputs: Mapping[str, List[torch.Tensor]],
                    gt_boxes: torch.Tensor, gt_kps: torch.Tensor,
                    gt_valid: torch.Tensor, cfg: SCRFDLossConfig,
                    gt_kps_valid: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """``scrfd_loss``'s three terms before their division: {"cls", "box",
    "kps"} summed over the batch's anchors, "n_pos" the positive anchors
    and "n_kps" those whose face has landmarks. The JAX loss divides by the
    counts of the whole batch, so a meshed step adds these over its slots
    first."""
    if gt_kps_valid is None:
        gt_kps_valid = gt_valid
    scores = torch.cat(outputs["scores"], dim=1)[..., 0]          # (B, N)
    dtype = scores.dtype
    centers, aboxes, stride_rep = _anchor_tensors(cfg, scores.device, dtype)
    level_sizes = _anchor_boxes(cfg)[2]
    dist_pred = torch.cat(outputs["bboxes"], dim=1)               # (B, N, 4)
    kps_pred = torch.cat(outputs["kps"], dim=1)                   # (B, N, 10)
    boxes_pred = distance2bbox(centers, dist_pred * stride_rep[:, None])

    assigned, _ = atss_assign(gt_boxes, gt_valid.bool(), centers, aboxes,
                              level_sizes, cfg.topk)              # (B, N)
    pos = assigned >= 0
    idx = assigned.clamp_min(0)

    # classification: QFL against the IoU of the (detached) prediction
    gt_for_anchor = torch.gather(gt_boxes, 1,
                                 idx[..., None].expand(-1, -1, 4))  # (B, N, 4)
    box_l = diou_loss(boxes_pred, gt_for_anchor)
    pred_iou = 1.0 - _minimum(_maximum(box_l, 0.0), 1.0)
    q = torch.where(pos, pred_iou.detach(), 0.0)
    cls_sum = quality_focal_loss(scores, q).sum()

    # boxes: DIoU at the positives
    box_sum = torch.where(pos, box_l, 0.0).sum()

    # keypoints: smooth-L1 on stride-normalized offsets
    b, n = idx.shape
    gt_kps_a = torch.gather(gt_kps.reshape(b, gt_kps.shape[1], -1), 1,
                            idx[..., None].expand(-1, -1, 2 * cfg.num_kps))
    tgt_off = ((gt_kps_a.reshape(b, n, cfg.num_kps, 2)
                - centers[None, :, None, :])
               / stride_rep[None, :, None, None])
    kps_off = kps_pred.reshape(b, n, cfg.num_kps, 2)
    kps_l = smooth_l1(kps_off - tgt_off).sum(dim=(-1, -2))
    # anchors whose face has no landmark labels leave the term
    kps_pos = pos & torch.gather(gt_kps_valid.bool(), 1, idx)
    return {"cls": cls_sum, "box": box_sum,
            "kps": torch.where(kps_pos, kps_l, 0.0).sum(),
            "n_pos": pos.sum(), "n_kps": kps_pos.sum()}


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------

@torch.no_grad()
def init_detector_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialize an SCRFDNet in place with the JAX trainer's distributions
    (Flax's ``SCRFDNet.init``); returns it. The head's cls / box / kps conv
    kernels N(0, 0.01^2) and the cls bias -4.595 (the prior p = 0.01: a
    fresh detector scores 0.01 everywhere); every other conv kernel He
    normal on the fan-out (``variance_scaling(2, "fan_out", "normal")``,
    std sqrt(2 / (out * kh * kw))), its bias zero; BatchNorm and GroupNorm
    the identity (running mean 0, variance 1); the per-level box scales 1.

    Draws on the CPU from ``seed`` in module order, so a seed gives the same
    weights on every device; they are not JAX's numbers."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    heads = [m for m in model.modules() if isinstance(m, SCRFDHead)]
    outs = {id(c): c for h in heads for c in (h.cls, h.box, h.kps)}
    cls_convs = {id(h.cls) for h in heads}
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            kh, kw = m.kernel_size
            std = (HEAD_STD if id(m) in outs
                   else math.sqrt(2.0 / max(m.out_channels * kh * kw, 1)))
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * std)
            if m.bias is not None:
                m.bias.fill_(CLS_PRIOR_BIAS if id(m) in cls_convs else 0.0)
        elif isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.GroupNorm)):
            m.reset_parameters()
        if isinstance(m, SCRFDHead):
            for name, p in m.named_parameters(recurse=False):
                if name.startswith("scale"):
                    p.fill_(1.0)
    return set_compute_dtype(model)     # the new weights, rounded


class SCRFDTrainState(NamedTuple):
    model: nn.Module                 # the detector: weights and BN stats
    trace: Dict[str, torch.Tensor]   # SGD momentum, a parameter name each
    step: int


@dataclasses.dataclass
class SCRFDTrainer:
    """SCRFD trainer on one device (``device``: the card unless "cpu"), or
    over the slots of a ('data',) ``mesh``, the state on the first slot's
    device.

    ``model`` is the detector's architecture (a port ``SCRFDNet`` at
    float32 compute); each state gets its own copy, in the trainer's
    ``dtype``: float32, as the JAX trainer's, or float64 for checking the
    steps (the head's outputs and the loss then stay float64 too).
    """
    model: nn.Module
    loss_cfg: SCRFDLossConfig = dataclasses.field(
        default_factory=SCRFDLossConfig)
    learning_rate: float = 0.01
    weight_decay: float = 5e-4
    # the lr warms up 0 -> learning_rate over warmup_steps, then anneals to
    # ~0 over decay_steps ("poly" or "cosine"); the defaults keep it fixed
    warmup_steps: int = 0
    decay_steps: Optional[int] = None
    lr_decay: str = "cosine"
    device: Any = None
    dtype: torch.dtype = torch.float32
    mesh: Any = None        # None: one device; else a ('data',) mesh

    def __post_init__(self):
        from .schedules import make_lr_schedule

        if self.mesh is None:
            self.device = resolve_device(self.device)
        else:
            if tuple(self.mesh.axis_names) != ("data",):
                raise ValueError(f"mesh axes {self.mesh.axis_names}: "
                                 "('data',)")
            first = self.mesh.devices.flat[0].device
            if self.device is not None and \
                    resolve_device(self.device) != first:
                raise ValueError(f"device {self.device}: a meshed trainer "
                                 f"keeps its state on the first slot's, "
                                 f"{first}")
            self.device = first
            self._data = DataSlots(self.mesh)
        check_trainable(self.model, self.dtype)
        lr = make_lr_schedule(self.learning_rate, self.warmup_steps,
                              self.decay_steps, self.lr_decay)
        self.lr = lr if callable(lr) else (lambda step: lr)
        self.last_grad_norm = None

    # ------------------------------------------------------------- setup

    def init_state(self, seed: int = 0) -> SCRFDTrainState:
        """A fresh state from ``seed``: the detector by ``init_detector_``
        (drawn on the CPU), the momentum zero, step 0."""
        model = init_detector_(copy.deepcopy(self.model), seed)
        trace = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        return self._placed(model, trace, 0)

    def state_from(self, parts: Mapping[str, Any]) -> SCRFDTrainState:
        """A state from its parts (``state.state_parts`` /
        ``weights.scrfd_train_state_from_jax``: the detector's state dict,
        the momentum by parameter name, the step)."""
        model = module_from(self.model, parts["model"], self.dtype)
        names = [n for n, _ in model.named_parameters()]
        if sorted(parts["trace"]) != sorted(names):
            raise ValueError("the momentum does not name the model's "
                             "parameters")
        return self._placed(model, dict(parts["trace"]), int(parts["step"]))

    def _placed(self, model, trace, step) -> SCRFDTrainState:
        """The state on the trainer's device and in its dtype, in tensors of
        its own (the update works in place)."""
        return SCRFDTrainState(
            model=placed_module(model, self.device, self.dtype),
            trace={k: v.detach().to(self.device, self.dtype, copy=True)
                   for k, v in trace.items()},
            step=step)

    # -------------------------------------------------------------- step

    def loss(self, state: SCRFDTrainState, images: torch.Tensor,
             gt_boxes: torch.Tensor, gt_kps: torch.Tensor,
             gt_valid: torch.Tensor, gt_kps_valid: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The step's loss and metrics (the detector in training mode: BN
        moves its running statistics once)."""
        with span("scrfd_train.forward"):
            outputs = state.model.train()(images)
        with span("scrfd_train.assign_loss"):
            return scrfd_loss(outputs, gt_boxes, gt_kps, gt_valid,
                              self.loss_cfg, gt_kps_valid=gt_kps_valid)

    def train_step(self, state: SCRFDTrainState, images, gt_boxes, gt_kps,
                   gt_valid, gt_kps_valid=None
                   ) -> Tuple[SCRFDTrainState, torch.Tensor,
                              Dict[str, torch.Tensor]]:
        """One update, in place on the state's tensors. images (B, 3, H, W)
        f32 normalized; gt_boxes (B, M, 4); gt_kps (B, M, 5, 2); gt_valid
        (B, M) bool; gt_kps_valid (B, M) bool (None: every valid face has
        landmarks). Returns (the state at step + 1, the loss before the
        update, its metrics), on the device."""
        def put(x, dtype):
            return torch.as_tensor(x).to(self.device, dtype)

        if gt_kps_valid is None:
            gt_kps_valid = gt_valid
        names, params = zip(*state.model.named_parameters())
        with torch.enable_grad():
            if self.mesh is not None:
                loss, metrics, grads = self._mesh_loss_grads(
                    state, images, gt_boxes, gt_kps, gt_valid, gt_kps_valid)
            else:
                loss, metrics = self.loss(
                    state, put(images, self.dtype), put(gt_boxes, self.dtype),
                    put(gt_kps, self.dtype), put(gt_valid, torch.bool),
                    put(gt_kps_valid, torch.bool))
                with span("scrfd_train.backward"):
                    grads = list(torch.autograd.grad(loss, params))
        with span("scrfd_train.update"):
            self.last_grad_norm = sgd_update_(
                list(params), grads, [state.trace[n] for n in names],
                self.lr(state.step), self.weight_decay)
        return (state._replace(step=state.step + 1), loss.detach(),
                {k: v.detach() for k, v in metrics.items()})

    def _mesh_loss_grads(self, state: SCRFDTrainState, images, gt_boxes,
                         gt_kps, gt_valid, gt_kps_valid):
        """The meshed step: (the global loss, its metrics, the gradients of
        the master's parameters)."""
        data = self._data
        x, boxes, kps = (data.split(a, self.dtype)
                         for a in (images, gt_boxes, gt_kps))
        valid, kvalid = (data.split(a, torch.bool)
                         for a in (gt_valid, gt_kps_valid))
        modules, replicas = data.modules(state.model)

        def slot(i):
            outputs = modules[i].train()(x[i])
            return scrfd_loss_sums(outputs, boxes[i], kps[i], valid[i],
                                   self.loss_cfg, gt_kps_valid=kvalid[i])

        with span("scrfd_train.forward_loss"):
            sums = data.run(slot)
            loss, metrics = scrfd_loss_from_sums(
                {k: ordered_sum([s[k] for s in sums], self.device)
                 for k in sums[0]}, self.loss_cfg)
        with span("scrfd_train.backward"):
            grads = data.grads(loss, state.model, replicas, [])
        return loss, metrics, grads

    # ------------------------------------------------------- checkpointing

    def save_checkpoint(self, state: SCRFDTrainState, path: str) -> None:
        """``torch.save`` of the detector's Flax-layout ``{"params",
        "batch_stats"}`` as float32 tensors (the JAX tool saves the
        variables alone, too)."""
        torch.save(tensor_tree(variables_from_module(state.model)),
                   path + ".tmp")
        os.replace(path + ".tmp", path)


def synthetic_detection_batch(rng: np.random.Generator, batch: int,
                              input_size: Tuple[int, int] = (640, 640),
                              max_gt: int = 8):
    """Random-but-plausible training batch for tests and dry runs: each
    image gets 1..max_gt square faces with 5 landmarks laid out like a
    face's. Returns numpy (images (B, H, W, 3) f32, gt_boxes, gt_kps,
    gt_valid), the same arrays as the JAX package's from the same ``rng``
    state (the trainer takes the images as NCHW)."""
    h, w = input_size
    images = rng.normal(size=(batch, h, w, 3)).astype(np.float32)
    gt_boxes = np.zeros((batch, max_gt, 4), np.float32)
    gt_kps = np.zeros((batch, max_gt, 5, 2), np.float32)
    gt_valid = np.zeros((batch, max_gt), bool)
    for b in range(batch):
        n = int(rng.integers(1, max_gt + 1))
        for m in range(n):
            side = float(rng.uniform(min(h, w) * 0.1, min(h, w) * 0.5))
            x1 = float(rng.uniform(0, w - side))
            y1 = float(rng.uniform(0, h - side))
            gt_boxes[b, m] = [x1, y1, x1 + side, y1 + side]
            # a canonical landmark layout inside the box
            rel = np.asarray([[0.3, 0.4], [0.7, 0.4], [0.5, 0.6],
                              [0.35, 0.8], [0.65, 0.8]], np.float32)
            gt_kps[b, m] = np.stack([x1 + rel[:, 0] * side,
                                     y1 + rel[:, 1] * side], axis=1)
            gt_valid[b, m] = True
    return images, gt_boxes, gt_kps, gt_valid
