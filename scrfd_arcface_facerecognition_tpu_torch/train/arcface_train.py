"""ArcFace margin-softmax training on one card.

The port of the JAX package's ``train/arcface_train.py`` without its mesh
(the data-parallel batch and the class-sharded matrix wait for the
multi-device slice). The loss follows the ArcFace paper: additive angular
margin m on the target class angle, scale s, logits_y = s * cos(theta_y +
m), with the stability fallback s * (cos(theta_y) - m * sin(m)) when
theta_y + m > pi. Partial FC (arXiv:2010.05222) runs each step's softmax
over the batch's positives and a sampled subset of the other classes.

The update is optax's ``chain(clip_by_global_norm(5), add_decayed_weights
(wd), sgd(lr, momentum=0.9))``, written out once for both trainers
(``state.sgd_update_``): the global norm over every trained tensor
(backbone and class matrix), decay on every tensor, the trace ``g + 0.9 *
trace``, the learning rate read at the step before the increment.
Autograd through cuDNN and cuBLAS stands where the JAX package has
``jax.value_and_grad``; the margin logits are plain matmuls there and
here, so training adds no hand-written kernel.

Checkpoints are ``torch.save`` files of tensors (not orbax directories):
the backbone in Flax layout (``weights.variables_from_module``), the class
matrix, the momentum and the step.
"""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, Dict, Iterable, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..device import resolve_device
from ..models.checkpoints import read_checkpoint, tensor_tree
from ..models.init_utils import seeded_init_
from ..models.layers import at_least_f32
from ..models.weights import (train_state_parts, variables_from_module,
                              variables_from_state_dict)
from ..ops.nms import stable_top_k
from ..ops.similarity import l2_normalize
from .state import check_trainable, module_from, placed_module, sgd_update_


def arcface_margin_logits(embeddings: torch.Tensor, w: torch.Tensor,
                          labels: torch.Tensor, s: float = 64.0,
                          m: float = 0.5) -> torch.Tensor:
    """(B, D) embeddings x (D, C) class matrix -> (B, C) margin logits, in
    float32 (float64 when the inputs are)."""
    emb_n = l2_normalize(at_least_f32(embeddings))
    w_n = l2_normalize(at_least_f32(w), dim=0)
    cos = (emb_n @ w_n).clamp(-1.0, 1.0)
    sin = (1.0 - cos * cos).clamp_min(0.0).sqrt()
    cos_m, sin_m = float(np.cos(m)), float(np.sin(m))
    phi = cos * cos_m - sin * sin_m                     # cos(theta + m)
    # the fallback for theta + m > pi
    phi = torch.where(cos > float(np.cos(np.pi - m)), phi, cos - m * sin_m)
    onehot = F.one_hot(labels.long(), w.shape[1]).bool()
    return s * torch.where(onehot, phi, cos)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0]


def partial_fc_from_scores(scores: torch.Tensor, labels: torch.Tensor,
                           num_sample: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Partial FC's class subset from one score a class (deterministic).

    Positives get 2.0 added (once for each time they occur, as JAX's
    scatter-add), so they outrank every uniform score; one top-k in
    ``lax.top_k``'s tie order (lower index first) takes ``num_sample``
    classes. Returns (idx (S,) int32, the sampled classes; new_labels (B,)
    int32, each label's position in idx; matched (B,) bool, whether the
    label made the sample: with more unique positives than S the overflow
    rows are flagged, and the loss leaves them out).
    """
    labels = labels.long()
    scores = at_least_f32(scores)
    bumped = scores.index_add(
        0, labels, torch.full(labels.shape, 2.0, dtype=scores.dtype,
                              device=scores.device))
    _, idx = stable_top_k(bumped, num_sample)
    idx = idx.int()
    match = idx[None, :] == labels[:, None]
    new_labels = match.to(torch.uint8).argmax(dim=1).int()
    return idx, new_labels, match.any(dim=1)


def _seed_of(seed: int, step: int) -> int:
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


def partial_fc_sample(labels: torch.Tensor, num_classes: int,
                      num_sample: int, seed: int, step: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial FC with uniform scores drawn on the labels' device from a
    ``torch.Generator`` seeded from ``(seed, step)``: the same sample for
    the same (seed, step) on one device (not JAX's draws)."""
    gen = torch.Generator(device=labels.device)
    gen.manual_seed(_seed_of(seed, step))
    scores = torch.rand(num_classes, generator=gen, device=labels.device)
    return partial_fc_from_scores(scores, labels, num_sample)


class TrainState(NamedTuple):
    backbone: nn.Module              # the embedder: weights and BN stats
    head_w: torch.Tensor             # (D, num_classes) class matrix
    trace: Dict[str, torch.Tensor]   # SGD momentum: a backbone parameter
                                     # name each, and "head_w"
    step: int


def _trained(state: TrainState):
    """(names, tensors) the optimizer updates, in a fixed order."""
    named = list(state.backbone.named_parameters())
    return ([n for n, _ in named] + ["head_w"],
            [p for _, p in named] + [state.head_w])


@dataclasses.dataclass
class ArcFaceTrainer:
    """ArcFace trainer on one device (``device``: the card unless "cpu").

    ``model`` is the embedder's architecture (a port ``IResNet`` /
    ``MobileFaceNet`` at float32 compute); each state gets its own copy,
    in the trainer's ``dtype``.
    """
    model: nn.Module
    num_classes: int
    margin: float = 0.5
    scale: float = 64.0
    learning_rate: float = 0.02
    weight_decay: float = 5e-4
    emb_dim: int = 512
    # Partial FC: the fraction of classes in each step's softmax (1.0 =
    # full softmax; w600k-scale training uses 0.1-0.3)
    sample_rate: float = 1.0
    seed: int = 0
    # recompute each trunk block's activations in the backward pass
    # (torch.utils.checkpoint): about one more forward of work for
    # activation memory
    remat: bool = False
    warmup_steps: int = 0
    decay_steps: Optional[int] = None
    lr_decay: str = "poly"
    device: Any = None
    # the precision of the weights, the momentum and the backbone's
    # arithmetic: float32, as the JAX trainer's; float64 checks the steps
    # where float32 rounding is amplified (the margin head computes in
    # float32 either way, as there)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        from .schedules import make_lr_schedule

        self.device = resolve_device(self.device)
        check_trainable(self.model, self.dtype)
        lr = make_lr_schedule(self.learning_rate, self.warmup_steps,
                              self.decay_steps, self.lr_decay)
        self.lr = lr if callable(lr) else (lambda step: lr)
        if not 0.0 < self.sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in (0, 1], got "
                             f"{self.sample_rate}")
        self.num_sample = max(1, int(round(self.sample_rate
                                           * self.num_classes)))
        self.last_grad_norm = None

    # ------------------------------------------------------------- setup

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """A fresh state from ``seed`` (the trainer's by default), drawn on
        the CPU so a seed gives the same state on every device: the
        backbone by ``seeded_init_``, the class matrix N(0, 0.01^2), the
        momentum zero, step 0."""
        seed = self.seed if seed is None else seed
        backbone = seeded_init_(copy.deepcopy(self.model), seed)
        gen = torch.Generator(device="cpu").manual_seed(seed + 1)
        head_w = torch.randn((self.emb_dim, self.num_classes),
                             generator=gen) * 0.01
        trace = {n: torch.zeros_like(p)
                 for n, p in backbone.named_parameters()}
        trace["head_w"] = torch.zeros_like(head_w)
        return self._placed(backbone, head_w, trace, 0)

    def state_from(self, parts: Mapping[str, Any]) -> TrainState:
        """A state from its parts (``weights.train_state_parts`` /
        ``train_state_from_jax``: a backbone state dict, ``head_w``, the
        momentum by name, the step)."""
        backbone = module_from(self.model, parts["backbone"], self.dtype)
        names = [n for n, _ in backbone.named_parameters()] + ["head_w"]
        if sorted(parts["trace"]) != sorted(names):
            raise ValueError("the momentum does not name the model's "
                             "parameters")
        head_w = torch.as_tensor(parts["head_w"])
        if tuple(head_w.shape) != (self.emb_dim, self.num_classes):
            raise ValueError(f"head_w {tuple(head_w.shape)}, want "
                             f"{(self.emb_dim, self.num_classes)}")
        return self._placed(backbone, head_w, dict(parts["trace"]),
                            int(parts["step"]))

    def _placed(self, backbone, head_w, trace, step) -> TrainState:
        """The state on the trainer's device and in its dtype, in tensors of
        its own (the update works in place)."""
        def own(t):
            return t.detach().to(self.device, self.dtype, copy=True)

        return TrainState(backbone=placed_module(backbone, self.device,
                                                 self.dtype),
                          head_w=own(head_w).requires_grad_(True),
                          trace={k: own(v) for k, v in trace.items()},
                          step=step)

    # -------------------------------------------------------------- step

    def loss(self, state: TrainState, images: torch.Tensor,
             labels: torch.Tensor, scores: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """The step's loss (the backbone in training mode: BN moves its
        running statistics once). ``scores`` (num_classes,) replaces
        Partial FC's draw."""
        emb = state.backbone.train()(images, remat=self.remat)
        if self.num_sample < self.num_classes:
            if scores is None:
                idx, new_labels, matched = partial_fc_sample(
                    labels, self.num_classes, self.num_sample, self.seed,
                    state.step)
            else:
                idx, new_labels, matched = partial_fc_from_scores(
                    scores.to(labels.device), labels, self.num_sample)
            logits = arcface_margin_logits(
                emb, state.head_w[:, idx.long()], new_labels, self.scale,
                self.margin)
            # rows whose class overflowed the sample take no gradient
            xent = softmax_xent(logits, new_labels) * matched
            return xent.sum() / matched.sum().clamp_min(1)
        logits = arcface_margin_logits(emb, state.head_w, labels,
                                       self.scale, self.margin)
        return softmax_xent(logits, labels).mean()

    def train_step(self, state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor,
                   scores: Optional[torch.Tensor] = None
                   ) -> Tuple[TrainState, torch.Tensor]:
        """One update, in place on the state's tensors. images (B, 3, H, W)
        f32 normalized; labels (B,) int. Returns (the state at step + 1,
        the loss before the update)."""
        images = torch.as_tensor(images).to(self.device, self.dtype)
        labels = torch.as_tensor(labels).to(self.device, torch.int64)
        names, params = _trained(state)
        with torch.enable_grad():
            loss = self.loss(state, images, labels, scores)
            grads = list(torch.autograd.grad(loss, params))
        self.last_grad_norm = sgd_update_(
            params, grads, [state.trace[n] for n in names],
            self.lr(state.step), self.weight_decay)
        return state._replace(step=state.step + 1), loss.detach()

    # ------------------------------------------------------- checkpointing

    def save_checkpoint(self, state: TrainState, path: str) -> None:
        """``torch.save`` of the whole state as float32 tensors: the
        backbone's Flax-layout variables, ``head_w``, the momentum in the
        same layout, the step."""
        momentum = {n: t for n, t in state.trace.items() if n != "head_w"}
        data = {
            "backbone": tensor_tree(variables_from_module(state.backbone)),
            "head_w": state.head_w.detach().to("cpu", torch.float32,
                                               copy=True),
            "trace": {
                "backbone": tensor_tree(
                    variables_from_state_dict(momentum)["params"]),
                "head_w": state.trace["head_w"].to("cpu", torch.float32,
                                                   copy=True)},
            "step": int(state.step)}
        torch.save(data, path + ".tmp")
        os.replace(path + ".tmp", path)

    def restore_checkpoint(self, path: str) -> TrainState:
        data = read_checkpoint(path)
        return self.state_from(train_state_parts(
            data["backbone"], data["head_w"], data["trace"], data["step"]))


# --------------------------------------------------------------------------
# evaluation: pairwise verification metrics (LFW-style protocol)
# --------------------------------------------------------------------------

def verification_metrics(emb1, emb2, same, far_targets=(1e-2, 1e-3)):
    """Face-verification quality of an embedder on labeled pairs.

    emb1/emb2 (N, D) embeddings of pair halves; same (N,) bool. Returns
    {accuracy, threshold, tar_at_far: {far: tar}, n_pairs}: accuracy is
    the best cosine-threshold accuracy (the LFW protocol's sweep), TAR@FAR
    reads the ROC at the requested false-accept rates.
    """
    e1 = np.asarray(emb1, np.float32)
    e2 = np.asarray(emb2, np.float32)
    # not in place: the caller's arrays stay as they were
    e1 = e1 / np.maximum(np.linalg.norm(e1, axis=1, keepdims=True), 1e-12)
    e2 = e2 / np.maximum(np.linalg.norm(e2, axis=1, keepdims=True), 1e-12)
    sims = np.sum(e1 * e2, axis=1)
    same = np.asarray(same, bool)

    n = len(sims)
    if n == 0:
        return {"accuracy": 0.0, "threshold": 0.0,
                "tar_at_far": {far: 0.0 for far in far_targets}, "n_pairs": 0}
    order = np.argsort(-sims)
    s_sorted = sims[order]
    y_sorted = same[order]
    n_pos = int(same.sum())
    n_neg = n - n_pos
    # cuts: accept the top k for k = 0..n (k=0 rejects all, the best cut
    # when every pair is negative)
    tp = np.concatenate([[0], np.cumsum(y_sorted)])
    fp = np.concatenate([[0], np.cumsum(~y_sorted)])
    acc = (tp + (n_neg - fp)) / n
    best = int(np.argmax(acc))
    # the threshold sits just above the first rejected similarity
    thr = float(s_sorted[best - 1]) if best > 0 else float(s_sorted[0] + 1e-6)
    tar_at_far = {}
    for far in far_targets:
        if n_neg == 0:
            tar_at_far[far] = float(tp[-1] / n_pos) if n_pos else 0.0
            continue
        k = int(np.searchsorted(fp / n_neg, far, side="right")) - 1
        tar_at_far[far] = float(tp[k] / n_pos) if (k >= 0 and n_pos) else 0.0
    return {"accuracy": float(acc[best]), "threshold": thr,
            "tar_at_far": tar_at_far, "n_pairs": n}


def evaluate_embedder(model: nn.Module, pairs: Iterable, batch: int = 64):
    """Embed (img1, img2, same) pairs with ``model`` in inference mode and
    score them with ``verification_metrics``. The images are (112, 112, 3)
    normalized arrays, as the JAX package's; the model takes them NCHW on
    its own device."""
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()

    @torch.no_grad()
    def embed(imgs):
        x = torch.from_numpy(np.stack(imgs).astype(np.float32))
        return model(x.permute(0, 3, 1, 2).to(dev)).cpu().numpy()

    e1s, e2s, labels = [], [], []
    buf_a, buf_b = [], []
    try:
        for a, b, s in pairs:
            buf_a.append(a)
            buf_b.append(b)
            labels.append(bool(s))
            if len(buf_a) == batch:
                e1s.append(embed(buf_a))
                e2s.append(embed(buf_b))
                buf_a, buf_b = [], []
        if buf_a:
            e1s.append(embed(buf_a))
            e2s.append(embed(buf_b))
    finally:
        model.train(was_training)
    if not e1s:
        return verification_metrics(np.zeros((0, 1)), np.zeros((0, 1)),
                                    np.zeros((0,), bool))
    return verification_metrics(np.concatenate(e1s), np.concatenate(e2s),
                                np.asarray(labels))
