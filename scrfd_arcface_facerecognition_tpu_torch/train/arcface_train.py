"""ArcFace margin-softmax training, on one card or DP x TP over a mesh.

The port of the JAX package's ``train/arcface_train.py``. The loss follows
the ArcFace paper: additive angular margin m on the target class angle,
scale s, logits_y = s * cos(theta_y + m), with the stability fallback s *
(cos(theta_y) - m * sin(m)) when theta_y + m > pi. Partial FC
(arXiv:2010.05222) runs each step's softmax over the batch's positives
and a sampled subset of the other classes.

``mesh=None`` trains on one device. With a ('data', 'model') mesh
(``parallel.make_mesh``) the step is the JAX trainer's sharded one, which
GSPMD keeps equal to the global-batch step:

- the batch splits over 'data' (B must divide by the axis); the backbone
  runs one thread a data slot (``parallel.collectives``), its BatchNorm
  over the global batch (``models/layers.py``), with a copy of the
  weights on each other device (``state.DataSlots``);
- the class matrix is padded to a multiple of the 'model' axis (the pad
  columns drawn with the rest, masked to -1e9 in the full softmax, never
  sampled, decayed as JAX's are) and split into column shards
  (``state.ColumnShards``) on the 'model' slots, with its momentum;
- the full softmax computes each (data i, shard j) block of logits on
  slot (i, j) and takes each row's log-sum-exp across the shards (the
  maximum first, then the sum of exponentials), the target logit from
  the shard that owns the label; the loss is the global mean;
- Partial FC draws once a step on the master device, as the one-device
  trainer does for the same (seed, step); each shard gives the sampled
  columns in its range, assembled in the sample's order on each data
  slot; the loss is the sum over matched rows over the global count;
- one backward from the global loss; the gradients of each device's
  copy are summed onto the master's, and the update runs once (the clip's
  norm counts each parameter and each shard once).

The update is optax's ``chain(clip_by_global_norm(5), add_decayed_weights
(wd), sgd(lr, momentum=0.9))``, written out once for both trainers
(``state.sgd_update_``): the global norm over every trained tensor
(backbone and class matrix), decay on every tensor, the trace ``g + 0.9 *
trace``, the learning rate read at the step before the increment.
Autograd through cuDNN and cuBLAS stands where the JAX package has
``jax.value_and_grad``; the margin logits are plain matmuls there and
here, so training adds no hand-written kernel.

Checkpoints are ``torch.save`` files of tensors (not orbax directories):
the backbone in Flax layout (``weights.variables_from_module``), the whole
(padded) class matrix, the momentum and the step. A checkpoint restores
onto any trainer whose class matrix has its width: a mesh that pads to
it, or one device when there is no pad.
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
from ..parallel.collectives import ordered_sum
from ..stages import span
from .state import (ColumnShards, DataSlots, check_trainable, host_copy,
                    module_from, placed_module, sgd_update_)


def arcface_margin_logits(embeddings: torch.Tensor, w: torch.Tensor,
                          labels: torch.Tensor, s: float = 64.0,
                          m: float = 0.5, col0: int = 0) -> torch.Tensor:
    """(B, D) embeddings x (D, C) class matrix -> (B, C) margin logits, in
    float32 (float64 when the inputs are). ``w`` may be the columns [col0,
    col0 + C) of a larger matrix (a shard): the margin goes to the column
    that holds the label, if this one does."""
    emb_n = l2_normalize(at_least_f32(embeddings))
    w_n = l2_normalize(at_least_f32(w), dim=0)
    cos = (emb_n @ w_n).clamp(-1.0, 1.0)
    sin = (1.0 - cos * cos).clamp_min(0.0).sqrt()
    cos_m, sin_m = float(np.cos(m)), float(np.sin(m))
    phi = cos * cos_m - sin * sin_m                     # cos(theta + m)
    # the fallback for theta + m > pi
    phi = torch.where(cos > float(np.cos(np.pi - m)), phi, cos - m * sin_m)
    cols = torch.arange(col0, col0 + w.shape[1], device=w.device)
    onehot = cols[None, :] == labels.long()[:, None]
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
    head_w: Any                      # (D, num_classes) class matrix; on a
                                     # mesh ColumnShards of (D, padded)
    trace: Dict[str, Any]            # SGD momentum: a backbone parameter
                                     # name each, and "head_w" (as head_w)
    step: int


def _pieces(t) -> List[torch.Tensor]:
    return list(t.cols) if isinstance(t, ColumnShards) else [t]


def _trained(state: TrainState
             ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(tensors, their momentum) the optimizer updates, in a fixed order:
    the backbone's parameters, then the class matrix (a shard each)."""
    named = list(state.backbone.named_parameters())
    return ([p for _, p in named] + _pieces(state.head_w),
            [state.trace[n] for n, _ in named]
            + _pieces(state.trace["head_w"]))


@dataclasses.dataclass
class ArcFaceTrainer:
    """ArcFace trainer on one device (``device``: the card unless "cpu"),
    or over ``mesh``: ('data', 'model') or ('data',) slots, the state's
    master copy on the first slot's device.

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
    # None: one device; else a parallel.Mesh with axes ('data', 'model')
    # or ('data',)
    mesh: Any = None

    def __post_init__(self):
        from .schedules import make_lr_schedule

        self._place_on_mesh()
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

    def _place_on_mesh(self) -> None:
        """The device, the class matrix's padded width and, on a mesh, its
        slots: ``_grid[i][j]`` the slot of (data i, model j)."""
        if self.mesh is None:
            self.device = resolve_device(self.device)
            self.padded_classes = self.num_classes
            return
        names = tuple(self.mesh.axis_names)
        if names not in (("data", "model"), ("data",)):
            raise ValueError(f"mesh axes {names}: ('data', 'model') or "
                             "('data',)")
        grid = self.mesh.devices
        self._grid = grid.tolist() if grid.ndim == 2 else [[s] for s in grid]
        first = self._grid[0][0].device
        if self.device is not None and resolve_device(self.device) != first:
            raise ValueError(f"device {self.device}: a meshed trainer keeps "
                             f"its state on the first slot's, {first}")
        self.device = first
        self._data = DataSlots(self.mesh)
        self._model_slots = self._grid[0]
        tp = len(self._model_slots)
        self.padded_classes = -(-self.num_classes // tp) * tp

    # ------------------------------------------------------------- setup

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """A fresh state from ``seed`` (the trainer's by default), drawn on
        the CPU so a seed gives the same state on every device: the
        backbone by ``seeded_init_``, the class matrix (its pad columns
        too) N(0, 0.01^2), the momentum zero, step 0."""
        seed = self.seed if seed is None else seed
        backbone = seeded_init_(copy.deepcopy(self.model), seed)
        gen = torch.Generator(device="cpu").manual_seed(seed + 1)
        head_w = torch.randn((self.emb_dim, self.padded_classes),
                             generator=gen) * 0.01
        trace = {n: torch.zeros_like(p)
                 for n, p in backbone.named_parameters()}
        trace["head_w"] = torch.zeros_like(head_w)
        return self._placed(backbone, head_w, trace, 0)

    def state_from(self, parts: Mapping[str, Any]) -> TrainState:
        """A state from its parts (``weights.train_state_parts`` /
        ``train_state_from_jax``: a backbone state dict, ``head_w``, the
        momentum by name, the step). ``head_w`` has the trainer's padded
        width: JAX's (D, padded_classes) from a mesh of the same 'model'
        size; (D, num_classes) on one device."""
        backbone = module_from(self.model, parts["backbone"], self.dtype)
        names = [n for n, _ in backbone.named_parameters()] + ["head_w"]
        if sorted(parts["trace"]) != sorted(names):
            raise ValueError("the momentum does not name the model's "
                             "parameters")
        head_w = torch.as_tensor(parts["head_w"])
        want = (self.emb_dim, self.padded_classes)
        if tuple(head_w.shape) != want:
            raise ValueError(
                f"head_w {tuple(head_w.shape)}: this trainer's class matrix "
                f"is {want} ({self.num_classes} classes"
                + ("" if self.mesh is None else
                   f", padded to a multiple of the 'model' axis "
                   f"{len(self._model_slots)}") + ")")
        return self._placed(backbone, head_w, dict(parts["trace"]),
                            int(parts["step"]))

    def _placed(self, backbone, head_w, trace, step) -> TrainState:
        """The state on the trainer's device (the class matrix and its
        momentum in shards on a mesh) and in its dtype, in tensors of its
        own (the update works in place)."""
        def own(t):
            return t.detach().to(self.device, self.dtype, copy=True)

        def matrix(t):
            if self.mesh is None:
                return own(t)
            return ColumnShards.split(torch.as_tensor(t), self._model_slots,
                                      self.dtype)

        head = matrix(head_w)
        for t in _pieces(head):
            t.requires_grad_(True)
        momentum = {k: own(v) for k, v in trace.items() if k != "head_w"}
        momentum["head_w"] = matrix(trace["head_w"])
        return TrainState(backbone=placed_module(backbone, self.device,
                                                 self.dtype),
                          head_w=head, trace=momentum, step=step)

    # -------------------------------------------------------------- step

    def _sample(self, state: TrainState, labels: torch.Tensor,
                scores: Optional[torch.Tensor]):
        """Partial FC's (idx, new_labels, matched) for the step, or None
        for the full softmax."""
        if self.num_sample >= self.num_classes:
            return None
        if scores is None:
            return partial_fc_sample(labels, self.num_classes,
                                     self.num_sample, self.seed, state.step)
        return partial_fc_from_scores(scores.to(labels.device), labels,
                                      self.num_sample)

    def loss(self, state: TrainState, images: torch.Tensor,
             labels: torch.Tensor, scores: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """The one-device step's loss (the backbone in training mode: BN
        moves its running statistics once). ``scores`` (num_classes,)
        replaces Partial FC's draw."""
        emb = state.backbone.train()(images, remat=self.remat)
        sample = self._sample(state, labels, scores)
        if sample is not None:
            idx, new_labels, matched = sample
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
        params, traces = _trained(state)
        with torch.enable_grad():
            if self.mesh is None:
                images = torch.as_tensor(images).to(self.device, self.dtype)
                labels = torch.as_tensor(labels).to(self.device, torch.int64)
                loss = self.loss(state, images, labels, scores)
                grads = list(torch.autograd.grad(loss, params))
            else:
                loss, grads = self._mesh_loss_grads(state, images, labels,
                                                    scores)
        with span("arcface_train.update"):
            self.last_grad_norm = sgd_update_(
                params, grads, traces, self.lr(state.step),
                self.weight_decay)
        return state._replace(step=state.step + 1), loss.detach()

    def _mesh_loss_grads(self, state: TrainState, images, labels, scores):
        """The meshed step's global loss and the gradients of the master's
        tensors (``_trained``'s order)."""
        data = self._data
        parts = data.split(images, self.dtype)
        label_parts = data.split(labels, torch.int64)
        sample = self._sample(
            state, torch.as_tensor(labels).to(self.device, torch.int64),
            scores)
        modules, replicas = data.modules(state.backbone)
        w = state.head_w
        if sample is None:
            def slot(i):
                emb = modules[i].train()(parts[i], remat=self.remat)
                return self._full_xent_sum(emb, label_parts[i], w,
                                           self._grid[i])
        else:
            idx, new_labels, matched = sample
            gather = self._sample_columns(idx, w)
            new_parts = data.split(new_labels, torch.int64)
            matched_parts = data.split(matched, torch.bool)

            def slot(i):
                emb = modules[i].train()(parts[i], remat=self.remat)
                cols = torch.cat([c.index_select(1, local.to(c.device))
                                  .to(emb.device)
                                  for c, local in zip(w.cols, gather[0])],
                                 dim=1)
                w_s = cols.index_select(1, gather[1].to(emb.device))
                logits = arcface_margin_logits(emb, w_s, new_parts[i],
                                               self.scale, self.margin)
                return (softmax_xent(logits, new_parts[i])
                        * matched_parts[i]).sum()
        with span("arcface_train.forward_loss"):
            total = ordered_sum(data.run(slot), self.device)
            if sample is None:
                loss = total / sum(p.shape[0] for p in parts)
            else:
                loss = total / sample[2].sum().clamp_min(1)
        with span("arcface_train.backward"):
            grads = data.grads(loss, state.backbone, replicas, _pieces(w))
        return loss, grads

    @staticmethod
    def _sample_columns(idx: torch.Tensor, w: ColumnShards):
        """Where each shard's sampled columns go: (for each shard, the
        local columns it gives, in the sample's order; the permutation that
        puts the shards' columns, joined in shard order, back in the
        sample's order)."""
        owner = idx.long() // w.per
        local, order = [], []
        for j in range(len(w.cols)):
            pos = torch.nonzero(owner == j)[:, 0]
            local.append(idx.long()[pos] - j * w.per)
            order.append(pos)
        return local, torch.argsort(torch.cat(order))

    def _full_xent_sum(self, emb: torch.Tensor, labels: torch.Tensor,
                       w: ColumnShards, row: list) -> torch.Tensor:
        """The summed softmax cross-entropy of one data slot's rows over
        every shard: block j of the margin logits on ``row[j]``'s device,
        the pad columns at -1e9; each row's log-sum-exp across the blocks
        (the maximum first, then the sum of exponentials) and its target
        logit from the block that holds the label, on ``emb``'s device."""
        home = emb.device
        blocks, targets = [], []
        for j, (c, slot) in enumerate(zip(w.cols, row)):
            dev, col0 = slot.device, j * w.per
            lab = labels.to(dev)
            lg = arcface_margin_logits(emb.to(dev), c.to(dev), lab,
                                       self.scale, self.margin, col0=col0)
            if self.padded_classes > self.num_classes:
                col = torch.arange(col0, col0 + w.per, device=dev)
                lg = torch.where(col[None, :] < self.num_classes, lg, -1e9)
            own = (lab >= col0) & (lab < col0 + w.per)
            at = lg.gather(1, (lab - col0).clamp(0, w.per - 1)[:, None])[:, 0]
            blocks.append(lg)
            targets.append(torch.where(own, at, 0.0).to(home))
        top = torch.stack([b.detach().amax(dim=1).to(home)
                           for b in blocks]).amax(dim=0)
        sums = ordered_sum([torch.exp(b - top.to(b.device)[:, None]).sum(1)
                            for b in blocks], home)
        return (top + torch.log(sums) - ordered_sum(targets, home)).sum()

    # ------------------------------------------------------- checkpointing

    def save_checkpoint(self, state: TrainState, path: str) -> None:
        """``torch.save`` of the whole state as float32 tensors: the
        backbone's Flax-layout variables, ``head_w`` (on a mesh the whole
        padded matrix), the momentum in the same layout, the step."""
        momentum = {n: t for n, t in state.trace.items() if n != "head_w"}
        data = {
            "backbone": tensor_tree(variables_from_module(state.backbone)),
            "head_w": host_copy(state.head_w).float(),
            "trace": {
                "backbone": tensor_tree(
                    variables_from_state_dict(momentum)["params"]),
                "head_w": host_copy(state.trace["head_w"]).float()},
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
