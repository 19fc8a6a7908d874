"""Ports of the JAX repository's concluded kernel experiments under
``tools/``: each module is named after the script it ports, holds the
experiment's kernel wrapper and plain version, and keeps the script's
workload, reference check and timing as functions (``main`` runs them on
the card: ``python -m scrfd_arcface_facerecognition_tpu_torch.tools.<name>``).

- ``exp_warp2``: kernel K3, the 5-pass band-mix face warp
  (``csrc/warp_band.cu``, all five passes in one launch);
- ``exp_pallas_conv``: kernel K4, the narrow-channel 3x3 conv
  (``csrc/conv3x3.cu``), on the tensor cores;
- ``conv3x3_ablate``: K4 built with one part taken out at a time, to see
  where its time goes (no JAX counterpart);
- ``pq_adc_ablate``: the same for K2, the PQ distance scorer
  (``csrc/pq_adc.cu``; no JAX counterpart);
- ``warp_band_ablate``: the same for K3 (no JAX counterpart);
- ``warp_align_ablate``: the same for K1, the face-crop warp
  (``csrc/warp_align.cu``; no JAX counterpart).

The release sign-off, ports of the JAX repository's root tools that run
on the card (``--device cpu`` for the CPU):

- ``verify_release``: the five-graph sign-off (preflight, executor and
  importer against an oracle, the export round trip, ``FaceAnalysis``
  end to end against the reference replica ``e2e_oracle``);
- ``parity_harness``: the executor against the stand-ins or the importer;
- ``dryrun_multichip``: one step of every sharded path on n slots;
- ``release_check``: the gate that chains them with the tests and
  ``check_ui_js``, the web page's script lint.

The gallery at the scale its tiers exist for, ports of the JAX
repository's root experiments that drive the gallery's own paths (K2 the
one kernel on them; ``--device cpu`` for the CPU):

- ``exp_pq_scale``: a 10M-row PQ gallery's fill rate, search over a
  query-batch sweep in both LUT precisions, a dense search for context,
  recall of ADC and of the exact rerank;
- ``exp_migration``: the dense -> PQ crossing of ``AutoGallery``, its
  synchronous stall and serving while it migrates in the background;
- ``exp_merge_1m``: the blocked duplicate scan over a million rows with
  planted pairs, then the union-find merge worklist;
- ``exp_train_budget``: the codec's train budget against shortlist
  quality, why ``AutoGallery`` ships its ``pq_train_rows`` /
  ``pq_train_iters``.

The serving host's budget and the trainers' proof, ports of the JAX
repository's root experiments (``--device cpu`` for the CPU where the tool
runs models):

- ``exp_microbatch``: concurrent single-image ``FaceAnalysis.get`` calls,
  one batch-1 call each against the facade's request coalescing;
- ``exp_convergence``: both trainers memorize a synthetic set, held-out
  verification accuracy and AP@0.5 scored through the full eval paths;
- ``bench_ingest``: the host's decode and batch-assembly rates (raw
  decode, the frame ring, decode threads, ``DecodePool``) and the decode
  cores one card needs at a given frames/s.

The measurement tools, ports of the JAX repository's root profiling
scripts that ask the card what those scripts asked the TPU (each prints
the JAX tool's rows under its labels, the card's name and power limit
first, times device work with CUDA events through ``device_ms`` and
returns its rows; ``--device cpu`` for the CPU):

- ``profile_stages``: the e2e path's two stages and their sub-stages in
  the order ``FacePipeline`` runs them (letterbox, normalize, SCRFD,
  decode, top-k + NMS + compaction, canvas -> u8, then the warp K1, the
  r50 forward, l2 + match);
- ``exp_r50``: iResNet-50 at 960 crops: TFLOPS from
  ``FlopCounterMode``, the stage groups as cumulative prefixes, a batch
  sweep, ``channels_last`` against NCHW, the f32 control;
- ``exp_r50b``: four equal formulations of the embedding head (the
  production NHWC flatten, an einsum, a 7x7 conv, an NCHW flatten with
  the weight's rows permuted), alone and in the full model;
- ``exp_scrfd``: det_10g's backbone, neck and head alone, two padded
  widths and the f32 control;
- ``trace_ops``: a traced forward's top device ops, read back from the
  Chrome trace ``utils.profiling.trace`` writes;
- ``exp_int8``: int8 against bf16 on det_10g's conv geometry, each conv
  the same im2col GEMM (``torch._int_mm`` for int8), cuDNN's bf16 conv
  beside them, the 8192 GEMM and the 28-conv backbone-shaped chain.

The decision-quality tools, ports of the JAX repository's root tools that
score the engines' decisions (``--device cpu`` for the CPU):

- ``exp_decisions``: det_500m and w600k_mbf trained on composites of
  identity crops, then the whole clustering decide path over unseen
  identities: grouping precision and recall, both duplicate gates,
  verification, the 0.8 merge;
- ``replay_visits``: a visits JSON through the engine with an image
  cache of md5(url).jpg files in place of the network;
- ``host_images``: cv2's resizes of the compositing (INTER_AREA and
  INTER_LINEAR) in numpy, bit for bit, for a machine without cv2.

This module imports no torch when it is imported: ``bench_ingest``'s
capture opener runs in ``DecodePool``'s decode processes, which must stay
free of torch.
"""
from __future__ import annotations

import subprocess
import time


def device_ms(fn, iters: int, dev) -> float:
    """Mean ms of fn() over ``iters`` calls after a warm-up: CUDA events on
    the card, the host clock on the CPU."""
    fn()
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / iters
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) * 1e3 / iters


def synchronize(dev) -> None:
    """Wait for the card (a ``torch.device``) to finish its queued work;
    nothing on the CPU."""
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def card_line(dev) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    first card); on the CPU a line that says there is none."""
    if dev.type != "cuda":
        return "no card: --device cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]
