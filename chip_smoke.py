#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

from the repository root. Phases, each of which ends the run with a
non-zero exit if it fails:

1. toolchain: torch / CUDA versions, nvcc, whether triton imports, the
   card's name and power limit (nvidia-smi);
2. builds every hand-written kernel from ``csrc/`` with nvcc, in parallel;
3. kernel K1 (the face-crop warp, ``warp_align``) against its plain PyTorch
   version on the card: 16 synthetic 1080p frames and 320 crops covering
   rotations to 180 deg, scales 0.2-4, partly and wholly off-frame crops,
   degenerate and NaN matrices, plus frames narrower than 512 px, and the
   edge sets of ``K1_EDGES`` (no crop, one crop, an output width off the
   4-pixel quads, a height off the kernel's tile rows, a width of three
   112-column tiles, frame indices outside [0, B), frames smaller than a
   crop's footprint); max abs error in u8
   units (tolerance 1e-3, expected 0) and equal NaN positions; the
   kernel's occupancy (threads and rows a CTA, CTAs an SM); kernel /
   plain / affine_grid + grid_sample / bound times at 320 crops, and the
   kernel and its bound at 960 crops over 96 x 1080p frames (bench.py's
   batch);
4. the main path at full width: FacePipeline with det_10g + w600k_r50
   (seeded weights) on the card, a gallery of 128, 8 synthetic 1080p
   frames, three calls with max_num=10 and process_stream over two
   batches, with the kernel's launch count reset just before and read just
   after, per-stage CUDA-event times and the kernel's times at the shapes
   this path gave it, beside ``crop_matrices`` (the rest of the align +
   warp stage) at the same shapes;
5. the port on the card against the port on the CPU (small seeded config,
   TF32 off for convolutions and matmuls);
6. kernel K2 (the PQ distance scorer, ``pq_adc``) against its plain
   PyTorch version on the card, in both precisions: Q in {1, 3, 13, 16,
   80} queries (13 leaves a part-filled last chunk), G in {0, 1, 4097,
   2,000,000} code rows, K in {16, 256}, M=64 and M=12, NaN and inf LUT
   entries; then ``K2_EDGES``: codes views 3 and 5 bytes past 16-byte
   alignment, M=128 (three slabs of subspaces), K=99 (the LUT staged
   entry by entry; M=160 in two slabs); max abs difference
   relative to the largest |score| (tolerance 1e-6, expected 0) and the
   same NaN / inf positions;
7. the gallery path at full width: the main path's embeddings are the
   queries; AutoGallery(tier="pq") on the card takes 1,000,000 synthetic
   identity rows (the embeddings among them at known ids) in one
   add_batch, migrates (codec training, encoding, a 2,000,000-row
   PQGallery) and answers search_batch(k=5) with K2's launch count
   (``launches`` + ``topk_launches``: the rerank shortlist of 32 takes the
   top-k fused into K2) reset just before and read just after; recall@1
   of noisy views after the exact rerank (>= 0.95), each embedding finds
   itself (cosine >= 0.9999), stage times, PQGallery.search(rerank=0),
   the dense GalleryStore at the same rows; K2's times at these shapes
   against its bound, its plain version and ``embedding_bag``, then on
   the tier's filled rows alone (the tier is scored whole, and half of it
   is empty) and at Q=1, 4, 16; the fused top-k bit-equal to the plain
   chain and to K2 + mask + sort at the path's shapes;
8. the PQ gallery on the card against the CPU at 20,000 rows (same codec,
   codes and queries): ids equal, scores within 1e-5;
9. kernel K3 (the 5-pass band-mix warp, ``warp_band``) on its experiment's
   path (``tools.exp_warp2.run``: 16 x 1080p frames, 320 crops, against
   K1), with its launch count reset just before and read just after; then
   against its plain version on that workload and on stress sets (scales
   to 8, level-1 canvas crops, rotations past the envelope and upside
   down, crops past the frame edge, 512-wide and 400-wide frames) and 12
   hand-made edge crops (NaN and infinite parameters, |v| = 1, frame
   indices outside [0, B)), max abs error in u8 units (tolerance 1e-3,
   expected 0), and the ranges the kernel used equal to
   ``exp_warp2.fused_plan``'s; kernel / plain / bound times at 320 crops
   and the kernel and bound at 80 (the bound from what the crops need,
   traced back through the passes' taps), the fused kernel's shared
   memory a block, blocks an SM and waves, the peak device memory of one
   call, and K3's deviation from exact bilinear;
10. kernel K4 (the narrow 3x3 conv on the tensor cores, ``conv3x3``) on
   its experiment's path (``tools.exp_pallas_conv.run``: B=64, H=96,
   W=160, Wp=256, C=F=56), with its launch count reset just before and
   read just after; against its plain version there and on ``K4_CASES``
   (C=3, F=16, H=8, Wp=21; C=72, F=88; Wp=300; NaN and inf pixels), ReLU
   on and off, scale and bias given and absent, within one bf16 step plus
   |scale| * 2^-12 * sum |w| |x| (``sum_tolerance_ratio`` at most 1, NaN
   positions and infinities equal); kernel / plain / bound times and
   cuDNN's bf16 conv2d on all Wp lanes (the same work) and on the W real
   lanes;
11. the main path on the torch stand-in weights: det_10g and w600k_r50
   stand-ins (``tests/torch_export.py``) exported to ONNX, loaded through
   the port's importer (``variables_from_onnx``) on the card, FacePipeline
   at bench.py's settings (conf 0.5, pre_nms 256, max_det 16, max_num 10,
   8 x 1080p frames, gallery 128), K1's launch count reset just before and
   read just after; faces per call, said as meeting or not meeting the
   expectation (more than 0, fewer than every slot; 0 fails), ms per
   call, stage times; K1 against its plain version on the path's crops;
   the path's crop matrices through WarpParams and K3 against its plain
   version;
12. the facade and the engines (``FACADE``): (a) ``FaceAnalysis`` with
   det_10g + w600k_r50 (seeded) on the card, ``get_batch`` on 8 x 1080p
   images (the static route), 8 more at 720 x 1280 (two static chunks of
   different shapes through ``process_stream``) and 8 one-off web shapes
   (the dynamic 256-px buckets), K1's launches counted around the call,
   faces per image, each group's route and ms per route; each one-off
   image's dynamic canvas within 1e-4 of the exact-shape ``letterbox``;
   K1 against its plain version on the inputs this call gave it (the
   first call for each frame-batch shape: both static chunks and every
   dynamic bucket);
   (b) ``enable_microbatch()`` and 16 threads each calling ``get()`` on one
   image, the results equal to the direct ``get_batch`` of the batches the
   collector formed (bbox atol 1e-2, embeddings atol 1e-3); (c)
   ``SmartFaceEngine`` on that facade with an injected image loader (no
   network, no cv2) over ``FACADE["visits"]`` visits: the result counts,
   the "no face" count split by the gate that gave it, ms per visit, the
   results file's size, K1 against its plain version on the run's
   inputs; then on the PQ tier with an identity-coded app
   (``IdentityApp``) over ``ENGINE_PQ``'s visits in batches, K2's
   launches counted (the gallery crosses to PQ mid-run), K2 against its
   plain version on the LUT and codes of every search the tier ran and
   its fused top-k against the plain chain and K2 + mask + sort, the
   decisions (the SQLite rows and the clustering_results JSON, without
   timestamps) equal to the same run on the CPU; (d)
   ``FaceComparison.process_face_comparisons`` on ``FACADE["pairs"]``
   (image, refImage) pairs with the facade: the accuracy block well formed,
   ms per pair. Any ERROR record that the port logs during (c) or (d)
   fails the phase: the engine counts a visit whose decision raised as
   "no face", so the log is where such a fault shows, and the run fails
   when no visit reaches the gallery. The facade is pinned to f32, as in
   the phase's first form: at bf16 the seeded detector's boxes fail the
   engine's side-face gate on every visit, and the engine's decisions
   would not run. The facade's default (bf16 on the card) is built and
   driven once beside it (finite unit embeddings);
13. the main path at bf16 at bench.py's settings (``BENCH``): the
   det_10g + w600k_r50 stand-ins at bf16 (weights f32), 96 x 1080p frames
   resident on the card, gallery 128, max_det 16, max_num 10, pre_nms 256,
   conf 0.5; after warm-up ``process_stream([frames] * 12, depth=12)`` for
   3 rounds (the median frames/s and the spread), K1's count reset just
   before and read just after; then depth 1 and 2 alike, and the frames
   fed from numpy at depth 1, 2 and 12, through the pipeline's pinned
   staging and through the plain pageable copy it replaces; one call of
   each precision split by stage (CUDA events); bf16 against f32 on the
   same frames (faces paired by IoU, match_idx agreement, the minimum
   embedding cosine); K1 against its plain version on the path's inputs;
   one line ``{"bench_bf16": {...}}``; then (13b, ``CKPT``) the committed
   trained det_500m + w600k_mbf (read with the port's msgpack reader) at
   bf16 on the card against the CPU, at the budget of
   ``tests/test_torch_bf16.py``: head outputs on one canvas within 2 bf16
   ulps, and the card's bf16 at least half an ulp from its f32 (a forward
   that stays f32 fails); the pipeline's faces on 16 smooth seeded frames
   paired by IoU >= 0.9, each face on one side only a checked tie (at
   most 2), boxes / kps / scores within budget, embeddings cosine >=
   0.999, match_idx equal away from the threshold;
14. the realtime app (``REALTIME``): ``apps.realtime.run`` on a synthetic
   cv2-shaped capture of 43 seeded 1080p frames (the last batch partial)
   through ``BatchedFrameReader`` over the native ring, ``--batch 8``, the
   stand-ins at bf16, a faces directory of seeded photos; the opener, the
   writer, the photo reader and ``annotate_batch`` replaced (the card's
   machine has no cv2); every frame written, in order; each batch's
   count, valid and match_idx equal to a direct ``FacePipeline`` call on
   the same frames, embeddings cosine >= 0.999; K1's count reset just
   before the run and read just after, and K1 against its plain version
   on the run's inputs; frames/s of the run with the decode thread
   overlapping, and numpy-fed ``process_stream`` over its batches at
   depth 1 and 2, staged and through the plain copy;
15. the ONNX executor path (``models/onnx_exec.py``) on phase 11's
   det_10g + w600k_r50 stand-in files: (a) the executor on the card
   against the executor on the CPU at f32 (TF32 off) on 8 x 1080p frames
   at the stand-in path's settings: the 9 head outputs on one canvas and
   ArcFace on the path's crops, the pipeline's faces paired by IoU >= 0.9
   (a face on one side only a checked tie) and held to the f32 budget,
   each largest error said as a share of its budget; (b) the executor
   against the native models loaded through the importer on the card at
   f32 (TF32 off), then each model's device ms (cold L2), host ms of the
   dispatch and CUDA kernels per forward at bf16, SCRFD at 8 and 96
   canvases of 384 x 640 and ArcFace at 80 and 960 crops; (c) one warm
   forward of each graph at bf16 and f32 under
   ``torch.cuda.set_sync_debug_mode("error")`` (any host sync fails); (d)
   ``FacePipeline(det_onnx=, rec_onnx=, dtype=bf16)`` at bench.py's
   settings (``BENCH``: 96 x 1080p resident, depth 12, 3 rounds), frames/s
   beside phase 13's native figure, one call by stage at bf16 and f32,
   the device busy share of one round; (e) K1's launches over (d)'s
   rounds and K1 against its plain version on the phase's inputs; (f)
   ``FaceAnalysis(det_onnx=, rec_onnx=)`` ``get_batch`` on phase 12's
   static images and ``apps.realtime.run`` with ``--det-weight`` /
   ``--rec-weight`` the stand-in files on a synthetic 16-frame capture:
   every frame written in order, each batch's count equal to a direct
   call;
16. the camera apps (``CAMERAS``), on phase 11's stand-in files given as
   ``--det-weight`` / ``--rec-weight`` (the graph executor at bf16):
   ``apps.multistream.run`` over 4 synthetic cameras (three 1080p, one
   720p, one ending at half length) and one that does not open, once
   through decode threads and once through ``--decode-pool`` (2 worker
   processes, 4 slots a stream of 1080p, the cameras opened in the
   workers by the top-level ``synthetic_camera``); the writers, the
   drawing and the photo reader replaced; every live camera's frames
   written in order at its own size, each round's count, valid and
   match_idx equal to a direct ``FacePipeline`` call (embeddings cosine
   >= 0.999), the same rounds from both readers; frames/s of each reader,
   the pool's start and first-round times; then ``apps.dualstream.run``
   on a 1080p and a 720p camera for ``CAMERAS["dual_pairs"]`` pairs (the
   720p frame resized to 1080p); K1 counted around each run and held to
   its plain version on the runs' inputs;
17. the web API: ``apps.webapp.make_server`` on 127.0.0.1 (port 0) in a
   thread over ``SmartFaceEngine`` on phase 12's facade (f32, seeded) and
   an injected loader: POST /api/process-visits of phase 12's visits, the
   results and the SQLite rows and results files equal to the same
   engine driven directly, ms a visit beside phase 12's; the comparisons
   in one request, ms a pair beside phase 12's; every other route once
   (``/api/image-base64`` with its reader and encoder replaced: no cv2);
   K1 counted and held to its plain version on the requests' inputs;
   with ``serving.microbatch`` on, 8 concurrent comparison requests that
   must coalesce (batch width > 1) and answer as the sequential ones;
   the PQ tier through the web (``IdentityApp``, ``ENGINE_PQ``'s visits
   in POSTs), K2 counted and held to its plain version on every search
   (its fused top-k to both chains), the decisions equal to a CPU
   run's; an ERROR logged by the port fails the phase;
18. train, checkpoint, export, serve (``TRAIN``): (a) the ArcFace
   trainer on w600k_mbf at full width, batch 16, 1,000 classes, on the
   card and on the CPU from one seeded state, full softmax and Partial FC
   0.1 on the same scores: the first step's loss at f32 with TF32 off
   (1e-5 relative), then one and three steps in float64 (training-mode
   BN makes some gradients small sums of large terms, which f32 rounding
   moves by percents): the losses within 1e-11 relative and every tensor
   (weights, BN statistics, momentum, class matrix) within 1e-12 + 1e-10
   of its largest magnitude; (b) w600k_r50 at batch 128 over 600,000
   classes (WebFace600K's) with Partial FC 0.1, 3 warm-up and 10 timed
   steps on fresh random batches, without and with remat: ms a step
   (CUDA events), images a second, peak device memory, every loss finite
   and above ln(sampled classes) / 2 (random labels cannot be learned);
   one step under ``torch.profiler`` (the device's busy share and its
   longest events); (c) w600k_mbf memorizes one batch of 64 over 64 classes
   in 30 steps (the last loss below the first); (d) ``tools.train_arcface
   --synthetic 5`` and ``tools.export_onnx --verify`` in child processes,
   ``preflight_graph`` on the file, ``variables_from_onnx`` bit-equal to
   ``load_inference_variables`` of the checkpoint, ``Embedder(onnx_path=)``
   within cosine 0.9999 of the trained module at f32, then
   ``FacePipeline`` with phase 11's det_10g stand-in and the exported
   embedder on 8 seeded 1080p frames, K1 counted and held to its plain
   version on the calls' inputs;
19. the SCRFD detector: train, checkpoint, AP, export, serve
   (``TRAIN_DET``): (a) the detector trainer on det_500m at full width,
   640 x 640, batch 4, 8 faces at most, on the card and on the CPU from
   one seeded state: the ATSS assignment equal on both devices, the first
   step's loss at f32 with TF32 off (1e-5 relative), one and three steps
   in float64: the losses within 1e-11 relative, n_pos equal and every
   tensor (weights, BN statistics, momentum) within 1e-12 + 1e-10 of its
   largest magnitude; (b) det_10g at ``tools.train_scrfd``'s defaults
   (640 x 640, batch 32, 32 faces at most), 3 warm-up and 10 timed steps
   on fresh synthetic batches: ms a step (CUDA events), images a second,
   peak device memory, every loss finite and n_pos > 0; one step under
   ``torch.profiler`` (the device's busy share and longest events) and the
   device time of the kernels launched in each of the trainer's spans
   (network forward, assignment + loss, backward, update); (c) det_500m
   memorizes one batch of 4 in 30 steps (the last loss below the first);
   (d) a retinaface ``label.txt`` of 16 seeded images (some faces'
   landmarks unlabeled) through ``parse_wider_annotations`` and
   ``batches_from_annotations`` with an injected loader (no cv2), det_500m
   trained five passes over those batches and checkpointed,
   ``evaluate_detector``'s AP (finite, in [0, 1]), ``tools.train_scrfd --synthetic 3`` and
   ``tools.export_onnx --verify`` of the checkpoint in child processes,
   ``preflight_graph`` on the file and ``variables_from_onnx`` bit-equal to
   ``load_inference_variables``; then ``FacePipeline(det_onnx=<the
   file>)`` and ``FacePipeline(detector=Detector(variables=<the
   checkpoint>))`` with phase 11's w600k_r50 stand-in on 8 seeded 1080p
   frames at f32 (TF32 off), the threshold set below the trained
   detector's top anchor scores: faces held to the f32 budget, K1 counted
   (the phase fails if it warped no crop) and held to its plain version;
20. multi-device serving (``PAR``) over a mesh of the CUDA cards when
   there are two or more, else of 4 slots that share cuda:0 (its times
   are then labelled no scaling figure): (a) a ShardedGallery of
   1,000,000 x 512 f32 rows over the shards, Q = 80, k = 5, against the
   single-device top-k (ids equal, scores within 1e-5); (b) phase 7's
   codec and rows in a 2,000,000-row PQGallery(mesh=): K2 launched once a
   shard a search, in "hilo" and with rerank 32 in "hi", ids and scores
   bit-equal to phase 7's unsharded gallery, K2 held to its plain version
   on a shard, its fused top-k to both chains on the last shard (rows
   offset); AutoGallery(tier="pq", mesh=) through a migration and
   snapshots restored unmeshed and back onto the mesh, the same hits; (c)
   frame DP with phase 4's det_10g + w600k_r50, gallery 128, 8 x 1080p,
   max_num 10, split over the slots, against one unsharded call at f32
   with TF32 off (valid, count, match_idx equal; boxes and kps within
   1e-2 px, scores, match_sim and embeddings within 1e-4), K1 counted and
   held to its plain version; (d) DisaggPipeline over half the slots
   each way, the gallery sharded and "auto", process_stream(depth=2) of
   4 batches of 8 frames held as in (c), K1 counted; on one card
   ``realtime --disagg 1`` raises "needs at least 2 devices"; (e) every
   per-call time beside the single-device one;
21. the trainers' mesh (``TRAIN_MESH``) over phase 20's slots, a data
   slot's forward in a thread of its own, BatchNorm over the global
   batch: (a) in float64, 3 steps from one state, the mesh against the
   card's one-device trainer, every tensor within 1e-12 + 1e-10 x max and
   the losses within 1e-11 relative: w600k_mbf on a ('data', 'model')
   mesh over 1001 classes (padded to a multiple of 'model'), full softmax
   and Partial FC 0.1 (each trainer's own draw); det_500m at 640 on a
   ('data',) mesh, one image a slot, their face counts unequal, n_pos
   equal; (b) w600k_r50 at batch 128 over 600,000 classes, Partial FC
   0.1, and det_10g at 640, batch 32, on the meshes: ms a step, images a
   second, peak memory and the device's busy share, beside this run's
   18b and 19b; (c) a w600k_mbf trained on the mesh, its checkpoint
   through ``load_inference_variables`` held to the live state's
   embeddings (cosine 0.9999) and served by two ``FacePipeline`` calls,
   K1 counted and held to its plain version; (d) both training CLIs with
   ``--synthetic 2 --slots 4``;
22. the release sign-off tools (``SIGNOFF``): (a)
   ``tools.verify_release`` on the card over 3 seeded synthetic frames
   (480x640, 720x1280, 1080x1920): the five stand-ins (det_500m, det_2.5g,
   det_10g, w600k_mbf, w600k_r50) preflighted, each through the graph
   executor and the importer against its torch forward on the CPU, and
   through importer -> exporter -> executor; ``FaceAnalysis`` at f32 on
   det_10g + w600k_r50 and det_500m + w600k_mbf against the numpy
   reference replica (``tools/e2e_oracle.py``), within the JAX tool's
   budgets, TF32 off; every row printed, every verdict PASS; K1 counted
   over the e2e stage and held to its plain version on its inputs; (b)
   the same with ``--mutate`` (width / depth perturbed det_10g, w600k_mbf
   and w600k_r50): the graph rows required, the pairings printed with
   their hidden ties (a kept face with a suppressed neighbour of the same
   score, outside the tie rule) and not required, K1 counted and held
   alike; (c) a det_500m.onnx cut at 3/5 through the entry
   point: exit 2, ``SIGN-OFF FAIL``, ``corrupt_or_truncated``, the
   runbook; (d) ``tools.release_check --skip tests signoff mutate`` in a
   child process: ``dryrun_multichip`` on 8 slots of the card (the
   ArcFace DP x TP and Partial FC steps, the SCRFD DP step, sharded
   frames, DisaggPipeline, sharded searches) and the page lint, its
   report read back; the phase's seconds;
23. the gallery at deployment scale (``GALLERY_SCALE``), through the
   port's tools: (a) ``tools.exp_pq_scale`` at G = 1,000,000, the query
   sweep 16 and 256 in both LUT precisions, the 250,000-row dense search
   and recall study, K2's launch count reset just before and read just
   after: every id >= 0, K2 bit-equal to its plain version on the swept
   codes at Q = 16 in both precisions and at Q = 256 in "hi" (the
   comparison's own launches not counted), each search's peak device
   memory and stage split, top-1 the query's identity with and without
   the rerank for every query whose identity has a row in the gallery
   (an identity draws about 4 rows, none for one query in ~50; at the
   250,000 rows one of the 16 has none); then 10,000,000 codes drawn on the card (640 MB, no host
   fill), one search at Q = 256 "hi" (2.56e9 scores, past 2^31; every id
   >= 0), K2 bit-equal to its plain version on the whole (Q, G) and the
   fused top-k to the plain chain and K2 + mask + sort; (b)
   ``tools.exp_migration``: the synchronous and the background crossing
   at 250,000 rows, top-1 self 16/16 after each and on every probe while
   the background build runs, which must not fail; (c)
   ``tools.exp_merge_1m`` at 200,000 rows, 2,000 planted pairs, threshold
   0.95: exactly the planted pairs, G - 2,000 groups after the
   union-find; (d) ``tools.exp_train_budget`` at 250,000 rows, 256
   queries: 256/256 at the shipped codec budget (50,000 rows, 10
   iterations), the other rungs reported; (e) the benchmark's lookup cell
   (``LOOKUP_CELL``: 10,000,000 codes of 1,000,000 identities drawn on the
   card, 64 queries near rows): K2 bit-equal to its plain version there,
   the fused search (k = 5, "hilo") bit-equal to the plain chain and the
   unfused one (K2, mask, stable sort), the fused top-k to both at k = 5
   and 32 in both precisions, and the device ms of the fused top-k (with
   its own bound), K2 alone, K2 + mask + sort and the plain chain at the
   cell's shape; each part's seconds. With
   ``--full-scale`` (``GALLERY_SCALE_FULL``) the tools' defaults: the
   10,000,000-row host fill and the sweep 16, 64, 128, 256 on it (K2
   checked on its codes, the drawn gallery not built), the 2,000,000-row
   dense search and recall study, the synchronous crossing at 1,000,000
   and 2,000,000 rows and the background one at 1,000,000, the scan at
   1,000,000 rows and the budget at 1,000,000;
24. the serving host's budget and the trainers' proof (``HOST_TOOLS``),
   through the port's tools: (a) ``tools.exp_microbatch`` at its
   defaults (64 requests of 640 x 640 from 16 threads, det_10g +
   w600k_r50 seeded at bf16, max_wait 4 ms, max_num 4), one batch-1
   ``get()`` a request, then coalesced: req/s of both modes, the measured
   round's batches and widest; one warm batch-1 ``get()`` under
   ``torch.profiler`` (the device's busy share); K1's launch count reset
   just before and read just after (none fails), K1 against its plain
   version on the run's inputs; each coalesced request's faces equal to the direct
   ``get_batch`` of its batch and each batch-1 request's to ``get()``
   (bbox atol 1e-2, embeddings atol 1e-3); (b) ``tools.exp_convergence``
   at its defaults: w600k_mbf over 50 synthetic identities, 300 steps at
   batch 32, held-out verification accuracy every 50 steps, which must
   end above its step-0 value and at 0.95 or more; det_500m on 16
   synthetic images at 320, 400 steps at batch 8, AP@0.5 through the
   whole inference path, which must end above its step-0 value and at
   0.90 or more; both curves and the ms of a training step; (c)
   ``tools.bench_ingest`` on the synthetic source (camera-like 1080p
   frames drawn at read time, no codec), 100 frames a stream, streams 1,
   2, 4, 8: every row at streams x frames, the table with the host's
   cores and CPU model, the decode cores a card needs at phase 13's
   resident depth-12 frames/s; each part's seconds. The tool's 300
   frames a stream do not fit beside the rest: run them with its own
   entry point;
25. the measurement tools (``PROFILE_TOOLS``), the port's counterparts of
   the JAX repository's profiling scripts, each printing its rows: (a)
   ``tools.profile_stages`` at its default 32 frames and at 96 (the bf16
   bench path's batch), one seeded det_10g + w600k_r50 pipeline at bf16:
   the two full stages, e2e ms and frames/s, then every sub-stage in the
   pipeline's order, K1's launch count reset just before and read just
   after (none fails) and K1 against its plain version on the runs'
   inputs; (b) ``tools.exp_r50`` (w600k_r50 at 960 crops: ms, TFLOPS
   from ``FlopCounterMode``, the batch sweep, the stage groups,
   ``channels_last``, f32 with and without TF32), its full prefix plus the
   head equal to the forward; (c) ``tools.exp_r50b`` on the same model:
   the four heads held to the production one at float32 (1e-4 of its
   largest value, TF32 off), then timed alone and in the full model at
   B = 960 and 480; (d) ``tools.exp_scrfd`` (det_10g at B = 32, 640 x
   640, its parts, the padded widths, f32), backbone -> neck -> head
   within 2 bf16 ulps of ``SCRFDNet``'s outputs; (e) ``tools.trace_ops
   --what backbone``: the traced iterations' device ops, a non-empty table
   with a positive total; (f) ``tools.exp_int8`` (the im2col GEMM in int8
   and bf16, cuDNN's bf16 conv, the 8192 GEMM, the 28-conv chain), every
   int8 conv and the int8 GEMM exactly equal to float64 on the card; each
   part's seconds;
26. the decision tools (``DECISIONS``), on synthetic identities drawn in
   memory (``tools.exp_decisions.synthetic_crops``: no cv2, no image
   cache): (a) ``tools.exp_decisions.run_decision_eval`` on the committed
   det_500m + w600k_mbf (read with the port's msgpack reader) over 8
   identities x 3 visits, both duplicate probes, 8 verification pairs and
   the merge probes, through ``FaceAnalysis`` at f32 (TF32 off) on the
   card and on the CPU: the metrics equal (``elapsed_s`` aside, the
   verification means within 1e-4; a decision that flips must be a tie,
   a similarity within 1e-4 of its threshold on both devices); then at
   bf16 (the facade's card default): the counters sum to the visits, at
   least 2 duplicates (the URL probe and the same-pixels probe), at least
   one visit processed; (b) ``train_detector`` and ``train_embedder`` from
   the committed weights, 20 steps each at full width (det_500m at 320,
   batch 8; w600k_mbf at batch 64), eval every 10: the JAX tool's line
   keys, ms a step, the checkpoints saved under ``build/smoke/decisions``
   and read back bit for bit, eval from the files equal to eval from the
   trees; (c) ``tools.replay_visits.run`` with det_10g + w600k_r50 at the
   facade's seeded init (bf16) over 24 visits, 6 of them missing from the
   in-memory md5(url) cache: every visit handled, the misses failed
   downloads, processed = recognized + new persons = SQLite's persons,
   visits/s; K1's launch count reset just before (a) and read just after
   (c) (none fails) and K1 against its plain version on the card's
   inputs; an ERROR the port logs fails the phase; each part's seconds;
27. one JSON line of every kernel's numbers (K1's launches are those of
   phases 4, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 24, 25 and 26; K2's
   those of phases 7, 17, 20 and 23).

    python3 chip_smoke.py --phases 1-4,26     # some phases
    python3 chip_smoke.py --full-scale        # phase 23 at full scale

``--phases LIST`` runs phases 1, 2 and the listed ones, each with the
earlier phases whose results it takes (5 and 7 need 4, 8 and 20 need 7,
15 and 24 need 13, 16 needs 15, 17 needs 12, 21 needs 18 and 19); the
kernels line then lists the kernels whose timing phase ran (K1 4, K2 7,
K3 9, K4 10). ``--full-scale`` runs phase 23 at the tools' defaults (with
no ``--phases``, phase 23 alone).

The last line is {"ok": true, "device": {...}}. Without a CUDA card, or
without the package beside it, the script exits non-zero and prints no
result.
"""
import contextlib
import json
import logging
import math
import os
import subprocess
import sys
import time

import numpy as np

TOL_U8 = 1e-3          # kernel vs plain, in u8 units (both round alike)
DEV = "cuda"
# phase sizes: (frames, height, width, crops) for phase 3; the main path's
# models, frame batch and frame size for phase 4
K1_CASE = (16, 1080, 1920, 320)
# phase 3: K1 at bench.py's batch (frames, height, width, crops), and its
# edge sets: (name, frames, height, width, crops, out_hw, frame index
# offset); the offset moves every other crop's frame index outside [0, B)
K1_BENCH = (96, 1080, 1920, 960)
K1_EDGES = (("no crop", 2, 64, 96, 0, (112, 112), 0),
            ("one crop", 2, 64, 96, 1, (112, 112), 0),
            ("odd out_hw", 3, 90, 150, 24, (112, 110), 0),
            ("odd band and quad", 3, 90, 150, 24, (13, 7), 0),
            ("three tile columns", 3, 90, 150, 12, (9, 230), 0),
            ("frame index outside", 3, 90, 150, 24, (112, 112), 5),
            ("frames smaller than a footprint", 4, 12, 20, 24, (112, 112), 0))
MAIN = dict(det="det_10g", rec="w600k_r50", frames=8, hw=(1080, 1920),
            max_num=10, gallery=128)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
WARP_FLOPS_PER_PIXEL = 60   # coordinates, weights, 12 taps, normalize
TOL_K2 = 1e-6          # K2 vs plain, relative to max |score| (expected 0)
BF16_FLOPS_PER_S = 989e12
K3_FLOPS_PER_POSITION = 26   # position, two taps' weights, 3 x 2 mul-adds
# phase 9: K3's path (frames, height, width, crops); phase 10: K4's shapes;
# phase 11: the stand-in main path at bench.py's settings
K3_CASE = (16, 1080, 1920, 320)
K4_SHAPES = dict(b=64, h=96, w=160, c=56, f=56, wp=256)
# phase 10: K4 against its plain version beyond the script's shapes: the
# odd case, C and F above 64 and off 16, Wp above one 256-position tile,
# and NaN / inf pixels
K4_CASES = (("odd", dict(b=2, h=8, w=20, c=3, f=16, wp=21)),
            ("wide", dict(b=2, h=16, w=36, c=72, f=88, wp=40)),
            ("long", dict(b=2, h=8, w=290, c=56, f=56, wp=300)),
            ("nonfinite", dict(b=2, h=16, w=60, c=56, f=56, wp=64)))
STANDIN = dict(frames=8, hw=(1080, 1920), max_num=10, gallery=128, conf=0.5,
               pre_nms=256, max_det=16)
# phase 6: the (Q, G, K) grid, and beyond it (M, K, G, byte offset of the
# codes view) for each Q: views that are not 16-byte aligned; M=128, which
# K2 stages in three slabs; K=99, whose LUT rows it stages entry by entry
# (one slab with 16-byte code loads, two with byte loads); phase 7: the
# gallery path (rows, synthetic identities, their per-dim noise, search
# k); phase 8: rows
K2_GRID = dict(q=(1, 3, 13, 16, 80), g=(0, 1, 4097, 2_000_000), k=(16, 256))
K2_EDGES = ((64, 256, 4097, 3), (64, 256, 2_000_000, 5), (128, 256, 4097, 0),
            (128, 256, 4097, 1), (64, 99, 4097, 0), (160, 99, 4097, 1))
GAL = dict(rows=1_000_000, idents=100_000, sigma=0.05, k=5)
GAL_CPU_ROWS = 20_000
# phase 12: the facade's groups (static: n x h x w; stream: a second static
# shape; one-off web shapes (h, w) for the dynamic buckets), the
# micro-batched images (16 distinct shapes), the clustering run's visits
# and image size, the verification pairs; then the PQ-tier engine run
# (visits over identities, in batches, the tier's training rows)
FACADE = dict(det="det_10g", rec="w600k_r50", det_size=(640, 640), max_det=16,
              static=(8, 1080, 1920), stream=(8, 720, 1280),
              oneoff=((300, 400), (480, 640), (1280, 720), (97, 131),
                      (1000, 1000), (600, 800), (250, 180), (768, 1024)),
              microbatch=[(200 + 24 * i, 260 + 16 * i) for i in range(16)],
              visits=200, visit_hw=(480, 640), pairs=50)
ENGINE_PQ = dict(visits=300, idents=120, batches=3, min_train_rows=64)
# phase 13: bench.py's settings (frames a batch, batches a round = depth,
# rounds; the other depths timed; the depths timed with frames fed from
# numpy); phase 14: the realtime app's capture (frames, size), --batch, the
# faces directory's photos
BENCH = dict(frames=96, hw=(1080, 1920), depth=12, depths=(1, 2),
             fed_depths=(1, 2, 12), rounds=3, max_num=10, gallery=128,
             conf=0.5, pre_nms=256, max_det=16)
# phase 13b: the trained checkpoints at bf16, card against CPU (frames n x
# h x w; the detector's settings of tests/test_torch_bf16.py; faces on one
# side only allowed, each a checked tie)
CKPT = dict(det="det_500m", rec="w600k_mbf", frames=(16, 240, 320),
            input_size=(256, 256), conf=0.1, pre_nms=64, max_det=6, sim=0.4,
            max_ties=2)
REALTIME = dict(frames=43, hw=(1080, 1920), batch=8, faces=3, rounds=3,
                pre_nms=256, max_det=16)
# phase 15: the ONNX executor path (the stand-in files of phase 11 through
# models/onnx_exec.py): SCRFD timed at these canvas counts and ArcFace at
# these crop counts; the realtime app's capture (frames, batch)
ONNX_EXEC = dict(det_canvases=(8, 96), rec_crops=(80, 960), canvas=(384, 640),
                 realtime=(16, 8))
# phase 16: the camera apps' synthetic cameras (1080p and 720p sizes,
# frames a camera, the dual app's pairs) and the decode pool (processes,
# slot bytes)
CAMERAS = dict(hd=(1080, 1920), sd=(720, 1280), frames=24, dual_pairs=24,
               workers=2, slot_bytes=1920 * 1080 * 3)
TOL_CANVAS = 1e-4       # dynamic canvas vs exact-shape letterbox
TOL_RECORD = 1e-5       # engine floats (similarities), card vs CPU
# phase 18: (a) card vs CPU, (b) the released training shape (WebFace600K's
# classes), (c) one batch memorized, (d) the CLIs to the pipeline
TRAIN = dict(
    cmp=dict(rec="w600k_mbf", batch=16, classes=1000, steps=3, rate=0.1),
    full=dict(rec="w600k_r50", batch=128, classes=600_000, rate=0.1, warm=3,
              timed=10),
    learn=dict(rec="w600k_mbf", batch=64, classes=64, steps=30, lr=0.1),
    loop=dict(rec="w600k_mbf", steps=5, batch=64, crops=64, frames=8,
              hw=(1080, 1920), calls=2))
# card vs CPU: the f32 first loss and the float64 losses relative; in
# float64 every tensor within atol + rtol * max |CPU| after one step and
# after three; the exported embedder's cosine
TOL_TRAIN = dict(loss=1e-5, loss64=1e-11, double=(1e-12, 1e-10),
                 cos=0.9999)
# phase 19, the detector: (a) card vs CPU, (b) det_10g at
# tools.train_scrfd's defaults, (c) one batch memorized, (d) a labelled set
# through the data path (one shuffled pass, trained over ``passes`` times),
# training, AP, export and the pipeline (conf between the conf_ranks-th
# highest anchor scores of the frames)
# phase 20: multi-device serving: slots when the machine has one card;
# (a) the dense sharded gallery (rows, queries, k); (b) the sharded PQ
# gallery's capacity (phase 7's codec and rows), k and the AutoGallery's
# rows to migrate at; (c) frame DP at phase 4's width; (d) disaggregation's
# batches
PAR = dict(slots=4, dense=(1_000_000, 80, 5), pq_capacity=2_000_000, k=5,
           auto_min_rows=4096,
           dp=dict(frames=8, hw=(1080, 1920), max_num=10, gallery=128),
           disagg=dict(batches=4))
# phase 21: the trainers' mesh over phase 20's slots: (a) the mesh against
# the card's one-device trainer in float64 (ArcFace on ('data', 'model')
# with classes that do not split over 'model', full softmax and Partial FC;
# the detector over 'data' on one image a slot, their face counts unequal);
# (b) the full-width steps timed as 18b / 19b; (c) a mesh-trained
# checkpoint through FacePipeline; (d) both CLIs on --slots
TRAIN_MESH = dict(
    cmp=dict(rec="w600k_mbf", batch=16, classes=1001, rate=0.1, steps=3,
             det="det_500m", size=640, max_gt=8),
    full=dict(rec="w600k_r50", batch=128, classes=600_000, rate=0.1,
              det="det_10g", size=640, det_batch=32, max_gt=32,
              det_batches=4, warm=3, timed=10),
    serve=dict(rec="w600k_mbf", classes=64, batch=16, steps=3, crops=64,
               frames=8, hw=(1080, 1920), calls=2),
    cli=dict(steps=2, rec="w600k_mbf", batch=64, det="det_500m",
             det_batch=4))
# phase 22: the release sign-off tools (tools/verify_release.py and
# release_check.py) on the card: seeded synthetic frames of mixed sizes
# (480x640, 720x1280, 1080x1920), the gate's dry run on 8 slots of the card
SIGNOFF = dict(frames=3, gate_slots=8)
# phase 23: (a) exp_pq_scale's gallery, query sweep and dense / recall
# rows, K2 held to its plain version at k2_checks (Q, precision) on the
# swept gallery, and "wide": a gallery of g rows whose codes are drawn on
# the card, one search past 2^31 scores (Q x G) and K2 held to its plain
# version on it (None where the swept gallery is itself past 2^31); (b)
# the synchronous crossing at each sync_rows, the background one at
# async_rows; (c) the duplicate scan; (d) the codec budget; (e) the
# lookup cell, the fused top-k against the unfused path. The default
# call cuts the tools' defaults (GALLERY_SCALE_FULL, --full-scale) to fit
# beside the other phases: the 10M host fill, the sweep's Q = 64 and 128,
# the 2M-row dense and recall rows, the 1M and 2M crossings, the 1M scan
# and the 1M budget rows
# 23e: the benchmark's lookup cell (10M rows of 1M identities, a 32nd of
# a row's sub-codes drawn anew; 64 queries near rows, top 5 in "hilo"), the
# fused top-k against the plain chain and K2 + mask + sort
LOOKUP_CELL = dict(g=10_000_000, identities=1_000_000, changed=1 / 32,
                   q=64, k=5, precision="hilo", noise=0.3)
GALLERY_SCALE = dict(
    pq=dict(g=1_000_000, q_sweep=(16, 256), dense_g=250_000),
    k2_checks=((16, "hilo"), (16, "hi"), (256, "hi")),
    wide=dict(g=10_000_000, q=256, precision="hi"),
    sync_rows=(250_000,), async_rows=250_000,
    merge=dict(g=200_000, dups=2000, threshold=0.95),
    budget=dict(rows=250_000, queries=256),
    fused=LOOKUP_CELL)
GALLERY_SCALE_FULL = dict(
    pq=dict(g=10_000_000, q_sweep=(16, 64, 128, 256), dense_g=2_000_000),
    k2_checks=((16, "hilo"), (16, "hi"), (256, "hi")),
    wide=None,
    sync_rows=(1_000_000, 2_000_000), async_rows=1_000_000,
    merge=dict(g=1_000_000, dups=2000, threshold=0.95),
    budget=dict(rows=1_000_000, queries=256),
    fused=LOOKUP_CELL)
# phase 24: the tools' defaults: (a) exp_microbatch (requests, threads,
# image side, the collector's wait, the models, the detector's input);
# (b) exp_convergence (steps, eval interval, batches, the
# detector's side) and the floors its last points must reach (the JAX
# record: 1.00 and 0.979); (c) bench_ingest on the synthetic source, 100
# frames a stream where the tool takes 300 (its defaults run alone)
HOST_TOOLS = dict(
    microbatch=dict(requests=64, threads=16, size=640, max_wait_ms=4.0,
                    det="det_10g", rec="w600k_r50", det_size=(640, 640)),
    convergence=dict(arc_steps=300, det_steps=400, eval_every=50, batch=32,
                     det_batch=8, size=320, min_accuracy=0.95, min_ap=0.90),
    ingest=dict(res=(1920, 1080), frames=100, streams=(1, 2, 4, 8)))
# phase 25: the measurement tools at their defaults (profile_stages also at
# 96 frames, the bf16 bench path's batch); check_n crops for exp_r50's
# prefix check
PROFILE_TOOLS = dict(
    profile_stages=dict(batches=(32, 96), iters=20),
    exp_r50=dict(n=960, sweep=(240, 480), iters=10, check_n=64),
    exp_r50b=dict(batches=(960, 480)),
    exp_scrfd=dict(batch=32, iters=20, size=640),
    trace_ops=dict(what="backbone", batch=32, iters=5, top=30),
    exp_int8=dict(convs=((64, 160, 160, 56, 56), (64, 160, 160, 128, 128),
                         (32, 80, 80, 256, 256)),
                  matmul=8192, chain_batch=16))
# phase 26: the decision tools: synthetic identities (eval, train and val
# ones), the committed checkpoints' eval slice (visits an identity,
# verification pairs), a few steps of each trainer from the committed
# weights (eval every eval_every), the replay's visits (misses of them not
# in the cache) through the tool's default models
DECISIONS = dict(
    ids=dict(eval=8, train=8, val=4), seed=0,
    eval=dict(visits=3, pairs=8),
    train=dict(det_steps=20, emb_steps=20, eval_every=10, det_batch=8,
               emb_batch=64, per_id=4),
    replay=dict(visits=24, misses=6, det="det_10g", rec="w600k_r50",
                det_size=(640, 640)))
TOL_DECISION = 1e-4     # f32 card vs CPU: verification means, ties
TRAIN_DET = dict(
    cmp=dict(det="det_500m", size=640, batch=4, max_gt=8, steps=3),
    full=dict(det="det_10g", size=640, batch=32, max_gt=32, warm=3,
              timed=10),
    learn=dict(det="det_500m", size=640, batch=4, max_gt=8, steps=30,
               lr=0.01),
    loop=dict(det="det_500m", size=640, images=16, batch=4, max_gt=8,
              passes=5, lr=0.01, cli_steps=3, frames=8, hw=(1080, 1920),
              calls=2, conf_ranks=(16, 64)))


def fail(msg):
    raise RuntimeError(msg)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Report:
    def __init__(self, card):
        self.card = card

    def say(self, msg):
        print(f"{msg}  [{self.card}]", flush=True)


def time_ms(torch, fn, iters=10, flush_bytes=64 << 20):
    """Mean device time of fn() over ``iters`` launches, each after a
    write that flushes the 50 MB L2, so every launch finds it cold. A
    device-side spin (about 5 ms) after the flush keeps the card busy
    while the host enqueues fn(), so the host's launch overhead is not
    counted as device time unless fn() takes longer than that to enqueue."""
    scratch = torch.empty(flush_bytes, dtype=torch.uint8, device=DEV)
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        scratch.zero_()
        torch.cuda._sleep(10_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def synthetic_frames(torch, rng, b, h, w):
    """Smooth u8 BGR frames (B, H, W, 3) on the card from a numpy seed."""
    base = torch.from_numpy(rng.uniform(0, 255, (b, 3, max(h // 16, 2),
                                                 max(w // 16, 2)))
                            .astype(np.float32)).to(DEV)
    big = torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear",
                                          align_corners=False)
    return big.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1
                                                            ).contiguous()


def warp_matrices(rng, n, h, w):
    """(n, 2, 3) src -> dst similarities: scale 0.2-4 source px per crop px,
    any rotation, centers up to 30 % outside the frame; then a singular
    matrix, a NaN one and a wholly off-frame one."""
    ms = np.zeros((n, 2, 3), np.float32)
    for i in range(n):
        sigma = rng.uniform(0.2, 4.0)
        ang = rng.uniform(-np.pi, np.pi)
        cx = rng.uniform(-0.3 * w, 1.3 * w)
        cy = rng.uniform(-0.3 * h, 1.3 * h)
        rot = np.array([[np.cos(ang), -np.sin(ang)],
                        [np.sin(ang), np.cos(ang)]]) / sigma
        ms[i, :, :2] = rot
        ms[i, :, 2] = np.array([55.5, 55.5]) - rot @ np.array([cx, cy])
    ms[0] = 0.0
    ms[1, :, 2] = np.nan
    ms[2] = [[1, 0, -1e6], [0, 1, 0]]
    return ms


def tap_coords(torch, minv, oh=112, ow=112):
    gy, gx = torch.meshgrid(torch.arange(oh, dtype=torch.float32,
                                         device=minv.device),
                            torch.arange(ow, dtype=torch.float32,
                                         device=minv.device), indexing="ij")
    sx = (minv[:, 0, 0, None, None] * gx + minv[:, 0, 1, None, None] * gy
          + minv[:, 0, 2, None, None])
    sy = (minv[:, 1, 0, None, None] * gx + minv[:, 1, 1, None, None] * gy
          + minv[:, 1, 2, None, None])
    return sx, sy


def warp_bound(torch, frames, minv, frame_idx):
    """Least time for K1's work: every distinct source byte the crops touch
    read once, the f32 crops written once, the matrices and indices read;
    or the arithmetic at the fp32 rate, whichever is larger."""
    b, h, w, _ = frames.shape
    f = minv.shape[0]
    sx, sy = tap_coords(torch, minv)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    base = frame_idx.to(torch.int64)[:, None, None] * h
    lins = []
    for dy in (0.0, 1.0):
        for dx in (0.0, 1.0):
            xt, yt = x0 + dx, y0 + dy
            inside = (xt >= 0) & (xt <= w - 1) & (yt >= 0) & (yt <= h - 1)
            lin = (base + torch.where(inside, yt, 0).to(torch.int64)) * w \
                + torch.where(inside, xt, 0).to(torch.int64)
            lins.append(lin[inside])
    distinct = int(torch.unique(torch.cat(lins)).numel())
    nbytes = distinct * 3 + f * 3 * 112 * 112 * 4 + f * 6 * 4 + f * 4
    flops = f * 112 * 112 * WARP_FLOPS_PER_PIXEL
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes


def grid_sample_yardstick(torch, frames, minv, frame_idx):
    """``affine_grid`` + ``grid_sample`` (bilinear, zero padding) computing
    the same crops, timed as a yardstick only: frames pre-converted to f32
    NCHW, each frame's crops stacked along the output height (padded with
    empty crops to one count per frame) so one call serves the batch; no
    normalize, no channel swap. Returns the call and its (F, 112, 112, 3)
    crops in the caller's order, for a sanity check."""
    nnf = torch.nn.functional
    b, h, w, _ = frames.shape
    src = frames.permute(0, 3, 1, 2).to(torch.float32).contiguous()
    fi = frame_idx.cpu().numpy()
    per = max(int(np.bincount(fi, minlength=b).max()), 1)
    slot = np.zeros(len(fi), np.int64)
    seen = np.zeros(b, np.int64)
    for i, fr in enumerate(fi):
        slot[i], seen[fr] = seen[fr], seen[fr] + 1
    rows = torch.from_numpy(fi * per + slot).to(minv.device)
    # output pixel j = 56 * x_n + 55.5 (align_corners=False); source
    # x_n = (2 * sx + 1) / w - 1, with sx = m00 * j + m01 * i + m02
    theta = torch.zeros((b * per, 2, 3), device=minv.device)
    theta[:, :, 2] = 4.0                       # padding crops sample nothing
    for r, size in ((0, w), (1, h)):
        m0, m1, m2 = minv[:, r, 0], minv[:, r, 1], minv[:, r, 2]
        theta[rows, r, 0] = 2 / size * m0 * 56
        theta[rows, r, 1] = 2 / size * m1 * 56
        theta[rows, r, 2] = 2 / size * (m0 * 55.5 + m1 * 55.5 + m2) \
            + 1 / size - 1

    def call():
        grid = nnf.affine_grid(theta, (b * per, 3, 112, 112),
                               align_corners=False)
        return nnf.grid_sample(src, grid.view(b, per * 112, 112, 2),
                               mode="bilinear", padding_mode="zeros",
                               align_corners=False)

    out = call().view(b, 3, per, 112, 112).permute(0, 2, 3, 4, 1)
    return call, out.reshape(b * per, 112, 112, 3)[rows]


def compare_k1(torch, wa, frames, minv, frame_idx, out_hw=(112, 112)):
    """Kernel vs plain on the same card tensors: same NaN positions, and
    the max abs difference of the rest in u8 units."""
    got = wa.warp_align_crops(frames, minv, frame_idx, out_hw)
    want = wa.warp_align_plain(frames, minv, frame_idx, out_hw)
    torch.cuda.synchronize()
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        fail("warp_align: NaN pattern differs from the plain version")
    fin = ~torch.isnan(want)
    err = float((got[fin] - want[fin]).abs().max()) * 127.5 if fin.any() else 0.0
    if not err <= TOL_U8:
        fail(f"warp_align: max abs err {err} u8 > {TOL_U8}")
    return err, got


def k1_edges(torch, wa, rng):
    """K1 against its plain version on each set of ``K1_EDGES``; returns
    the largest error and a line for the report."""
    errs = []
    for name, nb, h, w, nc, out_hw, off in K1_EDGES:
        frames = synthetic_frames(torch, rng, nb, h, w)
        # warp_matrices' first three are degenerate: drawn only with room
        ms = (warp_matrices(rng, nc, h, w) if nc >= 3 else
              warp_matrices(rng, nc + 3, h, w)[3:])
        fidx = rng.integers(0, nb, nc).astype(np.int32)
        if off:     # every other crop's index below 0 or past B, in turn
            bad = fidx[::2]
            bad[0::2], bad[1::2] = -off, nb - 1 + off
        err, got = compare_k1(torch, wa, frames, wa_inputs(torch, ms),
                              torch.from_numpy(fidx).to(DEV), out_hw)
        if got.shape != (nc, 3, *out_hw):
            fail(f"K1 edge set {name}: shape {tuple(got.shape)}")
        errs.append((name, err))
    return max(e for _, e in errs), "; ".join(f"{n} {e:.6g}" for n, e in errs)


def k1_times(torch, wa, frames, minv, frame_idx):
    ms = time_ms(torch, lambda: wa.warp_align_crops(frames, minv, frame_idx))
    plain_ms = time_ms(torch, lambda: wa.warp_align_plain(frames, minv,
                                                          frame_idx))
    lib_call, _ = grid_sample_yardstick(torch, frames, minv, frame_idx)
    lib_ms = time_ms(torch, lib_call)
    bound_ms, bound_by, nbytes = warp_bound(torch, frames, minv, frame_idx)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)


class StageTimer:
    """Stage hook: CUDA events around every pipeline stage."""

    def __init__(self, torch):
        self.torch = torch
        self.events = []

    @contextlib.contextmanager
    def __call__(self, name):
        s = self.torch.cuda.Event(enable_timing=True)
        e = self.torch.cuda.Event(enable_timing=True)
        s.record()
        try:
            yield
        finally:
            e.record()
            self.events.append((name, s, e))

    def totals(self):
        self.torch.cuda.synchronize()
        out = {}
        for name, s, e in self.events:
            out[name] = out.get(name, 0.0) + s.elapsed_time(e)
        return out


def phase_kernel_vs_plain(torch, wa, rep):
    rng = np.random.default_rng(0)
    nb, h, w, nc = K1_CASE
    frames = synthetic_frames(torch, rng, nb, h, w)
    ms = warp_matrices(rng, nc, h, w)
    fidx = rng.permutation(np.arange(nc) % nb).astype(np.int32)
    minv = wa_inputs(torch, ms)
    fidx_t = torch.from_numpy(fidx).to(DEV)
    err, got = compare_k1(torch, wa, frames, minv, fidx_t)
    n_nan = int(torch.isnan(got).flatten(1).all(1).sum())
    if n_nan < 2:
        fail("the degenerate crops did not come out NaN")
    rep.say(f"K1 vs plain, {nb}x{h}x{w} frames, {nc} crops (scale 0.2-4, any "
            f"rotation, off-frame, {n_nan} degenerate/NaN crops): "
            f"max_abs_err {err:.6g} u8 (tolerance {TOL_U8})")
    # frames narrower than the TPU kernel's 512-px window
    frames_n = synthetic_frames(torch, rng, 4, 300, 400)
    ms_n = warp_matrices(rng, 40, 300, 400)
    fidx_n = torch.from_numpy(rng.integers(0, 4, 40).astype(np.int32)).to(DEV)
    err_n, _ = compare_k1(torch, wa, frames_n, wa_inputs(torch, ms_n), fidx_n)
    rep.say(f"K1 vs plain, 4x(300x400) frames, 40 crops: max_abs_err "
            f"{err_n:.6g} u8")
    err_e, said = k1_edges(torch, wa, rng)
    rep.say(f"K1 vs plain on its edge sets, max_abs_err u8: {said}")
    occ = wa.occupancy()
    rep.say(f"K1 launch: {occ['threads']} threads a CTA, {occ['rows']} output "
            f"rows a CTA ({-(-112 // occ['rows'])} CTAs a 112-row crop), "
            f"{occ['blocks_per_sm']} CTAs an SM (occupancy API), "
            f"{occ['regs']} registers a thread")
    t = k1_times(torch, wa, frames, minv, fidx_t)
    _, lib_crops = grid_sample_yardstick(torch, frames, minv, fidx_t)
    plain = wa.warp_align_plain(frames, minv, fidx_t)
    plain_u8 = (plain * 127.5 + 127.5).permute(0, 2, 3, 1).flip(-1)
    fin = torch.isfinite(plain_u8) & torch.isfinite(lib_crops)
    lib_err = float((plain_u8[fin] - lib_crops[fin]).abs().max())
    rep.say(f"K1 times at {nb}x{h}x{w} / {nc} crops: kernel {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, affine_grid + grid_sample "
            f"{t['library_ms']:.4f} ms (its max diff from the plain crops "
            f"{lib_err:.4g} u8), "
            f"bound {t['bound_ms']:.4f} ms by {t['bound_by']} "
            f"({t['bytes']} B at 3.35 TB/s)")
    # bench.py's batch: 96 frames, up to 960 crops
    nb, h, w, nc = K1_BENCH
    frames = synthetic_frames(torch, rng, nb, h, w)
    minv = wa_inputs(torch, warp_matrices(rng, nc, h, w))
    fidx_t = torch.from_numpy(
        rng.permutation(np.arange(nc) % nb).astype(np.int32)).to(DEV)
    err_b, _ = compare_k1(torch, wa, frames, minv, fidx_t)
    ms_b = time_ms(torch, lambda: wa.warp_align_crops(frames, minv, fidx_t))
    bound, by, nbytes = warp_bound(torch, frames, minv, fidx_t)
    rep.say(f"K1 at {nb}x{h}x{w} / {nc} crops: kernel {ms_b:.4f} ms, bound "
            f"{bound:.4f} ms by {by} ({nbytes} B at 3.35 TB/s), "
            f"max_abs_err {err_b:.6g} u8")
    return max(err, err_n, err_e, err_b)


def wa_inputs(torch, ms):
    from scrfd_arcface_facerecognition_tpu_torch import ops

    return ops.invert_affine(torch.from_numpy(ms).to(DEV)).contiguous()


def phase_main_path(torch, rep):
    from scrfd_arcface_facerecognition_tpu_torch import FacePipeline, stages
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.pipeline.embedder import (
        crop_matrices)
    from scrfd_arcface_facerecognition_tpu_torch.pipeline.face_pipeline import (
        bucket_slots)

    t0 = time.perf_counter()
    nb, (h, w), max_num, ng = (MAIN["frames"], MAIN["hw"], MAIN["max_num"],
                               MAIN["gallery"])
    pipe = FacePipeline(det_variant=MAIN["det"], rec_variant=MAIN["rec"],
                        gallery_capacity=ng, seed=0, device=DEV)
    rng = np.random.default_rng(0)
    pipe.set_gallery(rng.normal(size=(ng, 512)).astype(np.float32),
                     [f"p{i}" for i in range(ng)])
    frames = torch.from_numpy(rng.integers(0, 255, (nb, h, w, 3),
                                           dtype=np.uint8)).to(DEV)
    frames2 = torch.from_numpy(rng.integers(0, 255, (nb, h, w, 3),
                                            dtype=np.uint8)).to(DEV)
    pipe(frames, max_num=max_num)            # warm-up (cuDNN, allocator)
    torch.cuda.synchronize()
    rep.say(f"main path: {MAIN['det']} + {MAIN['rec']} seeded on "
            f"{pipe.device}, {nb}x{h}x{w} frames, gallery {ng}; setup + "
            f"warm-up {time.perf_counter() - t0:.2f} s")

    timer = StageTimer(torch)
    wa.launches = 0
    stages.set_stage_hook(timer)
    call_ms, outs = [], []
    for _ in range(3):
        t = time.perf_counter()
        out = pipe(frames, max_num=max_num)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t) * 1e3)
        outs.append(out)
    stage_ms = timer.totals()
    stream = list(pipe.process_stream([frames, frames2], max_num=max_num))
    torch.cuda.synchronize()
    stages.set_stage_hook(None)
    launches = wa.launches

    if launches == 0:
        fail("main path launched the warp kernel no time")
    for o in outs + stream:
        faces = int(o.valid.sum())
        if faces <= 0:
            fail("main path found no faces")
        if o.embeddings.shape != (nb, max_num, 512):
            fail(f"embeddings shape {tuple(o.embeddings.shape)}")
        ev = o.embeddings[o.valid]
        if not bool(torch.isfinite(ev).all()):
            fail("non-finite embeddings on valid slots")
        norms = ev.norm(dim=-1)
        if not bool(((norms - 1).abs() < 1e-3).all()):
            fail("valid embeddings are not unit-norm")
        if not bool((o.embeddings[~o.valid] == 0).all()):
            fail("invalid slots carry embeddings")
    faces = int(outs[-1].valid.sum())
    rep.say(f"main path: faces found {faces} per {nb}-frame call, "
            f"{int(stream[0].valid.sum())}/{int(stream[1].valid.sum())} in the "
            f"stream; K1 launches {launches} over 3 calls + 2 stream batches; "
            f"embeddings finite and unit-norm on valid slots; "
            f"matches {int((outs[-1].match_idx >= 0).sum())}")
    rep.say(f"main path: ms per {nb}x{h}x{w} call " + ", ".join(
        f"{m:.2f}" for m in call_ms) + f" (median {sorted(call_ms)[1]:.2f})")
    rep.say("main path per-stage device ms (mean of 3 calls): " + ", ".join(
        f"{k} {stage_ms.get(k, 0.0) / 3:.3f}" for k in stages.STAGES))

    # the kernel at the shapes this path gave it (last call)
    o = outs[-1]
    b, k = o.valid.shape
    bucket = pipe._round_bucket(faces, b * k)
    sel, fidx = bucket_slots(o.valid, bucket)
    kps = o.kps.reshape(b * k, 5, 2)[sel]
    minv = crop_matrices(kps)
    err, _ = compare_k1(torch, wa, frames, minv, fidx)
    t = k1_times(torch, wa, frames, minv, fidx)
    cm_ms = time_ms(torch, lambda: crop_matrices(kps))
    rep.say(f"K1 at the main path's shapes ({nb}x{h}x{w}, {bucket} crops): "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"affine_grid + grid_sample {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} "
            f"ms by {t['bound_by']} ({t['bytes']} B), max_abs_err {err:.6g} u8; "
            f"crop_matrices (umeyama + inverse) on the same {bucket} faces "
            f"{cm_ms:.4f} ms")
    return launches, err, t, o.embeddings[o.valid].cpu().numpy()


@contextlib.contextmanager
def full_f32(torch):
    """TF32 off for convolutions and matmuls inside the block, the
    process's settings restored after it (the phases after it time the
    paths at PyTorch's defaults)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def phase_card_vs_cpu(torch, rep):
    """The port on the card against the port on the CPU; run it inside
    ``full_f32``."""
    from scrfd_arcface_facerecognition_tpu_torch.models.arcface import (
        ArcFaceConfig)
    from scrfd_arcface_facerecognition_tpu_torch.models.scrfd import (
        SCRFDConfig)
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
        Detector, Embedder, FacePipeline)

    det_cfg = SCRFDConfig("small_det", 16, (1, 2, 1, 1), (16, 16, 32, 48),
                          neck_filters=16, head_stacks=2, head_filters=32,
                          gn_groups=8)
    emb_cfg = ArcFaceConfig("small_r", "iresnet", emb_dim=128,
                            stage_blocks=(1, 2, 2, 1),
                            stage_filters=(16, 32, 64, 64))
    rng = np.random.default_rng(1)
    frames = synthetic_frames(torch, rng, 2, 240, 320).cpu().numpy()
    gallery = rng.normal(size=(8, 128)).astype(np.float32)

    def build(device):
        det = Detector(config=det_cfg, input_size=(320, 320), seed=3,
                       conf_thres=0.5, pre_nms=64, max_det=8, device=device)
        emb = Embedder(config=emb_cfg, seed=4, device=device)
        return FacePipeline(detector=det, embedder=emb, gallery_capacity=16,
                            similarity_thresh=0.3, device=device)

    cpu, gpu = build("cpu"), build(DEV)
    first = cpu(frames, max_num=4)
    valid = first.valid.numpy()
    gal = np.concatenate([gallery, first.embeddings.numpy()[valid]], 0)
    for p in (cpu, gpu):
        p.set_gallery(gal, [str(i) for i in range(len(gal))])
    want = cpu(frames, max_num=4)
    got = [t.cpu() for t in gpu(frames, max_num=4)]
    tb, ts, tk, tv, tc, te, ti, tm = got
    if int(want.valid.sum()) == 0:
        fail("card-vs-CPU phase found no faces")
    if not (torch.equal(tv, want.valid) and torch.equal(tc, want.count)
            and torch.equal(ti, want.match_idx)):
        fail("card vs CPU: valid/count/match_idx differ")
    db = float((tb - want.boxes).abs().max())
    dk = float((tk - want.kps).abs().max())
    ds = float((ts - want.scores).abs().max())
    dm = float((tm - want.match_sim).abs().max())
    a, b = te[tv], want.embeddings[tv]
    cos = float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min())
    if not (db <= 1e-2 and dk <= 1e-2 and ds <= 1e-4 and dm <= 1e-4
            and cos >= 0.9999):
        fail(f"card vs CPU out of tolerance: boxes {db} kps {dk} scores {ds} "
             f"match_sim {dm} cos {cos}")
    rep.say(f"card vs CPU (TF32 off), {int(tv.sum())} faces, "
            f"{int((ti >= 0).sum())} matches: valid/count/match_idx equal; "
            f"max |d| boxes {db:.3g} px, kps {dk:.3g} px, scores {ds:.3g}, "
            f"match_sim {dm:.3g}; min embedding cosine {cos:.7f}")


class HostStageTimer:
    """Stage hook for the gallery: host clock around each stage, with the
    device synchronized on entry and exit, since the migration's stages mix
    host and device work."""

    def __init__(self, torch):
        self.torch = torch
        self.ms = {}

    @contextlib.contextmanager
    def __call__(self, name):
        self.torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            yield
        finally:
            self.torch.cuda.synchronize()
            self.ms[name] = (self.ms.get(name, 0.0)
                             + (time.perf_counter() - t) * 1e3)


def compare_k2(torch, pq_adc, lut, codes, precision):
    """Kernel vs plain on the same card tensors: same NaN and inf positions,
    and the max abs difference of the rest, absolute and relative to the
    largest |score|."""
    got = pq_adc.pq_adc_scores(lut, codes, precision)
    want = pq_adc.adc_scores_plain(lut, codes, precision)
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"pq_adc: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.isinf(got), torch.isinf(want))):
        fail("pq_adc: NaN/inf pattern differs from the plain version")
    fin = torch.isfinite(want)
    if not bool(fin.any()):
        return 0.0, 0.0
    err = float((got[fin] - want[fin]).abs().max())
    rel = err / max(float(want[fin].abs().max()), 1e-30)
    if not rel <= TOL_K2:
        fail(f"pq_adc ({precision}): max abs err {err} = {rel} of max "
             f"|score| > {TOL_K2}")
    inf = torch.isinf(want)
    if not torch.equal(got[inf], want[inf]):
        fail("pq_adc: infinite scores differ in sign")
    return err, rel


def k2_count(pq_adc):
    """K2's launches: the scoring kernel's and the fused top-k's."""
    return pq_adc.launches + pq_adc.topk_launches


def k2_reset(pq_adc):
    pq_adc.launches = pq_adc.topk_launches = 0


def k2_capture():
    """The PQ searches' K2 calls (``gallery.pq.adc_candidates``, K2 with
    the top-k fused in): each call's (lut, codes, valid, k, precision),
    cloned before the call."""
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq

    return captured_calls(pq, "adc_candidates")


def compare_topk(torch, pq_adc, what, lut, codes, valid, k, precision,
                 row_offset=0, block=64):
    """The fused top-k (one call over every query) against the plain chain
    (``pq_adc.topk_plain``: the plain scores, independent of K2, invalid
    rows to -inf, a stable sort) and against the chain it replaces (K2's
    scores, the mask, the sort), ``block`` queries at a time, on the same
    card tensors: rows equal, scores equal as bits, NaN where NaN. No
    launch is counted. Returns the number of (query, place) pairs
    compared."""
    n0 = (pq_adc.launches, pq_adc.topk_launches)
    got_s, got_i = pq_adc.pq_adc_topk(lut, codes, valid, k, precision,
                                      row_offset)
    for name, scores in (("the plain chain", pq_adc.adc_scores_plain),
                         ("K2 + mask + sort", pq_adc.pq_adc_scores)):
        for q0 in range(0, lut.shape[0], block):
            want_s, want_i = pq_adc.topk_plain(
                lut[q0:q0 + block].contiguous(), codes, valid, k, precision,
                row_offset, scores=scores)
            s, i = got_s[q0:q0 + block], got_i[q0:q0 + block]
            nan = torch.isnan(want_s)
            if not (s.shape == want_s.shape and torch.equal(i, want_i)
                    and torch.equal(torch.isnan(s), nan) and torch.equal(
                        s[~nan].view(torch.int32),
                        want_s[~nan].view(torch.int32))):
                fail(f"{what}: the fused top-k ({precision}, k={k}) differs "
                     f"from {name} in queries {q0}.."
                     f"{q0 + len(want_i) - 1}")
            del want_s, want_i
    pq_adc.launches, pq_adc.topk_launches = n0
    return got_i.numel()


def k2_lut(torch, rng, q, m, k):
    """A normal (Q, M, K) f32 LUT on the card; from Q=3 on, query 1 is
    NaN at one subspace and query 2 has infinite entries at another."""
    lut = rng.normal(size=(q, m, k)).astype(np.float32)
    if q >= 3:
        lut[1, 5, :] = np.nan
        lut[2, 7, : k // 2] = np.inf
    return torch.from_numpy(lut).to(DEV)


def k2_codes(torch, rng, g, m, k, offset=0):
    """Uniform (G, M) u8 codes on the card, a contiguous view starting
    ``offset`` bytes into its buffer."""
    codes = torch.from_numpy(rng.integers(0, k, (g, m), dtype=np.uint8))
    buf = torch.empty(g * m + offset, dtype=torch.uint8, device=DEV)
    view = buf[offset:].view(g, m)
    view.copy_(codes)
    if (view.data_ptr() % 16 == 0) != (offset % 16 == 0):
        fail(f"pq_adc: codes view at offset {offset} has the wrong "
             f"alignment")
    return view


def phase_k2_vs_plain(torch, pq_adc, rep):
    rng = np.random.default_rng(2)
    worst = (0.0, 0.0)
    n_cases = 0

    def check(lut, codes):
        nonlocal worst, n_cases
        for precision in pq_adc.PRECISIONS:
            err, rel = compare_k2(torch, pq_adc, lut, codes, precision)
            worst = max(worst, (err, rel), key=lambda x: x[1])
            n_cases += 1

    for m in (64, 12):
        for k in K2_GRID["k"]:
            g_max = max(K2_GRID["g"]) if m == 64 else 4097
            codes_all = k2_codes(torch, rng, g_max, m, k)
            for q in K2_GRID["q"]:
                lut = k2_lut(torch, rng, q, m, k)
                for g in K2_GRID["g"]:
                    if g <= g_max:
                        check(lut, codes_all[:g])
            del codes_all
    for m, k, g, offset in K2_EDGES:
        codes = k2_codes(torch, rng, g, m, k, offset)
        for q in K2_GRID["q"]:
            check(k2_lut(torch, rng, q, m, k), codes)
        del codes
    rep.say(f"K2 vs plain, {n_cases} cases (both precisions; Q "
            f"{K2_GRID['q']}, G {K2_GRID['g']}, K {K2_GRID['k']}, M 64 and "
            f"12, NaN and inf LUT entries; then (M, K, G, codes offset) "
            f"{K2_EDGES}: unaligned codes, three slabs, K % 4 != 0): NaN/inf "
            f"positions equal, max abs err {worst[0]:.6g} = {worst[1]:.3g} "
            f"of max |score| (tolerance {TOL_K2}, expected 0)")
    return worst[0]


def k2_bound(q, m, k, g, precision, top_k=None):
    """Least time for K2's work: code bytes, LUT bytes (2 a entry in "hi")
    and score bytes once at the HBM rate, or Q*G*M adds at the f32 rate.
    With ``top_k``, the fused top-k's: no scores stored, but the rows'
    valid flags read and the (Q, top_k) answers (f32 and int64)
    written."""
    nbytes = g * m + q * m * k * (2 if precision == "hi" else 4) + (
        q * g * 4 if top_k is None else g + q * top_k * 12)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = q * g * m / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes


def k2_times(torch, pq_adc, lut, codes, precision):
    """K2, its plain version and one embedding_bag call (the yardstick: the
    same (G, Q) sums over codes offset into an (M*K, Q) table) on the same
    card tensors; the yardstick's result is held to the plain version's."""
    q, m, k = lut.shape
    g = codes.shape[0]
    ms = time_ms(torch, lambda: pq_adc.pq_adc_scores(lut, codes, precision))
    plain_ms = time_ms(torch, lambda: pq_adc.adc_scores_plain(
        lut, codes, precision), iters=3)
    table = lut if precision == "hilo" else lut.to(torch.bfloat16).float()
    weight = table.permute(1, 2, 0).reshape(m * k, q).contiguous()
    idx = codes.long() + torch.arange(m, device=DEV)[None, :] * k
    nnf = torch.nn.functional

    def lib():
        return nnf.embedding_bag(idx, weight, mode="sum")

    library_ms = time_ms(torch, lib, iters=3)
    want = pq_adc.adc_scores_plain(lut, codes, precision)
    lib_rel = float((lib().T - want).abs().max() / want.abs().max())
    del idx, weight
    bound_ms, bound_by, nbytes = k2_bound(q, m, k, g, precision)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                lib_rel=lib_rel)


def identity_rows(rng, n, idents, dim, sigma, chunk=100_000):
    """(n, dim) unit rows, each a noisy view (per-dim noise sigma) of one of
    `idents` random unit centers, the identity drawn at random per row (so
    any id range spans the identities), made in chunks."""
    centers = rng.standard_normal((idents, dim), dtype=np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    ident = rng.integers(0, idents, n)
    rows = np.empty((n, dim), np.float32)
    for i0 in range(0, n, chunk):
        blk = centers[ident[i0:i0 + chunk]]
        blk += sigma * rng.standard_normal(blk.shape, dtype=np.float32)
        blk /= np.linalg.norm(blk, axis=1, keepdims=True)
        rows[i0:i0 + chunk] = blk
    return rows, ident, centers


def sync_all(torch):
    """Wait for every card (phase 20's slots may span several)."""
    for d in range(max(1, torch.cuda.device_count())):
        torch.cuda.synchronize(d)


def median_ms(torch, fn, n=5):
    out, times = None, []
    for _ in range(n):
        sync_all(torch)
        t = time.perf_counter()
        out = fn()
        sync_all(torch)
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[n // 2], times, out


def phase_gallery_path(torch, rep, main_emb):
    from scrfd_arcface_facerecognition_tpu_torch import stages
    from scrfd_arcface_facerecognition_tpu_torch.gallery import (
        AutoGallery, GalleryStore, pq_adc)

    n, dim, k = GAL["rows"], main_emb.shape[1], GAL["k"]
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    rows, ident, centers = identity_rows(rng, n, GAL["idents"], dim,
                                         GAL["sigma"])
    main_q = main_emb / np.linalg.norm(main_emb, axis=1, keepdims=True)
    known = rng.choice(n, len(main_q), replace=False)
    rows[known] = main_q
    ident[known] = -1
    ids = np.arange(n, dtype=np.int64)
    # noisy views of enrolled identities, for recall@1
    probe = rng.choice(np.flatnonzero(ident >= 0), 256, replace=False)
    probe_ident = ident[probe]
    views = centers[probe_ident] + GAL["sigma"] * rng.standard_normal(
        (len(probe), dim), dtype=np.float32)
    views /= np.linalg.norm(views, axis=1, keepdims=True)
    cos = main_q @ main_q.T
    off = cos[~np.eye(len(cos), dtype=bool)]
    rep.say(f"gallery path: {n} synthetic rows of {GAL['idents']} "
            f"identities (noise {GAL['sigma']} a dim) made in "
            f"{time.perf_counter() - t0:.1f} s; {len(main_q)} main-path "
            f"embeddings enrolled at known ids (pairwise cosine mean "
            f"{off.mean():.4f}, max {off.max():.4f})")

    timer = HostStageTimer(torch)
    stages.set_stage_hook(timer)
    ag = AutoGallery(vector_size=dim, tier="pq", device=DEV)
    torch.cuda.synchronize()
    t = time.perf_counter()
    added = ag.add_batch(ids, rows)
    torch.cuda.synchronize()
    add_ms = (time.perf_counter() - t) * 1e3
    mig = dict(timer.ms)
    if added != n or ag.tier != "pq" or ag.get_embedding_count() != n:
        fail(f"gallery: add_batch wrote {added}, tier {ag.tier}")
    cap = ag._pq.capacity
    if cap != 2 * n:
        fail(f"gallery: PQ capacity {cap} != {2 * n}")
    rep.say(f"gallery path: add_batch of {n} rows {add_ms:.0f} ms = dense "
            f"fill {add_ms - mig['pq_migrate']:.0f} ms + migration stall "
            f"{mig['pq_migrate']:.0f} ms (codec training on "
            f"{ag.pq_train_rows} rows x {ag.pq_train_iters} iterations "
            f"{mig['pq_train']:.0f} ms, encoding {n} rows "
            f"{mig['pq_encode']:.0f} ms); PQGallery capacity {cap} rows")

    # the path: search_batch, with K2's count reset just before
    timer.ms.clear()
    k2_reset(pq_adc)
    search_ms, all_ms, hits = median_ms(
        torch, lambda: ag.search_batch(main_q, k=k))
    stage_ms = {s: timer.ms[s] / len(all_ms) for s in stages.GALLERY_STAGES
                if s in timer.ms}
    stages.set_stage_hook(None)
    probe_hits = ag.search_batch(views, k=k)
    launches = k2_count(pq_adc)
    if launches == 0:
        fail("gallery path launched K2 no time")
    for i, h in enumerate(hits):
        if len(h) != k or h[0].id != known[i] or not h[0].score >= 0.9999:
            fail(f"gallery: main-path embedding {i} (id {known[i]}) found "
                 f"{[(x.id, x.score) for x in h[:2]]}")
    recall = float(np.mean([len(h) > 0 and ident[h[0].id] == want
                            for h, want in zip(probe_hits, probe_ident)]))
    if not recall >= 0.95:
        fail(f"gallery: recall@1 {recall} < 0.95")
    rep.say(f"gallery path: search_batch of {len(main_q)} queries, k={k}, "
            f"rerank {ag.pq_rerank} (K2 in 'hi'): median {search_ms:.2f} ms "
            f"of " + ", ".join(f"{x:.2f}" for x in all_ms)
            + "; stages (mean host ms a call, synchronized): " + ", ".join(
                f"{s} {v:.3f}" for s, v in stage_ms.items())
            + f"; K2 launches {launches} over 6 calls (5 of the embeddings, "
            f"1 of {len(probe)} noisy views; the shortlist of "
            f"{ag.pq_rerank} fused into K2); every embedding "
            f"finds itself first (min cosine "
            f"{min(h[0].score for h in hits):.7f}); recall@1 of "
            f"{len(probe)} noisy views {recall:.4f}")

    # the "hilo" mode: PQGallery.search without rerank
    q_norm = main_q.astype(np.float32)
    hilo_ms, _, (s0, i0) = median_ms(
        torch, lambda: ag._pq.search(q_norm, k=k), n=3)
    self_first = float(np.mean(i0[:, 0] == known))
    rep.say(f"gallery path: PQGallery.search(rerank=0, K2 in 'hilo') "
            f"median {hilo_ms:.2f} ms; ADC top-1 is the embedding itself for "
            f"{self_first:.3f} of the queries")

    # K2 at the path's shapes
    lut = ag._pq.codec.lut(q_norm)
    codes = ag._pq._codes
    errs, times = [], {}
    for precision, kk in (("hilo", k), ("hi", ag.pq_rerank)):
        compare_topk(torch, pq_adc, "gallery path", lut, codes,
                     ag._pq._shards.valid[0], kk, precision)
    for precision in pq_adc.PRECISIONS:
        errs.append(compare_k2(torch, pq_adc, lut, codes, precision)[0])
        times[precision] = k2_times(torch, pq_adc, lut, codes, precision)
        t = times[precision]
        rep.say(f"K2 at the path's shapes (Q={lut.shape[0]}, M="
                f"{lut.shape[1]}, K={lut.shape[2]}, G={codes.shape[0]}, "
                f"{precision}): kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, embedding_bag "
                f"{t['library_ms']:.4f} ms (its max diff from the plain "
                f"scores {t['lib_rel']:.3g} of max |score|), bound "
                f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({t['bytes']} B "
                f"at 3.35 TB/s), max abs err vs plain {errs[-1]:.6g}; the "
                f"fused top-k bit-equal to the plain chain and to K2 + mask "
                f"+ sort at k={k} hilo and k={ag.pq_rerank} hi")
    # the tier is scored whole: half its rows are empty (zero codes)
    filled = codes[:n]
    for precision in pq_adc.PRECISIONS:
        ms_n = time_ms(torch, lambda: pq_adc.pq_adc_scores(lut, filled,
                                                           precision))
        b_n = k2_bound(lut.shape[0], lut.shape[1], lut.shape[2], n,
                       precision)
        rep.say(f"K2 on the {n} filled rows only (G={n} of the tier's "
                f"{codes.shape[0]}; {precision}): kernel {ms_n:.4f} ms "
                f"(whole tier {times[precision]['ms']:.4f}), bound "
                f"{b_n[0]:.4f} ms by {b_n[1]}")
    for q in (1, 4, 16):
        lut_q = lut[:q].contiguous()
        for precision in pq_adc.PRECISIONS:
            ms_q = time_ms(torch, lambda: pq_adc.pq_adc_scores(
                lut_q, codes, precision))
            b_q = k2_bound(q, lut.shape[1], lut.shape[2], codes.shape[0],
                           precision)
            rep.say(f"K2 at Q={q} of the path's queries ({precision}): "
                    f"kernel {ms_q:.4f} ms, bound {b_q[0]:.4f} ms by "
                    f"{b_q[1]}")
    sc = torch.zeros((lut.shape[0], codes.shape[0]), device=DEV)
    sort_ms = time_ms(torch, lambda: torch.sort(sc, dim=-1, descending=True,
                                                stable=True), iters=3)
    topk_ms = time_ms(torch, lambda: torch.topk(sc, 32, dim=-1), iters=3)
    rep.say(f"gallery path: the stable top-k (a stable descending sort) of "
            f"the ({lut.shape[0]}, {codes.shape[0]}) scores {sort_ms:.3f} ms; "
            f"torch.topk(32) on them {topk_ms:.3f} ms (not tie-stable)")
    del sc, lut

    # the dense tier at the same rows
    t = time.perf_counter()
    dense = GalleryStore(vector_size=dim, capacity=1 << 20, device=DEV)
    dense.add_batch(ids, rows)
    torch.cuda.synchronize()
    dense_fill = time.perf_counter() - t
    dense_ms, _, dhits = median_ms(
        torch, lambda: dense.search_batch(main_q, k=k))
    same = np.mean([[a.id for a in x] == [b.id for b in y]
                    for x, y in zip(hits, dhits)])
    same1 = np.mean([x[0].id == y[0].id for x, y in zip(hits, dhits)])
    if not all(h[0].id == w for h, w in zip(dhits, known)):
        fail("dense gallery: an embedding does not find itself")
    rep.say(f"dense GalleryStore at the same {n} rows (f32, "
            f"{dense.capacity * dim * 4 / 1e9:.2f} GB on the card): fill "
            f"{dense_fill:.1f} s, search_batch median {dense_ms:.2f} ms; "
            f"the PQ tier's reranked top-{k} equals the dense top-{k} for "
            f"{same:.3f} of the queries, its top-1 for {same1:.3f}")
    del dense
    n_cpu = GAL_CPU_ROWS
    return dict(codec=ag._pq.codec, rows=rows[:n_cpu], ids=ids[:n_cpu],
                queries=np.concatenate([main_q, views[:48]]),
                launches=launches, err=max(errs), times=times["hi"],
                pq=ag._pq)


def phase_gallery_card_vs_cpu(torch, rep, codec, mat, ids, queries):
    import tempfile
    from scrfd_arcface_facerecognition_tpu_torch.gallery import (
        PQCodec, PQGallery)

    n = len(ids)
    card = PQGallery(codec, capacity=2 * n, keep_exact=True, device=DEV)
    card.add(ids, mat)
    cpu_codes = PQCodec(codec.centroids.cpu()).encode(mat)
    code_diff = int((cpu_codes != card._codes[:n].cpu()).sum())
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        path = os.path.join(d, "pq.npz")
        card.snapshot(path)
        cpu = PQGallery.restore(path, device="cpu")
    worst = 0.0
    for kw in (dict(k=5, rerank=32), dict(k=5)):
        sc, ic = card.search(queries, **kw)
        sh, ih = cpu.search(queries, **kw)
        if not np.array_equal(ic, ih):
            fail(f"gallery card vs CPU ({kw}): ids differ in "
                 f"{int((ic != ih).sum())} places")
        worst = max(worst, float(np.abs(sc - sh).max()))
    if not worst <= 1e-5:
        fail(f"gallery card vs CPU: scores {worst} apart > 1e-5")
    rep.say(f"gallery card vs CPU at {n} rows, {len(queries)} queries "
            f"(codes carried across in the npz snapshot): ids equal with "
            f"rerank 32 ('hi') and without ('hilo'), scores at most "
            f"{worst:.3g} apart; encoding the same rows on the CPU gives "
            f"{code_diff} of {mat.shape[0] * codec.m} codes that differ "
            f"from the card's")


# ---------------------------------------------------------------- K3 and K4

def k3_bound(frames_planar, canvas_planar, prm):
    """Least time for K3's work, from what this run's crops depend on
    (``exp_warp2.needed``: traced back from the kept crop pixels through
    each pass's taps with non-zero weight): the f32 crops written once,
    the params and the needed source pixels (3 channels) read once; or
    K3_FLOPS_PER_POSITION for each needed output position of the five
    passes at the f32 rate."""
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_params as wp
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_warp2

    f = prm.iparams.shape[0]
    counts, hit_f, hit_c = exp_warp2.needed(frames_planar, canvas_planar, prm)
    src_px = int(hit_f.sum()) + int(hit_c.sum())
    nbytes = f * 3 * wp.OUT * wp.OUT * 4 + f * 16 * 4 + 3 * src_px
    positions = sum(counts)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = positions * K3_FLOPS_PER_POSITION / FP32_FLOPS_PER_S * 1e3
    return dict(ms=max(t_bytes, t_ops),
                by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, src_px=src_px, positions=positions,
                flops=positions * K3_FLOPS_PER_POSITION)


def compare_k3(torch, exp_warp2, frames_planar, canvas_planar, prm):
    """K3 vs its plain version on the same card tensors: same NaN
    positions, and the max abs difference of the rest in u8 units; and the
    ranges the kernel used equal to ``fused_plan``'s."""
    f = prm.iparams.shape[0]
    plan = torch.full((f, exp_warp2.PLAN_COLS), -7, dtype=torch.int32,
                      device=DEV)
    got = exp_warp2.warp_crops_band(frames_planar, canvas_planar, prm,
                                    plan=plan)
    want = exp_warp2.warp_crops_band_plain(frames_planar, canvas_planar, prm)
    torch.cuda.synchronize()
    if not torch.equal(plan.long(), exp_warp2.fused_plan(prm)):
        bad = int((plan.long() != exp_warp2.fused_plan(prm)).any(1).sum())
        fail(f"warp_band: the kernel's ranges differ from fused_plan on "
             f"{bad} of {f} crops")
    if got.shape != want.shape:
        fail(f"warp_band: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        fail("warp_band: NaN pattern differs from the plain version")
    fin = ~torch.isnan(want)
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    if not err <= TOL_U8:
        fail(f"warp_band: max abs err {err} u8 > {TOL_U8}")
    return err


def k3_stress(torch, rng, nb, h, w, n):
    """Frames, canvas and WarpParams of n crops that leave the workload's
    envelope: scales to 8 source px a crop px (level 1, inside the canvas
    envelope and beyond it), rotations to 0.6 rad and upside down (fallback
    crops, compared all the same), centers near and past the frame edge."""
    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_params as wp

    frames = synthetic_frames(torch, rng, nb, h, w)
    ms = np.zeros((n, 2, 3), np.float32)
    for k in range(n):
        sigma = rng.uniform(0.4, 8.0)
        u = rng.random()
        ang = (rng.uniform(-0.24, 0.24) if u < 0.6 else
               rng.uniform(-0.6, 0.6) if u < 0.85 else
               np.pi + rng.uniform(-0.3, 0.3))
        cx = rng.choice([rng.uniform(-60, 120), rng.uniform(w - 120, w + 60),
                         rng.uniform(0, w)])
        cy = rng.choice([rng.uniform(-60, 120), rng.uniform(h - 120, h + 60),
                         rng.uniform(0, h)])
        rot = np.array([[np.cos(ang), -np.sin(ang)],
                        [np.sin(ang), np.cos(ang)]]) / sigma
        ms[k, :, :2] = rot
        ms[k, :, 2] = np.array([wp.C0, wp.C0]) - rot @ np.array([cx, cy])
    fidx = torch.from_numpy(rng.integers(0, nb, n).astype(np.int32)).to(DEV)
    plan = ops.tight_letterbox_plan((h, w), (640, 640))
    canvas = ops.letterbox(frames, plan).round().clamp(0, 255).to(torch.uint8)
    prm = wp.prepare_warp_params(torch.from_numpy(ms).to(DEV), fidx, (h, w),
                                 plan.det_scale,
                                 canvas_hw=tuple(canvas.shape[1:3]))
    return wp.planarize(frames), wp.planarize(canvas), prm


def k3_edges(torch, prm):
    """A copy of ``prm`` with hand-made crops in its first 12 rows: NaN and
    infinite sigma / u / v / my / mx (written all NaN, or zeros for my and
    mx at +-inf), |v| = 1 both ways, frame indices outside [0, B)."""
    nan, inf = float("nan"), float("inf")
    fp, ip = prm.fparams.clone(), prm.iparams.clone()
    for k, (col, val) in enumerate(((0, nan), (1, nan), (2, nan), (3, nan),
                                    (4, nan), (0, inf), (1, -inf), (2, inf),
                                    (3, inf), (4, -inf))):
        fp[k, col] = val
    fp[10, 1:3] = torch.tensor([-1.0, 1.0])
    fp[11, 1:3] = torch.tensor([1.0, -1.0])
    ip[10, 0], ip[11, 0] = -1, 1 << 20
    return prm._replace(iparams=ip, fparams=fp)


def phase_k3(torch, rep):
    """K3's path (the experiment script's run, counts reset just before and
    read just after), then K3 against its plain version on the workload and
    the stress sets, its times at the path's shapes and its deviation from
    exact bilinear."""
    from scrfd_arcface_facerecognition_tpu_torch.ops.warp_params import (
        planarize)
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_warp2

    nb, h, w, nc = K3_CASE
    exp_warp2.launches = 0
    run = exp_warp2.run(batch=nb, faces=nc, iters=10, fh=h, fw=w, seed=0,
                        device=DEV)
    torch.cuda.synchronize()
    launches = exp_warp2.launches
    if launches == 0:
        fail("K3's path launched the band-mix kernel no time")
    rep.say(f"K3 path (tools.exp_warp2.run, {nb}x{h}x{w} frames, {nc} "
            f"crops, {run['in_envelope']} inside the envelope): K3 "
            f"{run['band_ms']:.4f} ms, K1 {run['k1_ms']:.4f} ms a call "
            f"(CUDA events, warm L2); K3 vs K1 max {run['max_vs_k1']:.4f} "
            f"mean {run['mean_vs_k1']:.4f} u8; K3 launches {launches}")

    frames, canvas, _, _, prm = exp_warp2.make_workload(
        np.random.default_rng(0), nb, nc, fh=h, fw=w, device=DEV)
    fp, cp = planarize(frames), planarize(canvas)
    errs = [compare_k3(torch, exp_warp2, fp, cp, prm)]
    rng = np.random.default_rng(9)
    cases = []
    for sb, sh, sw, sn in ((4, h, w, 120), (4, 384, 512, 60),
                           (2, 300, 400, 30)):
        sfp, scp, sprm = k3_stress(torch, rng, sb, sh, sw, sn)
        errs.append(compare_k3(torch, exp_warp2, sfp, scp, sprm))
        lv = sprm.iparams[:, 1]
        cases.append(f"{sb}x{sh}x{sw}: {sn} crops, {int((lv == 1).sum())} "
                     f"at level 1, {int(sprm.fallback.sum())} fallback")
    edges = k3_edges(torch, sprm)
    errs.append(compare_k3(torch, exp_warp2, sfp, scp, edges))
    dead = int(exp_warp2.fused_plan(edges)[:, 6].sum())
    rep.say(f"K3 vs plain: workload {errs[0]:.6g} u8; stress sets ("
            + "; ".join(cases) + f"): " + ", ".join(f"{e:.6g}" for e in
                                                    errs[1:4])
            + f" u8; the last set with 12 hand-made edge crops ({dead} "
            f"written all NaN): {errs[4]:.6g} u8 (tolerance {TOL_U8}, "
            f"expected 0); the kernel's ranges equal fused_plan's on every "
            f"crop")

    ms = time_ms(torch, lambda: exp_warp2.warp_crops_band(fp, cp, prm))
    plain_ms = time_ms(torch, lambda: exp_warp2.warp_crops_band_plain(
        fp, cp, prm), iters=2)
    bd = k3_bound(fp, cp, prm)
    # F = 80 crops of the same frames (make_workload's first 80 draws)
    fr80, cv80, _, _, prm80 = exp_warp2.make_workload(
        np.random.default_rng(0), nb, 80, fh=h, fw=w, device=DEV)
    fp80, cp80 = planarize(fr80), planarize(cv80)
    ms80 = time_ms(torch, lambda: exp_warp2.warp_crops_band(fp80, cp80,
                                                            prm80))
    bd80 = k3_bound(fp80, cp80, prm80)
    chk = exp_warp2.check(device=DEV)
    rep.say(f"K3 times at {nb}x{h}x{w} / {nc} crops (cold L2): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library n/a (no single "
            f"PyTorch call computes the five resampling passes), bound "
            f"{bd['ms']:.4f} ms by {bd['by']} ({bd['bytes']} B at 3.35 TB/s: "
            f"the crops, the params and {bd['src_px']} needed source pixels "
            f"x 3 channels; {bd['positions']} needed positions x "
            f"{K3_FLOPS_PER_POSITION} flops = {bd['flops']} at 67 TFLOP/s); "
            f"kernel / bound {ms / bd['ms']:.1f}; at 80 crops: kernel "
            f"{ms80:.4f} ms, bound {bd80['ms']:.4f} ms by {bd80['by']}")
    occ = exp_warp2.occupancy()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = occ["blocks_per_sm"] * sms
    del fr80, cv80, fp80, cp80, prm80
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    exp_warp2.warp_crops_band(fp, cp, prm)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    rep.say(f"K3 fused (one launch a call, one block per crop): "
            f"{occ['smem_bytes']} B of shared memory a block (a ring of "
            f"{exp_warp2.RING} p3 rows), {occ['regs']} registers a thread, "
            f"{occ['blocks_per_sm']} blocks an SM (occupancy API) on {sms} "
            f"SMs: {nc / slots:.2f} waves at F = {nc}, "
            f"{80 / slots:.2f} at F = 80; peak device memory of one "
            f"call {peak} B above what was allocated before it (the "
            f"{nc * 3 * 112 * 112 * 4} B of crops); K3 vs exact bilinear "
            f"(check, noise frames, {chk['crops']} crops): mean "
            f"{chk['mean']:.4f}, p99 {chk['p99']:.3f}, max {chk['max']:.3f} "
            f"u8")
    return dict(launches=launches, err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bd["ms"], bound_by=bd["by"])


def k4_bound(b, c, h, wp, f):
    """Least time for K4's work: x and w3 read once (bf16), the affine read,
    y written once (bf16); or 2 * 9C * F flops an output position at the
    bf16 tensor-core rate."""
    nbytes = b * c * h * wp * 2 + 9 * c * f * 2 + 2 * f * 4 + b * f * h * wp * 2
    flops = 2 * b * h * wp * 9 * c * f
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes


def k4_case(torch, exp_pallas_conv, rng, shp, nonfinite=False):
    """K4's inputs at ``shp`` on the card (the script's workload), with a
    per-channel scale and bias; ``nonfinite`` puts a NaN pixel, a +inf
    pixel and a -inf pixel in x, the last on lane Wp - 1, whose right
    neighbour is lane 0."""
    x, w3, k = exp_pallas_conv.workload(rng, shp["b"], shp["h"], shp["w"],
                                        shp["c"], shp["f"], shp["wp"],
                                        device=DEV)
    if nonfinite:
        b, c, h, wp = x.shape
        x[0, c // 2, h // 2, wp // 3] = float("nan")
        x[b - 1, c - 1, 1, 0] = float("inf")
        x[b - 1, 0, h - 1, wp - 1] = -float("inf")
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, shp["f"]).astype(
        np.float32)).to(DEV)
    bi = torch.from_numpy(rng.normal(size=shp["f"]).astype(
        np.float32)).to(DEV)
    return x, w3, k, sc, bi


def phase_k4(torch, rep):
    """K4's path (the experiment script's run, counts reset just before and
    read just after), K4 against its plain version within the sum's
    tolerance at the script's shapes and the odd ones, and its times
    against cuDNN's bf16 conv on the W real lanes and on all Wp lanes."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_pallas_conv

    s = K4_SHAPES
    exp_pallas_conv.launches = 0
    run = exp_pallas_conv.run(dict(s), iters=30, device=DEV)
    torch.cuda.synchronize()
    launches = exp_pallas_conv.launches
    if launches == 0:
        fail("K4's path launched the conv kernel no time")
    if not 0 <= run["ratio"] <= 1:
        fail(f"K4's path: tolerance ratio {run['ratio']} from the plain "
             f"version (at most 1 passes, -1: NaN positions differ)")
    rep.say(f"K4 path (tools.exp_pallas_conv.run, B={s['b']} C={s['c']} "
            f"H={s['h']} W={s['w']} Wp={s['wp']} F={s['f']}): K4 "
            f"{run['ms']:.4f} ms ({run['gflop'] / run['ms']:.1f} TFLOP/s), "
            f"cuDNN bf16 conv2d {run['cudnn_wp_ms']:.4f} ms on all "
            f"{s['wp']} lanes, {run['cudnn_ms']:.4f} ms on {s['w']} (warm "
            f"L2); K4 vs plain tolerance ratio {run['ratio']:.4g} "
            f"({run['ulps']} bf16 steps); K4 vs cuDNN max abs "
            f"{run['cudnn_max_abs']:.4g} (scale {run['scale']:.2f}); K4 "
            f"launches {launches}")

    rng = np.random.default_rng(11)
    worst, worst_ulps, worst_abs, n_cases, lines = 0.0, 0, 0.0, 0, []
    for name, shp in (("script", s),) + K4_CASES:
        x, w3, k, sc, bi = k4_case(torch, exp_pallas_conv, rng, shp,
                                   nonfinite=name == "nonfinite")
        a = exp_pallas_conv.tap_abs_sum(x, w3)
        c_ratio, c_nan, c_inf = 0.0, 0, 0
        for relu in (False, True):
            for aff in ((None, None), (sc, bi)):
                got = exp_pallas_conv.conv3x3(x, w3, *aff, relu=relu)
                want = exp_pallas_conv.conv3x3_plain(x, w3, *aff, relu=relu)
                ratio = exp_pallas_conv.sum_tolerance_ratio(got, want, a,
                                                            aff[0])
                if not 0 <= ratio <= 1:
                    fail(f"conv3x3: tolerance ratio {ratio} from the plain "
                         f"version (case {name} {shp}, relu {relu}, affine "
                         f"{aff[0] is not None}; at most 1 passes, -1: NaN "
                         f"positions differ)")
                c_ratio = max(c_ratio, ratio)
                worst_ulps = max(worst_ulps,
                                 exp_pallas_conv.bf16_ulps(got, want))
                d = torch.nan_to_num((got.float() - want.float()).abs(),
                                     nan=0.0)
                worst_abs = max(worst_abs, float(d.max()))
                c_nan = max(c_nan, int(torch.isnan(want).sum()))
                c_inf = max(c_inf, int(torch.isinf(want).sum()))
                n_cases += 1
        if name == "nonfinite" and not (c_nan and c_inf):
            fail(f"conv3x3: the non-finite case gave {c_nan} NaN and "
                 f"{c_inf} infinite outputs; both expected")
        worst = max(worst, c_ratio)
        lines.append(f"{name} (B={shp['b']} C={shp['c']} H={shp['h']} "
                     f"W={shp['w']} Wp={shp['wp']} F={shp['f']}) "
                     f"{c_ratio:.4g}" + (f", {c_nan} NaN and {c_inf} inf "
                                         f"outputs agree" if c_nan else ""))
        if name == "script":
            kept = (x, w3, k, sc, bi)
    rep.say(f"K4 vs plain, {n_cases} cases (relu on and off; scale and "
            f"bias given and absent), worst tolerance ratio by shape: "
            + "; ".join(lines) + f". Worst ratio {worst:.4g} (at most 1 "
            f"passes: one bf16 step + |scale| * 2^-12 * sum |w||x|), at most "
            f"{worst_ulps} bf16 steps apart, max abs difference "
            f"{worst_abs:.6g}")

    x, w3, k, sc, bi = kept
    kt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).to(DEV).to(
        torch.bfloat16)
    ms = time_ms(torch, lambda: exp_pallas_conv.conv3x3(x, w3, sc, bi, True))
    plain_ms = time_ms(torch, lambda: exp_pallas_conv.conv3x3_plain(
        x, w3, sc, bi, True), iters=2)
    lib_w_ms = time_ms(torch, lambda: exp_pallas_conv.cudnn_conv(
        x, kt, s["w"], sc, bi, True))
    lib_ms = time_ms(torch, lambda: exp_pallas_conv.cudnn_conv(
        x, kt, s["wp"], sc, bi, True))
    lib = exp_pallas_conv.cudnn_conv(x, kt, s["w"], sc, bi, True)
    ref = exp_pallas_conv.conv3x3(x, w3, sc, bi, True)[..., :s["w"]]
    lib_err = float((lib.float() - ref.float()).abs().max())
    bound_ms, bound_by, nbytes = k4_bound(s["b"], s["c"], s["h"], s["wp"],
                                          s["f"])
    flops = 2 * s["b"] * s["h"] * s["wp"] * 9 * s["c"] * s["f"]
    rep.say(f"K4 times at the script's shapes, affine + ReLU (cold L2): "
            f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
            f"{plain_ms:.4f} ms, cuDNN bf16 conv2d + affine + ReLU on all "
            f"{s['wp']} lanes (K4's work) {lib_ms:.4f} ms, on the {s['w']} "
            f"real lanes {lib_w_ms:.4f} ms (max abs {lib_err:.4g} from the "
            f"kernel there), bound {bound_ms:.4f} ms by {bound_by} ({nbytes} "
            f"B at 3.35 TB/s; {flops} flops at 989 TFLOP/s bf16); kernel / "
            f"bound {ms / bound_ms:.1f}, kernel / cuDNN {ms / lib_ms:.2f}")
    return dict(launches=launches, err=worst_abs, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by)


# ------------------------------------------------ the stand-in main path

def standin_onnx(torch, build):
    """The det_10g and w600k_r50 torch stand-ins (``tests/torch_export.py``,
    crc32 seeds, the detector calibrated) exported to ONNX under ``build``,
    cached by the stand-ins' definition."""
    import importlib.util
    import zlib

    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "tests", "torch_export.py")
    with open(src, "rb") as f:
        key = f"{zlib.crc32(f.read()):08x}"
    spec = importlib.util.spec_from_file_location("torch_export", src)
    te = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(te)
    out = {}
    os.makedirs(build, exist_ok=True)
    for name, side in (("det_10g", 640), ("w600k_r50", 112)):
        path = os.path.join(build, f"{name}_standin_{key}.onnx")
        if not os.path.exists(path):
            tm = te.seeded(te.STAND_INS[name](),
                           seed=zlib.crc32(name.encode()) % 1000)
            if name.startswith("det"):
                tm = te.calibrate_detector(tm)
            te.export_onnx(tm, torch.randn(1, 3, side, side), path + ".tmp")
            os.replace(path + ".tmp", path)
        out[name] = path
    return out


def standin_expectation(faces, slots):
    """The stand-in path's face-count expectation (more than 0 faces and
    fewer than every slot a call), said as met or NOT MET. Zero faces fails
    the phase; a full count is reported: the random-weight stand-ins score
    every frame alike, so they fill max_num on any content."""
    if faces <= 0:
        fail("stand-in path found no faces")
    if faces < slots:
        return (f"stand-in path: expectation met: {faces} faces, more than 0 "
                f"and fewer than the {slots} slots a call")
    return (f"stand-in path: expectation NOT MET: more than 0 and fewer than "
            f"{slots} faces a call expected, {faces} of {slots} found; the "
            f"random-weight stand-ins score every frame alike and fill "
            f"max_num on any content, so realistic counts need a trained "
            f"checkpoint")


def phase_standin_path(torch, rep):
    """The main path on the stand-in weights, loaded through the port's
    ONNX importer; K1's count reset just before the calls and read just
    after; then the path's crop matrices through WarpParams and K3."""
    from scrfd_arcface_facerecognition_tpu_torch import FacePipeline, ops, stages
    from scrfd_arcface_facerecognition_tpu_torch.models.config_from_graph import (
        variables_from_onnx)
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_params as wp
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
        Detector, Embedder)
    from scrfd_arcface_facerecognition_tpu_torch.pipeline.embedder import (
        crop_matrices)
    from scrfd_arcface_facerecognition_tpu_torch.pipeline.face_pipeline import (
        bucket_slots)
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_warp2

    t0 = time.perf_counter()
    c = STANDIN
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "standins")
    paths = standin_onnx(torch, build)
    t_export = time.perf_counter() - t0
    det_cfg, det_v = variables_from_onnx(paths["det_10g"], name="det_10g")
    rec_cfg, rec_v = variables_from_onnx(paths["w600k_r50"], name="w600k_r50")
    t_import = time.perf_counter() - t0 - t_export
    det = Detector(config=det_cfg, variables=det_v, conf_thres=c["conf"],
                   pre_nms=c["pre_nms"], max_det=c["max_det"], device=DEV)
    emb = Embedder(config=rec_cfg, variables=rec_v, device=DEV)
    pipe = FacePipeline(detector=det, embedder=emb,
                        gallery_capacity=c["gallery"], device=DEV)
    nb, (h, w), max_num, ng = c["frames"], c["hw"], c["max_num"], c["gallery"]
    rng = np.random.default_rng(0)
    pipe.set_gallery(rng.normal(size=(ng, 512)).astype(np.float32),
                     [f"p{i}" for i in range(ng)])
    frames = torch.from_numpy(rng.integers(0, 255, (nb, h, w, 3),
                                           dtype=np.uint8)).to(DEV)
    pipe(frames, max_num=max_num)                     # warm-up
    torch.cuda.synchronize()
    rep.say(f"stand-in path: {det_cfg.name} (stem {det_cfg.stem_filters}, "
            f"stages {tuple(det_cfg.stage_filters)}) + {rec_cfg.name} "
            f"(blocks {tuple(rec_cfg.stage_blocks)}) stand-ins exported in "
            f"{t_export:.1f} s, loaded through the port's ONNX importer in "
            f"{t_import:.1f} s; set-up + warm-up "
            f"{time.perf_counter() - t0:.1f} s")

    timer = StageTimer(torch)
    wa.launches = 0
    stages.set_stage_hook(timer)
    call_ms, outs = [], []
    for _ in range(3):
        t = time.perf_counter()
        out = pipe(frames, max_num=max_num)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t) * 1e3)
        outs.append(out)
    stage_ms = timer.totals()
    stages.set_stage_hook(None)
    launches = wa.launches
    if launches == 0:
        fail("stand-in path launched K1 no time")
    o = outs[-1]
    faces = int(o.valid.sum())
    expectation = standin_expectation(faces, nb * max_num)
    ev = o.embeddings[o.valid]
    if not bool(torch.isfinite(ev).all()) or not bool(
            ((ev.norm(dim=-1) - 1).abs() < 1e-3).all()):
        fail("stand-in path: valid embeddings not finite and unit-norm")
    cos = ev @ ev.T
    off = cos[~torch.eye(len(ev), dtype=torch.bool, device=ev.device)]
    per_frame = o.valid.sum(1).tolist()
    rep.say(f"stand-in path: faces found {faces} of {nb * max_num} slots per "
            f"{nb}-frame call ({per_frame} a frame), K1 launches {launches} "
            f"over 3 calls; embeddings finite "
            f"and unit-norm, pairwise cosine mean {float(off.mean()):.4f} max "
            f"{float(off.max()):.4f}; scores {float(o.scores[o.valid].min()):.4f}"
            f"-{float(o.scores[o.valid].max()):.4f}")
    rep.say(expectation)
    rep.say(f"stand-in path: ms per {nb}x{h}x{w} call " + ", ".join(
        f"{m:.2f}" for m in call_ms) + f" (median {sorted(call_ms)[1]:.2f}); "
        "per-stage device ms (mean of 3 calls): " + ", ".join(
            f"{k} {stage_ms.get(k, 0.0) / 3:.3f}" for k in stages.STAGES))

    b, k = o.valid.shape
    sel, fidx = bucket_slots(o.valid, faces)
    kps = o.kps.reshape(b * k, 5, 2)[sel]
    err1, _ = compare_k1(torch, wa, frames, crop_matrices(kps), fidx)
    rep.say(f"stand-in path's {faces} crops: K1 vs plain {err1:.6g} u8")

    # the path's crops through WarpParams and K3

    mats = ops.estimate_norm(kps, 112)                  # src -> dst
    plan = pipe.detector.plan((h, w), tight=True)
    canvas = ops.letterbox(frames, plan).round().clamp(0, 255).to(torch.uint8)
    prm = wp.prepare_warp_params(mats, fidx, (h, w), plan.det_scale,
                                 canvas_hw=tuple(canvas.shape[1:3]))
    err = compare_k3(torch, exp_warp2, wp.planarize(frames),
                     wp.planarize(canvas), prm)
    inside = float((~prm.fallback).float().mean())
    lv1 = int((prm.iparams[:, 1] == 1).sum())
    sig = prm.fparams[:, 0]
    rep.say(f"stand-in path's {faces} crops through WarpParams: "
            f"{inside:.3f} inside the K3 envelope ({lv1} at level 1; sigma "
            f"{float(sig.min()):.3f}-{float(sig.max()):.3f}, |sin phi| max "
            f"{float(prm.fparams[:, 2].abs().max()):.3f}); K3 vs plain on "
            f"them {err:.6g} u8")
    return dict(err=err, err1=err1, faces=faces, launches=launches)

# ---------------------------------------------------------------------
# phase 12: the facade and the engines


def loader_image(source, hw):
    """A seeded synthetic BGR image for ``source`` (no network, no cv2)."""
    import zlib

    rng = np.random.default_rng(zlib.crc32(source.encode()))
    return rng.integers(0, 256, (*hw, 3), dtype=np.uint8)


def identity_image(identity, jitter=0, h=240, w=320):
    """The identity-coded image: identity and jitter in pixels [0, 0] and
    [0, 1] of every channel."""
    img = np.full((h, w, 3), 128, np.uint8)
    img[0, 0, :] = identity
    img[0, 1, :] = jitter
    return img


def identity_loader(src, save_path=None, timeout=30):
    """The identity-coded image for ``http://.../id_<identity>_<jitter>.jpg``
    (an injected loader: no network, no cv2)."""
    a, b = src.rsplit("/", 1)[1][3:-4].split("_")
    return identity_image(int(a), int(b))


def identity_embedding(identity, jitter=0, dim=512):
    """A fixed unit vector per identity; a jitter moves it to cosine about
    0.83 (above the grouping thresholds, below the duplicate one)."""
    v = np.random.default_rng(1000 + identity).normal(size=dim).astype(
        np.float32)
    if jitter:
        v = v / np.linalg.norm(v)
        v = v + np.random.default_rng(5000 + jitter).normal(
            scale=0.03, size=dim).astype(np.float32)
    return v / np.linalg.norm(v)


class IdentityApp:
    """FaceAnalysis-shaped stand-in whose faces are read from the image's
    identity pixels: one face a image, its embedding
    ``identity_embedding``. ``get_batch`` is the port facade's routing."""

    MIN_STATIC_GROUP = 8

    def __init__(self, det_score=0.9, bbox=(100, 100, 200, 230)):
        self.det_score = det_score
        self.bbox = np.asarray(bbox, np.float32)
        self._microbatcher = None

    def prepare(self, ctx_id=0, det_size=(640, 640), det_thresh=0.5):
        pass

    def get(self, image, max_num=0):
        return self.get_batch([np.asarray(image)], max_num=max_num)[0]

    def get_batch(self, images, max_num=0):
        from scrfd_arcface_facerecognition_tpu_torch.apps import FaceAnalysis

        return FaceAnalysis.get_batch(self, images, max_num=max_num)

    def enable_microbatch(self, **kw):
        from scrfd_arcface_facerecognition_tpu_torch.apps import FaceAnalysis

        return FaceAnalysis.enable_microbatch(self, **kw)

    def disable_microbatch(self):
        from scrfd_arcface_facerecognition_tpu_torch.apps import FaceAnalysis

        FaceAnalysis.disable_microbatch(self)

    def _get_batch_direct(self, images, max_num=0):
        from scrfd_arcface_facerecognition_tpu_torch.apps import Face

        out = []
        for im in images:
            im = np.asarray(im)
            emb = identity_embedding(int(im[0, 0, 0]), int(im[0, 1, 0]))
            x1, y1, x2, y2 = self.bbox
            cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
            kps = np.asarray([[cx - 30, cy - 30], [cx + 30, cy - 30],
                              [cx, cy], [cx - 30, cy + 30],
                              [cx + 30, cy + 30]], np.float32)
            out.append([Face(bbox=self.bbox.copy(), kps=kps,
                             det_score=self.det_score, embedding=emb * 10.0,
                             normed_embedding=emb)])
        return out


def engine_visits(n, url, box=True):
    """n visit records, visit i's image at ``url(i)``."""
    ok_box = {"width": 90, "height": 120, "top": 300, "left": 300}
    return {"visits": [{
        "id": i, "image": url(i), "customerId": f"cust_{i}",
        "entryTime": f"2025-01-0{1 + i % 9}T10:00:00", "branchId": "b1",
        "entryEventIds": ([{"box": ok_box, "event": "entry",
                            "fileName": f"f{i}.jpg", "camera": "cam1"}]
                          if box else [])} for i in range(n)]}


_PERSON = __import__("re").compile(r"^(Person_.*)_\d{9,}$")
# the columns SQLite fills from the clock (CURRENT_TIMESTAMP)
CLOCK_COLUMNS = ("created_at", "last_seen", "processed_at")


def without_clock(v):
    """A record value without what the clock wrote: the clock columns of
    dict rows and the time() suffix of person names."""
    if isinstance(v, str):
        return _PERSON.sub(r"\1_<t>", v)
    if isinstance(v, dict):
        return {k: without_clock(x) for k, x in v.items()
                if k not in CLOCK_COLUMNS}
    if isinstance(v, (list, tuple)):
        return [without_clock(x) for x in v]
    return v


def engine_record(engine):
    """What an engine decided, without timestamps: every SQLite table's
    rows in insertion order (without the clock columns), the
    clustering_results payloads in the order written (without job id and
    time), the gallery's ids."""
    import glob
    import sqlite3

    con = sqlite3.connect(engine.database_path)
    try:
        tables = [r[0] for r in con.execute(
            "SELECT name FROM sqlite_master WHERE type='table' AND name "
            "NOT LIKE 'sqlite_%' ORDER BY name")]
        db = {}
        for t in tables:
            cur = con.execute(f"SELECT * FROM {t} ORDER BY rowid")
            cols = [d[0] for d in cur.description]
            db[t] = [without_clock(dict(zip(cols, row))) for row in cur]
    finally:
        con.close()
    files = sorted(glob.glob(os.path.join(engine.json_storage.output_dir,
                                          "clustering_results_*.json")),
                   key=lambda f: (os.path.getmtime(f), f))
    payloads = []
    for f in files:
        with open(f) as fh:
            p = json.load(fh)
        p.pop("job_id", None)
        p.pop("timestamp", None)
        payloads.append(without_clock(p))
    return {"db": db, "json": payloads,
            "gallery": sorted(engine.vector_db.ids())}


def record_diff(a, b, tol, path="record"):
    """None when the records agree (floats within ``tol``), else the path
    of the first difference and the two values."""
    if isinstance(a, float) or isinstance(b, float):
        if (isinstance(a, (int, float)) and isinstance(b, (int, float))
                and abs(a - b) <= tol):
            return None
        return f"{path}: {a!r} != {b!r}"
    if isinstance(a, dict) and isinstance(b, dict):
        if sorted(a) != sorted(b):
            return f"{path}: keys {sorted(a)} != {sorted(b)}"
        for k in a:
            d = record_diff(a[k], b[k], tol, f"{path}[{k!r}]")
            if d:
                return d
        return None
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return f"{path}: length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            d = record_diff(x, y, tol, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if a == b else f"{path}: {a!r} != {b!r}"


def engine_config(tmp, **vdb):
    from scrfd_arcface_facerecognition_tpu_torch.utils.config import (
        DEFAULT_CONFIG, deep_update)

    return deep_update(DEFAULT_CONFIG, {
        "system": {"database_path": os.path.join(tmp, "face.db"),
                   "image_cache_dir": os.path.join(tmp, "cache")},
        "vector_database": vdb})


def faces_close(want, got):
    """The microbatch contract: same face count, bbox atol 1e-2,
    embeddings atol 1e-3."""
    if len(want) != len(got):
        return False
    return all(np.allclose(a.bbox, b.bbox, atol=1e-2, rtol=0)
               and np.allclose(a.normed_embedding, b.normed_embedding,
                               atol=1e-3, rtol=0)
               for a, b in zip(want, got))


@contextlib.contextmanager
def captured_calls(module, name, key=None):
    """Calls of ``module.<name>`` go through unchanged; the list this
    yields gets a clone of the positional arguments of every call, or with
    ``key`` of the first call for each ``key(args)``. The clones are made
    before the call, so they are the inputs that call saw."""
    fn = getattr(module, name)
    kept, seen = [], set()

    def wrapped(*a, **k):
        sig = key(a) if key else len(kept)
        if sig not in seen:
            seen.add(sig)
            kept.append(tuple(x.clone() if hasattr(x, "clone") else x
                              for x in a))
        return fn(*a, **k)

    setattr(module, name, wrapped)
    try:
        yield kept
    finally:
        setattr(module, name, fn)


def k1_capture():
    """K1's inputs on the facade path: the first call for each frame-batch
    shape (each static chunk shape and each dynamic bucket)."""
    from scrfd_arcface_facerecognition_tpu_torch import ops

    return captured_calls(ops, "warp_align_crops",
                          key=lambda a: tuple(a[0].shape))


def k1_on_path(torch, wa, calls):
    """K1 against its plain version on captured (frames, minv, frame_idx)
    calls: the largest error in u8 units and a summary of the inputs."""
    worst = 0.0
    for frames, minv, fidx in calls:
        err, _ = compare_k1(torch, wa, frames, minv, fidx)
        worst = max(worst, err)
    shapes = ", ".join(f"{len(m)} crops over {'x'.join(map(str, f.shape[:3]))}"
                       for f, m, _ in calls)
    return worst, f"{len(calls)} calls ({shapes})"


class LogRecords(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


@contextlib.contextmanager
def port_log(what):
    """The port's log records at INFO and above during the block, in the
    list this yields; an ERROR record fails the run once the block ends
    (the engines log a fault they absorb at ERROR)."""
    lg = logging.getLogger("scrfd_arcface_facerecognition_tpu_torch")
    handler, level = LogRecords(), lg.level
    lg.addHandler(handler)
    lg.setLevel(logging.INFO)
    try:
        yield handler.records
    finally:
        lg.removeHandler(handler)
        lg.setLevel(level)
    errors = [r for r in handler.records if r.levelno >= logging.ERROR]
    if errors:
        fail(f"{what}: the port logged {len(errors)} error(s), the first: "
             f"{errors[0].name}: {errors[0].getMessage()}")


# the engine's gates that count a visit as "no face", by the message each
# logs (apps/clustering.py _gate_face); a visit with no face logs nothing
NO_FACE_GATES = (("confidence", "face confidence too low"),
                 ("side face", "side face rejected"))


def no_face_split(records, n_no_face):
    """The "no face" count split by the gate that gave it."""
    split = {name: sum(r.msg.startswith(prefix) for r in records)
             for name, prefix in NO_FACE_GATES}
    split["no face detected"] = n_no_face - sum(split.values())
    return split


def unit_embeddings(faces, what):
    """Every face's embedding a finite unit 512-vector."""
    for f in (x for fs in faces for x in fs):
        e = np.asarray(f.normed_embedding)
        if e.shape != (512,) or not np.isfinite(e).all() or abs(
                float(np.linalg.norm(e)) - 1) > 1e-3:
            fail(f"{what}: an embedding is not a finite unit 512-vector")


def phase_facade(torch, rep):
    """12a: get_batch over the three routes; returns the facade."""
    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.apps import FaceAnalysis
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    t0 = time.perf_counter()
    app = FaceAnalysis(det_variant=FACADE["det"], rec_variant=FACADE["rec"],
                       max_det=FACADE["max_det"], seed=0,
                       dtype=torch.float32, device=DEV)
    app.prepare(det_size=FACADE["det_size"])
    rng = np.random.default_rng(12)
    (ns, hs, ws), (nt, ht, wt) = FACADE["static"], FACADE["stream"]
    static = [rng.integers(0, 256, (hs, ws, 3), dtype=np.uint8)
              for _ in range(ns)]
    stream = [rng.integers(0, 256, (ht, wt, 3), dtype=np.uint8)
              for _ in range(nt)]
    oneoff = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in FACADE["oneoff"]]
    images = static + stream + oneoff
    chunks, buckets = app.routes(images)
    if len(chunks) < 2 or not buckets:
        fail(f"facade: routing gave {len(chunks)} static chunks and "
             f"{len(buckets)} buckets")
    with k1_capture() as k1_calls:          # warm-up (cuDNN, allocator)
        app.get_batch(images)
    torch.cuda.synchronize()
    rep.say(f"facade: FaceAnalysis({FACADE['det']} + {FACADE['rec']}, "
            f"seeded, max_det {FACADE['max_det']}, dtype {app.dtype}) on "
            f"{app.device}, "
            f"det_size {FACADE['det_size']}; "
            f"setup + warm-up {time.perf_counter() - t0:.2f} s")

    seen = []
    pipe = app._pipe

    def spy(route, fn):
        def wrapped(frames, *a, **k):
            seen.append((route, tuple(np.shape(frames))))
            return fn(frames, *a, **k)
        return wrapped

    pipe.process_stream = spy("stream", pipe.process_stream)
    pipe.call_dynamic = spy("dynamic", pipe.call_dynamic)
    wa.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    faces = app.get_batch(images)
    torch.cuda.synchronize()
    mixed_ms = (time.perf_counter() - t) * 1e3
    launches = wa.launches
    del pipe.process_stream, pipe.call_dynamic
    if launches <= 0:
        fail("facade path launched K1 no time")
    unit_embeddings(faces, "facade")
    routes = {r for r, _ in seen}
    if routes != {"stream", "dynamic"}:
        fail(f"facade: routes taken {sorted(routes)}")
    per = [len(f) for f in faces]
    rep.say(f"facade: get_batch of {len(images)} images in {mixed_ms:.2f} ms, "
            f"K1 launches {launches}; faces per image: static "
            f"{ns}x{hs}x{ws} {per[:ns]}, {nt}x{ht}x{wt} "
            f"{per[ns:ns + nt]}, one-off {per[ns + nt:]}; routes: "
            f"{len(chunks)} static chunks "
            f"{[len(c) for c in chunks]} streamed through process_stream, "
            + ", ".join(f"bucket {bh}x{bw} {len(ix)} image(s)"
                        for (bh, bw), ix in buckets.items())
            + f" through call_dynamic ({sum(r == 'dynamic' for r, _ in seen)}"
            f" calls)")

    # the facade's default dtype: bf16 on the card (f32 on the CPU)
    dflt = FaceAnalysis(det_variant=FACADE["det"], rec_variant=FACADE["rec"],
                        max_det=FACADE["max_det"], seed=0, device=DEV)
    dflt.prepare(det_size=FACADE["det_size"])
    want = torch.bfloat16 if DEV == "cuda" else torch.float32
    if (dflt.detector.dtype, dflt.embedder.dtype) != (want, want):
        fail(f"facade: the default dtype on {DEV} is "
             f"{dflt.detector.dtype}, not {want}")
    got = dflt.get_batch(images)
    unit_embeddings(got, "facade (default dtype)")
    rep.say(f"facade: the default dtype on the card, "
            f"{dflt.detector.dtype}: get_batch of the same {len(images)} "
            f"images, {sum(len(f) for f in got)} faces, every embedding a "
            f"finite unit 512-vector")
    del dflt, got

    # ms by route (medians of 3)
    by_route = {}
    for name, group in (("static (one chunk)", static),
                        ("two static chunks, streamed", static + stream),
                        ("dynamic buckets", oneoff)):
        by_route[name] = median_ms(torch, lambda: app.get_batch(group),
                                   n=3)[0]
    rep.say("facade: ms per get_batch by route (median of 3): " + "; ".join(
        f"{k} {v:.2f} ms ({v / n:.2f} an image)" for (k, v), n in zip(
            by_route.items(), (ns, ns + nt, len(oneoff)))))

    # each one-off image's dynamic canvas against its exact-shape letterbox
    worst = 0.0
    model_hw = app.detector.input_size
    step = max(1, min(app.chunk, app.DYNAMIC_CHUNK))
    for bucket_hw, idxs in buckets.items():
        for c in range(0, len(idxs), step):
            part = idxs[c:c + step]
            frames, wy, wx, _, hws = app.dynamic_inputs(images, part,
                                                        bucket_hw)
            canvas = ops.letterbox_dynamic(
                torch.from_numpy(frames).to(DEV),
                torch.from_numpy(wy).to(DEV), torch.from_numpy(wx).to(DEV))
            for bi, i in enumerate(part):
                h, w = (int(v) for v in hws[bi])
                exact = ops.letterbox(torch.from_numpy(images[i]).to(DEV),
                                      ops.letterbox_plan((h, w), model_hw))
                worst = max(worst, float((canvas[bi] - exact).abs().max()))
    if not worst <= TOL_CANVAS:
        fail(f"facade: dynamic canvas differs from the exact-shape "
             f"letterbox by {worst} (tolerance {TOL_CANVAS})")
    rep.say(f"facade: {len(oneoff)} one-off images' dynamic canvases vs "
            f"exact-shape letterbox: max |d| {worst:.3g} (tolerance "
            f"{TOL_CANVAS})")

    # K1 against its plain version on the inputs this path gave it
    err, what = k1_on_path(torch, wa, k1_calls)
    if len({tuple(f.shape) for f, _, _ in k1_calls}) < len(chunks) + 1:
        fail(f"facade: K1's inputs captured from {what}")
    rep.say(f"facade: K1 vs plain on the get_batch call's inputs, {what}: "
            f"max abs err {err:.6g} u8 (tolerance {TOL_U8})")
    return app, dict(launches=launches, mixed_ms=mixed_ms, routes=by_route,
                     err=err)


def phase_microbatch(torch, rep, app):
    """12b: 16 threads, one get() each, through the collector."""
    import threading

    rng = np.random.default_rng(13)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in FACADE["microbatch"]]
    groups = []
    direct = app._get_batch_direct

    def recorded(imgs, max_num=0):
        groups.append([next(i for i, im in enumerate(images) if im is x)
                       for x in imgs])
        return direct(imgs, max_num=max_num)

    app._get_batch_direct = recorded
    mb = app.enable_microbatch(max_batch=len(images), max_wait_ms=50.0)
    got = [None] * len(images)

    def worker(i):
        got[i] = app.get(images[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(images))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    app.disable_microbatch()
    del app._get_batch_direct
    n_items, n_batches = mb.n_items, mb.n_batches
    if n_items != len(images) or sorted(sum(groups, [])) != list(
            range(len(images))):
        fail(f"microbatch: {n_items} items served, groups {groups}")
    bad = []
    for g in groups:
        want = app.get_batch([images[i] for i in g])
        bad += [i for i, w in zip(g, want) if not faces_close(w, got[i])]
    if bad:
        fail(f"microbatch: images {bad} differ from the direct get_batch")
    rep.say(f"microbatch: {len(images)} threads x get(), n_items {n_items}, "
            f"n_batches {n_batches} (groups {[len(g) for g in groups]}); "
            f"every image's faces equal the direct get_batch of its batch "
            f"(bbox atol 1e-2, embeddings atol 1e-3; "
            f"{sum(len(f) for f in got)} faces)")
    return dict(n_items=n_items, n_batches=n_batches)


def run_engine(tmp, app, loader, visits, batches, device, **vdb):
    from scrfd_arcface_facerecognition_tpu_torch.apps import SmartFaceEngine

    eng = SmartFaceEngine(config=engine_config(tmp, **vdb), app=app,
                          image_loader=loader,
                          results_dir=os.path.join(tmp, "results"),
                          device=device)
    totals = {}
    step = -(-len(visits["visits"]) // batches)
    for c in range(0, len(visits["visits"]), step):
        res = eng.process_visit_data_from_json(
            {"visits": visits["visits"][c:c + step]}, save_images=False)
        for k, v in res.items():
            totals[k] = totals.get(k, 0) + v
    return eng, totals


def phase_engine(torch, rep, app):
    """12c: the clustering engine on the facade."""
    import tempfile

    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    hw = FACADE["visit_hw"]
    loader = (lambda src, save_path=None, timeout=30:
              loader_image(src, hw))
    n = FACADE["visits"]
    visits = engine_visits(n, lambda i: f"http://cam/visit_{i}.jpg")
    with tempfile.TemporaryDirectory() as tmp, port_log(
            "engine") as records, k1_capture() as k1_calls:
        wa.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng, res = run_engine(tmp, app, loader, visits, 1, DEV)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        k1 = wa.launches
        files = [os.path.join(eng.json_storage.output_dir, f)
                 for f in os.listdir(eng.json_storage.output_dir)]
        size = sum(os.path.getsize(f) for f in files)
    # each visit lands in exactly one of these counters, and some reach
    # the gallery (a decision taken on a model embedding)
    if k1 <= 0 or sum(res[k] for k in (
            "new_persons", "recognized", "duplicate_faces", "no_faces",
            "low_quality", "download_failed")) != n or sum(res[k] for k in (
                "new_persons", "recognized", "duplicate_faces")) == 0:
        fail(f"engine: K1 launches {k1}, results {res}")
    rep.say(f"engine: SmartFaceEngine on the facade, {n} visits of "
            f"{hw[0]}x{hw[1]} images (seeded weights: groupings are not "
            f"meaningful): new persons {res['new_persons']}, assigned "
            f"{res['recognized']}, skipped (duplicates) "
            f"{res['duplicate_faces']}, no face {res['no_faces']}, low "
            f"quality {res['low_quality']}; {ms:.1f} ms, {ms / n:.2f} ms a "
            f"visit; K1 launches {k1}; clustering_results {len(files)} "
            f"file(s), {size} B")
    split = no_face_split(records, res["no_faces"])
    if split["no face detected"] < 0:
        fail(f"engine: {res['no_faces']} visits counted no face, but the "
             f"gates logged {split}")
    err, what = k1_on_path(torch, wa, k1_calls)
    rep.say(f"engine: 'no face' by gate: " + ", ".join(
        f"{k} {v}" for k, v in split.items()) + f"; no ERROR logged; K1 vs "
        f"plain on the run's inputs, {what}: max abs err {err:.6g} u8")
    return dict(k1=k1, ms_visit=ms / n, err=err, no_face=split)


def phase_engine_pq(torch, rep):
    """12c: the clustering engine on the PQ tier, identity-coded; its
    decisions on the card equal those on the CPU."""
    import tempfile

    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq, pq_adc

    cfg = ENGINE_PQ
    ident = [(i % cfg["idents"], i // cfg["idents"])
             for i in range(cfg["visits"])]
    pq_visits = engine_visits(cfg["visits"],
                              lambda i: "http://cam/id_%d_%d.jpg" % ident[i])

    vdb = dict(tier="pq", pq_min_train_rows=cfg["min_train_rows"])
    runs = []                     # (results, ms, K2 launches, tier, record)
    for device in (DEV, "cpu"):
        with tempfile.TemporaryDirectory() as tmp, port_log(
                "engine on the PQ tier"), k2_capture() as calls:
            k2_reset(pq_adc)
            t = time.perf_counter()
            eng, res = run_engine(tmp, IdentityApp(), identity_loader,
                                  pq_visits, cfg["batches"], device, **vdb)
            runs.append((res, (time.perf_counter() - t) * 1e3,
                         k2_count(pq_adc), eng.vector_db.tier,
                         engine_record(eng)))
        if not runs[1:]:
            k2_calls = calls             # the searches of the card's run
    (res, ms, k2, tier, card), cpu = runs
    if tier != "pq" or k2 <= 0 or not k2_calls:
        fail(f"engine on the PQ tier: tier {tier}, K2 launches {k2}, "
             f"{len(k2_calls)} searches captured")
    # K2 against its plain version on each search's LUT and codes, and
    # the fused top-k against both chains: the decisions come from
    # the exact rerank of K2's shortlist, so they alone would not show a
    # wrong score
    err, rel = 0.0, 0.0
    for lut, codes, valid, k, precision in k2_calls:
        e, r = compare_k2(torch, pq_adc, lut, codes, precision)
        err, rel = max(err, e), max(rel, r)
        compare_topk(torch, pq_adc, "engine on the PQ tier", lut, codes,
                     valid, k, precision)
    diff = record_diff(card, cpu[4], TOL_RECORD)
    if diff:
        fail(f"engine on the PQ tier: card and CPU decide differently: "
             f"{diff}")
    n_rows = sum(len(v) for v in card["db"].values())
    rep.say(f"engine, PQ tier (min_train_rows {cfg['min_train_rows']}), "
            f"identity-coded app, {cfg['visits']} visits of "
            f"{cfg['idents']} identities in {cfg['batches']} batches: new "
            f"persons {res['new_persons']}, assigned {res['recognized']}, "
            f"skipped {res['duplicate_faces']}, no face {res['no_faces']}; "
            f"{ms / cfg['visits']:.2f} ms a visit on the card "
            f"({cpu[1] / cfg['visits']:.2f} on the CPU); K2 launches "
            f"{k2}; decisions ({n_rows} SQLite rows, "
            f"{len(card['json'])} results files) equal to the CPU "
            f"run's (floats within {TOL_RECORD}); K2 vs plain on the "
            f"searches' inputs (" + ", ".join(
                f"LUT {tuple(c[0].shape)} {c[4]}, codes {tuple(c[1].shape)}"
                f", k {c[3]}" for c in k2_calls) + f"): max abs err "
            f"{err:.6g} = {rel:.3g} of max |score| (tolerance {TOL_K2}); "
            f"the fused top-k bit-equal to the plain chain and to K2 + "
            f"mask + sort on them")
    return dict(k2=k2, ms_visit=ms / cfg["visits"], err=err)


def phase_verification(torch, rep, app):
    """12d: FaceComparison on the facade."""
    from scrfd_arcface_facerecognition_tpu_torch.apps import FaceComparison
    from scrfd_arcface_facerecognition_tpu_torch.apps.verification import (
        build_comparison_results_json)
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.utils.config import (
        DEFAULT_CONFIG)

    hw = FACADE["visit_hw"]
    n = FACADE["pairs"]
    fc = FaceComparison(config=DEFAULT_CONFIG, app=app,
                        image_loader=lambda src: loader_image(src, hw),
                        log_file=None, device=DEV)
    records = fc.transform_records([
        {"id": f"r{i}", "image": f"http://cam/a_{i}.jpg",
         "refImage": f"http://cam/{'a' if i % 3 == 0 else 'b'}_{i}.jpg",
         "isConverted": i % 2 == 0, "branchId": "b1"} for i in range(n)])
    with port_log("verification"):
        wa.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fc.process_face_comparisons(records)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        k1 = wa.launches
    keys = {"total_comparisons", "processed", "same_person",
            "different_person", "errors", "accuracy_vs_api", "api_matches",
            "total_with_api_data", "results"}
    ok = (keys <= set(out) and out["total_comparisons"] == n
          and out["processed"] == n == len(out["results"])
          and out["same_person"] + out["different_person"]
          + out["errors"] == n
          and out["total_with_api_data"] == n
          and 0 <= out["api_matches"] <= n
          and abs(out["accuracy_vs_api"] - 100.0 * out["api_matches"] / n)
          < 1e-9)
    payload = build_comparison_results_json(out)
    if not ok or len(payload["comparisons"]) != n or k1 <= 0:
        fail(f"verification: malformed accuracy block "
             f"{ {k: v for k, v in out.items() if k != 'results'} }, "
             f"K1 launches {k1}")
    block = {k: out[k] for k in ("total_comparisons", "same_person",
                                 "different_person", "errors",
                                 "accuracy_vs_api", "api_matches")}
    rep.say(f"verification: FaceComparison on the facade, {n} pairs of "
            f"{hw[0]}x{hw[1]} images: {json.dumps(block)}; {ms:.1f} ms, "
            f"{ms / n:.2f} ms a pair; K1 launches {k1}")
    return dict(ms_pair=ms / n, k1=k1)


# ---------------------------------------------------------------------
# phase 13: the bf16 main path at bench.py's settings


def standin_parts(torch, dtype, **det_kw):
    """Detector and Embedder on the det_10g + w600k_r50 stand-ins (phase
    11's ONNX files, loaded through the port's importer once a run) at
    ``dtype``."""
    from scrfd_arcface_facerecognition_tpu_torch.models.config_from_graph import (
        variables_from_onnx)
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
        Detector, Embedder)

    if not _STANDIN_VARS:
        build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "standins")
        paths = standin_onnx(torch, build)
        _STANDIN_VARS["det"] = variables_from_onnx(paths["det_10g"],
                                                   name="det_10g")
        _STANDIN_VARS["rec"] = variables_from_onnx(paths["w600k_r50"],
                                                   name="w600k_r50")
    (det_cfg, det_v), (rec_cfg, rec_v) = (_STANDIN_VARS["det"],
                                          _STANDIN_VARS["rec"])
    det = Detector(config=det_cfg, variables=det_v, dtype=dtype, device=DEV,
                   **det_kw)
    emb = Embedder(config=rec_cfg, variables=rec_v, dtype=dtype, device=DEV)
    return det, emb


_STANDIN_VARS = {}


def iou_pairs(boxes_a, valid_a, boxes_b, valid_b, thresh=0.9):
    """One frame's faces paired by IoU >= thresh, best first: [(i, j)]
    slot indices, and the count found on one side only."""
    ia = [k for k in range(len(valid_a)) if valid_a[k]]
    ib = [k for k in range(len(valid_b)) if valid_b[k]]
    pairs, used = [], set()
    for i in ia:
        a = boxes_a[i]
        best, bj = thresh, None
        for j in ib:
            if j in used:
                continue
            b = boxes_b[j]
            iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
            ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
            inter = iw * ih
            union = ((a[2] - a[0]) * (a[3] - a[1])
                     + (b[2] - b[0]) * (b[3] - b[1]) - inter)
            v = inter / union if union > 0 else 0.0
            if v >= best:
                best, bj = v, j
        if bj is not None:
            used.add(bj)
            pairs.append((i, bj))
    return pairs, len(ia) + len(ib) - 2 * len(pairs)


def compare_outputs(torch, a, b):
    """Two PipelineOutputs of the same frames: faces paired by IoU per
    frame; (faces a, faces b, one-sided, match_idx agreement over the
    pairs, min embedding cosine over the pairs)."""
    ba, va, ea, ma = (t.float().cpu().numpy() if t.is_floating_point()
                      else t.cpu().numpy()
                      for t in (a.boxes, a.valid, a.embeddings, a.match_idx))
    bb, vb, eb, mb = (t.float().cpu().numpy() if t.is_floating_point()
                      else t.cpu().numpy()
                      for t in (b.boxes, b.valid, b.embeddings, b.match_idx))
    lone, same, n, cos = 0, 0, 0, 1.0
    for f in range(len(va)):
        pairs, k = iou_pairs(ba[f], va[f], bb[f], vb[f])
        lone += k
        for i, j in pairs:
            n += 1
            same += int(ma[f, i] == mb[f, j])
            x, y = ea[f, i], eb[f, j]
            cos = min(cos, float(x @ y / (np.linalg.norm(x)
                                          * np.linalg.norm(y))))
    return dict(faces_a=int(va.sum()), faces_b=int(vb.sum()), lone=lone,
                pairs=n, match_agree=same / max(n, 1), min_cos=cos)


def check_output(torch, o, nb, max_num, what):
    """Finite unit-norm embeddings on valid slots, zeros elsewhere."""
    if o.embeddings.shape != (nb, max_num, 512):
        fail(f"{what}: embeddings shape {tuple(o.embeddings.shape)}")
    ev = o.embeddings[o.valid].float()
    if not bool(torch.isfinite(ev).all()) or not bool(
            ((ev.norm(dim=-1) - 1).abs() < 1e-3).all()):
        fail(f"{what}: valid embeddings not finite and unit-norm")
    if not bool((o.embeddings[~o.valid] == 0).all()):
        fail(f"{what}: invalid slots carry embeddings")


def stream_fps(torch, pipe, batches, depth, max_num, rounds):
    """Frames a second of ``process_stream(batches, depth)``, one number a
    round (host clock, the card synchronized at both ends)."""
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = 0
        for o in pipe.process_stream(iter(batches), max_num=max_num,
                                     depth=depth):
            n += o.boxes.shape[0]
        torch.cuda.synchronize()
        out.append(n / (time.perf_counter() - t))
    return out


@contextlib.contextmanager
def plain_copy(pipe):
    """``pipe`` copies numpy batches to its device as ``as_frames`` does
    (pageable memory, on the compute stream), not through its staging."""
    from scrfd_arcface_facerecognition_tpu_torch.pipeline.detector import (
        as_frames)

    staging = pipe._staging
    pipe._staging = lambda frames: as_frames(frames, pipe.device)
    try:
        yield
    finally:
        pipe._staging = staging


def fps_said(fps):
    s = sorted(fps)
    return (f"median {s[len(s) // 2]:.2f} (spread {s[0]:.2f}-{s[-1]:.2f}, "
            f"{len(s)} rounds)")


def device_busy(torch, fn):
    """fn() under torch.profiler: the device's busy share (the union of
    its kernels' and copies' intervals over the window from the first
    device event to the last), the host's ms, and the six device events
    (by name) that took the most time. None where the trace holds no
    device event (and on the CPU)."""
    if DEV != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
    # the device's own events: kernels, copies and sets (the runtime's
    # "Command Buffer Full" waits are host-side, though tagged CUDA; a
    # profiler span of the detector trainer shows on the device's timeline
    # as a range over its kernels, not as work)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith("Command Buffer")
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith(("scrfd_train.", "arcface_train."))]
    if not dev:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, (lo, hi) = 0.0, spans[0]
    first, last = spans[0][0], max(e for _, e in spans)
    for s0, e0 in spans[1:]:
        if s0 > hi:
            busy += hi - lo
            lo, hi = s0, e0
        else:
            hi = max(hi, e0)
    busy += hi - lo
    window = max(last - first, 1e-9)
    by_name = {}
    for e in dev:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + (e.time_range.end - e.time_range.start) / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(busy_share=busy / window, device_window_ms=window / 1e3,
                host_ms=host_ms, top=top)


def busy_said(b):
    if b is None:
        return "not measured (no device events in the trace)"
    window = b["device_window_ms"]
    return (f"device busy {b['busy_share']:.4f} of its {window:.1f} ms "
            f"window (host {b['host_ms']:.1f} ms; the device events that "
            f"took longest: "
            + ", ".join(f"{k[:60]} {v:.1f} ms" for k, v in b["top"]) + ")")


def phase_bf16_bench(torch, rep):
    """The stand-in main path at bf16 at bench.py's settings: frames
    resident on the card, process_stream at depth 12 (and 1, 2), frames
    fed from numpy at depth 1, 2, 12; stage splits at bf16 and f32; bf16
    against f32 on the same frames; K1 on the path's inputs."""
    from scrfd_arcface_facerecognition_tpu_torch import FacePipeline, stages
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    c = BENCH
    t0 = time.perf_counter()
    nb, (h, w), max_num, ng = c["frames"], c["hw"], c["max_num"], c["gallery"]
    det_kw = dict(conf_thres=c["conf"], pre_nms=c["pre_nms"],
                  max_det=c["max_det"])
    rng = np.random.default_rng(0)
    gallery = rng.normal(size=(ng, 512)).astype(np.float32)
    pipes = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        det, emb = standin_parts(torch, dtype, **det_kw)
        pipes[name] = FacePipeline(detector=det, embedder=emb,
                                   gallery_capacity=ng, device=DEV)
        pipes[name].set_gallery(gallery, [f"p{i}" for i in range(ng)])
    pipe = pipes["bf16"]
    host = rng.integers(0, 255, (nb, h, w, 3), dtype=np.uint8)
    frames = torch.from_numpy(host).to(DEV)
    with k1_capture() as k1_calls:                 # warm-up, K1's inputs
        for _ in range(2):
            pipe(frames, max_num=max_num)
        for _ in pipe.process_stream([frames] * 2, max_num=max_num):
            pass
    pipes["f32"](frames, max_num=max_num)          # the f32 one's warm-up
    torch.cuda.synchronize()
    rep.say(f"bf16 bench path: stand-in det_10g + w600k_r50 at bf16 "
            f"(weights f32, rounded once), {nb}x{h}x{w} frames on the card, "
            f"gallery {ng}, max_det {c['max_det']}, max_num {max_num}, "
            f"pre_nms {c['pre_nms']}, conf {c['conf']}; set-up + warm-up "
            f"{time.perf_counter() - t0:.1f} s")

    # the path: frames resident, depth 12 (bench.py's), counted
    wa.launches = 0
    fps = stream_fps(torch, pipe, [frames] * c["depth"], c["depth"],
                     max_num, c["rounds"])
    launches = wa.launches
    if launches <= 0:
        fail("bf16 bench path launched K1 no time")
    by_depth = {c["depth"]: fps}
    for d in c["depths"]:
        by_depth[d] = stream_fps(torch, pipe, [frames] * c["depth"], d,
                                 max_num, c["rounds"])
    rep.say(f"bf16 bench path: frames/s, {c['depth']} batches of {nb} "
            f"resident frames a round: " + "; ".join(
                f"depth {d} {fps_said(v)}" for d, v in sorted(
                    by_depth.items())) + f"; K1 launches {launches}")
    # numpy-fed, through the pinned staging and through the plain pageable
    # copy it replaces, alternating at each depth
    fed, fed_plain = {}, {}
    for d in c["fed_depths"]:
        fed[d] = stream_fps(torch, pipe, [host] * c["depth"], d, max_num,
                            c["rounds"])
        with plain_copy(pipe):
            fed_plain[d] = stream_fps(torch, pipe, [host] * c["depth"], d,
                                      max_num, c["rounds"])
    # the staged batches are the frames: two alternating numpy batches,
    # more in flight than the pinned ring has buffers, against the
    # resident frames' direct calls
    flipped = np.ascontiguousarray(host[::-1])
    want = [pipe(frames, max_num=max_num),
            pipe(frames.flip(0).contiguous(), max_num=max_num)]
    for i, o in enumerate(pipe.process_stream(
            [host, flipped] * 3, max_num=max_num, depth=4)):
        w = want[i % 2]
        if not all(torch.equal(getattr(o, f), getattr(w, f))
                   for f in ("valid", "count", "match_idx", "boxes")):
            fail(f"bf16 bench path: numpy-fed batch {i} differs from the "
                 f"resident frames' call")
    rep.say(f"bf16 bench path, frames fed from numpy (pinned staging): "
            + "; ".join(f"depth {d} {fps_said(v)}"
                        for d, v in sorted(fed.items()))
            + "; through the plain pageable copy instead: "
            + "; ".join(f"depth {d} {fps_said(v)}"
                        for d, v in sorted(fed_plain.items()))
            + "; 6 staged batches (depth 4) equal to the resident frames' "
            "calls")
    busy = {}
    for name, src in (("resident", frames), ("numpy-fed", host)):
        busy[name] = device_busy(torch, lambda: stream_fps(
            torch, pipe, [src] * c["depth"], c["depth"], max_num, 1))
    rep.say("bf16 bench path, one round at depth "
            f"{c['depth']} under torch.profiler: " + "; ".join(
                f"{k}: {busy_said(v)}" for k, v in busy.items()))

    # one call of each precision, by stage
    split = {}
    for name in ("bf16", "f32"):
        timer = StageTimer(torch)
        stages.set_stage_hook(timer)
        try:
            out = pipes[name](frames, max_num=max_num)
            split[name] = timer.totals()
        finally:
            stages.set_stage_hook(None)
        check_output(torch, out, nb, max_num, f"bf16 bench path ({name})")
        split[name + "_out"] = out
    rep.say("bf16 bench path, one call by stage (device ms): " + "; ".join(
        f"{name} " + ", ".join(f"{k} {split[name].get(k, 0.0):.3f}"
                               for k in stages.STAGES)
        for name in ("bf16", "f32")))
    # the stand-ins score every anchor alike, so bf16's rounding reorders
    # which max_num faces a frame keeps: the pairs are held, not their count
    cmp = compare_outputs(torch, split["bf16_out"], split["f32_out"])
    if (abs(cmp["faces_a"] - cmp["faces_b"]) > 0.01 * cmp["faces_b"]
            or not cmp["pairs"]
            or cmp["min_cos"] < 0.99 or cmp["match_agree"] < 0.99):
        fail(f"bf16 bench path: bf16 and f32 disagree: {cmp}")
    rep.say(f"bf16 bench path, bf16 vs f32 on the same {nb} frames: faces "
            f"{cmp['faces_a']} / {cmp['faces_b']}, paired by IoU >= 0.9 "
            f"{cmp['pairs']}, on one side only {cmp['lone']}, match_idx "
            f"agreement over the pairs {cmp['match_agree']:.4f}, min "
            f"embedding cosine over the pairs {cmp['min_cos']:.5f}")
    faces = int(split["bf16_out"].valid.sum())
    err, what = k1_on_path(torch, wa, k1_calls)
    rep.say(f"bf16 bench path: K1 vs plain on the path's inputs, {what}: "
            f"max abs err {err:.6g} u8 (tolerance {TOL_U8})")
    s = sorted(fps)
    bench = {"frames_per_sec": s[len(s) // 2], "spread": [s[0], s[-1]],
             "rounds": c["rounds"], "depth": c["depth"],
             "batch": nb, "faces_in_batch": faces,
             "by_depth": {str(d): sorted(v)[len(v) // 2]
                          for d, v in sorted(by_depth.items())},
             "numpy_fed_by_depth": {str(d): sorted(v)[len(v) // 2]
                                    for d, v in sorted(fed.items())},
             "numpy_fed_plain_copy_by_depth": {
                 str(d): sorted(v)[len(v) // 2]
                 for d, v in sorted(fed_plain.items())},
             "dtype": "bfloat16", "weights": "stand-ins (tests/torch_export.py)",
             "device_busy_share": {k: (v or {}).get("busy_share")
                                   for k, v in busy.items()},
             "card": rep.card}
    print(json.dumps({"bench_bf16": bench}), flush=True)
    return dict(launches=launches, err=err, fps=fps, bench=bench)


# ---------------------------------------------------------------------
# phase 13b: the bf16 path on the trained checkpoints, card against CPU
#
# The stand-ins score every anchor alike, so phase 13 cannot tell a wrong
# bf16 detector on the card from a right one. Here the committed trained
# det_500m + w600k_mbf run at bf16 on the card and on the CPU (whose bf16
# path tests/test_torch_bf16.py holds to the JAX package), at that test's
# budget (bf16 ulps: 2^(floor(log2 x) - 7)).


def bf16_ulp(x):
    """The spacing of bf16 values at magnitude ``x`` (8 significant bits)."""
    x = abs(float(x))
    if x == 0 or not np.isfinite(x):
        return 0.0
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def score_tol(s, logit_max):
    """2 ulps of the logits (at their largest magnitude) through the
    sigmoid's slope, plus 2 ulps of the score's own rounding."""
    s = np.asarray(s, np.float64)
    return (2 * bf16_ulp(logit_max) * s * (1 - s)
            + 2 * np.vectorize(bf16_ulp)(s))


def smooth_frames(torch, rng, n, h, w):
    """Seeded smooth content (upsampled noise), in which the trained
    detector finds faces at a low threshold; made on the CPU."""
    base = rng.integers(0, 255, (n, 3, max(2, h // 20), max(2, w // 20)))
    up = torch.nn.functional.interpolate(
        torch.from_numpy(base.astype(np.float32)), size=(h, w),
        mode="bilinear", align_corners=False)
    return up.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous(
        ).numpy()


def checkpoint_pipe(torch, dtype, device):
    """FacePipeline on the committed det_500m + w600k_mbf (``CKPT``'s
    detector settings, tight canvas) at ``dtype`` on ``device``."""
    from scrfd_arcface_facerecognition_tpu_torch import FacePipeline
    from scrfd_arcface_facerecognition_tpu_torch.models import (
        read_flax_msgpack)
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
        Detector, Embedder)

    c = CKPT
    if not _CKPT_TREES:
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "checkpoints", "decisions")
        for part in ("det", "rec"):
            with open(os.path.join(root, c[part] + ".msgpack"), "rb") as f:
                _CKPT_TREES[part] = read_flax_msgpack(f.read())
    det = Detector(c["det"], variables=_CKPT_TREES["det"],
                   input_size=c["input_size"], conf_thres=c["conf"],
                   pre_nms=c["pre_nms"], max_det=c["max_det"], dtype=dtype,
                   device=device)
    emb = Embedder(c["rec"], variables=_CKPT_TREES["rec"], dtype=dtype,
                   device=device)
    return FacePipeline(detector=det, embedder=emb, tight_canvas=True,
                        similarity_thresh=c["sim"], gallery_capacity=16,
                        device=device)


_CKPT_TREES = {}


def box_iou(a, b):
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / union if union > 0 else 0.0


def hold_bf16_faces(want, got, *, conf, cut, iou_thres, det_scale, where):
    """One frame's faces, ``want`` (the reference) and ``got`` lists of
    (box (4,), score, kps (5, 2)), paired by IoU >= 0.9 (best first) and
    held to the bf16 budget: boxes and kps within 2 ulps of the box's
    extent in canvas pixels over det_scale, scores within 2 ulps of 1. A
    face on one side only must be a tie: its score within 2 ulps of
    ``conf`` or of the slate's ``cut``, or an IoU within 0.05 of the NMS
    threshold with a face of the other side. Returns (pairs [(i, j)],
    faces on one side only)."""
    pairs, used = [], set()
    for i, (wb, _, _) in enumerate(want):
        best, bj = 0.9, None
        for j, (gb, _, _) in enumerate(got):
            if j not in used and box_iou(wb, gb) >= best:
                best, bj = box_iou(wb, gb), j
        if bj is not None:
            used.add(bj)
            pairs.append((i, bj))
    for i, j in pairs:
        (wb, ws, wk), (gb, gs, gk) = want[i], got[j]
        extent = max(wb[2] - wb[0], wb[3] - wb[1]) * det_scale
        tol = 2 * bf16_ulp(extent) / det_scale
        d = max(float(np.abs(gb - wb).max()), float(np.abs(gk - wk).max()))
        if d > tol or abs(gs - ws) > 2 * bf16_ulp(1.0):
            fail(f"bf16 checkpoints, {where}: a face's box / kps {d} px "
                 f"apart (budget {tol}) or scores {gs} / {ws}")
    near = lambda v, edge: abs(float(v) - float(edge)) <= 2 * bf16_ulp(edge)
    lone = ([(f, got) for i, f in enumerate(want)
             if i not in {a for a, _ in pairs}]
            + [(f, want) for j, f in enumerate(got)
               if j not in {b for _, b in pairs}])
    for (box, score, _), other in lone:
        if not (near(score, conf) or near(score, cut) or any(
                abs(box_iou(box, ob) - iou_thres) <= 0.05
                for ob, _, _ in other)):
            fail(f"bf16 checkpoints, {where}: a face on one side only is "
                 f"no tie (score {score}, conf {conf}, cut {cut})")
    return pairs, len(lone)


def phase_bf16_checkpoints(torch, rep):
    """13b: the trained checkpoints at bf16, card against CPU: the raw
    head outputs on one canvas (and the card's bf16 against its f32, which
    must differ: a forward that stays f32 fails), then the pipeline's
    outputs end to end."""
    from scrfd_arcface_facerecognition_tpu_torch import ops

    c = CKPT
    n, h, w = c["frames"]
    frames = smooth_frames(torch, np.random.default_rng(131), n, h, w)
    cpu = checkpoint_pipe(torch, torch.bfloat16, "cpu")
    card = checkpoint_pipe(torch, torch.bfloat16, DEV)
    card32 = checkpoint_pipe(torch, torch.float32, DEV)

    # the pipeline's canvas, made on the CPU, through each detector
    plan = ops.tight_letterbox_plan((h, w), cpu.detector.input_size)
    canvas = ops.letterbox(torch.from_numpy(frames), plan,
                           dtype=torch.bfloat16)
    net_in = ops.normalize_image(canvas, ops.SCRFD_MEAN, ops.SCRFD_STD
                                 ).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        want = cpu.detector.model(net_in)
        got = card.detector.model(net_in.to(DEV))
        hi = card32.detector.model(net_in.to(DEV))
    used, apart = {}, {}
    for key in ("scores", "bboxes", "kps"):
        gap, mag = 0.0, 0.0
        for li, (g, ref, f) in enumerate(zip(got[key], want[key], hi[key])):
            g, ref, f = (t.float().cpu().numpy() for t in (g, ref, f))
            if key == "scores":
                rs = np.clip(ref.astype(np.float64), 1e-12, 1 - 1e-12)
                tol = score_tol(ref, np.abs(np.log(rs / (1 - rs))).max())
            else:
                tol = 2 * bf16_ulp(np.abs(ref).max())
            err = np.abs(g - ref)
            if not (err <= tol).all():
                fail(f"bf16 checkpoints: the card's {key} (level {li}) "
                     f"{float(err.max())} from the CPU's, past the bf16 "
                     f"budget")
            used[key] = max(used.get(key, 0.0), float((err / tol).max()))
            gap = max(gap, float(np.abs(g - f).max()))
            mag = max(mag, float(np.abs(f).max()))
        apart[key] = gap / bf16_ulp(mag)
        if apart[key] < 0.5:
            fail(f"bf16 checkpoints: the card's bf16 {key} only "
                 f"{apart[key]:.3f} ulps from its f32: the forward did not "
                 f"round to bf16")
    scores = torch.cat([s[..., 0] for s in want["scores"]], dim=1)
    cuts = ops.stable_top_k(scores, c["pre_nms"])[0][:, -1].numpy()

    # end to end, with a gallery of the CPU's first faces
    first = cpu(frames)
    gal = first.embeddings.numpy()[first.valid.numpy()][:6]
    if not len(gal):
        fail("bf16 checkpoints: no face on the CPU")
    for p in (cpu, card):
        p.set_gallery(gal, [f"g{i}" for i in range(len(gal))])
    ref = [t.float().numpy() if t.is_floating_point() else t.numpy()
           for t in cpu(frames)]
    out = [t.float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()
           for t in card(frames)]
    jb, js, jk, jv, _, je, ji, jm = ref
    tb, ts, tk, tv, _, te, ti, tm = out
    lone, npairs, cos, held = 0, 0, 1.0, 0
    for b in range(n):
        wl = [(jb[b, k], float(js[b, k]), jk[b, k]) for k in range(len(jv[b]))
              if jv[b, k]]
        gl = [(tb[b, k], float(ts[b, k]), tk[b, k]) for k in range(len(tv[b]))
              if tv[b, k]]
        pairs, k = hold_bf16_faces(wl, gl, conf=c["conf"],
                                   cut=float(cuts[b]),
                                   iou_thres=card.detector.iou_thres,
                                   det_scale=plan.det_scale,
                                   where=f"frame {b}")
        lone += k
        npairs += len(pairs)
        wk, gk = np.flatnonzero(jv[b]), np.flatnonzero(tv[b])
        for i, j in pairs:
            x, y = je[b, wk[i]], te[b, gk[j]]
            cos = min(cos, float(x @ y / (np.linalg.norm(x)
                                          * np.linalg.norm(y))))
            ws, gs = jm[b, wk[i]], tm[b, gk[j]]
            if not (abs(ws - c["sim"]) <= 2 * bf16_ulp(c["sim"])
                    or abs(gs - c["sim"]) <= 2 * bf16_ulp(c["sim"])):
                held += 1
                if ji[b, wk[i]] != ti[b, gk[j]]:
                    fail(f"bf16 checkpoints, frame {b}: match_idx "
                         f"{ti[b, gk[j]]} on the card, {ji[b, wk[i]]} on "
                         f"the CPU (match_sim {gs} / {ws})")
    if cos < 0.999 or lone > c["max_ties"] or not npairs:
        fail(f"bf16 checkpoints: {npairs} faces paired, {lone} on one side "
             f"only (at most {c['max_ties']}), min embedding cosine {cos}")
    rep.say(f"bf16 checkpoints ({c['det']} + {c['rec']}, bf16, "
            f"{n}x{h}x{w} smooth seeded frames, det_size "
            f"{c['input_size']}, conf {c['conf']}), card vs CPU: head "
            f"outputs on one canvas within the 2-ulp budget (the largest "
            f"error a share of it: " + ", ".join(
                f"{k} {v:.3f}" for k, v in used.items())
            + "); the card's bf16 from its f32: " + ", ".join(
                f"{k} {v:.2f} ulps" for k, v in apart.items())
            + f"; end to end: faces {int(jv.sum())} / {int(tv.sum())}, "
            f"paired by IoU >= 0.9 {npairs}, on one side only (ties) "
            f"{lone}, boxes / kps / scores within budget, min embedding "
            f"cosine {cos:.6f}, match_idx equal on {held} faces away from "
            f"the threshold")
    return dict(pairs=npairs, lone=lone, used=used, apart=apart, cos=cos)


# ---------------------------------------------------------------------
# phase 14: the realtime app


class SyntheticCapture:
    """A cv2-shaped capture of ``n`` seeded frames (read, get, isOpened,
    release), made when it opens; each read hands out a new copy, as a
    decoder does, and keeps its checksum."""

    def __init__(self, n, h, w, fps=25.0, seed=14):
        self.n, self.h, self.w, self.fps = n, h, w, fps
        rng = np.random.default_rng(seed)
        self.frames = [rng.integers(0, 255, (h, w, 3), np.uint8)
                       for _ in range(n)]
        self.sums = []
        self.released = False

    def read(self):
        if len(self.sums) >= self.n:
            return False, None
        frame = self.frames[len(self.sums)].copy()
        self.sums.append(frame_sum(frame))
        return True, frame

    def get(self, prop):
        return {3: float(self.w), 4: float(self.h), 5: self.fps}.get(prop, 0.0)

    def isOpened(self):
        return not self.released

    def release(self):
        self.released = True


def frame_sum(frame):
    import zlib

    return zlib.crc32(np.ascontiguousarray(frame).tobytes())


class RecordingWriter:
    def __init__(self):
        self.sums = []
        self.released = False

    def write(self, frame):
        self.sums.append(frame_sum(frame))

    def release(self):
        self.released = True


def phase_realtime(torch, rep):
    """``realtime.run`` on a synthetic capture through the native ring, the
    stand-ins at bf16; every frame written in order, each batch equal to a
    direct call, K1 on the run's inputs; frames/s with the decode thread,
    and numpy-fed process_stream at depth 1 and 2."""
    import tempfile

    from scrfd_arcface_facerecognition_tpu_torch import FacePipeline
    from scrfd_arcface_facerecognition_tpu_torch.apps import realtime
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.runtime import (
        native_available)

    c = REALTIME
    n, (h, w), batch = c["frames"], c["hw"], c["batch"]
    made, seen = {}, []

    def factory(**kw):
        if kw.get("dtype") != torch.bfloat16 or kw.get("device") != DEV:
            fail(f"realtime: pipeline asked for {kw}")
        det, emb = standin_parts(torch, torch.bfloat16,
                               conf_thres=kw["conf_thres"],
                               pre_nms=c["pre_nms"], max_det=c["max_det"])
        made["pipe"] = FacePipeline(detector=det, embedder=emb,
                                    similarity_thresh=kw["similarity_thresh"],
                                    device=DEV)
        return made["pipe"]

    cap = SyntheticCapture(n, h, w)
    writer = RecordingWriter()

    def annotate(frames, out, names, colors):
        seen.append((frames.copy(), out, time.perf_counter()))

    saved = {k: getattr(realtime, k) for k in (
        "FacePipeline", "open_capture", "open_writer", "annotate_batch",
        "read_image")}
    realtime.FacePipeline = factory
    realtime.open_capture = lambda source: cap
    realtime.open_writer = lambda path, fps, size: writer
    realtime.annotate_batch = annotate
    realtime.read_image = lambda path: np.load(path)
    frng = np.random.default_rng(15)
    try:
        with tempfile.TemporaryDirectory() as tmp, k1_capture() as k1_calls:
            faces = os.path.join(tmp, "faces")
            os.makedirs(faces)
            for i in range(c["faces"]):
                np.save(os.path.join(faces, f"person{i}.npy"),
                        frng.integers(0, 255, (240, 240, 3), np.uint8))
            args = realtime.parse_args([
                "--source", "synthetic", "--faces-dir", faces,
                "--batch", str(batch), "--output", os.path.join(tmp, "o.mp4"),
                "--det-weight", os.path.join(tmp, "det_10g.onnx"),
                "--rec-weight", os.path.join(tmp, "w600k_r50.onnx"),
                "--log-level", "WARNING"])
            wa.launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = realtime.run(args, device=DEV)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t
            launches = wa.launches
    finally:
        for k, v in saved.items():
            setattr(realtime, k, v)
    pipe = made["pipe"]
    # steady state: from the first batch's annotation to the last's
    steady = (sum(len(f) for f, _, _ in seen[1:])
              / max(seen[-1][2] - seen[0][2], 1e-9))
    seen = [(f, o) for f, o, _ in seen]
    sizes = [len(f) for f, _ in seen]
    want_sizes = [batch] * (n // batch) + ([n % batch] if n % batch else [])
    if (res["frames"] != n or writer.sums != cap.sums or sizes != want_sizes
            or not cap.released or not writer.released):
        fail(f"realtime: {res['frames']} of {n} frames, batches {sizes}, "
             f"written in order {writer.sums == cap.sums}")
    if launches <= 0:
        fail("realtime path launched K1 no time")
    worst_cos, faces = hold_to_direct(torch, pipe, seen, "realtime")
    err, what = k1_on_path(torch, wa, k1_calls)
    rep.say(f"realtime: run() on a synthetic {n}-frame {h}x{w} capture "
            f"through BatchedFrameReader (native ring: "
            f"{native_available()}), batch {batch} ({sizes}), stand-ins at "
            f"bf16, {res['targets']} targets from the faces directory: "
            f"{steady:.2f} frames/s with the decode thread overlapping "
            f"(from the first batch's annotation to the last; the whole "
            f"run {run_s:.2f} s, {n / run_s:.2f} frames/s with the "
            f"pipeline's set-up and the gallery); every frame written in "
            f"order; {faces} faces; each batch's count / valid / match_idx "
            f"equal to a direct call, min embedding cosine {worst_cos:.6f}; "
            f"K1 launches {launches}; K1 vs plain on the run's inputs, "
            f"{what}: max abs err {err:.6g} u8")
    batches = [f for f, _ in seen]
    fed, fed_plain = {}, {}
    for d in (1, 2):
        fed[d] = stream_fps(torch, pipe, batches, d, 0, c["rounds"])
        with plain_copy(pipe):
            fed_plain[d] = stream_fps(torch, pipe, batches, d, 0,
                                      c["rounds"])
    rep.say(f"realtime: numpy-fed process_stream over the {len(batches)} "
            f"batches: " + "; ".join(f"depth {d} {fps_said(v)} frames/s"
                                     for d, v in fed.items())
            + "; through the plain pageable copy instead: " + "; ".join(
                f"depth {d} {fps_said(v)} frames/s"
                for d, v in fed_plain.items()))
    busy = device_busy(torch, lambda: stream_fps(torch, pipe, batches, 2, 0,
                                                 1))
    rep.say(f"realtime: one numpy-fed round at depth 2 under "
            f"torch.profiler: {busy_said(busy)}")
    return dict(launches=launches, err=err, fps=steady)


# ---------------------------------------------------------------------
# phase 15: the ONNX executor path
#
# The released .onnx graphs run op by op through models/onnx_exec.py. Its
# numbers are held to the f32 budget of PERF.md §2: boxes and kps within
# 1e-2 frame px, scores within 1e-4, embeddings cosine >= 0.9999. The
# stand-ins score every anchor almost alike, so faces are paired by IoU
# >= 0.9 and a face on one side only must be a tie (score within 2 bf16
# ulps of conf, of the pre-NMS slate's cut or of the last face a full
# max_det slate keeps, or an NMS IoU within 0.05), or one half of an
# order tie: a face on the other side only that overlaps it past the NMS
# threshold with a score within 2 bf16 ulps (NMS keeps whichever of two
# such faces sorts first). The pipelines are
# compared at max_num 0: the stand-ins' boxes come out near one size, so
# the max_num selection by area ties.


def head_shares(torch, want, got, det_scale, strides=(8, 16, 32)):
    """The largest |got - want| of each head kind on one canvas, a share
    of the f32 budget: scores 1e-4; box and kps distances (stride units)
    1e-2 frame px, i.e. 1e-2 * det_scale / stride."""
    out = {}
    for key in ("scores", "bboxes", "kps"):
        worst = 0.0
        for li, s in enumerate(strides):
            d = float((got[key][li].float().cpu()
                       - want[key][li].float().cpu()).abs().max())
            tol = 1e-4 if key == "scores" else 1e-2 * det_scale / s
            worst = max(worst, d / tol)
        out[key] = worst
    return out


def hold_f32_faces(torch, ref, out, *, conf, cuts, iou_thres, sim, where):
    """Two PipelineOutputs of the same frames at the f32 budget, faces
    paired by IoU >= 0.9; a face on one side only must be a tie (``cuts``:
    each frame's scores a face may tie with). Returns
    the largest shares of the budget (boxes / kps, scores, 1 - cos,
    match_sim), the pairs and the one-sided count."""
    a = [t.float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()
         for t in ref]
    b = [t.float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()
         for t in out]
    jb, js, jk, jv, _, je, ji, jm = a
    tb, ts, tk, tv, _, te, ti, tm = b
    share = dict(px=0.0, score=0.0, cos=0.0, sim=0.0)
    npairs, lone = 0, 0
    near = lambda v, edge: abs(float(v) - float(edge)) <= 2 * bf16_ulp(edge)
    for f in range(len(jv)):
        wk, gk = np.flatnonzero(jv[f]), np.flatnonzero(tv[f])
        pairs, used = [], set()
        for i in wk:
            best, bj = 0.9, None
            for j in gk:
                if j not in used and box_iou(jb[f, i], tb[f, j]) >= best:
                    best, bj = box_iou(jb[f, i], tb[f, j]), j
            if bj is not None:
                used.add(bj)
                pairs.append((i, bj))
        for i, j in pairs:
            px = max(float(np.abs(tb[f, j] - jb[f, i]).max()),
                     float(np.abs(tk[f, j] - jk[f, i]).max()))
            x, y = je[f, i], te[f, j]
            cos = float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))
            share["px"] = max(share["px"], px / 1e-2)
            share["score"] = max(share["score"],
                                 abs(float(ts[f, j] - js[f, i])) / 1e-4)
            share["cos"] = max(share["cos"], (1 - cos) / 1e-4)
            share["sim"] = max(share["sim"],
                               abs(float(tm[f, j] - jm[f, i])) / 1e-4)
            if (ji[f, i] != ti[f, j] and abs(float(jm[f, i]) - sim) > 1e-4
                    and abs(float(tm[f, j]) - sim) > 1e-4):
                fail(f"{where}, frame {f}: match_idx {ti[f, j]} against "
                     f"{ji[f, i]} away from the threshold")
        lone_ref = [i for i in wk if i not in {p for p, _ in pairs}]
        lone_out = [j for j in gk if j not in used]
        others = ([(jb[f, i], js[f, i], tb[f, gk],
                    [(tb[f, j], ts[f, j]) for j in lone_out])
                   for i in lone_ref]
                  + [(tb[f, j], ts[f, j], jb[f, wk],
                      [(jb[f, i], js[f, i]) for i in lone_ref])
                     for j in lone_out])
        for box, score, other, rivals in others:
            if not (near(score, conf) or any(near(score, cut)
                                             for cut in cuts[f]) or any(
                    abs(box_iou(box, ob) - iou_thres) <= 0.05
                    for ob in other) or any(
                    box_iou(box, rb) > iou_thres - 0.05 and near(rs, score)
                    for rb, rs in rivals)):
                best = max(other, key=lambda ob: box_iou(box, ob),
                           default=None)
                fail(f"{where}, frame {f}: a face on one side only is no "
                     f"tie (score {score}, box {box}, conf {conf}, cuts "
                     f"{cuts[f]}; the other side's nearest box {best}, IoU "
                     f"{box_iou(box, best) if best is not None else None})")
        npairs += len(pairs)
        lone += len(others)
    if not npairs or any(v > 1 for v in share.values()):
        fail(f"{where}: {npairs} faces paired; shares of the f32 budget "
             f"{share}")
    return share, npairs, lone


def slate_cuts(torch, ops, heads, pre_nms):
    """Each frame's pre-NMS slate cut: the score of its pre_nms-th anchor."""
    scores = torch.cat([s[..., 0].float().cpu() for s in heads["scores"]],
                       dim=1)
    return ops.stable_top_k(scores, pre_nms)[0][:, -1].numpy()


def forward_costs(torch, fn):
    """One forward's device ms (cold L2, CUDA events), host ms (the
    dispatch, median of 3, the card idle before each) and the device
    kernels it launched (torch.profiler; None where the trace shows no
    device event)."""
    ms = time_ms(torch, fn, iters=5)
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    kernels = None
    if DEV == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset",
                                          "Command Buffer"))]
        kernels = len(dev) or None
    return dict(ms=ms, host_ms=sorted(host)[1], kernels=kernels)


def no_sync(torch, fn, what):
    """fn() under torch.cuda.set_sync_debug_mode("error"): any host-device
    synchronization in it fails the phase."""
    if DEV != "cuda":
        return "not checked on the CPU"
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        fail(f"{what}: a warm forward synchronized with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return "no sync"


def executor_pipe(torch, paths, dtype, device, **kw):
    from scrfd_arcface_facerecognition_tpu_torch import FacePipeline

    c = STANDIN
    return FacePipeline(det_onnx=paths["det_10g"], rec_onnx=paths["w600k_r50"],
                        conf_thres=c["conf"], pre_nms=c["pre_nms"],
                        max_det=c["max_det"], gallery_capacity=c["gallery"],
                        dtype=dtype, device=device, **kw)


def phase_onnx_exec(torch, rep, native_bench):
    """15: the stand-in files through the ONNX graph executor: (a) card
    against CPU at f32; (b) against the native models on the card, with
    each model's device ms, host ms and kernels per forward; (c) a warm
    forward makes no host sync; (d) bench.py's settings at bf16, beside
    phase 13's native figure; (e) K1 counted on (d) and held on the
    phase's inputs; (f) FaceAnalysis and the realtime app on the files."""
    from scrfd_arcface_facerecognition_tpu_torch import ops, stages
    from scrfd_arcface_facerecognition_tpu_torch.models import graph_models
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.pipeline.embedder import (
        crop_matrices)
    from scrfd_arcface_facerecognition_tpu_torch.pipeline.face_pipeline import (
        bucket_slots)

    t0 = time.perf_counter()
    c, ox = STANDIN, ONNX_EXEC
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "standins")
    paths = standin_onnx(torch, build)
    nb, (h, w), ng = c["frames"], c["hw"], c["gallery"]
    rng = np.random.default_rng(15)
    gallery = rng.normal(size=(ng, 512)).astype(np.float32)
    frames = rng.integers(0, 255, (nb, h, w, 3), dtype=np.uint8)
    frames_dev = torch.from_numpy(frames).to(DEV)

    # (a) card against CPU, f32 (the executor turns TF32 off itself)
    cpu = executor_pipe(torch, paths, torch.float32, "cpu")
    card = executor_pipe(torch, paths, torch.float32, DEV)
    for p in (cpu, card):
        p.set_gallery(gallery, [f"p{i}" for i in range(ng)])
        if not isinstance(p.detector.model, graph_models.SCRFDGraphModule):
            fail("executor path: the detector is not the graph module")
    plan = ops.tight_letterbox_plan((h, w), cpu.detector.input_size)
    canvas = ops.letterbox(torch.from_numpy(frames[:1]), plan)
    net_in = ops.normalize_image(canvas, ops.SCRFD_MEAN, ops.SCRFD_STD
                                 ).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        want = cpu.detector.model(net_in)
        got = card.detector.model(net_in.to(DEV))
    heads = head_shares(torch, want, got, plan.det_scale)
    ref = cpu(frames)
    with k1_capture() as k1_calls:
        out = card(frames_dev)
    with torch.inference_mode():                  # the slates, on the card
        full = card.detector.model(ops.normalize_image(
            ops.letterbox(frames_dev, plan), ops.SCRFD_MEAN,
            ops.SCRFD_STD).permute(0, 3, 1, 2).contiguous())
    full_slate = ref.valid.all(dim=1)
    last = ref.scores[:, -1]
    cuts = [(float(sc),) + ((float(last[f]),) if full_slate[f] else ())
            for f, sc in enumerate(slate_cuts(torch, ops, full,
                                              c["pre_nms"]))]
    share, npairs, lone = hold_f32_faces(
        torch, ref, out, conf=c["conf"], cuts=cuts,
        iou_thres=card.detector.iou_thres, sim=card.similarity_thresh,
        where="executor card vs CPU")
    b, k = out.valid.shape
    faces = int(out.valid.sum())
    sel, fidx = bucket_slots(out.valid, faces)
    kps = out.kps.reshape(b * k, 5, 2)[sel]
    crops = ops.warp_align_crops(frames_dev, crop_matrices(kps), fidx)
    with torch.inference_mode():
        e_card = card.embedder.model(crops)
        e_cpu = cpu.embedder.model(crops.cpu())
    cos_cpu = float(torch.nn.functional.cosine_similarity(
        e_card.cpu(), e_cpu).min())
    if cos_cpu < 0.9999 or any(v > 1 for v in heads.values()):
        fail(f"executor card vs CPU: heads {heads} of the f32 budget, "
             f"ArcFace cosine {cos_cpu}")
    rep.say(f"onnx executor, card vs CPU (f32, TF32 off), det_10g + "
            f"w600k_r50 stand-in files, {nb}x{h}x{w} frames, conf "
            f"{c['conf']}, max_det {c['max_det']}, max_num 0: heads on one "
            f"canvas, the "
            f"largest error a share of the f32 budget: " + ", ".join(
                f"{k_} {v:.4f}" for k_, v in heads.items())
            + f"; pipeline faces {int(ref.valid.sum())} / {faces}, paired "
            f"by IoU >= 0.9 {npairs}, on one side only (ties) {lone}; "
            f"shares: boxes / kps {share['px']:.4f}, scores "
            f"{share['score']:.4f}, 1 - cosine {share['cos']:.4f}, "
            f"match_sim {share['sim']:.4f}; ArcFace on the path's {faces} "
            f"crops min cosine {cos_cpu:.7f}")
    del cpu

    # (b) against the native models (the importer's), f32, TF32 off
    det_n, emb_n = standin_parts(torch, torch.float32, conf_thres=c["conf"],
                                 pre_nms=c["pre_nms"], max_det=c["max_det"])
    with full_f32(torch), torch.inference_mode():
        nat = det_n.model(net_in.to(DEV))
        exe = card.detector.model(net_in.to(DEV))
        en, ee = emb_n.model(crops), card.embedder.model(crops)
    nheads = head_shares(torch, nat, exe, plan.det_scale)
    cos_nat = float(torch.nn.functional.cosine_similarity(en, ee).min())
    if cos_nat < 0.9999 or any(v > 1 for v in nheads.values()):
        fail(f"executor vs native: heads {nheads} of the f32 budget, "
             f"ArcFace cosine {cos_nat}")
    rep.say("onnx executor vs the native models (the importer's) on the "
            "card, f32, TF32 off: heads, the largest error a share of the "
            "f32 budget: " + ", ".join(f"{k_} {v:.4f}"
                                       for k_, v in nheads.items())
            + f"; ArcFace on the {faces} crops min cosine {cos_nat:.7f}")
    del det_n, emb_n, nat, exe, card

    # per forward at bf16 (the serving dtype): executor and native
    det_nb, emb_nb = standin_parts(torch, torch.bfloat16)
    exe_det = graph_models.scrfd_from_onnx(paths["det_10g"], torch.bfloat16,
                                           device=DEV)
    exe_rec = graph_models.arcface_from_onnx(paths["w600k_r50"],
                                             torch.bfloat16, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(15)
    costs = []
    with torch.inference_mode():
        for what, n, shape, models in (
                ("SCRFD", ox["det_canvases"], (3, *ox["canvas"]),
                 (exe_det, det_nb.model)),
                ("ArcFace", ox["rec_crops"], (3, 112, 112),
                 (exe_rec, emb_nb.model))):
            for count in n:
                x = torch.randn((count, *shape), generator=gen, device=DEV)
                for name, m in zip(("executor", "native"), models):
                    r = forward_costs(torch, lambda: m(x))
                    costs.append((what, count, name, r))
                    del r
                del x
    rep.say("onnx executor vs native per forward at bf16 (device ms cold "
            "L2 / host ms of the dispatch / CUDA kernels launched): " +
            "; ".join(f"{wt} x{n} {nm} {r['ms']:.3f} / {r['host_ms']:.3f} / "
                      f"{r['kernels']}" for wt, n, nm, r in costs))

    # (c) a warm forward makes no host sync, at bf16 and f32
    x8 = torch.randn((ox["det_canvases"][0], 3, *ox["canvas"]), device=DEV)
    x80 = torch.randn((ox["rec_crops"][0], 3, 112, 112), device=DEV)
    exe32 = (graph_models.scrfd_from_onnx(paths["det_10g"], device=DEV),
             graph_models.arcface_from_onnx(paths["w600k_r50"], device=DEV))
    syncs = []
    with torch.inference_mode():
        for name, m, x in (("det_10g bf16", exe_det, x8),
                           ("w600k_r50 bf16", exe_rec, x80),
                           ("det_10g f32", exe32[0], x8),
                           ("w600k_r50 f32", exe32[1], x80)):
            syncs.append(f"{name} {no_sync(torch, lambda: m(x), name)}")
    rep.say("onnx executor, one warm forward of each graph under "
            "set_sync_debug_mode('error'): " + ", ".join(syncs))
    del exe_det, exe_rec, exe32, det_nb, emb_nb, x8, x80

    # (d) bench.py's settings at bf16, resident frames, depth 12; (e) K1
    bc = BENCH
    pipes = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        pipes[name] = executor_pipe(torch, paths, dtype, DEV)
        pipes[name].set_gallery(gallery, [f"p{i}" for i in range(ng)])
    pipe = pipes["bf16"]
    big = torch.from_numpy(rng.integers(0, 255, (bc["frames"], *bc["hw"], 3),
                                        dtype=np.uint8)).to(DEV)
    with k1_capture() as k1_bench:
        pipe(big, max_num=bc["max_num"])
        for _ in pipe.process_stream([big] * 2, max_num=bc["max_num"]):
            pass
    torch.cuda.synchronize()
    wa.launches = 0
    fps = stream_fps(torch, pipe, [big] * bc["depth"], bc["depth"],
                     bc["max_num"], bc["rounds"])
    launches = wa.launches
    if launches <= 0:
        fail("onnx executor bench path launched K1 no time")
    busy = device_busy(torch, lambda: stream_fps(
        torch, pipe, [big] * bc["depth"], bc["depth"], bc["max_num"], 1))
    split = {}
    for name in ("bf16", "f32"):
        timer = StageTimer(torch)
        stages.set_stage_hook(timer)
        try:
            o = pipes[name](big, max_num=bc["max_num"])
            split[name] = timer.totals()
        finally:
            stages.set_stage_hook(None)
        check_output(torch, o, bc["frames"], bc["max_num"],
                     f"onnx executor bench path ({name})")
    del pipes, big
    s_ = sorted(fps)
    native = native_bench.get("frames_per_sec")
    rep.say(f"onnx executor bench path: bench.py's settings at bf16 "
            f"({bc['frames']}x{bc['hw'][0]}x{bc['hw'][1]} frames resident, "
            f"depth {bc['depth']}, {bc['rounds']} rounds): "
            f"{fps_said(fps)} frames/s; the native models in phase 13 of "
            f"this run {native if native is None else f'{native:.2f}'} "
            f"frames/s; K1 launches {launches}; one call by stage (device "
            f"ms): " + "; ".join(f"{n} scrfd {split[n].get('scrfd', 0.0):.3f},"
                                 f" arcface {split[n].get('arcface', 0.0):.3f}"
                                 for n in ("bf16", "f32"))
            + f"; one round under torch.profiler: {busy_said(busy)}")
    err, what = k1_on_path(torch, wa, list(k1_calls) + list(k1_bench))
    rep.say(f"onnx executor path: K1 vs plain on the phase's inputs, {what}: "
            f"max abs err {err:.6g} u8 (tolerance {TOL_U8})")

    # (f) the entry points that took no weight file before
    fa = phase_onnx_entry_points(torch, rep, paths)
    rep.say(f"onnx executor phase done in {time.perf_counter() - t0:.1f} s")
    return dict(launches=launches, err=max(err, fa["err"]), fps=s_[len(s_) // 2],
                heads=heads, share=share, costs=costs, paths=paths)


def phase_onnx_entry_points(torch, rep, paths):
    """15f: FaceAnalysis(det_onnx=, rec_onnx=) on phase 12's static images;
    realtime.run with --det-weight / --rec-weight on a synthetic capture,
    every frame written in order, each batch's count equal to a direct
    call."""
    import tempfile

    from scrfd_arcface_facerecognition_tpu_torch.apps import FaceAnalysis
    from scrfd_arcface_facerecognition_tpu_torch.apps import realtime
    from scrfd_arcface_facerecognition_tpu_torch.models import graph_models
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    ns, hs, ws = FACADE["static"]
    rng = np.random.default_rng(12)                  # phase 12's images
    static = [rng.integers(0, 256, (hs, ws, 3), dtype=np.uint8)
              for _ in range(ns)]
    app = FaceAnalysis(det_onnx=paths["det_10g"], rec_onnx=paths["w600k_r50"],
                       max_det=FACADE["max_det"], device=DEV)
    app.prepare(det_size=FACADE["det_size"])
    if not (isinstance(app.detector.model, graph_models.SCRFDGraphModule)
            and isinstance(app.embedder.model,
                           graph_models.ArcFaceGraphModule)):
        fail("facade: det_onnx / rec_onnx did not give the graph models")
    t = time.perf_counter()
    got = app.get_batch(static)
    torch.cuda.synchronize()
    fa_ms = (time.perf_counter() - t) * 1e3
    unit_embeddings(got, "facade on the ONNX files")
    fa_dtype = str(app.dtype).replace("torch.", "")
    del app

    n, batch = ONNX_EXEC["realtime"]
    cap = SyntheticCapture(n, hs, ws, seed=151)
    writer = RecordingWriter()
    made, seen = [], []
    saved = {k: getattr(realtime, k) for k in (
        "FacePipeline", "open_capture", "open_writer", "annotate_batch",
        "read_image")}

    def recorded(**kw):
        made.append(saved["FacePipeline"](**kw))
        return made[-1]

    realtime.FacePipeline = recorded
    realtime.open_capture = lambda source: cap
    realtime.open_writer = lambda path, fps, size: writer
    realtime.annotate_batch = lambda frames, out, names, colors: seen.append(
        (frames.copy(), out))
    realtime.read_image = lambda path: np.load(path)
    try:
        with tempfile.TemporaryDirectory() as tmp, k1_capture() as k1_calls:
            faces = os.path.join(tmp, "faces")
            os.makedirs(faces)
            np.save(os.path.join(faces, "person0.npy"),
                    rng.integers(0, 255, (240, 240, 3), np.uint8))
            args = realtime.parse_args([
                "--source", "synthetic", "--faces-dir", faces,
                "--batch", str(batch), "--output", os.path.join(tmp, "o.mp4"),
                "--det-weight", paths["det_10g"],
                "--rec-weight", paths["w600k_r50"], "--log-level", "WARNING"])
            t = time.perf_counter()
            res = realtime.run(args, device=DEV)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t
    finally:
        for k, v in saved.items():
            setattr(realtime, k, v)
    pipe = made[0]
    if not isinstance(pipe.detector.model, graph_models.SCRFDGraphModule):
        fail("realtime: --det-weight did not give the graph model")
    if res["frames"] != n or writer.sums != cap.sums:
        fail(f"realtime on the ONNX files: {res['frames']} of {n} frames, "
             f"in order {writer.sums == cap.sums}")
    for i, (fr, o) in enumerate(seen):
        if not torch.equal(o.count, pipe(fr).count):
            fail(f"realtime on the ONNX files, batch {i}: counts differ "
                 f"from a direct call")
    err, what = k1_on_path(torch, wa, k1_calls)
    rep.say(f"onnx executor entry points: FaceAnalysis(det_onnx=, "
            f"rec_onnx=) ({fa_dtype}) get_batch of phase 12's "
            f"{ns}x{hs}x{ws} images in {fa_ms:.2f} ms, "
            f"{sum(len(f) for f in got)} faces, every embedding a finite "
            f"unit 512-vector; realtime.run --det-weight / --rec-weight "
            f"the stand-in files on a {n}-frame {hs}x{ws} capture, batch "
            f"{batch}: {res['frames']} frames written in order, "
            f"{res['targets']} target, {len(seen)} batches each with the "
            f"count of a direct call, {run_s:.2f} s with set-up; K1 vs plain "
            f"on the run's inputs, {what}: max abs err {err:.6g} u8")
    return dict(err=err, facade_ms=fa_ms)


# ---------------------------------------------------------------------
# phase 16: the camera apps


def synthetic_camera(source):
    """The camera apps' opener in phase 16: ``"cam:<seed>:<frames>:<h>:<w>:
    <fps>"`` -> a SyntheticCapture; ``"cam:down"`` -> a capture that did
    not open (cv2's shape for a camera that is down). Defined at the top
    level: the decode pool's workers unpickle it by name."""
    if source == "cam:down":
        cap = SyntheticCapture(0, 1, 1)
        cap.released = True
        return cap
    _, seed, n, h, w, fps = source.split(":")
    return SyntheticCapture(int(n), int(h), int(w), fps=float(fps),
                            seed=int(seed))


def camera_sources():
    """Phase 16's cameras: (source, frames, h, w), one of them down (0
    frames) and one ending at half length."""
    c = CAMERAS
    (hh, hw), (sh, sw), n = c["hd"], c["sd"], c["frames"]
    cams = [(160, n, hh, hw), (161, n // 2, hh, hw), (162, n, sh, sw),
            (163, n, hh, hw)]
    out = [(f"cam:{seed}:{k}:{h}:{w}:25", k, h, w) for seed, k, h, w in cams]
    out.insert(2, ("cam:down", 0, 0, 0))
    return out


class AppRecorder:
    """The camera apps' replaceable names for one run: the pipeline they
    build (kept), the drawing (each round's frames and outputs kept, with
    the time), writers that keep each file's frame sums, size and rate,
    photos read with ``np.load``."""

    def __init__(self, realtime):
        self.realtime = realtime
        self.saved = {k: getattr(realtime, k) for k in (
            "FacePipeline", "open_capture", "open_writer", "annotate_batch",
            "read_image")}
        self.made, self.seen, self.files = [], [], {}

    def __enter__(self):
        rt, real = self.realtime, self.saved["FacePipeline"]

        def made(**kw):
            self.made.append(real(**kw))
            return self.made[-1]

        def open_writer(path, fps, size):
            w = self.files[os.path.basename(path)] = RecordingWriter()
            w.fps, w.size = fps, tuple(size)
            return w

        rt.FacePipeline = made
        rt.open_capture = synthetic_camera
        rt.open_writer = open_writer
        rt.annotate_batch = lambda frames, out, names, colors: (
            self.seen.append((frames.copy(), out, time.perf_counter())))
        rt.read_image = lambda path: np.load(path)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.realtime, k, v)

    def fps(self):
        """Frames a second from the first round's drawing to the last."""
        s = self.seen
        return (sum(len(f) for f, _, _ in s[1:])
                / max(s[-1][2] - s[0][2], 1e-9)) if len(s) > 1 else 0.0


def hold_to_direct(torch, pipe, seen, what):
    """Each round's count, valid and match_idx equal to a direct call of
    ``pipe`` on the same frames, embeddings cosine >= 0.999; -> (the
    least cosine, faces)."""
    worst, faces = 1.0, 0
    for i, (frames, out, *_) in enumerate(seen):
        check_output(torch, out, len(frames), out.valid.shape[1],
                     f"{what} round {i}")
        want = pipe(frames, max_num=0)
        for name in ("count", "valid", "match_idx"):
            if not torch.equal(getattr(out, name), getattr(want, name)):
                fail(f"{what} round {i}: {name} differs from a direct call")
        a, b = out.embeddings[out.valid], want.embeddings[want.valid]
        if len(a):
            worst = min(worst, float(((a * b).sum(-1) / (
                a.norm(dim=-1) * b.norm(dim=-1))).min()))
        faces += int(out.valid.sum())
    if worst < 0.999:
        fail(f"{what}: embeddings differ from a direct call, cos {worst}")
    return worst, faces


def phase_camera_apps(torch, rep, paths):
    """16: ``multistream.run`` over ``CAMERAS`` through decode threads and
    through the decode pool, and ``dualstream.run`` on a 1080p and a 720p
    camera, on the stand-in files at bf16 through the graph executor."""
    import tempfile

    from scrfd_arcface_facerecognition_tpu_torch.apps import (
        dualstream, multistream, realtime)
    from scrfd_arcface_facerecognition_tpu_torch.models import graph_models
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.ops.resize import (
        resize_bilinear_u8_exact)
    from scrfd_arcface_facerecognition_tpu_torch.runtime import decode_pool

    c = CAMERAS
    cams = camera_sources()
    live = [(i, k, h, w) for i, (_, k, h, w) in enumerate(cams) if k]
    want = {i: [frame_sum(f) for f in synthetic_camera(src).frames]
            for i, (src, k, _, _) in enumerate(cams) if k}
    runs, pools, k1_calls, launches = {}, [], [], 0
    real_pool = decode_pool.DecodePool

    def kept_pool(*a, **k):
        pools.append(real_pool(*a, **k))
        return pools[-1]

    with tempfile.TemporaryDirectory() as tmp:
        faces = os.path.join(tmp, "faces")
        os.makedirs(faces)
        np.save(os.path.join(faces, "person0.npy"),
                np.random.default_rng(16).integers(0, 255, (240, 240, 3),
                                                   np.uint8))
        weights = ["--det-weight", paths["det_10g"], "--rec-weight",
                   paths["w600k_r50"], "--faces-dir", faces]
        for reader in ("threads", "pool"):
            argv = ["--sources", *(s for s, *_ in cams), "--output-dir",
                    os.path.join(tmp, reader)] + weights
            if reader == "pool":
                argv += ["--decode-pool", "--decode-workers",
                         str(c["workers"]), "--slot-bytes",
                         str(c["slot_bytes"])]
            decode_pool.DecodePool = kept_pool
            try:
                with AppRecorder(realtime) as rec, k1_capture() as calls:
                    wa.launches = 0
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    res = multistream.run(multistream.parse_args(argv),
                                          device=DEV)
                    torch.cuda.synchronize()
                    run_s = time.perf_counter() - t
                    n_k1 = wa.launches
            finally:
                decode_pool.DecodePool = real_pool
            launches += n_k1
            k1_calls += calls
            runs[reader] = (res, rec, run_s, n_k1)

        # the dual app on a 1080p and a 720p camera
        (hh, hw), (sh, sw), n = c["hd"], c["sd"], c["dual_pairs"]
        dual_src = (f"cam:164:{n}:{hh}:{hw}:25", f"cam:165:{n}:{sh}:{sw}:25")
        argv = ["--source1", dual_src[0], "--source2", dual_src[1],
                "--output", os.path.join(tmp, "both.mp4"),
                "--reconnect-delay", "0"] + weights
        with AppRecorder(realtime) as dual, k1_capture() as calls:
            wa.launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            dres = dualstream.run(dualstream.parse_args(argv), device=DEV)
            torch.cuda.synchronize()
            dual_s = time.perf_counter() - t
            dual_k1 = wa.launches
        launches += dual_k1
        k1_calls += calls

    # the multi-camera app: every frame of every live camera written, in
    # order, at the camera's own size; the same rounds from both readers
    rounds = {}
    for reader, (res, rec, run_s, n_k1) in runs.items():
        pipe = rec.made[0]
        if not isinstance(pipe.detector.model, graph_models.SCRFDGraphModule) \
                or pipe.detector.dtype != torch.bfloat16:
            fail(f"camera apps ({reader}): the pipeline is not the graph "
                 f"executor at bf16")
        total = sum(k for _, k, _, _ in live)
        if res["frames"] != total or n_k1 <= 0:
            fail(f"camera apps ({reader}): {res['frames']} of {total} frames "
                 f"served, K1 launches {n_k1}")
        for i, k, h, w in live:
            wr = rec.files.get(f"stream_{i}.mp4")
            if wr is None or wr.sums != want[i] or wr.size != (w, h) \
                    or not wr.released:
                fail(f"camera apps ({reader}): stream {i} written "
                     f"{None if wr is None else (len(wr.sums), wr.size)}, "
                     f"not its {k} frames in order at {w}x{h}")
        if "stream_2.mp4" in rec.files:
            fail(f"camera apps ({reader}): the camera that is down was "
                 f"written")
        cos, faces = hold_to_direct(torch, pipe, rec.seen,
                                    f"camera apps ({reader})")
        rounds[reader] = [frame_sum(f) for f, _, _ in rec.seen]
        runs[reader] = dict(res=res, fps=rec.fps(), run_s=run_s, k1=n_k1,
                            cos=cos, faces=faces, n_rounds=len(rec.seen),
                            sizes=sorted({len(f) for f, _, _ in rec.seen}))
    if rounds["threads"] != rounds["pool"]:
        fail("camera apps: the decode threads and the decode pool gave "
             "different rounds")
    pool = pools[0]
    for reader, r in runs.items():
        rep.say(f"camera apps: multistream.run ({reader}) over "
                f"{len(live)} synthetic cameras and one that does not open "
                f"({c['hd'][1]}x{c['hd'][0]} x3, {c['sd'][1]}x{c['sd'][0]} "
                f"x1, one ending at {c['frames'] // 2} of {c['frames']} "
                f"frames), the "
                f"stand-in files at bf16 through the executor: "
                f"{r['res']['frames']} frames in {r['n_rounds']} rounds of "
                f"{r['sizes']} streams, {r['fps']:.2f} frames/s from the "
                f"first round's drawing to the last (the run "
                f"{r['run_s']:.2f} s with set-up); every stream written in "
                f"order at its own size; {r['faces']} faces; each round's "
                f"count / valid / match_idx equal to a direct call, min "
                f"cosine {r['cos']:.6f}; K1 launches {r['k1']}")
    rep.say(f"camera apps: the decode pool: {pool.n_workers} workers, "
            f"{pool.slots_per_stream} slots a stream of {pool.slot_bytes} B; "
            f"the workers' start calls {pool.start_s:.3f} s, its first "
            f"round {pool.first_round_s:.3f} s after its start; the same "
            f"rounds as the decode threads (every frame's sum)")

    # the dual app: every pair served, the 720p frame resized to 1080p
    pipe = dual.made[0]
    (hh, hw) = c["hd"]
    left = [frame_sum(f) for f in synthetic_camera(dual_src[0]).frames]
    wr = dual.files.get("both.mp4")
    if (dres["frames"] != 2 * n or len(dual.seen) != n or wr is None
            or len(wr.sums) != n or wr.size != (2 * hw, hh) or dual_k1 <= 0):
        fail(f"dual app: {dres['frames']} frames, {len(dual.seen)} pairs, "
             f"written {None if wr is None else (len(wr.sums), wr.size)}, "
             f"K1 launches {dual_k1}")
    right = synthetic_camera(dual_src[1]).frames
    for i, (frames, _, _) in enumerate(dual.seen):
        # the card's resize against the same arithmetic on the host
        want_right = resize_bilinear_u8_exact(torch.from_numpy(right[i]),
                                              (hh, hw)).numpy()
        if frames.shape != (2, hh, hw, 3) or frame_sum(
                frames[0]) != left[i] or not np.array_equal(frames[1],
                                                            want_right):
            fail(f"dual app: pair {i} is not the first camera's frame "
                 f"beside the second's resized")
    cos, faces = hold_to_direct(torch, pipe, dual.seen, "dual app")
    err, what = k1_on_path(torch, wa, k1_calls)
    rep.say(f"camera apps: dualstream.run on a {hw}x{hh} and a "
            f"{c['sd'][1]}x{c['sd'][0]} camera: {n} pairs (the second "
            f"resized on the card by ops.resize_bilinear_u8_exact, equal to "
            f"the host's) in {dual_s:.2f} s "
            f"with set-up, {dual.fps():.2f} frames/s from the first pair's "
            f"drawing to the last; "
            f"{faces} faces, each pair equal to a direct call, min cosine "
            f"{cos:.6f}; K1 launches {dual_k1}; K1 vs plain on the three "
            f"runs' inputs, {what}: max abs err {err:.6g} u8 (tolerance "
            f"{TOL_U8})")
    return dict(launches=launches, err=err,
                fps={r: v["fps"] for r, v in runs.items()},
                dual_fps=dual.fps(), start_s=pool.start_s,
                first_round_s=pool.first_round_s)


# ---------------------------------------------------------------------
# phase 17: the web API


class WebClient:
    """Requests to the server at ``base``: each answer's status, content
    type and body (JSON decoded where it is JSON)."""

    def __init__(self, base):
        self.base = base

    def __call__(self, method, path, body=None):
        import urllib.error
        import urllib.request

        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            self.base + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                status, ctype, raw = (r.status, r.headers["Content-Type"],
                                      r.read())
        except urllib.error.HTTPError as e:
            status, ctype, raw = (e.code, e.headers["Content-Type"],
                                  e.read())
        if ctype == "application/json":
            raw = json.loads(raw)
        return status, ctype, raw


@contextlib.contextmanager
def web_server(engine, comparison, tmp):
    """``make_server`` on 127.0.0.1, port 0, serving ``engine`` in a
    thread; yields a WebClient; shut down and joined after the block."""
    import threading

    from scrfd_arcface_facerecognition_tpu_torch.apps.webapp import (
        WebApp, make_server)

    app = WebApp(engine, comparison=comparison,
                 api_config_path=os.path.join(tmp, "api_config.txt"),
                 results_dir=tmp, allowed_image_dirs=[tmp])
    server = make_server(app, host="127.0.0.1", port=0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        yield WebClient(f"http://127.0.0.1:{server.server_address[1]}")
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)


def comparison_records(n, prefix="a"):
    return [{"id": f"r{i}", "image": f"http://cam/{prefix}_{i}.jpg",
             "refImage": f"http://cam/{'a' if i % 3 == 0 else 'b'}_{i}.jpg",
             "isConverted": i % 2 == 0, "branchId": "b1"} for i in range(n)]


def phase_web(torch, rep, app, direct):
    """17: the web API on the card: (a) the engine on phase 12's facade
    over HTTP against the same engine driven directly, then every other
    route once; (b) micro-batched concurrent comparisons; (c) the PQ tier
    through the web, its decisions equal to the CPU's. ``direct`` holds
    phase 12's ms a visit and a pair."""
    import base64
    import tempfile
    import threading

    from scrfd_arcface_facerecognition_tpu_torch.apps import (
        FaceComparison, SmartFaceEngine, webapp)
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq, pq_adc
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.utils.config import (
        DEFAULT_CONFIG, deep_update)

    hw, n, npairs = FACADE["visit_hw"], FACADE["visits"], FACADE["pairs"]
    loader = (lambda src, save_path=None, timeout=30: loader_image(src, hw))
    pair_loader = (lambda src: loader_image(src, hw))
    visits = engine_visits(n, lambda i: f"http://cam/visit_{i}.jpg")

    def engine(tmp, **cfg):
        return SmartFaceEngine(
            config=deep_update(engine_config(tmp), cfg), app=app,
            image_loader=loader, results_dir=os.path.join(tmp, "results"),
            device=DEV)

    def comparison():
        return FaceComparison(config=DEFAULT_CONFIG, app=app,
                              image_loader=pair_loader, log_file=None,
                              device=DEV)

    seen = {}
    saved = (webapp.read_image, webapp.encode_jpeg)
    webapp.read_image = lambda path: np.load(path)
    webapp.encode_jpeg = lambda img, quality, max_wh: (
        b"\xff\xd8" + img[:4, :4].tobytes() + b"\xff\xd9")
    try:
        with tempfile.TemporaryDirectory() as d0, tempfile.TemporaryDirectory(
                ) as tmp, port_log("web API"):
            # (a) the visits over HTTP against the engine driven directly
            ref = engine(d0)
            want = ref.process_visit_data_from_json(visits, save_images=False)
            want_rec = engine_record(ref)
            eng = engine(tmp)
            with web_server(eng, comparison(), tmp) as web, k1_capture(
                    ) as k1_calls:
                wa.launches = 0
                torch.cuda.synchronize()
                t = time.perf_counter()
                status, _, got = web("POST", "/api/process-visits",
                                     dict(visits, save_images=False))
                visit_ms = (time.perf_counter() - t) * 1e3 / n
                k1_visits = wa.launches
                if status != 200 or not got["success"]:
                    fail(f"web API: process-visits answered {status} {got}")
                diff = record_diff(without_clock(want),
                                   without_clock(got["results"]), TOL_RECORD,
                                   "results") or record_diff(
                    want_rec, engine_record(eng), TOL_RECORD)
                if diff:
                    fail(f"web API: the engine over HTTP and driven directly "
                         f"differ: {diff}")
                wa.launches = 0
                t = time.perf_counter()
                status, _, cmp_ = web(
                    "POST", "/api/process-face-comparisons-from-api",
                    {"records": comparison_records(npairs)})
                pair_ms = (time.perf_counter() - t) * 1e3 / npairs
                k1_pairs = wa.launches
                if status != 200 or cmp_["summary"]["processed"] != npairs:
                    fail(f"web API: face comparisons answered {status}")
                # every other route once
                groups = web("GET", "/api/person-groups")
                pid = groups[2]["groups"][0]["person_id"]
                img = os.path.join(tmp, "face.npy")
                np.save(img, loader_image("http://cam/photo.jpg", hw))
                routes = {
                    "GET /": web("GET", "/"),
                    "GET /api/stats": web("GET", "/api/stats"),
                    "GET /api/config": web("GET", "/api/config"),
                    "GET /api/person-groups": groups,
                    "GET /api/low-similarity-images": web(
                        "GET", "/api/low-similarity-images"),
                    "GET /api/job-progress": web("GET", "/api/job-progress"),
                    "GET /api/person/{id}": web("GET", f"/api/person/{pid}"),
                    "GET /api/image/{path}": web("GET", f"/api/image/{img}"),
                    "GET /api/image-base64/{path}": web(
                        "GET", f"/api/image-base64/{img}"),
                    "POST /api/merge-duplicates": web(
                        "POST", "/api/merge-duplicates", {}),
                    "POST /api/process-visits-from-api": web(
                        "POST", "/api/process-visits-from-api", {}),
                    "POST /api/clear-cache": web("POST", "/api/clear-cache",
                                                 {}),
                    "POST /api/clear-database": web(
                        "POST", "/api/clear-database", {}),
                }
                stats = web("GET", "/api/stats")[2]
            expect = {"POST /api/process-visits-from-api": 400}
            bad = {k: v[0] for k, v in routes.items()
                   if v[0] != expect.get(k, 200)}
            b64 = routes["GET /api/image-base64/{path}"][2]["image"]
            if bad or stats["total_persons"] != 0 or not base64.b64decode(
                    b64.split(",", 1)[1]).startswith(b"\xff\xd8"):
                fail(f"web API: routes answered {bad}, persons after the "
                     f"clear {stats['total_persons']}")
            seen["routes"] = {k: v[0] for k, v in routes.items()}

            # (b) micro-batched concurrent comparisons, on the
            # identity-coded app: the seeded facade's faces are near ties
            # whose pick moves with the batch's route (phase 12b holds the
            # facade's own micro-batching to the direct path)
            ident_app = IdentityApp()
            eng = SmartFaceEngine(
                config=deep_update(engine_config(tmp), {"serving": {
                    "microbatch": True, "microbatch_max_wait_ms": 150.0}}),
                app=ident_app, image_loader=identity_loader,
                results_dir=os.path.join(tmp, "results"), device=DEV)
            mb = ident_app._microbatcher
            records = [{"id": f"r{i}",
                        "image": f"http://cam/id_{i}_0.jpg",
                        "refImage": "http://cam/id_%d_1.jpg"
                        % (i if i % 2 == 0 else i + 100),
                        "customerId": f"c{i}"} for i in range(8)]
            ident_cmp = FaceComparison(
                config=DEFAULT_CONFIG, app=ident_app, log_file=None,
                image_loader=lambda src: identity_loader(src), device=DEV)
            try:
                with web_server(eng, ident_cmp, tmp) as web:
                    seq = [web("POST",
                               "/api/process-face-comparisons-from-api",
                               {"records": [r]})[2]["confidences"][0]
                           for r in records]
                    mb.n_batches = mb.n_items = mb.max_batch_seen = 0
                    par = [None] * len(records)

                    def post(i):
                        par[i] = web("POST",
                                     "/api/process-face-comparisons-from-api",
                                     {"records": [records[i]]})[2][
                                         "confidences"][0]

                    ts = [threading.Thread(target=post, args=(i,))
                          for i in range(len(records))]
                    for th in ts:
                        th.start()
                    for th in ts:
                        th.join(timeout=120)
                    width, n_batches = mb.max_batch_seen, mb.n_batches
            finally:
                ident_app.disable_microbatch()
            worst = max(abs(a["confidence"] - b["confidence"])
                        for a, b in zip(seq, par) if b is not None)
            if (any(b is None for b in par) or width <= 1
                    or any(a["our_result"] != b["our_result"]
                           or a["comparison_id"] != b["comparison_id"]
                           for a, b in zip(seq, par)) or worst > 1e-6):
                fail(f"web API: concurrent comparisons (max batch {width}) "
                     f"differ from the sequential ones, by up to {worst}")
            seen["microbatch"] = (width, n_batches, worst)

        # (c) the PQ tier through the web, against the CPU run
        cfg = ENGINE_PQ
        ident = [(i % cfg["idents"], i // cfg["idents"])
                 for i in range(cfg["visits"])]
        pq_visits = engine_visits(cfg["visits"],
                                  lambda i: "http://cam/id_%d_%d.jpg"
                                  % ident[i])

        vdb = dict(tier="pq", pq_min_train_rows=cfg["min_train_rows"])
        with tempfile.TemporaryDirectory() as tmp, tempfile.TemporaryDirectory(
                ) as d0, port_log("web API, PQ tier"):
            cpu_eng, cpu_res = run_engine(d0, IdentityApp(), identity_loader,
                                          pq_visits, cfg["batches"], "cpu",
                                          **vdb)
            cpu_rec = engine_record(cpu_eng)
            eng = SmartFaceEngine(
                config=engine_config(tmp, **vdb), app=IdentityApp(),
                image_loader=identity_loader,
                results_dir=os.path.join(tmp, "results"), device=DEV)
            with web_server(eng, None, tmp) as web, k2_capture() as k2_calls:
                k2_reset(pq_adc)
                step = -(-cfg["visits"] // cfg["batches"])
                totals = {}
                for c0 in range(0, cfg["visits"], step):
                    status, _, got = web("POST", "/api/process-visits", {
                        "visits": pq_visits["visits"][c0:c0 + step],
                        "save_images": False})
                    if status != 200:
                        fail(f"web API, PQ tier: process-visits answered "
                             f"{status} {got}")
                    for k, v in got["results"].items():
                        totals[k] = totals.get(k, 0) + v
                k2 = k2_count(pq_adc)
            card_rec = engine_record(eng)
            tier = eng.vector_db.tier
    finally:
        webapp.read_image, webapp.encode_jpeg = saved
    if tier != "pq" or k2 <= 0 or not k2_calls:
        fail(f"web API, PQ tier: tier {tier}, K2 launches {k2}, "
             f"{len(k2_calls)} searches captured")
    diff = record_diff(card_rec, cpu_rec, TOL_RECORD) or record_diff(
        totals, cpu_res, 0, "results")
    if diff:
        fail(f"web API, PQ tier: the card over HTTP and the CPU decide "
             f"differently: {diff}")
    err2, rel = 0.0, 0.0
    for lut, codes, valid, k, precision in k2_calls:
        e, r = compare_k2(torch, pq_adc, lut, codes, precision)
        err2, rel = max(err2, e), max(rel, r)
        compare_topk(torch, pq_adc, "web API, PQ tier", lut, codes, valid, k,
                     precision)
    err1, what = k1_on_path(torch, wa, k1_calls)
    width, n_batches, worst = seen["microbatch"]
    rep.say(f"web API: make_server on 127.0.0.1 over SmartFaceEngine on "
            f"phase 12's facade (f32, seeded): POST /api/process-visits "
            f"of {n} visits {visit_ms:.2f} ms a visit over HTTP (phase 12 "
            f"direct {direct['ms_visit']:.2f}), K1 launches {k1_visits}; "
            f"the SQLite rows and results equal to the engine driven "
            f"directly; {npairs} comparisons in one request {pair_ms:.2f} "
            f"ms a pair (phase 12 direct {direct['ms_pair']:.2f}), K1 "
            f"launches {k1_pairs}; K1 vs plain on the requests' inputs, "
            f"{what}: max abs err {err1:.6g} u8 (tolerance {TOL_U8})")
    rep.say("web API: every other route once: " + ", ".join(
        f"{k} {v}" for k, v in seen["routes"].items())
        + "; /api/image-base64 with its reader and encoder replaced (no "
        "cv2 on this machine); no ERROR logged")
    rep.say(f"web API: serving.microbatch on (the identity-coded app), "
            f"8 concurrent comparison requests: coalesced, max batch "
            f"{width} over {n_batches} batches; each answer equal to the "
            f"sequential one (our_result, ids; confidence within "
            f"{worst:.3g}, tolerance 1e-6)")
    rep.say(f"web API, PQ tier: IdentityApp, {cfg['visits']} visits in "
            f"{cfg['batches']} POSTs: new persons {totals['new_persons']}, "
            f"assigned {totals['recognized']}; K2 launches {k2}; the "
            f"decisions equal to the CPU run's; K2 vs plain on every "
            f"search's inputs ({len(k2_calls)} searches): max abs err "
            f"{err2:.6g} = {rel:.3g} of max |score| (tolerance {TOL_K2}); "
            f"the fused top-k bit-equal to the plain chain and to K2 + "
            f"mask + sort on them")
    return dict(k1=k1_visits + k1_pairs, k2=k2, err1=err1, err2=err2,
                ms_visit=visit_ms, ms_pair=pair_ms, width=width)


# ---------------------------------------------------------------------
# phase 18: train, checkpoint, export, serve


def train_run(torch, trainer, parts, images, labels, scores, steps):
    """``steps`` updates from ``parts``: each state's parts (copied to the
    CPU) and the losses."""
    from scrfd_arcface_facerecognition_tpu_torch.train import state_parts

    state = trainer.state_from(parts)
    states, losses = [], []
    for step in range(steps):
        state, loss = trainer.train_step(
            state, images, labels,
            None if scores is None else scores[step])
        states.append(state_parts(state))
        losses.append(float(loss))
    return states, losses


def worst_gaps(got, want, what):
    """For the weights (with the class matrix), the BN statistics and the
    momentum: the largest gap between two states' tensors as a share of
    ``TOL_TRAIN["double"]`` (``atol + rtol * max |want|``), and its
    tensor; fails past 1."""
    from scrfd_arcface_facerecognition_tpu_torch.train import state_gaps

    atol, rtol = TOL_TRAIN["double"]
    out = {}
    for name, share in state_gaps(got, want, atol, rtol).items():
        kind = ("BN statistics" if ".running_" in name else
                "momentum" if name.startswith("trace.") else "weights")
        if share > 1.0:
            fail(f"{what} {name}: {share:.3g} x {atol} + {rtol} x max")
        if share >= out.get(kind, (-1.0, ""))[0]:
            out[kind] = share, name
    return out


def said_gaps(gaps):
    return ", ".join(f"{kind} {share:.3g} ({name})"
                     for kind, (share, name) in gaps.items())


def phase_train_card_vs_cpu(torch, rep):
    """18a: ``TRAIN["cmp"]`` on the card and on the CPU from one seeded
    state, full softmax and Partial FC on the same scores: the first
    step's loss at float32 (TF32 off), then one and three steps in
    float64, every tensor held to ``TOL_TRAIN["double"]``."""
    from scrfd_arcface_facerecognition_tpu_torch.models import build_arcface
    from scrfd_arcface_facerecognition_tpu_torch.train import (
        ArcFaceTrainer, state_parts)

    c = TRAIN["cmp"]
    rng = np.random.default_rng(18)
    images = torch.from_numpy(rng.normal(size=(c["batch"], 3, 112, 112)))
    labels = torch.from_numpy(rng.integers(0, c["classes"], c["batch"]))
    draws = [torch.from_numpy(rng.uniform(size=c["classes"]))
             for _ in range(c["steps"])]
    out = {}
    for rate in (1.0, c["rate"]):
        what = "full softmax" if rate == 1.0 else f"Partial FC {rate}"
        scores = None if rate == 1.0 else draws
        runs = {}
        for dtype, steps in ((torch.float32, 1), (torch.float64, c["steps"])):
            kw = dict(num_classes=c["classes"], sample_rate=rate, dtype=dtype)
            cpu = ArcFaceTrainer(model=build_arcface(c["rec"]), device="cpu",
                                 **kw)
            card = ArcFaceTrainer(model=build_arcface(c["rec"]), device=DEV,
                                  **kw)
            parts = state_parts(cpu.init_state(0))
            t0 = time.perf_counter()
            want = train_run(torch, cpu, parts, images, labels, scores, steps)
            t_cpu = time.perf_counter() - t0
            got = train_run(torch, card, parts, images.to(DEV),
                            labels.to(DEV), scores, steps)
            runs[dtype] = got, want, t_cpu
        (_, got32), (_, want32), _ = runs[torch.float32]
        rel32 = abs(got32[0] - want32[0]) / abs(want32[0])
        if rel32 > TOL_TRAIN["loss"]:
            fail(f"train card vs CPU, {what}, float32: step-1 loss "
                 f"{got32[0]!r} against {want32[0]!r}, {rel32:.3g} relative")
        (got, got_loss), (want, want_loss), t_cpu = runs[torch.float64]
        rel64 = max(abs(g - w) / abs(w) for g, w in zip(got_loss, want_loss))
        if rel64 > TOL_TRAIN["loss64"]:
            fail(f"train card vs CPU, {what}, float64: losses {got_loss} "
                 f"against {want_loss}")
        gaps = [worst_gaps(got[i], want[i], f"train card vs CPU, {what}, "
                           f"float64, step {i + 1}")
                for i in (0, c["steps"] - 1)]
        atol, rtol = TOL_TRAIN["double"]
        rep.say(f"train card vs CPU ({c['rec']} full width, batch "
                f"{c['batch']}, {c['classes']} classes, {what}): float32 "
                f"(TF32 off) step-1 loss card {got32[0]:.7f} CPU "
                f"{want32[0]:.7f} ({rel32:.3g} relative, tolerance "
                f"{TOL_TRAIN['loss']}); float64 losses within {rel64:.3g} "
                f"relative over {c['steps']} steps (tolerance "
                f"{TOL_TRAIN['loss64']}); the worst tensor's share of "
                f"{atol} + {rtol} x max after 1 step: {said_gaps(gaps[0])}"
                f"; after {c['steps']}: {said_gaps(gaps[1])}; the CPU's "
                f"{c['steps']} float64 steps {t_cpu:.1f} s")
        out[what] = dict(loss32=(got32[0], want32[0]), rel64=rel64,
                         gaps=gaps)
    return out


def phase_train_full(torch, rep):
    """18b: ``TRAIN["full"]`` (iResNet-50 at the released training shape,
    Partial FC) on the card, without and with remat: ms a step, images a
    second, peak device memory."""
    from scrfd_arcface_facerecognition_tpu_torch.models import build_arcface
    from scrfd_arcface_facerecognition_tpu_torch.train import ArcFaceTrainer

    c = TRAIN["full"]
    t0 = time.perf_counter()
    trainer = ArcFaceTrainer(model=build_arcface(c["rec"]),
                             num_classes=c["classes"], sample_rate=c["rate"],
                             device=DEV)
    state = trainer.init_state(0)
    gen = torch.Generator(device="cpu").manual_seed(181)
    n = c["warm"] + c["timed"]
    t_init = time.perf_counter() - t0
    # random labels cannot be learned: each step's loss stays near its
    # first, about ln(sampled classes) + s * sin(m)
    floor = math.log(trainer.num_sample) / 2
    out = {}
    for remat in (False, True):
        # fresh batches for each pass: a label seen once is learned
        batches = [
            (torch.randn((c["batch"], 3, 112, 112), generator=gen).to(DEV),
             torch.randint(0, c["classes"], (c["batch"],),
                           generator=gen).to(DEV)) for _ in range(n)]
        trainer.remat = remat
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses = []
        for images, labels in batches[:c["warm"]]:
            state, loss = trainer.train_step(state, images, labels)
            losses.append(loss)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for images, labels in batches[c["warm"]:]:
            state, loss = trainer.train_step(state, images, labels)
            losses.append(loss)
        e.record()
        e.synchronize()
        ms = s.elapsed_time(e) / c["timed"]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [float(v) for v in losses]
        if not all(np.isfinite(losses)):
            fail(f"train {c['rec']}: a loss is not finite: {losses}")
        if min(losses) < floor:
            fail(f"train {c['rec']}: a loss on fresh random labels below "
                 f"ln({trainer.num_sample}) / 2 = {floor:.3f}: {losses}")
        out[remat] = dict(ms=ms, ips=c["batch"] * 1e3 / ms, peak=peak,
                          losses=losses)
        rep.say(f"train {c['rec']} full width, 112 x 112, batch "
                f"{c['batch']}, {c['classes']} classes, Partial FC "
                f"{c['rate']} ({trainer.num_sample} sampled), f32 (TF32 "
                f"convs, PyTorch's default), remat {'on' if remat else 'off'}"
                f": {ms:.3f} ms a step (CUDA events, mean of {c['timed']} "
                f"after {c['warm']}; a fresh seeded batch a step), "
                f"{c['batch'] * 1e3 / ms:.1f} images a "
                f"second, peak device memory {peak:.2f} GiB; losses "
                f"{losses[0]:.4f} -> {losses[-1]:.4f} (min {min(losses):.4f}"
                f", max {max(losses):.4f}; fresh random labels, each above "
                f"ln({trainer.num_sample}) / 2 = {floor:.3f})")
    trainer.remat = False
    images, labels = batches[0]
    busy = device_busy(torch, lambda: trainer.train_step(state, images,
                                                         labels))
    rep.say(f"train {c['rec']}: one step (remat off) under torch.profiler: "
            + busy_said(busy))
    out["busy"] = busy
    d = out[True]
    rep.say(f"train {c['rec']}: remat costs {d['ms'] / out[False]['ms']:.3f}x"
            f" the time a step and saves {out[False]['peak'] - d['peak']:.2f}"
            f" GiB; the state's set-up (class matrix drawn on the CPU) "
            f"{t_init:.1f} s")
    return out


def phase_train_learns(torch, rep):
    """18c: ``TRAIN["learn"]`` memorizes one fixed batch: the last loss
    below the first."""
    from scrfd_arcface_facerecognition_tpu_torch.models import build_arcface
    from scrfd_arcface_facerecognition_tpu_torch.train import ArcFaceTrainer

    c = TRAIN["learn"]
    trainer = ArcFaceTrainer(model=build_arcface(c["rec"]),
                             num_classes=c["classes"], learning_rate=c["lr"],
                             device=DEV)
    state = trainer.init_state(0)
    rng = np.random.default_rng(183)
    images = torch.from_numpy(rng.normal(size=(c["batch"], 3, 112, 112))
                              .astype(np.float32)).to(DEV)
    labels = torch.from_numpy(rng.permutation(c["batch"]) % c["classes"]
                              ).to(DEV)
    losses = []
    for _ in range(c["steps"]):
        state, loss = trainer.train_step(state, images, labels)
        losses.append(loss)
    losses = [float(v) for v in losses]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"train {c['rec']} did not learn one fixed batch: {losses}")
    rep.say(f"train {c['rec']}: one fixed batch of {c['batch']} images over "
            f"{c['classes']} classes, lr {c['lr']}, {c['steps']} steps: loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f} (min {min(losses):.4f})")
    return losses


def run_cli(torch, module, args):
    """``python -m <module> <args>`` from the repository root in a child
    process (its own CUDA context); its standard output's lines."""
    repo = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-m", module] + list(args),
                         cwd=repo, capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        fail(f"{module} exited {out.returncode}: "
             f"{out.stderr.strip()[-2000:]}")
    return out.stdout.splitlines()


def run_clis(torch, calls):
    """``python -m <module> <args>`` for each (module, args) of ``calls``,
    all at once, each in a child process: each one's standard output's
    lines, in order. Every child has ended when this returns or fails."""
    repo = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, "-m", m] + list(a), cwd=repo,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for m, a in calls]
    try:
        out = []
        for (module, _), p in zip(calls, procs):
            stdout, stderr = p.communicate(timeout=600)
            if p.returncode != 0:
                fail(f"{module} exited {p.returncode}: "
                     f"{stderr.strip()[-2000:]}")
            out.append(stdout.splitlines())
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def said_after(lines, start):
    for line in lines:
        if start in line:
            return line.split(start, 1)[1].strip()
    fail(f"no line with {start!r} in {lines}")


def phase_train_loop(torch, rep):
    """18d: ``tools.train_arcface`` and ``tools.export_onnx --verify`` in
    child processes; the file's preflight, its weights read back against
    the checkpoint's, its embeddings against the trained module's; then
    ``FacePipeline`` with phase 11's det_10g stand-in and the exported
    embedder on 8 seeded 1080p frames, K1 counted and held to its plain
    version."""
    import shutil

    from scrfd_arcface_facerecognition_tpu_torch import FacePipeline
    from scrfd_arcface_facerecognition_tpu_torch.models import (
        ARCFACE_CONFIGS, load_inference_variables, preflight_graph)
    from scrfd_arcface_facerecognition_tpu_torch.models.config_from_graph import (
        variables_from_onnx)
    from scrfd_arcface_facerecognition_tpu_torch.models.weights import _leaves
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import Embedder

    c = TRAIN["loop"]
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase18")
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lines = run_cli(torch, "scrfd_arcface_facerecognition_tpu_torch.tools."
                    "train_arcface", [
                        "--synthetic", str(c["steps"]), "--variant", c["rec"],
                        "--batch", str(c["batch"]), "--device", DEV,
                        "--out", os.path.join(out_dir, "ckpt")])
    ckpt = said_after(lines, "saved ")
    t_train = time.perf_counter() - t0
    onnx = os.path.join(out_dir, f"{c['rec']}.onnx")
    lines = run_cli(torch, "scrfd_arcface_facerecognition_tpu_torch.tools."
                    "export_onnx", ["--variant", c["rec"], "--checkpoint",
                                    ckpt, "--out", onnx, "--verify",
                                    "--device", DEV])
    verify_cos = float(said_after(lines, "cosine(module, onnx) = "))
    t_export = time.perf_counter() - t0 - t_train
    info = preflight_graph(onnx, "rec")
    want = dict(_leaves(load_inference_variables(ckpt)))
    cfg, tree = variables_from_onnx(onnx, name=c["rec"])
    got = dict(_leaves(tree))
    if got.keys() != want.keys():
        fail(f"the exported file's tree has other leaves than the "
             f"checkpoint's: {sorted(set(got) ^ set(want))[:5]}")
    unequal = [k for k in want if not np.array_equal(got[k], want[k])]
    if unequal:
        fail(f"the exported file's weights differ from the checkpoint's at "
             f"{unequal[:5]}")
    variables = load_inference_variables(ckpt)
    graph = Embedder(onnx_path=onnx, device=DEV)
    native = Embedder(config=ARCFACE_CONFIGS[c["rec"]], variables=variables,
                      device=DEV)
    crops = np.random.default_rng(184).integers(
        0, 255, (c["crops"], 112, 112, 3), dtype=np.uint8)
    with full_f32(torch):
        eg = torch.from_numpy(graph.get_feat(crops))
        en = torch.from_numpy(native.get_feat(crops))
    cos = torch.nn.functional.cosine_similarity(eg, en)
    if float(cos.min()) < TOL_TRAIN["cos"]:
        fail(f"the exported embedder through the executor: cosine "
             f"{float(cos.min())} to the trained module's, below "
             f"{TOL_TRAIN['cos']}")
    rep.say(f"train -> export: tools.train_arcface --synthetic {c['steps']} "
            f"--variant {c['rec']} --batch {c['batch']} --device {DEV} in "
            f"{t_train:.1f} s (child process, start-up included) -> "
            f"{os.path.basename(ckpt)}; tools.export_onnx --verify in "
            f"{t_export:.1f} s, its cosine {verify_cos:.7f}; preflight "
            f"passes ({info['family']}, {info['n_nodes']} nodes); "
            f"variables_from_onnx "
            f"reads back {len(want)} leaves bit-equal to "
            f"load_inference_variables(checkpoint) ({cfg.name}); "
            f"Embedder(onnx_path=) on the card vs the trained module at f32 "
            f"(TF32 off) on {c['crops']} crops: cosine min "
            f"{float(cos.min()):.7f} (tolerance {TOL_TRAIN['cos']})")

    s = STANDIN
    det, _ = standin_parts(torch, torch.float32, conf_thres=s["conf"],
                           pre_nms=s["pre_nms"], max_det=s["max_det"])
    pipe = FacePipeline(detector=det, embedder=graph,
                        gallery_capacity=s["gallery"], device=DEV)
    rng = np.random.default_rng(185)
    pipe.set_gallery(rng.normal(size=(s["gallery"], 512)).astype(np.float32),
                     [f"p{i}" for i in range(s["gallery"])])
    nb, (h, w) = c["frames"], c["hw"]
    frames = torch.from_numpy(rng.integers(0, 255, (nb, h, w, 3),
                                           dtype=np.uint8)).to(DEV)
    pipe(frames, max_num=s["max_num"])                # warm-up
    torch.cuda.synchronize()
    wa.launches = 0
    t1 = time.perf_counter()
    with k1_capture() as calls:
        for _ in range(c["calls"]):
            o = pipe(frames, max_num=s["max_num"])
        torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t1) * 1e3 / c["calls"]
    launches = wa.launches
    if launches == 0:
        fail("train -> serve: the pipeline launched K1 no time")
    faces = int(o.valid.sum())
    ev = o.embeddings[o.valid]
    if faces == 0 or not bool(torch.isfinite(ev).all()) or not bool(
            ((ev.norm(dim=-1) - 1).abs() < 1e-3).all()):
        fail(f"train -> serve: {faces} faces, embeddings not finite and "
             f"unit-norm")
    err, summary = k1_on_path(torch, wa, calls)
    if err > TOL_U8:
        fail(f"train -> serve: K1 vs plain {err} u8 on the path's inputs")
    rep.say(f"train -> serve: FacePipeline with the det_10g stand-in and the "
            f"exported {c['rec']} (the graph executor, f32) on {nb} seeded "
            f"{h}x{w} frames: {faces} faces of {nb * s['max_num']} slots, "
            f"embeddings finite and unit-norm, {call_ms:.2f} ms a call; K1 "
            f"launches {launches} over {c['calls']} calls; K1 vs plain on "
            f"{summary}: {err:.6g} u8")
    return dict(launches=launches, err=err)


def phase_train(torch, rep):
    """18: (a) card vs CPU with TF32 off, (b) the full-width step, (c) it
    learns, (d) the loop through the CLIs to the pipeline."""
    t0 = time.perf_counter()
    with full_f32(torch):
        cmp = phase_train_card_vs_cpu(torch, rep)
    t1 = time.perf_counter()
    full = phase_train_full(torch, rep)
    learn = phase_train_learns(torch, rep)
    t2 = time.perf_counter()
    loop = phase_train_loop(torch, rep)
    rep.say(f"phase 18 took {time.perf_counter() - t0:.1f} s: (a) "
            f"{t1 - t0:.1f}, (b)-(c) {t2 - t1:.1f}, (d) "
            f"{time.perf_counter() - t2:.1f}")
    return dict(cmp=cmp, full=full, learn=learn, **loop)


# ---------------------------------------------------------------------
# phase 19: the SCRFD detector: train, checkpoint, AP, export, serve

# the trainer's spans (train/scrfd_train.py), in step order
DET_SPANS = ("scrfd_train.forward", "scrfd_train.assign_loss",
             "scrfd_train.backward", "scrfd_train.update")


def det_batch(torch, rng, c):
    """A ``synthetic_detection_batch`` of ``c``'s size and faces as
    tensors, the images NCHW."""
    from scrfd_arcface_facerecognition_tpu_torch.train import (
        synthetic_detection_batch)

    images, boxes, kps, valid = synthetic_detection_batch(
        rng, c["batch"], (c["size"], c["size"]), max_gt=c["max_gt"])
    return (torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(boxes), torch.from_numpy(kps),
            torch.from_numpy(valid))


def det_trainer(torch, variant, size, device, **kw):
    from scrfd_arcface_facerecognition_tpu_torch.models import build_scrfd
    from scrfd_arcface_facerecognition_tpu_torch.train import (
        SCRFDLossConfig, SCRFDTrainer)

    return SCRFDTrainer(model=build_scrfd(variant),
                        loss_cfg=SCRFDLossConfig(input_size=(size, size)),
                        device=device, **kw)


def det_run(torch, trainer, parts, batch, steps):
    """``steps`` updates from ``parts`` on one batch: each state's parts
    (on the CPU), the losses and n_pos."""
    from scrfd_arcface_facerecognition_tpu_torch.train import state_parts

    state = trainer.state_from(parts)
    batch = [t.to(trainer.device) for t in batch]
    states, losses, n_pos = [], [], []
    for _ in range(steps):
        state, loss, m = trainer.train_step(state, *batch)
        states.append(state_parts(state))
        losses.append(float(loss))
        n_pos.append(int(m["n_pos"]))
    return states, losses, n_pos


def phase_det_card_vs_cpu(torch, rep):
    """19a: ``TRAIN_DET["cmp"]`` on the card and on the CPU from one seeded
    state: the first step's loss at float32 (TF32 off), then one and three
    steps in float64, every tensor held to ``TOL_TRAIN["double"]``, the
    losses to ``TOL_TRAIN["loss64"]``; the ATSS assignment and n_pos
    equal."""
    from scrfd_arcface_facerecognition_tpu_torch.train import (
        SCRFDLossConfig, atss_assign, state_parts)
    from scrfd_arcface_facerecognition_tpu_torch.train.scrfd_train import (
        _anchor_boxes)

    c = TRAIN_DET["cmp"]
    batch = det_batch(torch, np.random.default_rng(190), c)
    centers, aboxes, levels = _anchor_boxes(SCRFDLossConfig(
        input_size=(c["size"], c["size"])))
    for dtype in (torch.float32, torch.float64):
        args = (batch[1].to(dtype), batch[3], torch.from_numpy(centers).to(
            dtype), torch.from_numpy(aboxes).to(dtype), levels)
        want = atss_assign(*args)[0]
        got = atss_assign(*[a.to(DEV) if hasattr(a, "to") else a
                            for a in args])[0].cpu()
        if not torch.equal(got, want):
            fail(f"det train card vs CPU: the ATSS assignment differs at "
                 f"{int((got != want).sum())} anchors ({dtype})")
    n_assigned = int((want >= 0).sum())
    runs = {}
    t0 = time.perf_counter()
    for dtype, steps in ((torch.float32, 1), (torch.float64, c["steps"])):
        cpu = det_trainer(torch, c["det"], c["size"], "cpu", dtype=dtype)
        card = det_trainer(torch, c["det"], c["size"], DEV, dtype=dtype)
        parts = state_parts(cpu.init_state(0))
        b = tuple(t.to(dtype) if t.is_floating_point() else t for t in batch)
        runs[dtype] = (det_run(torch, card, parts, b, steps),
                       det_run(torch, cpu, parts, b, steps))
    t_run = time.perf_counter() - t0
    (_, got32, np32), (_, want32, wnp32) = runs[torch.float32]
    rel32 = abs(got32[0] - want32[0]) / abs(want32[0])
    if rel32 > TOL_TRAIN["loss"] or np32 != wnp32:
        fail(f"det train card vs CPU, float32: step-1 loss {got32[0]!r} "
             f"against {want32[0]!r} ({rel32:.3g} relative), n_pos "
             f"{np32} against {wnp32}")
    (got, got_loss, gnp), (want, want_loss, wnp) = runs[torch.float64]
    rel64 = max(abs(g - w) / abs(w) for g, w in zip(got_loss, want_loss))
    if rel64 > TOL_TRAIN["loss64"] or gnp != wnp:
        fail(f"det train card vs CPU, float64: losses {got_loss} against "
             f"{want_loss}, n_pos {gnp} against {wnp}")
    gaps = [worst_gaps(got[i], want[i], f"det train card vs CPU, float64, "
                       f"step {i + 1}") for i in (0, c["steps"] - 1)]
    atol, rtol = TOL_TRAIN["double"]
    worst = max(s for g in gaps for s, _ in g.values())
    rep.say(f"det train card vs CPU ({c['det']} full width, "
            f"{c['size']}x{c['size']}, batch {c['batch']}, max_gt "
            f"{c['max_gt']}): ATSS assignment equal on both devices in "
            f"float32 and float64 ({n_assigned} positive anchors); float32 "
            f"(TF32 off) step-1 loss card {got32[0]:.7f} CPU "
            f"{want32[0]:.7f} ({rel32:.3g} relative, tolerance "
            f"{TOL_TRAIN['loss']}); float64 losses within {rel64:.3g} "
            f"relative over {c['steps']} steps (tolerance "
            f"{TOL_TRAIN['loss64']}), n_pos equal {gnp}; the worst tensor's "
            f"share of {atol} + {rtol} x max after 1 step: "
            f"{said_gaps(gaps[0])}; after {c['steps']}: {said_gaps(gaps[1])}"
            f"; worst {worst:.3g}; both devices' steps {t_run:.1f} s")
    return dict(loss32=(got32[0], want32[0]), rel64=rel64, gaps=gaps,
                worst=worst, n_pos=gnp)


def span_times(torch, fn):
    """fn() under torch.profiler: for each of the trainer's ``DET_SPANS``
    the device ms of the kernels launched inside it from the host thread
    that opened it, and all the device events' ms. The backward's kernels
    run on autograd's device thread, outside the span's children: they are
    the total less the other spans. None on the CPU."""
    if DEV != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    from scrfd_arcface_facerecognition_tpu_torch import stages

    torch.cuda.synchronize()
    stages.enable()                 # the spans open their profiler ranges
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        stages.disable()
    events = prof.events()
    spans = {n: 0.0 for n in DET_SPANS}
    for e in events:
        if e.name in spans and e.device_type != \
                torch.autograd.DeviceType.CUDA:
            spans[e.name] += e.device_time_total / 1e3
    total = sum((e.time_range.end - e.time_range.start) / 1e3
                for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.name not in spans
                and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith("Command Buffer"))
    spans["scrfd_train.backward"] = total - sum(
        v for k, v in spans.items() if k != "scrfd_train.backward")
    return dict(spans=spans, total=total)


def phase_det_full(torch, rep):
    """19b: ``TRAIN_DET["full"]`` (det_10g at tools.train_scrfd's defaults)
    on the card: ms a step, images a second, peak device memory, every loss
    finite and n_pos > 0; one step under torch.profiler: the device's busy
    share, its longest events, and the device time of the network's
    forward against the assignment and loss (the trainer's spans)."""
    c = TRAIN_DET["full"]
    trainer = det_trainer(torch, c["det"], c["size"], DEV)
    state = trainer.init_state(0)
    rng = np.random.default_rng(191)
    t0 = time.perf_counter()
    batches = [[t.to(DEV) for t in det_batch(torch, rng, c)]
               for _ in range(c["warm"] + c["timed"])]
    t_data = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, n_pos = [], []
    for b in batches[:c["warm"]]:
        state, loss, m = trainer.train_step(state, *b)
        losses.append(loss)
        n_pos.append(m["n_pos"])
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for b in batches[c["warm"]:]:
        state, loss, m = trainer.train_step(state, *b)
        losses.append(loss)
        n_pos.append(m["n_pos"])
    e.record()
    e.synchronize()
    ms = s.elapsed_time(e) / c["timed"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    n_pos = [int(v) for v in n_pos]
    if not all(np.isfinite(losses)) or min(n_pos) <= 0:
        fail(f"det train {c['det']}: losses {losses}, n_pos {n_pos}")
    rep.say(f"det train {c['det']} full width, {c['size']}x{c['size']}, "
            f"batch {c['batch']}, max_gt {c['max_gt']} (tools.train_scrfd's "
            f"defaults), f32 (TF32 convs, PyTorch's default): {ms:.3f} ms a "
            f"step (CUDA events, mean of {c['timed']} after {c['warm']}; a "
            f"fresh synthetic_detection_batch a step), "
            f"{c['batch'] * 1e3 / ms:.1f} images a second, peak device "
            f"memory {peak:.2f} GiB; losses {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, n_pos {min(n_pos)}-{max(n_pos)}; the "
            f"batches made on the host in {t_data:.1f} s")
    b = batches[0]
    busy = device_busy(torch, lambda: trainer.train_step(state, *b))
    rep.say(f"det train {c['det']}: one step under torch.profiler: "
            + busy_said(busy))
    spans = span_times(torch, lambda: trainer.train_step(state, *b))
    if spans is None:
        rep.say(f"det train {c['det']}: the spans' device time not "
                f"measured (no card)")
    else:
        sp = spans["spans"]
        rep.say(f"det train {c['det']}: device ms of one step's kernels by "
                f"the trainer's span, of {spans['total']:.3f} ms: "
                + ", ".join(f"{k.split('.')[1]} {v:.3f}"
                            for k, v in sp.items())
                + " (backward: the kernels outside the other spans, run on "
                "autograd's thread)")
    return dict(ms=ms, ips=c["batch"] * 1e3 / ms, peak=peak, losses=losses,
                n_pos=n_pos, busy=busy, spans=spans)


def phase_det_learns(torch, rep):
    """19c: ``TRAIN_DET["learn"]`` memorizes one fixed batch: the last
    loss below the first, n_pos > 0."""
    c = TRAIN_DET["learn"]
    trainer = det_trainer(torch, c["det"], c["size"], DEV,
                          learning_rate=c["lr"])
    state = trainer.init_state(0)
    batch = [t.to(DEV) for t in det_batch(torch, np.random.default_rng(192),
                                          c)]
    losses, n_pos = [], []
    for _ in range(c["steps"]):
        state, loss, m = trainer.train_step(state, *batch)
        losses.append(loss)
        n_pos.append(m["n_pos"])
    losses = [float(v) for v in losses]
    n_pos = [int(v) for v in n_pos]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and min(n_pos) > 0):
        fail(f"det train {c['det']} did not learn one fixed batch: "
             f"{losses}, n_pos {n_pos}")
    rep.say(f"det train {c['det']}: one fixed batch of {c['batch']} at "
            f"{c['size']}x{c['size']}, lr {c['lr']}, {c['steps']} steps: "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (min "
            f"{min(losses):.4f}), n_pos {n_pos[0]}")
    return losses


def det_faces(i):
    """Image ``i`` of phase 19d's labelled set: its (h, w) and its faces:
    boxes (x1, y1, w, h), five landmarks each and their flags (the odd
    faces' landmarks unlabeled, flag -1, as WIDER marks them)."""
    rng = np.random.default_rng(1900 + i)
    # small photos: the data path letterboxes on the host with
    # np.einsum, as the JAX package does (seconds for a 640 x 480 photo)
    h, w = ((120, 160), (180, 320), (160, 120), (150, 200))[i % 4]
    faces = []
    for j in range(int(rng.integers(1, 5))):
        side = float(rng.uniform(0.12, 0.35) * min(h, w))
        x1 = float(rng.uniform(0, w - side))
        y1 = float(rng.uniform(0, h - side))
        rel = np.asarray([[0.3, 0.4], [0.7, 0.4], [0.5, 0.6], [0.35, 0.8],
                          [0.65, 0.8]])
        pts = np.stack([x1 + rel[:, 0] * side, y1 + rel[:, 1] * side], 1)
        flag = -1.0 if j % 2 else 0.0
        faces.append(((x1, y1, side, side), pts, flag))
    return (h, w), faces


def det_label_file(path, n):
    """A retinaface ``label.txt`` of phase 19d's ``n`` images."""
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"# img_{i:02d}.jpg\n")
            for (x, y, w, h), pts, flag in det_faces(i)[1]:
                lm = " ".join(f"{-1.0 if flag < 0 else px:.2f} "
                              f"{-1.0 if flag < 0 else py:.2f} {flag:.1f}"
                              for px, py in pts)
                f.write(f"{x:.2f} {y:.2f} {w:.2f} {h:.2f} {lm} 0.5\n")


def det_image(path):
    """The injected image loader of phase 19d (the card's machine has no
    cv2): a smooth seeded BGR u8 image with each labelled face drawn as a
    skin-toned square with darker eyes and mouth."""
    i = int(os.path.basename(path)[4:6])
    (h, w), faces = det_faces(i)
    rng = np.random.default_rng(2900 + i)
    small = rng.uniform(40, 215, (h // 16 + 2, w // 16 + 2, 3))
    ys = np.linspace(0, small.shape[0] - 1.001, h)
    xs = np.linspace(0, small.shape[1] - 1.001, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    img = ((1 - fy) * ((1 - fx) * small[y0][:, x0] + fx * small[y0][:, x0 + 1])
           + fy * ((1 - fx) * small[y0 + 1][:, x0]
                   + fx * small[y0 + 1][:, x0 + 1]))
    for (x, y, s, _), pts, _ in faces:
        img[int(y):int(y + s), int(x):int(x + s)] = (120, 160, 210)
        for px, py in pts:
            r = max(2, int(s * 0.05))
            img[int(py) - r:int(py) + r, int(px) - r:int(px) + r] = (60, 70,
                                                                     90)
    return img.clip(0, 255).astype(np.uint8)


def trained_heads(torch, det, frames, tight=True):
    """The detector's raw head outputs on the pipeline's canvas of
    ``frames`` (f32, TF32 off), and the canvas's letterbox plan."""
    from scrfd_arcface_facerecognition_tpu_torch import ops

    plan = det.plan(tuple(frames.shape[1:3]), tight=tight)
    with torch.inference_mode(), full_f32(torch):
        heads = det.model(ops.normalize_image(
            ops.letterbox(frames, plan), ops.SCRFD_MEAN,
            ops.SCRFD_STD).permute(0, 3, 1, 2).contiguous())
    return heads, plan


def conf_below_top(torch, heads, lo, hi):
    """A score threshold between the ``lo``-th and ``hi``-th highest
    anchor scores of the batch, at the middle of the widest gap there (a
    barely trained detector scores near its prior everywhere, and a fixed
    threshold would pass no face or every anchor)."""
    s = torch.cat([x[..., 0].float().cpu() for x in heads["scores"]],
                  dim=1).reshape(-1)
    top = torch.sort(s, descending=True).values[:hi + 1].numpy()
    gaps = top[lo - 1:hi] - top[lo:hi + 1]
    r = int(np.argmax(gaps)) + lo
    return float((top[r - 1] + top[r]) / 2), float(top[0]), float(top[hi])


def sorted_corners(torch, o):
    """A PipelineOutput with each box's corners sorted (x1 <= x2, y1 <=
    y2): a barely trained detector predicts many boxes inside out, whose
    IoU with their own twin would read 0 when the faces are paired."""
    b = o.boxes
    return o._replace(boxes=torch.cat([torch.minimum(b[..., :2], b[..., 2:]),
                                       torch.maximum(b[..., :2], b[..., 2:])],
                                      dim=-1))


def phase_det_loop(torch, rep):
    """19d: a labelled set (``det_label_file`` + ``det_image``) parsed and
    batched, det_500m trained on it and checkpointed, AP with the same
    loader, ``tools.train_scrfd --synthetic`` and ``tools.export_onnx
    --verify`` in child processes, the exported file's preflight and
    weights; then ``FacePipeline(det_onnx=)`` and ``FacePipeline(detector=
    Detector(variables=checkpoint))`` with phase 11's w600k_r50 stand-in on
    8 seeded 1080p frames at f32, faces held to the f32 budget, K1 counted
    and held to its plain version."""
    import shutil

    from scrfd_arcface_facerecognition_tpu_torch import FacePipeline, ops
    from scrfd_arcface_facerecognition_tpu_torch.models import (
        load_inference_variables, preflight_graph)
    from scrfd_arcface_facerecognition_tpu_torch.models.config_from_graph import (
        variables_from_onnx)
    from scrfd_arcface_facerecognition_tpu_torch.models.weights import _leaves
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import Detector
    from scrfd_arcface_facerecognition_tpu_torch.train import (
        batches_from_annotations, evaluate_detector, parse_wider_annotations)

    c = TRAIN_DET["loop"]
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase19")
    shutil.rmtree(out_dir, ignore_errors=True)
    data = os.path.join(out_dir, "data")
    os.makedirs(data)
    label = os.path.join(data, "label.txt")
    det_label_file(label, c["images"])
    size = (c["size"], c["size"])
    t0 = time.perf_counter()
    anns = parse_wider_annotations(label)
    n_faces = sum(len(a.boxes) for a in anns)
    unlabeled = sum(int((~a.kps_valid).sum()) for a in anns)
    if len(anns) != c["images"] or not 0 < unlabeled < n_faces:
        fail(f"det loop: {len(anns)} images parsed, {n_faces} faces, "
             f"{unlabeled} without landmarks")
    trainer = det_trainer(torch, c["det"], c["size"], DEV,
                          learning_rate=c["lr"])
    state = trainer.init_state(0)
    # one shuffled pass, letterboxed once (on the host, in numpy), then
    # trained over ``passes`` times
    batches = list(batches_from_annotations(
        anns, c["batch"], size, c["max_gt"], image_loader=det_image))
    t_data = time.perf_counter() - t0
    losses = []
    for _ in range(c["passes"]):
        for images, boxes, kps, valid, kvalid in batches:
            nchw = torch.from_numpy(np.ascontiguousarray(
                images.transpose(0, 3, 1, 2)))
            state, loss, _ = trainer.train_step(state, nchw, boxes, kps,
                                                valid, kvalid)
            losses.append(float(loss))
    if not all(np.isfinite(losses)):
        fail(f"det loop: a loss is not finite: {losses}")
    ckpt_dir = os.path.join(out_dir, "ckpt")
    os.makedirs(ckpt_dir)
    ckpt = os.path.join(ckpt_dir, f"step_{state.step}.pt")
    trainer.save_checkpoint(state, ckpt)
    t_train = time.perf_counter() - t0
    variables = load_inference_variables(ckpt)
    det_eval = Detector(c["det"], variables=variables, input_size=size,
                        device=DEV)
    ap = evaluate_detector(det_eval, anns, image_loader=det_image)
    if not (np.isfinite(ap["ap"]) and 0.0 <= ap["ap"] <= 1.0
            and ap["images"] == c["images"]):
        fail(f"det loop: AP {ap}")
    rep.say(f"det data -> train: {c['images']} labelled images "
            f"({n_faces} faces, {unlabeled} with unlabeled landmarks) "
            f"through parse_wider_annotations and batches_from_annotations "
            f"(an injected loader; no cv2; {len(batches)} batches "
            f"letterboxed in {t_data:.1f} s), {c['det']} at "
            f"{c['size']}x{c['size']}, batch {c['batch']}, {c['passes']} "
            f"passes = {state.step} steps in {t_train:.1f} s, losses "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; evaluate_detector AP@0.5 "
            f"{ap['ap']:.4f} over {ap['images']} images (conf 0.02)")

    t1 = time.perf_counter()
    lines = run_cli(torch, "scrfd_arcface_facerecognition_tpu_torch.tools."
                    "train_scrfd", [
                        "--synthetic", str(c["cli_steps"]), "--variant",
                        c["det"], "--batch", str(c["batch"]),
                        "--input-size", str(c["size"]), "--device", DEV,
                        "--out", os.path.join(out_dir, "cli")])
    cli_ckpt = said_after(lines, "saved ")
    if set(load_inference_variables(cli_ckpt)) != {"params", "batch_stats"}:
        fail(f"tools.train_scrfd's checkpoint {cli_ckpt} holds no variables")
    t_cli = time.perf_counter() - t1
    onnx = os.path.join(out_dir, f"{c['det']}.onnx")
    lines = run_cli(torch, "scrfd_arcface_facerecognition_tpu_torch.tools."
                    "export_onnx", ["--variant", c["det"], "--checkpoint",
                                    ckpt, "--out", onnx, "--verify",
                                    "--device", DEV])
    verify = float(said_after(lines, "worst relative |module - onnx| = "))
    t_export = time.perf_counter() - t1 - t_cli
    info = preflight_graph(onnx, "det")
    want = dict(_leaves(variables))
    cfg, tree = variables_from_onnx(onnx, name=c["det"])
    got = dict(_leaves(tree))
    if got.keys() != want.keys():
        fail(f"the exported detector's tree has other leaves than the "
             f"checkpoint's: {sorted(set(got) ^ set(want))[:5]}")
    unequal = [k for k in want if not np.array_equal(got[k], want[k])]
    if unequal:
        fail(f"the exported detector's weights differ from the "
             f"checkpoint's at {unequal[:5]}")
    rep.say(f"det train -> export: tools.train_scrfd --synthetic "
            f"{c['cli_steps']} --variant {c['det']} --batch {c['batch']} in "
            f"{t_cli:.1f} s (child process, start-up included) -> "
            f"{os.path.basename(cli_ckpt)}; tools.export_onnx --verify of "
            f"the trained checkpoint in {t_export:.1f} s, worst relative "
            f"|module - onnx| {verify:.2e}; preflight passes "
            f"({info['family']}, {info['n_nodes']} nodes); "
            f"variables_from_onnx reads back {len(want)} leaves bit-equal "
            f"to load_inference_variables(checkpoint) ({cfg.name})")

    s = STANDIN
    rec = standin_onnx(torch, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build",
        "standins"))["w600k_r50"]
    rng = np.random.default_rng(193)
    nb, (h, w) = c["frames"], c["hw"]
    frames = synthetic_frames(torch, rng, nb, h, w)
    native = Detector(c["det"], variables=variables, input_size=size,
                      pre_nms=s["pre_nms"], max_det=s["max_det"],
                      device=DEV)
    heads, plan = trained_heads(torch, native, frames)
    conf, top, floor = conf_below_top(torch, heads, *c["conf_ranks"])
    native.conf_thres = conf
    pipes = {"native": FacePipeline(detector=native, rec_onnx=rec,
                                    gallery_capacity=s["gallery"],
                                    device=DEV),
             "onnx": FacePipeline(det_onnx=onnx, rec_onnx=rec,
                                  conf_thres=conf, pre_nms=s["pre_nms"],
                                  max_det=s["max_det"],
                                  gallery_capacity=s["gallery"],
                                  device=DEV)}
    gallery = rng.normal(size=(s["gallery"], 512)).astype(np.float32)
    for p in pipes.values():
        p.set_gallery(gallery, [f"p{i}" for i in range(s["gallery"])])
    with full_f32(torch):
        for p in pipes.values():
            p(frames)                                      # warm-up
        torch.cuda.synchronize()
        wa.launches = 0
        with k1_capture() as calls:
            # max_num 0: a barely trained detector's boxes come out near
            # one size, so the max_num selection by area would tie
            outs = {k: [p(frames) for _ in range(c["calls"])]
                    for k, p in pipes.items()}
            torch.cuda.synchronize()
    launches = wa.launches
    ref, out = (sorted_corners(torch, outs[k][-1]) for k in ("native",
                                                            "onnx"))
    full_slate = ref.valid.all(dim=1)
    last = ref.scores[:, -1]
    cuts = [(float(sc),) + ((float(last[f]),) if full_slate[f] else ())
            for f, sc in enumerate(slate_cuts(torch, ops, heads,
                                              s["pre_nms"]))]
    share, npairs, lone = hold_f32_faces(
        torch, ref, out, conf=conf, cuts=cuts, iou_thres=native.iou_thres,
        sim=pipes["native"].similarity_thresh,
        where="det train -> serve, the exported file vs the checkpoint")
    faces = int(out.valid.sum())
    if launches == 0 or faces == 0:
        fail(f"det train -> serve: K1 warped no crop ({launches} launches, "
             f"{faces} faces)")
    err, summary = k1_on_path(torch, wa, calls)
    if err > TOL_U8:
        fail(f"det train -> serve: K1 vs plain {err} u8 on the path's "
             f"inputs")
    rep.say(f"det train -> serve: the trained {c['det']} on {nb} seeded "
            f"{h}x{w} frames at f32 (TF32 off), max_num 0, conf {conf:.6f} "
            f"(its top "
            f"anchor score {top:.6f}, the {c['conf_ranks'][1]}th "
            f"{floor:.6f}), with phase 11's w600k_r50 stand-in: "
            f"FacePipeline(det_onnx=exported) {faces} faces, "
            f"FacePipeline(detector=Detector(variables=checkpoint)) "
            f"{int(ref.valid.sum())}; paired by IoU >= 0.9 {npairs}, on one "
            f"side only (ties) {lone}; shares of the f32 budget: boxes / kps "
            f"{share['px']:.4f}, scores {share['score']:.4f}, 1 - cosine "
            f"{share['cos']:.4f}, match_sim {share['sim']:.4f}; K1 launches "
            f"{launches} over {c['calls']} calls of each; K1 vs plain on "
            f"{summary}: {err:.6g} u8")
    return dict(launches=launches, err=err, ap=ap["ap"], faces=faces,
                share=share, verify=verify)


def phase_det_train(torch, rep):
    """19: (a) card vs CPU with TF32 off, (b) det_10g at the CLI's
    defaults, (c) it learns, (d) data -> train -> checkpoint -> AP ->
    export -> serve."""
    t0 = time.perf_counter()
    with full_f32(torch):
        cmp = phase_det_card_vs_cpu(torch, rep)
    t1 = time.perf_counter()
    full = phase_det_full(torch, rep)
    learn = phase_det_learns(torch, rep)
    t2 = time.perf_counter()
    loop = phase_det_loop(torch, rep)
    rep.say(f"phase 19 took {time.perf_counter() - t0:.1f} s: (a) "
            f"{t1 - t0:.1f}, (b)-(c) {t2 - t1:.1f}, (d) "
            f"{time.perf_counter() - t2:.1f}")
    return dict(cmp=cmp, full=full, learn=learn, **loop)


# ---------------------------------------------------------------------
# phase 20: multi-device serving
#
# One process drives every slot of a mesh (parallel/). With two or more
# cards the slots are the cards; with one, four slots share cuda:0, so the
# sharded paths run and are checked but their times are no scaling figure.


def parallel_slots(torch):
    """(slots, label): the CUDA cards (a power of two of them, at most 8)
    when there are two or more, else PAR["slots"] slots of one card."""
    from scrfd_arcface_facerecognition_tpu_torch import parallel

    n = torch.cuda.device_count()
    if n >= 2:
        use = 1 << (min(n, 8).bit_length() - 1)
        return (parallel.card_slots()[:use],
                f"{use} cards, one slot each")
    return (parallel.device_slots(DEV, PAR["slots"]),
            f"{PAR['slots']} slots on one card — not a scaling figure")


def hold_sharded(torch, got, want, what):
    """A sharded call against the unsharded one at f32 with TF32 off:
    valid, count and match_idx equal; boxes and kps within 1e-2 frame px,
    scores and match_sim within 1e-4 (phase 5's budget); embeddings within
    1e-4 (the JAX package's own DP test's bound). -> the largest gaps."""
    g = [t.cpu() for t in got]
    w = [t.cpu() for t in want]
    names = got._fields
    for name in ("valid", "count", "match_idx"):
        i = names.index(name)
        if not torch.equal(g[i], w[i]):
            fail(f"{what}: {name} differs from the unsharded call")
    gaps = {name: float((g[names.index(name)].float()
                         - w[names.index(name)].float()).abs().max())
            if g[names.index(name)].numel() else 0.0
            for name in ("boxes", "kps", "scores", "match_sim",
                         "embeddings")}
    budget = dict(boxes=1e-2, kps=1e-2, scores=1e-4, match_sim=1e-4,
                  embeddings=1e-4)
    over = {k: v for k, v in gaps.items() if not v <= budget[k]}
    if over:
        fail(f"{what}: out of tolerance against the unsharded call: {over}")
    return gaps


def phase_dense_sharded(torch, rep, slots, label):
    """20a: a dense ShardedGallery of PAR["dense"] rows against the
    single-device cosine top-k on the same normalized rows."""
    from scrfd_arcface_facerecognition_tpu_torch import parallel
    from scrfd_arcface_facerecognition_tpu_torch.ops import (
        l2_normalize, stable_top_k)

    rows, nq, k = PAR["dense"]
    gen = torch.Generator(device=DEV).manual_seed(20)
    mat = torch.randn((rows, 512), generator=gen, device=DEV)
    q = torch.randn((nq, 512), generator=gen, device=DEV)
    mesh = parallel.make_mesh((len(slots),), ("model",), devices=slots)
    sync_all(torch)
    t = time.perf_counter()
    sg = parallel.ShardedGallery(mat, mesh, axis="model")
    sync_all(torch)
    place_ms = (time.perf_counter() - t) * 1e3
    del mat
    flat = l2_normalize(torch.cat([r.to(DEV) for r in sg._rows.rows]))
    qn = l2_normalize(q)

    def single():
        s, i = stable_top_k(qn @ flat.T, k)
        return s.cpu().numpy(), i.cpu().numpy()

    shard_ms, _, (ss, si) = median_ms(torch, lambda: sg.search(q, k=k))
    flat_ms, _, (fs, fi) = median_ms(torch, single)
    if not np.array_equal(si, fi):
        fail(f"dense sharded: ids differ in {int((si != fi).sum())} places")
    gap = float(np.abs(ss - fs).max())
    if not gap <= 1e-5:
        fail(f"dense sharded: scores {gap} apart > 1e-5")
    rep.say(f"20a dense ShardedGallery ({label}): {rows} x 512 f32 rows "
            f"({rows * 512 * 4 / 1e9:.2f} GB) over {len(slots)} shards, "
            f"normalized and placed in {place_ms:.1f} ms; Q={nq}, k={k}: "
            f"ids equal to the single-device top-k, scores at most {gap:.3g} apart "
            f"({int((ss != fs).sum())} of {ss.size} not bit-equal); "
            f"search median {shard_ms:.2f} ms sharded, {flat_ms:.2f} ms "
            f"single-device (TF32 off)")
    del sg, flat
    return dict(ms=shard_ms, single_ms=flat_ms)


def phase_pq_sharded(torch, rep, slots, label, flat, queries, cpu_rows,
                     cpu_ids):
    """20b: phase 7's codec and rows in a PQGallery(mesh=) against phase
    7's unsharded PQGallery; then AutoGallery(tier="pq", mesh=) through a
    migration and snapshots between meshed and unmeshed."""
    import tempfile
    from scrfd_arcface_facerecognition_tpu_torch import parallel
    from scrfd_arcface_facerecognition_tpu_torch.gallery import (
        AutoGallery, PQGallery, pq_adc)

    k = PAR["k"]
    mesh = parallel.make_mesh((len(slots),), ("model",), devices=slots)
    n = len(flat)
    ids = flat._ids[:n]
    t = time.perf_counter()
    meshed = PQGallery(flat.codec, capacity=PAR["pq_capacity"],
                       keep_exact=True, device=DEV, mesh=mesh)
    meshed.add(ids, flat._exact[:n])
    sync_all(torch)
    fill_s = time.perf_counter() - t
    if meshed.capacity != flat.capacity or not torch.equal(
            meshed._codes, flat._codes):
        fail("sharded PQ: the meshed gallery's codes differ from phase 7's")
    out, launches, errs = {}, 0, []
    for name, kw in (("hilo", dict(k=k)), ("hi", dict(k=k, rerank=32))):
        k2_reset(pq_adc)
        s, i = meshed.search(queries, **kw)
        sync_all(torch)
        got = k2_count(pq_adc)
        if got != len(slots):
            fail(f"sharded PQ ({name}): K2 launched {got} times, not once "
                 f"for each of the {len(slots)} shards")
        launches += got
        fs, fi = flat.search(queries, **kw)
        if not (np.array_equal(i, fi) and np.array_equal(s, fs)):
            fail(f"sharded PQ ({name}): not bit-equal to the unsharded "
                 f"search (ids differ in {int((i != fi).sum())} places, "
                 f"scores {float(np.abs(s - fs).max())} apart)")
        shard_ms = median_ms(torch, lambda: meshed.search(queries, **kw))[0]
        flat_ms = median_ms(torch, lambda: flat.search(queries, **kw))[0]
        out[name] = (shard_ms, flat_ms)
    # K2 against its plain version on the first shard's inputs, the fused
    # top-k against both chains on the last shard's (its rows offset)
    lut = meshed.codec.lut(queries)
    shard0 = meshed._shards.rows[0]
    for precision in pq_adc.PRECISIONS:
        errs.append(compare_k2(torch, pq_adc, lut, shard0, precision)[0])
        last = len(slots) - 1
        rows, valid = meshed._shards.rows[last], meshed._shards.valid[last]
        compare_topk(torch, pq_adc, "sharded PQ", lut.to(rows.device), rows,
                     valid, 32, precision, last * meshed._shards.per)
    rep.say(f"20b sharded PQ ({label}): phase 7's codec and {n} rows in a "
            f"{meshed.capacity}-row PQGallery(mesh=) over {len(slots)} "
            f"shards (filled in {fill_s:.2f} s, codes equal to phase 7's); "
            f"{len(queries)} queries, k={k}: K2 launched once a shard a "
            f"search, ids and scores bit-equal to the unsharded gallery in "
            f"'hilo' (no rerank) and 'hi' (rerank 32); search median ms "
            f"sharded / unsharded: " + ", ".join(
                f"{p} {a:.2f} / {b:.2f}" for p, (a, b) in out.items())
            + f"; K2 vs plain on shard 0 ({shard0.shape[0]} rows) max abs "
            f"err {max(errs):.3g}; the fused top-k bit-equal to the plain "
            f"chain and to K2 + mask + sort on the last shard")
    del meshed

    ag = AutoGallery(vector_size=flat.codec.dim, tier="pq", mesh=mesh,
                     min_train_rows=PAR["auto_min_rows"], device=DEV)
    k2_reset(pq_adc)
    ag.add_batch(cpu_ids, cpu_rows)
    if ag.tier != "pq" or len(ag._pq._shards.rows) != len(slots):
        fail("AutoGallery(mesh=): the PQ tier is not sharded over the mesh")
    want = ag.search_batch(queries, k=k)
    launches += k2_count(pq_adc)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        path = os.path.join(d, "meshed.npz")
        ag.snapshot(path)
        plain = AutoGallery.restore(path, vector_size=flat.codec.dim,
                                    tier="pq", device=DEV)
        path2 = os.path.join(d, "plain.npz")
        plain.snapshot(path2)
        back = AutoGallery.restore(path2, vector_size=flat.codec.dim,
                                   tier="pq", mesh=mesh, device=DEV)
    k2_reset(pq_adc)
    for g, what in ((plain, "restored unmeshed"), (back, "restored onto "
                                                   "the mesh")):
        hits = g.search_batch(queries, k=k)
        if [[(h.id, h.score) for h in x] for x in hits] != [
                [(h.id, h.score) for h in x] for x in want]:
            fail(f"AutoGallery(mesh=): the snapshot {what} searches "
                 f"differently")
    launches += k2_count(pq_adc)
    rep.say(f"20b AutoGallery(tier='pq', mesh=) over {len(cpu_ids)} rows: "
            f"migrated to a PQ tier of {len(slots)} shards; its snapshot "
            f"restored unmeshed and that one's back onto the mesh give "
            f"the same hits (ids and scores equal)")
    return dict(launches=launches, err=max(errs), ms=out)


def phase_dp(torch, rep, slots, label):
    """20c: frame DP at phase 4's width against one unsharded call, f32
    with TF32 off; K1 counted and held to its plain version."""
    from scrfd_arcface_facerecognition_tpu_torch import FacePipeline, ops
    from scrfd_arcface_facerecognition_tpu_torch import parallel
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    c = PAR["dp"]
    nb, (h, w), max_num, ng = c["frames"], c["hw"], c["max_num"], c["gallery"]
    pipe = FacePipeline(det_variant=MAIN["det"], rec_variant=MAIN["rec"],
                        gallery_capacity=ng, seed=0, device=DEV)
    rng = np.random.default_rng(20)
    frames = torch.from_numpy(rng.integers(0, 255, (nb, h, w, 3),
                                           dtype=np.uint8)).to(DEV)
    first = pipe(frames, max_num=max_num)
    gal = np.concatenate([
        rng.normal(size=(ng - 4, 512)).astype(np.float32),
        first.embeddings[first.valid].cpu().numpy()[:4]])
    pipe.set_gallery(gal, [f"p{i}" for i in range(len(gal))])
    mesh = parallel.make_mesh((len(slots),), devices=slots)
    sharded = parallel.shard_frames(frames, mesh)
    want = pipe(frames, max_num=max_num)
    pipe(sharded, max_num=max_num)                 # the replicas, warm-up
    sync_all(torch)
    wa.launches = 0
    with captured_calls(ops, "warp_align_crops") as calls:
        got = pipe(sharded, max_num=max_num)
        sync_all(torch)
    launches = wa.launches
    if launches == 0:
        fail("frame DP: K1 was launched no time")
    gaps = hold_sharded(torch, got, want, "frame DP")
    check_output(torch, got, nb, max_num, "frame DP")
    err, said = k1_on_path(torch, wa, calls)
    shard_ms = median_ms(torch, lambda: pipe(sharded, max_num=max_num),
                         n=3)[0]
    flat_ms = median_ms(torch, lambda: pipe(frames, max_num=max_num), n=3)[0]
    rep.say(f"20c frame DP ({label}): {MAIN['det']} + {MAIN['rec']} seeded, "
            f"{nb}x{h}x{w} frames split {len(slots)} ways, gallery {ng}, "
            f"max_num {max_num}, f32 TF32 off: {int(got.valid.sum())} faces, "
            f"{int((got.match_idx >= 0).sum())} matches; valid, count and "
            f"match_idx equal to one unsharded call, max |d| " + ", ".join(
                f"{k} {v:.3g}" for k, v in gaps.items())
            + f"; K1 launches {launches} (one a slot with faces), vs plain "
            f"on {said} max abs err {err:.3g} u8; ms a call sharded "
            f"{shard_ms:.2f}, unsharded {flat_ms:.2f}")
    return pipe, dict(launches=launches, err=err, ms=shard_ms,
                      single_ms=flat_ms)


def phase_disagg(torch, rep, slots, label, pipe):
    """20d: DisaggPipeline over half the slots each way, the gallery
    sharded and "auto", process_stream(depth=2) against the pipeline; K1
    counted; on one card ``realtime --disagg 1`` raises the JAX app's
    message."""
    from scrfd_arcface_facerecognition_tpu_torch import ops, parallel
    from scrfd_arcface_facerecognition_tpu_torch.apps import realtime
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.parallel import (
        sharded_gallery)

    c, d = PAR["dp"], PAR["disagg"]
    rng = np.random.default_rng(21)
    batches = [rng.integers(0, 255, (c["frames"], *c["hw"], 3),
                            dtype=np.uint8) for _ in range(d["batches"])]
    det_g, emb_g = parallel.split_devices(devices=slots)
    launches, errs, times = 0, [], {}
    wants = [pipe(b, max_num=c["max_num"]) for b in batches]
    for shard in (True, "auto"):
        server = parallel.DisaggPipeline(pipe, det_g, emb_g,
                                         shard_gallery=shard)
        list(server.process_stream(batches[:1], max_num=c["max_num"]))
        sync_all(torch)
        placed = server._gallery_placed()
        if (shard is True) != isinstance(placed, sharded_gallery.RowShards):
            fail(f"disagg shard_gallery={shard}: gallery placed as "
                 f"{type(placed).__name__}")
        wa.launches = 0
        with captured_calls(ops, "warp_align_crops") as calls:
            outs = list(server.process_stream(batches, max_num=c["max_num"],
                                              depth=2))
            sync_all(torch)
        k1 = wa.launches
        if k1 == 0:
            fail(f"disagg shard_gallery={shard}: K1 was launched no time")
        launches += k1
        gaps = {}
        for i, (o, w) in enumerate(zip(outs, wants)):
            check_output(torch, o, c["frames"], c["max_num"], "disagg")
            g = hold_sharded(torch, o, w, f"disagg batch {i} "
                                          f"(shard_gallery={shard})")
            gaps = {k: max(v, gaps.get(k, 0.0)) for k, v in g.items()}
        err, said = k1_on_path(torch, wa, calls[:1])
        errs.append(err)
        times[shard] = median_ms(torch, lambda: list(server.process_stream(
            batches, max_num=c["max_num"], depth=2)), n=3)[0]
        rep.say(f"20d disagg ({label}): detect slots "
                f"{[s.id for s in det_g]}, embed slots "
                f"{[s.id for s in emb_g]}, shard_gallery={shard} "
                f"({type(placed).__name__}); process_stream(depth=2) of "
                f"{len(batches)} batches of {c['frames']} frames: each equal "
                f"to the pipeline's call (max |d| " + ", ".join(
                    f"{k} {v:.3g}" for k, v in gaps.items())
                + f"); K1 launches {k1}, vs plain on {said} max abs "
                f"err {err:.3g} u8; ms for the {len(batches)} batches "
                f"{times[shard]:.2f}")
    flat_ms = median_ms(torch, lambda: list(pipe.process_stream(
        batches, max_num=c["max_num"], depth=2)), n=3)[0]
    rep.say(f"20d the co-located FacePipeline.process_stream(depth=2) of the "
            f"same batches: {flat_ms:.2f} ms")
    if torch.cuda.device_count() < 2:
        args = realtime.parse_args(["--disagg", "1", "--det-weight",
                                    "det_500m.onnx", "--rec-weight",
                                    "w600k_mbf.onnx"])
        try:
            realtime.run(args, device=DEV)
        except ValueError as e:
            if "needs at least 2 devices" not in str(e):
                raise
            rep.say(f"20d realtime --disagg 1 on one card raises the JAX "
                    f"app's message: {e}")
        else:
            fail("realtime --disagg 1 ran on one card")
    return dict(launches=launches, err=max(errs), ms=times, flat_ms=flat_ms)


def phase_parallel(torch, rep, gal):
    """20: (a) the dense sharded gallery, (b) the sharded PQ gallery (K2 a
    shard) and AutoGallery(mesh=), (c) frame DP at full width, (d)
    disaggregation; (e) every time beside its single-device one."""
    t0 = time.perf_counter()
    slots, label = parallel_slots(torch)
    rep.say(f"phase 20 mesh: {label}: "
            + ", ".join(f"slot {s.id} on {s.device}" for s in slots))
    dense = phase_dense_sharded(torch, rep, slots, label)
    pq = phase_pq_sharded(torch, rep, slots, label, gal["pq"],
                          gal["queries"], gal["rows"], gal["ids"])
    with full_f32(torch):
        pipe, dp = phase_dp(torch, rep, slots, label)
        dis = phase_disagg(torch, rep, slots, label, pipe)
    rep.say(f"20e per-call ms, sharded / single-device ({label}): dense "
            f"search {dense['ms']:.2f} / {dense['single_ms']:.2f}; PQ "
            + ", ".join(f"{p} {a:.2f} / {b:.2f}"
                        for p, (a, b) in pq["ms"].items())
            + f"; DP call {dp['ms']:.2f} / {dp['single_ms']:.2f}; disagg "
            f"stream of {PAR['disagg']['batches']} batches "
            + ", ".join(f"shard_gallery={k} {v:.2f}"
                        for k, v in dis["ms"].items())
            + f" / {dis['flat_ms']:.2f}; phase 20 took "
            f"{time.perf_counter() - t0:.1f} s")
    return dict(k1=dp["launches"] + dis["launches"],
                err1=max(dp["err"], dis["err"]), k2=pq["launches"],
                err2=pq["err"])


# ---------------------------------------------------------------------
# phase 21: the trainers' mesh
#
# One process drives every slot (parallel/, train/): a data slot's forward
# runs in a thread of its own, the slots exchange BatchNorm's per-slot sums
# (parallel/collectives.py), one backward from the global loss. On one
# card the slots share cuda:0 (phase 20's), so the times are no scaling
# figure.


def arcface_meshes(torch, slots):
    """The ArcFace trainer's ('data', 'model') mesh over ``slots`` (2 on
    'model' where the slots allow it) and the detector's ('data',)."""
    from scrfd_arcface_facerecognition_tpu_torch import parallel

    tp = 2 if len(slots) % 2 == 0 else 1
    return (parallel.make_mesh((len(slots) // tp, tp), ("data", "model"),
                               devices=slots),
            parallel.make_mesh((len(slots),), ("data",), devices=slots))


def padded_parts(torch, parts, width, seed=21):
    """One-device ArcFace parts with seeded pad columns (their momentum
    zero) up to ``width`` classes."""
    d, c = parts["head_w"].shape
    gen = torch.Generator(device="cpu").manual_seed(seed)
    pad = torch.randn((d, width - c), generator=gen,
                      dtype=parts["head_w"].dtype) * 0.01
    out = dict(parts, trace=dict(parts["trace"]))
    out["head_w"] = torch.cat([parts["head_w"], pad], 1)
    out["trace"]["head_w"] = torch.cat(
        [parts["trace"]["head_w"], torch.zeros_like(pad)], 1)
    return out


def unpadded_parts(parts, classes):
    """A meshed ArcFace state's parts cut to its ``classes`` real
    classes."""
    out = dict(parts, trace=dict(parts["trace"]))
    out["head_w"] = parts["head_w"][:, :classes]
    out["trace"]["head_w"] = parts["trace"]["head_w"][:, :classes]
    return out


def phase_mesh_vs_one(torch, rep, arc_mesh, det_mesh, label):
    """21a: ``TRAIN_MESH["cmp"]`` in float64, the mesh against the card's
    one-device trainer from one state: every tensor within
    ``TOL_TRAIN["double"]`` after the first and the last step, the
    losses within ``TOL_TRAIN["loss64"]``, n_pos equal."""
    from scrfd_arcface_facerecognition_tpu_torch.models import build_arcface
    from scrfd_arcface_facerecognition_tpu_torch.train import (
        ArcFaceTrainer, state_parts, synthetic_detection_batch)

    c = TRAIN_MESH["cmp"]
    f64 = torch.float64
    rng = np.random.default_rng(210)
    images = torch.from_numpy(rng.normal(size=(c["batch"], 3, 112, 112))
                              ).to(DEV)
    labels = torch.from_numpy(rng.integers(0, c["classes"], c["batch"])
                              ).to(DEV)
    out, steps = {}, c["steps"]
    for rate in (1.0, c["rate"]):
        what = "full softmax" if rate == 1.0 else f"Partial FC {rate}"
        kw = dict(num_classes=c["classes"], sample_rate=rate, dtype=f64)
        one = ArcFaceTrainer(model=build_arcface(c["rec"]), device=DEV, **kw)
        meshed = ArcFaceTrainer(model=build_arcface(c["rec"]),
                                mesh=arc_mesh, **kw)
        parts = state_parts(one.init_state(0))
        t0 = time.perf_counter()
        want, want_loss = train_run(torch, one, parts, images, labels, None,
                                    steps)
        t1 = time.perf_counter()
        got, got_loss = train_run(torch, meshed, padded_parts(
            torch, parts, meshed.padded_classes), images, labels, None,
            steps)
        t2 = time.perf_counter()
        rel = max(abs(g - w) / abs(w) for g, w in zip(got_loss, want_loss))
        if rel > TOL_TRAIN["loss64"]:
            fail(f"21a ArcFace mesh vs one device, {what}: losses "
                 f"{got_loss} against {want_loss}")
        gaps = [worst_gaps(unpadded_parts(got[i], c["classes"]), want[i],
                           f"21a ArcFace mesh vs one device, {what}, step "
                           f"{i + 1}") for i in (0, steps - 1)]
        rep.say(f"21a ArcFace mesh {dict(arc_mesh.shape)} ({label}) vs the "
                f"card's one-device trainer, float64, {c['rec']} full "
                f"width, batch {c['batch']}, {c['classes']} classes (padded "
                f"to {meshed.padded_classes}), {what}: losses within "
                f"{rel:.3g} relative over {steps} steps (tolerance "
                f"{TOL_TRAIN['loss64']}); the worst tensor's share of the "
                f"bound after 1 step: {said_gaps(gaps[0])}; after {steps}: "
                f"{said_gaps(gaps[1])}; {steps} steps one device "
                f"{t1 - t0:.1f} s, mesh {t2 - t1:.1f} s")
        out[what] = dict(rel=rel, gaps=gaps)

    n = det_mesh.shape["data"]
    batch = None
    for seed in range(211, 231):
        arrays = synthetic_detection_batch(np.random.default_rng(seed), n,
                                           (c["size"], c["size"]),
                                           max_gt=c["max_gt"])
        if n == 1 or len(set(arrays[3].sum(1).tolist())) > 1:
            batch = arrays
            break
    if batch is None:
        fail("21a: no seeded batch whose images hold unequal face counts")
    faces = batch[3].sum(1).tolist()
    nchw = torch.from_numpy(batch[0]).permute(0, 3, 1, 2).contiguous()
    tensors = [nchw.double()] + [torch.from_numpy(a) for a in batch[1:]]
    tensors[1], tensors[2] = tensors[1].double(), tensors[2].double()
    one = det_trainer(torch, c["det"], c["size"], DEV, dtype=f64)
    meshed = det_trainer(torch, c["det"], c["size"], None, dtype=f64,
                         mesh=det_mesh)
    parts = state_parts(one.init_state(0))
    t0 = time.perf_counter()
    want, want_loss, want_pos = det_run(torch, one, parts, tensors,
                                        steps)
    t1 = time.perf_counter()
    got, got_loss, got_pos = det_run(torch, meshed, parts, tensors, steps)
    t2 = time.perf_counter()
    rel = max(abs(g - w) / abs(w) for g, w in zip(got_loss, want_loss))
    if rel > TOL_TRAIN["loss64"] or got_pos != want_pos:
        fail(f"21a detector mesh vs one device: losses {got_loss} against "
             f"{want_loss}, n_pos {got_pos} against {want_pos}")
    gaps = [worst_gaps(got[i], want[i], f"21a detector mesh vs one device, "
                       f"step {i + 1}") for i in (0, steps - 1)]
    rep.say(f"21a detector mesh {dict(det_mesh.shape)} ({label}) vs the "
            f"card's one-device trainer, float64, {c['det']} at "
            f"{c['size']}x{c['size']}, one image a slot holding {faces} "
            f"faces: losses within {rel:.3g} relative over {steps} steps, "
            f"n_pos equal {got_pos}; the worst tensor's share of the bound "
            f"after 1 step: {said_gaps(gaps[0])}; after {steps}: "
            f"{said_gaps(gaps[1])}; {steps} steps one device "
            f"{t1 - t0:.1f} s, mesh {t2 - t1:.1f} s")
    out["det"] = dict(rel=rel, gaps=gaps, n_pos=got_pos)
    return out


def timed_steps(torch, step, n_warm, n_timed):
    """``step(i)`` for i < n_warm + n_timed; (ms a timed step on the host's
    clock, every card synchronized around the timed steps, peak device
    memory in GiB over the cards, the steps' outputs)."""
    cards = range(max(1, torch.cuda.device_count()))
    sync_all(torch)
    torch.cuda.empty_cache()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    outs = [step(i) for i in range(n_warm)]
    sync_all(torch)
    t = time.perf_counter()
    outs += [step(n_warm + i) for i in range(n_timed)]
    sync_all(torch)
    ms = (time.perf_counter() - t) * 1e3 / n_timed
    peak = max(torch.cuda.max_memory_allocated(d) for d in cards) / 2 ** 30
    return ms, peak, outs


def host_split(torch, fn, trainer, prefix):
    """fn() (one meshed step) under the port's span recorder: the host ms
    of each of the trainer's spans (``<prefix>.forward_loss``,
    ``.backward``, ``.update``), and of the forward's barrier waits, the
    mean over the data slots, with the step's exchange count."""
    from scrfd_arcface_facerecognition_tpu_torch import stages

    sync_all(torch)
    stages.enable()
    try:
        fn()
        sync_all(torch)
    finally:
        stages.disable()
    spans = {name.split(".", 1)[1]: rec["ms"]
             for name, rec in stages.report().items()
             if name.startswith(prefix + ".")}
    group = trainer._data.last_group
    spans["barrier waits"] = 1e3 * sum(group.waited_s) / group.size
    return spans, group.exchanges


def split_said(spans, exchanges):
    return (", ".join(f"{k} {v:.1f}" for k, v in spans.items())
            + f" (host ms; {exchanges} exchanges a step)")


def phase_mesh_full(torch, rep, arc_mesh, det_mesh, label, ref_ms):
    """21b: ``TRAIN_MESH["full"]`` on the meshes: ms a step, images a
    second, peak device memory, the device's busy share over one step;
    beside this run's one-device 18b and 19b."""
    from scrfd_arcface_facerecognition_tpu_torch.models import build_arcface
    from scrfd_arcface_facerecognition_tpu_torch.train import ArcFaceTrainer

    c = TRAIN_MESH["full"]
    out = {}
    trainer = ArcFaceTrainer(model=build_arcface(c["rec"]),
                             num_classes=c["classes"], sample_rate=c["rate"],
                             mesh=arc_mesh)
    state = trainer.init_state(0)
    gen = torch.Generator(device="cpu").manual_seed(212)
    n = c["warm"] + c["timed"]
    batches = [(torch.randn((c["batch"], 3, 112, 112), generator=gen)
                .to(DEV), torch.randint(0, c["classes"], (c["batch"],),
                                        generator=gen).to(DEV))
               for _ in range(n + 1)]
    floor = math.log(trainer.num_sample) / 2

    def arc_step(i):
        nonlocal state
        state, loss = trainer.train_step(state, *batches[i])
        return loss

    ms, peak, losses = timed_steps(torch, arc_step, c["warm"], c["timed"])
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or min(losses) < floor:
        fail(f"21b ArcFace mesh: losses {losses} (each must be finite and "
             f"above ln({trainer.num_sample}) / 2 = {floor:.3f})")
    busy = device_busy(torch, lambda: arc_step(n))
    split = host_split(torch, lambda: arc_step(n), trainer, "arcface_train")
    out["arcface"] = dict(ms=ms, ips=c["batch"] * 1e3 / ms, peak=peak,
                          busy=busy, split=split)
    rep.say(f"21b ArcFace mesh {dict(arc_mesh.shape)} ({label}): "
            f"{c['rec']} full width, batch {c['batch']}, {c['classes']} "
            f"classes, Partial FC {c['rate']}, f32 (TF32 convs): {ms:.3f} ms "
            f"a step (host clock, every card synchronized, mean of "
            f"{c['timed']} after {c['warm']}), "
            f"{c['batch'] * 1e3 / ms:.1f} images a second, peak device "
            f"memory {peak:.2f} GiB; losses {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}; one step under torch.profiler: "
            + busy_said(busy) + "; one step's host time by span: "
            + split_said(*split) + f"; the one-device step of 18b in this "
            f"run {ref_ms['arcface']:.3f} ms")
    del trainer, state, batches
    trainer = det_trainer(torch, c["det"], c["size"], None, mesh=det_mesh)
    state = trainer.init_state(0)
    rng = np.random.default_rng(213)
    dc = dict(batch=c["det_batch"], size=c["size"], max_gt=c["max_gt"])
    made = [[t.to(DEV) for t in det_batch(torch, rng, dc)]
            for _ in range(c["det_batches"])]

    def det_step(i):
        nonlocal state
        state, loss, m = trainer.train_step(state, *made[i % len(made)])
        return float(loss), int(m["n_pos"])

    ms, peak, res = timed_steps(torch, det_step, c["warm"], c["timed"])
    if not all(np.isfinite(l) and p > 0 for l, p in res):
        fail(f"21b detector mesh: (loss, n_pos) {res}")
    busy = device_busy(torch, lambda: det_step(0))
    split = host_split(torch, lambda: det_step(0), trainer, "scrfd_train")
    out["det"] = dict(ms=ms, ips=c["det_batch"] * 1e3 / ms, peak=peak,
                      busy=busy, split=split)
    rep.say(f"21b detector mesh {dict(det_mesh.shape)} ({label}): "
            f"{c['det']} at {c['size']}x{c['size']}, batch {c['det_batch']}, "
            f"max_gt {c['max_gt']}, f32 (TF32 convs): {ms:.3f} ms a step "
            f"(host clock, every card synchronized, mean of {c['timed']} "
            f"after {c['warm']}; {c['det_batches']} synthetic batches in "
            f"turn), {c['det_batch'] * 1e3 / ms:.1f} images a second, peak "
            f"device memory {peak:.2f} GiB; losses {res[0][0]:.4f} -> "
            f"{res[-1][0]:.4f}; one step under torch.profiler: "
            + busy_said(busy) + "; one step's host time by span: "
            + split_said(*split) + f"; the one-device step of 19b in this "
            f"run {ref_ms['det']:.3f} ms")
    return out


def phase_mesh_serve(torch, rep, arc_mesh, label):
    """21c: ``TRAIN_MESH["serve"]``: a w600k_mbf trained on the mesh, its
    checkpoint read by ``load_inference_variables``, held to the live
    state's embeddings (``TOL_TRAIN["cos"]``), then served by two
    ``FacePipeline`` calls with phase 11's det_10g stand-in; K1 counted
    and held to its plain version."""
    import shutil

    from scrfd_arcface_facerecognition_tpu_torch import FacePipeline
    from scrfd_arcface_facerecognition_tpu_torch.models import (
        ARCFACE_CONFIGS, build_arcface, load_inference_variables)
    from scrfd_arcface_facerecognition_tpu_torch.models.weights import (
        variables_from_module)
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import Embedder
    from scrfd_arcface_facerecognition_tpu_torch.train import ArcFaceTrainer

    c = TRAIN_MESH["serve"]
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase21")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    trainer = ArcFaceTrainer(model=build_arcface(c["rec"]),
                             num_classes=c["classes"], learning_rate=0.1,
                             mesh=arc_mesh)
    state = trainer.init_state(0)
    rng = np.random.default_rng(214)
    for _ in range(c["steps"]):
        images = torch.from_numpy(rng.normal(
            size=(c["batch"], 3, 112, 112)).astype(np.float32)).to(DEV)
        labels = torch.from_numpy(rng.integers(0, c["classes"],
                                               c["batch"])).to(DEV)
        state, loss = trainer.train_step(state, images, labels)
    path = os.path.join(out_dir, f"step_{state.step}.pt")
    trainer.save_checkpoint(state, path)
    cfg = ARCFACE_CONFIGS[c["rec"]]
    served = Embedder(config=cfg, variables=load_inference_variables(path),
                      device=DEV)
    live = Embedder(config=cfg, variables=variables_from_module(
        state.backbone), device=DEV)
    crops = rng.integers(0, 255, (c["crops"], 112, 112, 3), dtype=np.uint8)
    with full_f32(torch):
        cos = torch.nn.functional.cosine_similarity(
            torch.from_numpy(served.get_feat(crops)),
            torch.from_numpy(live.get_feat(crops)))
    if float(cos.min()) < TOL_TRAIN["cos"]:
        fail(f"21c the mesh-trained checkpoint embeds at cosine "
             f"{float(cos.min())} to its live state, below "
             f"{TOL_TRAIN['cos']}")
    s = STANDIN
    det, _ = standin_parts(torch, torch.float32, conf_thres=s["conf"],
                           pre_nms=s["pre_nms"], max_det=s["max_det"])
    pipe = FacePipeline(detector=det, embedder=served,
                        gallery_capacity=s["gallery"], device=DEV)
    pipe.set_gallery(rng.normal(size=(s["gallery"], 512)).astype(np.float32),
                     [f"p{i}" for i in range(s["gallery"])])
    nb, (h, w) = c["frames"], c["hw"]
    frames = torch.from_numpy(rng.integers(0, 255, (nb, h, w, 3),
                                           dtype=np.uint8)).to(DEV)
    pipe(frames, max_num=s["max_num"])                # warm-up
    sync_all(torch)
    wa.launches = 0
    with k1_capture() as calls:
        for _ in range(c["calls"]):
            o = pipe(frames, max_num=s["max_num"])
        sync_all(torch)
    launches = wa.launches
    if launches == 0:
        fail("21c mesh-trained -> serve: the pipeline launched K1 no time")
    faces = int(o.valid.sum())
    ev = o.embeddings[o.valid]
    if faces == 0 or not bool(torch.isfinite(ev).all()) or not bool(
            ((ev.norm(dim=-1) - 1).abs() < 1e-3).all()):
        fail(f"21c mesh-trained -> serve: {faces} faces, embeddings not "
             f"finite and unit-norm")
    err, summary = k1_on_path(torch, wa, calls)
    if err > TOL_U8:
        fail(f"21c mesh-trained -> serve: K1 vs plain {err} u8")
    rep.say(f"21c mesh-trained -> serve ({label}): {c['rec']} trained "
            f"{c['steps']} steps on the mesh {dict(arc_mesh.shape)} over "
            f"{c['classes']} classes -> {os.path.basename(path)}; "
            f"load_inference_variables(checkpoint) through Embedder against "
            f"the live state at f32 (TF32 off) on {c['crops']} crops: cosine "
            f"min {float(cos.min()):.7f} (tolerance {TOL_TRAIN['cos']}); "
            f"FacePipeline with the det_10g stand-in on {nb} seeded "
            f"{h}x{w} frames: {faces} faces, embeddings finite and "
            f"unit-norm; K1 launches {launches} over {c['calls']} calls; K1 "
            f"vs plain on {summary}: {err:.6g} u8")
    return dict(launches=launches, err=err, cos=float(cos.min()))


def phase_mesh_clis(torch, rep):
    """21d: ``tools.train_arcface`` and ``tools.train_scrfd`` with
    ``--synthetic N --slots 4``, in two child processes at once."""
    c = TRAIN_MESH["cli"]
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase21")
    runs = (("train_arcface", ["--variant", c["rec"], "--batch",
                               str(c["batch"]), "--model-shards", "2"],
             "mesh=data:2xmodel:2"),
            ("train_scrfd", ["--variant", c["det"], "--batch",
                             str(c["det_batch"])], "mesh=data:4"))
    t0 = time.perf_counter()
    outs = run_clis(torch, [
        (f"scrfd_arcface_facerecognition_tpu_torch.tools.{module}",
         args + ["--synthetic", str(c["steps"]), "--slots", "4", "--device",
                 DEV, "--out", os.path.join(out_dir, module)])
        for module, args, _ in runs])
    took = time.perf_counter() - t0
    said = []
    for (module, args, layout), lines in zip(runs, outs):
        ckpt = said_after(lines, "saved ")
        if not any(layout in line for line in lines):
            fail(f"21d {module}: no {layout!r} in {lines}")
        losses = [float(line.split("loss", 1)[1].split()[0])
                  for line in lines if line.startswith("step ")]
        if not losses or not all(np.isfinite(losses)):
            fail(f"21d {module}: losses {losses}")
        said.append(f"{module} {' '.join(args)} --synthetic {c['steps']} "
                    f"--slots 4 ({layout}) -> {os.path.basename(ckpt)}, "
                    f"losses {losses}")
    rep.say(f"21d the CLIs, two child processes at once, in {took:.1f} s "
            "(start-up included): " + "; ".join(said))


def phase_train_mesh(torch, rep, ref_ms):
    """21: (a) the meshes against the one-device trainers in float64, (b)
    the full-width steps, (c) train -> checkpoint -> serve, (d) the
    CLIs."""
    t0 = time.perf_counter()
    slots, label = parallel_slots(torch)
    arc_mesh, det_mesh = arcface_meshes(torch, slots)
    with full_f32(torch):
        cmp = phase_mesh_vs_one(torch, rep, arc_mesh, det_mesh, label)
    t1 = time.perf_counter()
    full = phase_mesh_full(torch, rep, arc_mesh, det_mesh, label, ref_ms)
    t2 = time.perf_counter()
    serve = phase_mesh_serve(torch, rep, arc_mesh, label)
    t3 = time.perf_counter()
    phase_mesh_clis(torch, rep)
    rep.say(f"phase 21 took {time.perf_counter() - t0:.1f} s: (a) "
            f"{t1 - t0:.1f}, (b) {t2 - t1:.1f}, (c) {t3 - t2:.1f}, (d) "
            f"{time.perf_counter() - t3:.1f}")
    return dict(cmp=cmp, full=full, **serve)


# ------------------------------------------------ the release sign-off


def signoff_run(torch, rep, vr, label, argv, require_e2e=True):
    """One ``verify_release.run`` on the card at phase 22's settings, K1
    counted over it (only the e2e stage warps) and held to its plain
    version on the inputs of each frame-batch shape: (the run's result,
    K1 launches, K1's largest error in u8). Every graph row must PASS,
    and every e2e row unless ``require_e2e`` is False (then its rows are
    printed and said to be not required)."""
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    args = vr.parse_args(["--device", DEV, "--n", str(SIGNOFF["frames"]),
                          *argv])
    sync_all(torch)
    wa.launches = 0
    with k1_capture() as calls:
        res = vr.run(args, torch.device(DEV))
        sync_all(torch)
    launches = wa.launches
    for row in res["rows"]:
        rep.say(f"22{label} [graph] " + " | ".join(vr.row_cells(row))
                + f" (executor cos {row['graph']['exec_cos']:.9f}, importer "
                f"cos {row['graph']['imp_cos']:.9f}"
                + ("" if row["rt"] is None else
                   f", round trip cos {row['rt']['cos']:.9f}") + ")")
    for r in res["e2e"]:
        w = r["e2e"]
        rep.say(f"22{label} [e2e] {r['pair']}: conf {w['thresh']:.6f} iou "
                f"{w['iou']:.4f} faces {w['n_faces']} strict "
                f"{w['n_strict']} mismatches {w['count_mismatch']} ties "
                f"{w['tie_swaps']} hidden ties {w['hidden_ties']} box "
                f"{w['box']:.3e} px kps {w['kps']:.3e} px score "
                f"{w['score']:.3e} cos {w['cos']:.9f} simdiff "
                f"{w['simdiff']:.3e} " + ("PASS" if r["passed"] else "FAIL")
                + ("" if require_e2e else " (reported, not required)"))
    hold_signoff(res, label, require_e2e)
    if launches == 0:
        fail(f"22{label} the sign-off's e2e stage launched K1 no time")
    err, summary = k1_on_path(torch, wa, calls)
    if err > TOL_U8:
        fail(f"22{label} K1 vs plain on the e2e stage's inputs: {err} u8")
    passed = ("every graph and pairing PASS" if res["code"] == 0 else
              "every graph PASS, the pairings reported")
    rep.say(f"22{label} {res['source']}: {passed}; K1 launches {launches} "
            f"over the e2e stage; K1 vs plain on {summary}: {err:.6g} u8")
    return res, launches, err


def hold_signoff(res, label, require_e2e=True):
    """Fail unless every graph row of a sign-off passed, and every e2e row
    where they are required."""
    failed = [row["name"] for row in res["rows"] if not row["passed"]]
    if require_e2e:
        failed += [r["pair"] for r in res["e2e"] if not r["passed"]]
    if failed or res["source"] is None:
        fail(f"22{label} the sign-off failed (exit {res['code']}, "
             f"{res['source']}): {failed}")


def phase_signoff(torch, rep):
    """22: the release sign-off tools on the card (``SIGNOFF``): (a) the
    stand-in sign-off of the five graphs (the graph stage, the export
    round trip and both e2e pairings, all required); (b) the mutated
    stand-ins (the graph stage and the round trip required, the pairings
    reported); (c) a truncated det_500m.onnx through the entry point; (d)
    the release gate in a child process."""
    import contextlib
    import io
    import shutil

    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        verify_release as vr)

    t0 = time.perf_counter()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase22")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    no_weights = ["--weights", os.path.join(out_dir, "no_weights")]
    launches, errs, secs = 0, [], []
    runs = {}
    # the mutated stand-ins prove that the architecture comes from the
    # graph: their graph stage and round trip must pass. Their pairings are
    # reported: the mutated det_10g keeps, on each frame, a face whose
    # stride-32 neighbour ties its score and was suppressed, outside the
    # JAX tool's tie rule (hidden ties), and on the card rounding may keep
    # the neighbour instead
    for label, extra, require_e2e in (("a", [], True),
                                      ("b", ["--mutate"], False)):
        t = time.perf_counter()
        runs[label], n, err = signoff_run(torch, rep, vr, label,
                                          no_weights + extra, require_e2e)
        launches += n
        errs.append(err)
        secs.append(time.perf_counter() - t)
    modes = {row["mode"] for row in runs["b"]["rows"]}
    if modes != {"standin", "mutated"}:
        fail(f"22b the mutated run's graphs were {modes}")
    if (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) != tf32:
        fail("22 the sign-off left the TF32 settings changed")

    # (c) a truncated download through the entry point
    t = time.perf_counter()
    bad = os.path.join(out_dir, "bad_weights")
    os.makedirs(bad)
    with open(runs["a"]["rows"][0]["path"], "rb") as f:
        raw = f.read()
    with open(os.path.join(bad, "det_500m.onnx"), "wb") as f:
        f.write(raw[: len(raw) * 3 // 5])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = vr.main(["--device", DEV, "--weights", bad, "--out",
                        os.path.join(out_dir, "PARITY_bad.md")])
    said = buf.getvalue()
    if code != 2 or "SIGN-OFF FAIL" not in said or "RUNBOOK" not in said \
            or "corrupt_or_truncated" not in said:
        fail(f"22c a truncated det_500m.onnx: exit {code}, {said!r}")
    rep.say(f"22c a det_500m.onnx cut at 3/5 of its {len(raw)} bytes "
            f"through verify_release.main: exit {code}, "
            + said.strip().splitlines()[0])
    secs.append(time.perf_counter() - t)

    # (d) the release gate in a child process: the dry run on 8 slots of
    # the card and the page lint (the tests need JAX, which this machine
    # lacks; the sign-off ran in (a) and (b))
    t = time.perf_counter()
    gate = os.path.join(out_dir, "gate")
    lines = run_cli(torch, "scrfd_arcface_facerecognition_tpu_torch.tools."
                    "release_check", ["--device", DEV, "--skip", "tests",
                                      "signoff", "mutate", "--log-dir",
                                      gate])
    with open(os.path.join(gate, "RELEASE_CHECK.md")) as f:
        report = f.read()
    for want in ("| tests | SKIP |", "| multichip | PASS |",
                 "| signoff | SKIP |", "| mutate | SKIP |",
                 "| uilint | PASS |", "**Overall: PASS**"):
        if want not in report:
            fail(f"22d release_check: no {want!r} in its report: {report}")
    with open(os.path.join(gate, "release_check_multichip.log")) as f:
        dry = [line for line in f if line.startswith("dryrun_multichip(")]
    if not dry or f"dryrun_multichip({SIGNOFF['gate_slots']})" not in dry[0]:
        fail(f"22d the dry run said {dry}")
    secs.append(time.perf_counter() - t)
    overall = [line for line in lines if line.startswith("[gate] overall")]
    rep.say(f"22d release_check --skip tests signoff mutate in a child "
            f"process: {' '.join(overall)}; {dry[0].strip()}")
    rep.say(f"phase 22 took {time.perf_counter() - t0:.1f} s: (a) "
            f"{secs[0]:.1f}, (b) {secs[1]:.1f}, (c) {secs[2]:.1f}, (d) "
            f"{secs[3]:.1f}")
    return dict(launches=launches, err=max(errs), runs=runs)



def k2_bit_equal(torch, pq_adc, lut, codes, precision, block=64,
                 what="23a"):
    """K2 on the whole (Q, G) against its plain version computed ``block``
    queries at a time (the plain scan holds three (block, G) tensors, not
    three (Q, G) ones): every score bit-equal, NaN where NaN. The
    comparison's own launch is taken back off K2's count. Returns the max
    abs difference of the finite scores: 0.0, or the phase fails."""
    n0 = pq_adc.launches
    got = pq_adc.pq_adc_scores(lut, codes, precision)
    pq_adc.launches = n0
    for q0 in range(0, lut.shape[0], block):
        want = pq_adc.adc_scores_plain(lut[q0:q0 + block], codes, precision)
        part = got[q0:q0 + block]
        nan = torch.isnan(part)
        if not torch.equal(nan, torch.isnan(want)):
            fail(f"{what} K2 ({precision}): NaN positions differ from the "
                 f"plain version in queries {q0}..{q0 + len(want) - 1}")
        same = (part.view(torch.int32) == want.view(torch.int32)) | nan
        if not bool(same.all()):
            fin = torch.isfinite(want) & torch.isfinite(part)
            d = float((part[fin] - want[fin]).abs().max()) if bool(
                fin.any()) else float("inf")
            fail(f"{what} K2 ({precision}) differs from its plain version at "
                 f"{int((~same).sum())} of {same.numel()} scores "
                 f"(queries {q0}..{q0 + len(want) - 1}; max abs difference "
                 f"of the finite ones {d:.6g})")
        del want, part, nan, same
    del got
    return 0.0


def scale_search(torch, rep):
    """23a: tools.exp_pq_scale at GALLERY_SCALE["pq"], K2 counted over the
    tool's run and held to its plain version on the 10M codes."""
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq_adc
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        exp_pq_scale as xs)

    cfg = GALLERY_SCALE["pq"]
    want_checks = set(GALLERY_SCALE["k2_checks"])
    lines, checked = [], []

    def inspect(gal, qs):
        codes = gal._codes
        for q, precision in sorted(want_checks):
            if q != len(qs):
                continue
            t = time.perf_counter()
            lut = gal.codec.lut(qs)
            err = k2_bit_equal(torch, pq_adc, lut, codes, precision)
            checked.append((q, precision, err, q * codes.shape[0],
                            time.perf_counter() - t))
            del lut

    torch.cuda.empty_cache()
    k2_reset(pq_adc)
    res = xs.run(g=cfg["g"], q_sweep=cfg["q_sweep"],
                 dense_g=cfg["dense_g"], device=DEV, emit=lines.append,
                 inspect=inspect)
    launches = k2_count(pq_adc)
    for line in lines:
        rep.say("23a " + json.dumps(line))
    if launches == 0:
        fail("23a exp_pq_scale launched K2 no time")
    if {(q, p) for q, p, *_ in checked} != want_checks:
        fail(f"23a K2 was held to its plain version at "
             f"{sorted((q, p) for q, p, *_ in checked)}, not at "
             f"{sorted(want_checks)}")
    bad = [r for r in res["sweep"] if r["min_id"] < 0]
    if bad:
        fail(f"23a a search returned an id < 0: {bad[0]}")
    for r in res["recall"]:
        # a query whose identity drew no row of the gallery cannot find it
        if r["top1_hits"] != r["identity_present"]:
            fail(f"23a top-1 same identity for {r['top1_hits']} queries, "
                 f"not the {r['identity_present']} whose identity the "
                 f"gallery holds ({r['label']}; top1_same_identity "
                 f"{r['top1_same_identity']})")
    f = res["fill"]
    rep.say(f"23a fill of {cfg['g']} rows: {f['rows_per_s']:.1f} rows/s, "
            f"{f['seconds']:.2f} s = making the rows on the host "
            f"{f['make_rows_s']:.2f} s + PQGallery.add (encoding, the "
            f"scatter, the free list) {f['add_s']:.2f} s")
    for r in res["sweep"]:
        st = r["stage_ms"]
        mem = ("not measured (no card)" if r["peak_bytes"] is None else
               f"{r['peak_bytes'] / 1e9:.3f} GB ("
               f"{r['resident_bytes'] / 1e9:.3f} GB resident before)")
        rep.say(f"23a Q={r['q']} {r['precision']}: median {r['ms']:.3f} ms "
                f"({r['per_query_ms']:.4f} ms a query); one synchronized "
                f"search: pq_lut {st.get('pq_lut', 0):.3f}, pq_adc "
                f"{st.get('pq_adc', 0):.3f}, pq_topk {st.get('pq_topk', 0):.3f}"
                f" ms; peak device memory {mem}")
    for q, precision, err, n, secs in checked:
        rep.say(f"23a K2 vs plain on the {cfg['g']} codes at Q={q} "
                f"{precision}: {n} scores ({'past' if n > 2 ** 31 else 'below'}"
                f" 2^31), bit-equal, NaN positions equal ({secs:.1f} s)")
    rep.say(f"23a K2 launches over exp_pq_scale: {launches}")
    wide = scale_wide(torch, rep)
    return dict(launches=launches + wide["launches"],
                err=max([c[2] for c in checked] + wide["err"]), res=res)


def scale_wide(torch, rep):
    """23a: one search past 2^31 scores without the host fill: a
    PQGallery of GALLERY_SCALE["wide"]["g"] rows whose codes are drawn on
    the card (every row valid), one search of Q queries (K2 counted; every
    id >= 0), then K2 held bit for bit to its plain version on the whole
    (Q, G). None in the config: the swept gallery already is that large."""
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq_adc
    from scrfd_arcface_facerecognition_tpu_torch.gallery.pq import (
        PQCodec, PQGallery)
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        exp_pq_scale as xs)

    cfg = GALLERY_SCALE["wide"]
    if cfg is None:
        return dict(launches=0, err=[])
    t = time.perf_counter()
    rng = np.random.default_rng(1)
    codec = PQCodec.train(xs.unit_rows(rng, xs.CODEC_TRAIN_ROWS), m=64,
                          device=DEV)
    gal = PQGallery(codec, capacity=cfg["g"], device=DEV)
    codes, valid = gal._shards.rows[0], gal._shards.valid[0]
    gen = torch.Generator(device=codes.device).manual_seed(1)
    codes.copy_(torch.randint(0, codec.k, codes.shape, generator=gen,
                              dtype=torch.uint8, device=codes.device))
    valid.fill_(True)
    gal._ids[:] = np.arange(cfg["g"])
    gal._free = []
    qs = xs.unit_rows(rng, cfg["q"])
    sync_all(torch)
    drawn = time.perf_counter() - t
    torch.cuda.empty_cache()
    n0 = k2_count(pq_adc)
    t = time.perf_counter()
    _, ids = gal.search(qs, k=5, precision=cfg["precision"])
    search_s = time.perf_counter() - t
    launches = k2_count(pq_adc) - n0
    if launches == 0:
        fail("23a the search over the drawn codes launched K2 no time")
    if not (ids >= 0).all():
        fail(f"23a the search over {cfg['g']} drawn codes returned an id "
             f"< 0")
    t = time.perf_counter()
    lut = codec.lut(qs)
    err = k2_bit_equal(torch, pq_adc, lut, gal._codes, cfg["precision"])
    compare_topk(torch, pq_adc, "23a the search over the drawn codes", lut,
                 gal._codes, valid, 5, cfg["precision"], block=32)
    n = cfg["q"] * cfg["g"]
    rep.say(f"23a {cfg['g']} codes drawn on the card ({drawn:.1f} s with "
            f"the codec), one search at Q={cfg['q']} {cfg['precision']} "
            f"({search_s:.2f} s, {launches} K2 launch, every id >= 0); K2 "
            f"vs plain on them: {n} scores "
            f"({'past' if n > 2 ** 31 else 'below'} 2^31), bit-equal, NaN "
            f"positions equal; the fused top-k (one call) bit-equal to the "
            f"plain chain and to K2 + mask + sort (32 queries a call) "
            f"({time.perf_counter() - t:.1f}"
            f" s)")
    del gal, codes, valid, lut
    torch.cuda.empty_cache()
    return dict(launches=launches, err=[err])


def scale_migration(torch, rep):
    """23b: tools.exp_migration, the synchronous and the background
    crossing; K2 counted over both."""
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq_adc
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        exp_migration as xm)

    k2_reset(pq_adc)
    sync = []
    for rows in GALLERY_SCALE["sync_rows"]:
        sync.append(xm.run_scale(rows, device=DEV))
        rep.say("23b sync " + json.dumps(sync[-1]))
        if sync[-1]["top1_self"] != "16/16":
            fail(f"23b top-1 self {sync[-1]['top1_self']} after the "
                 f"synchronous crossing at {rows} rows")
    asy = xm.run_scale_async(GALLERY_SCALE["async_rows"], device=DEV)
    rep.say("23b async " + json.dumps(asy))
    if asy["bg_failed"]:
        fail("23b the background migration failed")
    if asy["swap_call_s"] is None:
        fail("23b the tier never flipped to pq")
    if asy["top1_self"] != "16/16":
        fail(f"23b top-1 self {asy['top1_self']} after the background "
             f"crossing")
    if asy["probe_top1_self_min"] not in (None, "16/16"):
        fail(f"23b a probe during the migration found top-1 self "
             f"{asy['probe_top1_self_min']}")
    launches = k2_count(pq_adc)
    if launches == 0:
        fail("23b the migrated tiers launched K2 no time")
    rep.say(f"23b K2 launches over both crossings: {launches}")
    return dict(launches=launches, sync=sync, asy=asy)


def scale_merge(torch, rep):
    """23c: tools.exp_merge_1m; exactly the planted pairs come back."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        exp_merge_1m as xd)

    cfg = GALLERY_SCALE["merge"]
    lines = []
    res = xd.run(cfg["g"], cfg["dups"], cfg["threshold"], device=DEV,
                 emit=lines.append)
    for line in lines:
        rep.say("23c " + json.dumps(line))
    if not res["exact_match"]:
        fail(f"23c the scan found {res['pairs_found']} pairs, not the "
             f"{cfg['dups']} planted: missed {res['missed'][:5]}, extra "
             f"{res['extra'][:5]}")
    if res["groups_after_merge"] != cfg["g"] - cfg["dups"]:
        fail(f"23c {res['groups_after_merge']} groups after the merge, not "
             f"{cfg['g'] - cfg['dups']}")
    return res


def scale_budget(torch, rep):
    """23d: tools.exp_train_budget; every query's identity at the codec
    budget AutoGallery ships."""
    import inspect

    from scrfd_arcface_facerecognition_tpu_torch.gallery import AutoGallery
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        exp_train_budget as xb)

    cfg = GALLERY_SCALE["budget"]
    params = inspect.signature(AutoGallery).parameters
    shipped = (params["pq_train_rows"].default,
               params["pq_train_iters"].default)
    rows = xb.run(cfg["rows"], cfg["queries"], DEV,
                  emit=lambda line: rep.say("23d " + json.dumps(line)))
    at = [r for r in rows if (r["train_rows"], r["iters"]) == shipped]
    if not at:
        fail(f"23d the ladder has no rung at the shipped budget {shipped}")
    if at[0]["hits"] != cfg["queries"]:
        fail(f"23d top-1 identity {at[0]['top1_identity']} at the shipped "
             f"budget {shipped}")
    return rows


def scale_fused(torch, rep):
    """23e: the lookup cell's shape (``GALLERY_SCALE["fused"]``): codes of
    prototypes with a share of each row's sub-codes drawn anew (so exact
    ties are common), N(0, 1/D) centroids, queries near random rows. K2
    against its plain version there, bit for bit; the fused search
    (``PQGallery.search``, K2 with the top-k in it) against the plain
    chain and the unfused one (K2, mask, stable sort) bit for bit, and the
    fused top-k at k of the cell and 32 in both precisions against both;
    then device ms at the cell's (Q, k, precision): the fused top-k (K2
    and the merge) beside its own bound, K2 alone, K2 + mask + sort. None
    of these launches is counted."""
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq_adc
    from scrfd_arcface_facerecognition_tpu_torch.gallery.pq import (
        PQCodec, PQGallery)

    cfg = GALLERY_SCALE["fused"]
    g, m, kc, dim = cfg["g"], 64, 256, 512
    n0 = (pq_adc.launches, pq_adc.topk_launches)
    gen = torch.Generator(device=DEV).manual_seed(25)
    cent = torch.randn((m, kc, dim // m), generator=gen, device=DEV) \
        / dim ** 0.5
    gal = PQGallery(PQCodec(cent), capacity=g, device=DEV)
    codes, valid = gal._shards.rows[0], gal._shards.valid[0]
    proto = torch.randint(0, kc, (cfg["identities"], m), generator=gen,
                          dtype=torch.uint8, device=DEV)
    for r0 in range(0, g, 1 << 20):
        n = min(1 << 20, g - r0)
        ident = torch.randint(0, cfg["identities"], (n,), generator=gen,
                              device=DEV)
        fresh = torch.randint(0, kc, (n, m), generator=gen,
                              dtype=torch.uint8, device=DEV)
        change = torch.rand((n, m), generator=gen, device=DEV) \
            < cfg["changed"]
        codes[r0:r0 + n] = torch.where(change, fresh, proto[ident])
    valid.fill_(True)
    gal._ids[:] = np.arange(g)
    gal._free = []
    near = gal.codec.decode(codes[torch.randint(
        0, g, (cfg["q"],), generator=gen, device=DEV)])
    qs = torch.nn.functional.normalize(near + cfg["noise"] * torch.randn(
        near.shape, generator=gen, device=DEV) / dim ** 0.5, dim=1)
    qs = qs.cpu().numpy()
    lut = gal.codec.lut(qs)
    k, precision = cfg["k"], cfg["precision"]
    k2_bit_equal(torch, pq_adc, lut, codes, precision, what="23e")
    s, i = gal.search(qs, k=k, precision=precision)
    for name, scores in (("the plain chain", pq_adc.adc_scores_plain),
                         ("the unfused one", pq_adc.pq_adc_scores)):
        want_s, want_i = pq_adc.topk_plain(lut, codes, valid, k, precision,
                                           scores=scores)
        if not (np.array_equal(i, want_i.cpu().numpy()) and np.array_equal(
                s.view(np.int32), want_s.cpu().numpy().view(np.int32))):
            fail(f"23e the fused search differs from {name} at Q="
                 f"{cfg['q']}, k={k}, {precision}")
        del want_s, want_i
    places = 0
    for p in pq_adc.PRECISIONS:
        for kk in sorted({k, pq_adc.KMAX}):
            places += compare_topk(torch, pq_adc, "23e", lut, codes, valid,
                                   kk, p)
    fused_ms = time_ms(torch, lambda: pq_adc.pq_adc_topk(
        lut, codes, valid, k, precision))
    k2_ms = time_ms(torch, lambda: pq_adc.pq_adc_scores(lut, codes,
                                                        precision))
    chain_ms = time_ms(torch, lambda: pq_adc.topk_plain(
        lut, codes, valid, k, precision, scores=pq_adc.pq_adc_scores),
        iters=3)
    plain_ms = time_ms(torch, lambda: pq_adc.topk_plain(
        lut, codes, valid, k, precision), iters=1)
    bound_ms, bound_by, _ = k2_bound(cfg["q"], m, kc, g, precision, top_k=k)
    k2_bound_ms, k2_bound_by, _ = k2_bound(cfg["q"], m, kc, g, precision)
    pq_adc.launches, pq_adc.topk_launches = n0
    rep.say(f"23e the lookup cell's shape, {g} codes of "
            f"{cfg['identities']} identities ({cfg['changed']:.5f} of a "
            f"row's sub-codes drawn anew), Q={cfg['q']}: K2 bit-equal to "
            f"its plain version ({precision}); the fused search (k={k}, "
            f"{precision}) bit-equal to the plain chain and to the unfused "
            f"one, the fused top-k bit-equal to both at k "
            f"{sorted({k, pq_adc.KMAX})} in both precisions ({places} "
            f"places); device ms at k={k} {precision}: the fused top-k "
            f"{fused_ms:.4f} (K2 with the selection, and the merge; its "
            f"bound {bound_ms:.4f} by {bound_by}), K2 alone {k2_ms:.4f} "
            f"(its bound {k2_bound_ms:.4f} by {k2_bound_by}), K2 + mask + "
            f"sort {chain_ms:.4f}, the plain chain {plain_ms:.4f}")
    del gal, codes, valid, lut
    torch.cuda.empty_cache()
    return dict(ms=fused_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=chain_ms,
                shape=dict(q=cfg["q"], g=g, k=k, precision=precision))


def phase_gallery_scale(torch, rep):
    """23: the gallery at deployment scale through the port's tools."""
    t0 = time.perf_counter()
    out, secs = {}, {}
    for part, run in (("a", scale_search), ("b", scale_migration),
                      ("c", scale_merge), ("d", scale_budget),
                      ("e", scale_fused)):
        t = time.perf_counter()
        out[part] = run(torch, rep)
        secs[part] = time.perf_counter() - t
    rep.say(f"phase 23 took {time.perf_counter() - t0:.1f} s: "
            + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()))
    return dict(launches=out["a"]["launches"] + out["b"]["launches"],
                err=out["a"]["err"], secs=secs, topk=out["e"])

# ---------------------------------------------------------------------
# phase 24: the serving host's budget and the trainers' proof, through the
# port's tools: concurrent requests with and without coalescing, both
# trainers memorizing, the host's ingest rates


def host_microbatch(torch, rep):
    """24a: ``tools.exp_microbatch`` on the card, K1 counted; each
    coalesced request held to the direct ``get_batch`` of its batch, each
    batch-1 request to ``get``."""
    from scrfd_arcface_facerecognition_tpu_torch.apps import FaceAnalysis
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_microbatch

    c = HOST_TOOLS["microbatch"]
    app = FaceAnalysis(det_variant=c["det"], rec_variant=c["rec"], seed=0,
                       device=DEV)
    app.prepare(det_size=c["det_size"])
    groups = []                  # the collector's batches, their images
    direct = app._get_batch_direct

    def recorded(imgs, max_num=0):
        if app._microbatcher is not None:
            groups.append(list(imgs))
        return direct(imgs, max_num=max_num)

    app._get_batch_direct = recorded
    lines = []
    with k1_capture() as k1_calls:
        wa.launches = 0
        out = exp_microbatch.run(c["requests"], c["threads"], c["size"],
                                 c["max_wait_ms"], app=app,
                                 emit=lines.append)
        launches = wa.launches
    del app._get_batch_direct
    if launches <= 0:
        fail("24a exp_microbatch launched K1 no time")
    images = out["images"]
    index = {id(im): i for i, im in enumerate(images)}
    groups = [[index[id(im)] for im in g] for g in groups]
    # the measured round's batches: those after the warm-up round's, which
    # cover every request once
    served, first = 0, len(groups)
    for gi, g in enumerate(groups):
        served += len(g)
        if served == len(images):
            first = gi + 1
            break
    measured = groups[first:]
    (one_line, _, one_faces), (mb_line, _, mb_faces) = out["modes"]
    if sorted(sum(measured, [])) != list(range(len(images))) or (
            len(measured) != mb_line["batches"]):
        fail(f"24a the measured round's batches {measured} do not serve "
             f"each request once ({mb_line})")
    bad = []
    for g in measured:
        want = app.get_batch([images[i] for i in g],
                             max_num=exp_microbatch.MAX_NUM)
        bad += [i for i, w in zip(g, want) if not faces_close(w, mb_faces[i])]
    if bad:
        fail(f"24a coalesced requests {bad} differ from the direct get_batch "
             "of their batch")
    bad = [i for i, im in enumerate(images)
           if not faces_close(app.get(im, max_num=exp_microbatch.MAX_NUM),
                              one_faces[i])]
    if bad:
        fail(f"24a batch-1 requests {bad} differ from get()")
    err, what = k1_on_path(torch, wa, k1_calls)
    for line in lines:
        rep.say("24a " + json.dumps(line))
    rep.say("24a one warm batch-1 get() alone under torch.profiler: "
            + busy_said(device_busy(torch, lambda: app.get(
                images[0], max_num=exp_microbatch.MAX_NUM))))
    faces = sum(len(f) for f in mb_faces)
    rep.say(f"24a {c['det']} + {c['rec']} at {app.dtype}, {c['requests']} "
            f"requests of {c['size']}x{c['size']} from {c['threads']} "
            f"threads, max_num {exp_microbatch.MAX_NUM}: coalesced "
            f"{mb_line['requests_per_sec']} req/s against "
            f"{one_line['requests_per_sec']} batch-1 "
            f"({mb_line['requests_per_sec'] / one_line['requests_per_sec']:.2f}"
            f"x), {mb_line['batches']} batches, widest {mb_line['widest']} "
            f"(sizes {[len(g) for g in measured]}); every coalesced request "
            f"equal to the direct get_batch of its batch and every batch-1 "
            f"request to get() (bbox atol 1e-2, embeddings atol 1e-3; "
            f"{faces} faces); K1 {launches} launches, vs plain on the run's "
            f"inputs, {what}: max abs err {err:.6g} u8 (tolerance {TOL_U8})")
    return dict(launches=launches, err=err, lines=lines)


def hold_learning(curve, floor, what):
    """A curve [(step, value), ...] learned: its last value above its
    step-0 value and at least ``floor``."""
    first, last = curve[0][1], curve[-1][1]
    if not (last > first and last >= floor):
        fail(f"24b {what} did not learn: {curve} (the last value must be "
             f"above step 0's {first} and at least {floor})")


def host_convergence(torch, rep):
    """24b: ``tools.exp_convergence`` at its defaults on the card, both
    curves held to the floors of ``HOST_TOOLS``."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_convergence

    c = HOST_TOOLS["convergence"]
    lines = []
    arc = exp_convergence.run_arcface(c["arc_steps"], c["eval_every"],
                                      c["batch"], device=DEV,
                                      emit=lines.append)
    det = exp_convergence.run_scrfd(c["det_steps"], c["eval_every"],
                                    c["det_batch"], size=c["size"],
                                    device=DEV, emit=lines.append)
    for line in lines:
        rep.say("24b " + json.dumps(line))
    hold_learning(arc["curve"], c["min_accuracy"],
                  "ArcFace held-out verification accuracy")
    hold_learning(det["curve"], c["min_ap"], "SCRFD AP@0.5")
    rep.say(f"24b w600k_mbf over 50 identities, batch {c['batch']}, "
            f"{c['arc_steps']} steps: accuracy {arc['curve'][0][1]:.4f} -> "
            f"{arc['curve'][-1][1]:.4f} (floor {c['min_accuracy']}), "
            f"{arc['ms_step']:.3f} ms a step, {arc['elapsed_s']:.1f} s; "
            f"det_500m at {c['size']}, batch {c['det_batch']}, "
            f"{c['det_steps']} steps: AP@0.5 {det['curve'][0][1]:.4f} -> "
            f"{det['curve'][-1][1]:.4f} (floor {c['min_ap']}), "
            f"{det['ms_step']:.3f} ms a step, {det['elapsed_s']:.1f} s")
    return dict(arc=arc, det=det)


def host_ingest(torch, rep, device_fps):
    """24c: ``tools.bench_ingest`` on the synthetic source, every row at
    streams x frames; the core budget at this run's phase 13 frames/s."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import bench_ingest

    c = HOST_TOOLS["ingest"]
    w, h = c["res"]
    cores = os.cpu_count() or 1
    rows = bench_ingest.run(bench_ingest.synthetic_source(w, h, c["frames"]),
                            w, h, c["streams"], cores)
    for name, ns, wk, _, n in rows:
        if n != ns * c["frames"]:
            fail(f"24c {name} over {ns} streams ({wk}) gave {n} frames, "
                 f"not {ns * c['frames']}")
    text = bench_ingest.table(rows, w, h, bench_ingest.SYNTHETIC,
                              c["frames"], cores, device_fps)
    for line in text.splitlines():
        if line.strip():
            rep.say("24c " + line)
    rep.say(f"24c the budget's card rate: phase 13's resident depth-12 "
            f"{device_fps:.2f} frames/s")
    return rows


def phase_host_and_learning(torch, rep, device_fps):
    """24: the serving host's budget and the trainers' proof."""
    t0 = time.perf_counter()
    out, secs = {}, {}
    for part, run in (("a", lambda: host_microbatch(torch, rep)),
                      ("b", lambda: host_convergence(torch, rep)),
                      ("c", lambda: host_ingest(torch, rep, device_fps))):
        t = time.perf_counter()
        out[part] = run()
        secs[part] = time.perf_counter() - t
    rep.say(f"phase 24 took {time.perf_counter() - t0:.1f} s: "
            + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()))
    return dict(launches=out["a"]["launches"], err=out["a"]["err"],
                secs=secs)

# ---------------------------------------------------------------------
# phase 25: the measurement tools, the port's counterparts of the JAX
# repository's profiling scripts, each at its defaults with its own check


def tools_profile(torch, rep):
    """25a: ``tools.profile_stages`` at each batch of ``PROFILE_TOOLS``
    (one seeded pipeline), K1 counted over the runs and held to its plain
    version on their inputs."""
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.tools import profile_stages

    c = PROFILE_TOOLS["profile_stages"]
    pipe = profile_stages.make_pipeline(DEV)
    runs = {}
    with k1_capture() as k1_calls:
        wa.launches = 0
        for b in c["batches"]:
            lines = []
            runs[b] = profile_stages.run(b, c["iters"], pipe=pipe,
                                         emit=lines.append)
            for line in lines:
                rep.say(f"25a B={b} {line}")
        launches = wa.launches
    if launches <= 0:
        fail("25a profile_stages launched K1 no time")
    err, what = k1_on_path(torch, wa, k1_calls)
    rep.say(f"25a K1 {launches} launches over profile_stages at batches "
            f"{list(c['batches'])}, vs plain on the runs' inputs, {what}: "
            f"max abs err {err:.6g} u8 (tolerance {TOL_U8})")
    return dict(launches=launches, err=err, runs=runs)


def tools_r50(torch, rep):
    """25b: ``tools.exp_r50``, then its full prefix plus head held to the
    forward; 25c: ``tools.exp_r50b`` on the same model (its four heads
    held to A inside the tool)."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        exp_r50, exp_r50b)

    c = PROFILE_TOOLS["exp_r50"]
    model = exp_r50.make_model(DEV)
    lines = []
    r50 = exp_r50.run(c["n"], c["sweep"], c["iters"], model=model,
                      emit=lines.append)
    x = torch.from_numpy(exp_r50.make_input(c["check_n"])).to(DEV)
    gap = exp_r50.check(model, x)
    for line in lines:
        rep.say("25b " + line)
    if gap != 0:
        fail(f"25b exp_r50: stem..layer4 then the head differs from the "
             f"forward by {gap}")
    rep.say(f"25b the full prefix plus the head equals the forward on "
            f"{c['check_n']} crops (max abs diff {gap})")
    lines = []
    r50b = exp_r50b.run(PROFILE_TOOLS["exp_r50b"]["batches"], model=model,
                        emit=lines.append)
    for line in lines:
        rep.say("25c " + line)
    return dict(r50=r50, r50b=r50b)


def tools_scrfd(torch, rep):
    """25d: ``tools.exp_scrfd``; backbone -> neck -> head held to
    ``SCRFDNet``'s outputs within 2 bf16 ulps of each kind's largest
    magnitude."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_scrfd

    c = PROFILE_TOOLS["exp_scrfd"]
    lines = []
    out = exp_scrfd.run(c["batch"], c["iters"], c["size"], device=DEV,
                        emit=lines.append)
    for line in lines:
        rep.say("25d " + line)
    whole, head = out["outputs"]
    gaps = exp_scrfd.compose_gap(whole, head)
    tol = {k: 2 * bf16_ulp(max(float(a.abs().max()) for a in whole[k]))
           for k in whole}
    bad = {k: (g, tol[k]) for k, g in gaps.items() if not g <= tol[k]}
    if bad:
        fail(f"25d exp_scrfd: backbone -> neck -> head differs from "
             f"SCRFDNet past 2 bf16 ulps: {bad}")
    rep.say("25d backbone -> neck -> head composes to SCRFDNet's outputs: "
            + ", ".join(f"{k} max abs diff {g:.3g} (2 ulps {tol[k]:.3g})"
                        for k, g in gaps.items()))
    return out["rows"]


def tools_trace(torch, rep):
    """25e: ``tools.trace_ops``: a non-empty table of device ops with a
    positive total."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import trace_ops

    c = PROFILE_TOOLS["trace_ops"]
    lines = []
    res = trace_ops.run(c["what"], c["batch"], c["iters"], c["top"],
                        device=DEV, emit=lines.append)
    for line in lines:
        rep.say("25e " + line)
    if not res["top"] or not res["total_ms"] > 0:
        fail(f"25e trace_ops: no device op in the trace ({res['path']})")
    return res


def tools_int8(torch, rep):
    """25f: ``tools.exp_int8``; every int8 conv (the three geometries and
    the chain's) and the int8 GEMM exactly equal to float64 on the card."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_int8

    c = PROFILE_TOOLS["exp_int8"]
    lines = []
    out = exp_int8.run(c["convs"], c["matmul"], c["chain_batch"],
                       device=DEV, check=True, emit=lines.append)
    for line in lines:
        rep.say("25f " + line)
    bad = {k: v for k, v in out["exact"].items() if v != 0}
    if bad:
        fail(f"25f exp_int8: int8 results differ from float64: {bad}")
    rep.say("25f every int8 conv (" + str(len(c["convs"])) + " geometries, "
            + str(len(exp_int8.chain_shapes()))
            + " chain convs) and the int8 GEMM equal float64 on the card "
            "exactly")
    return out


def phase_measure_tools(torch, rep):
    """25: the measurement tools at their defaults, each with its check;
    K1 counted over profile_stages."""
    t0 = time.perf_counter()
    out, secs = {}, {}
    for part, run in (("a", tools_profile), ("b-c", tools_r50),
                      ("d", tools_scrfd), ("e", tools_trace),
                      ("f", tools_int8)):
        t = time.perf_counter()
        out[part] = run(torch, rep)
        secs[part] = time.perf_counter() - t
        torch.cuda.empty_cache()
    rep.say(f"phase 25 took {time.perf_counter() - t0:.1f} s: "
            + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()))
    return dict(launches=out["a"]["launches"], err=out["a"]["err"],
                out=out, secs=secs)


# ---------------------------------------------------------------------
# phase 26: the decision tools on the card: tools.exp_decisions' eval of
# the committed checkpoints (f32 card against the CPU, then bf16), its two
# trainers for a few steps and the checkpoints round trip, and
# tools.replay_visits over an in-memory cache, K1 counted over all three


def decision_data():
    """The phase's synthetic identities (``exp_decisions.synthetic_crops``)
    and their eval / train / val ids."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        exp_decisions as xd)

    c = DECISIONS["ids"]
    crops, _ = xd.synthetic_crops(c["eval"] + c["train"] + c["val"],
                                  DECISIONS["seed"])
    ids = np.arange(len(crops))
    a, b = c["eval"], c["eval"] + c["train"]
    return crops, ids[:a], ids[a:b], ids[b:]


@contextlib.contextmanager
def decision_trace():
    """Every similarity the engine decides on, in order, in the list this
    yields: each search of its gallery (an ``AutoGallery``), the hits'
    scores before any threshold drops them ("search", [scores]), and each
    verification's ("compare", [similarity]). The threshold is applied
    after, as the gallery applies it (a hit below it is dropped)."""
    from scrfd_arcface_facerecognition_tpu_torch.apps import clustering
    from scrfd_arcface_facerecognition_tpu_torch.gallery import AutoGallery

    trace = []
    saved = [(AutoGallery, "search_batch", AutoGallery.search_batch),
             (clustering.SmartFaceEngine, "compare_face_images",
              clustering.SmartFaceEngine.compare_face_images)]

    def searched(fn):
        def search_batch(self, queries, k=5, threshold=None):
            hits = fn(self, queries, k=k, threshold=None)
            trace.extend(("search", [h.score for h in hl]) for hl in hits)
            return [[h for h in hl if threshold is None
                     or not h.score < threshold] for hl in hits]
        return search_batch

    def compared(fn):
        def compare_face_images(self, image1, image2):
            out = fn(self, image1, image2)
            if out.get("success"):
                trace.append(("compare", [out["similarity"]]))
            return out
        return compare_face_images

    AutoGallery.search_batch = searched(saved[0][2])
    clustering.SmartFaceEngine.compare_face_images = compared(saved[1][2])
    try:
        yield trace
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def decision_thresholds():
    """The thresholds the engine holds similarities to (its defaults)."""
    from scrfd_arcface_facerecognition_tpu_torch.utils.config import (
        DEFAULT_CONFIG)

    fr = DEFAULT_CONFIG["face_recognition"]
    return sorted({fr["grouping_threshold_json"], fr["similarity_threshold"],
                   fr["duplicate_similarity_threshold"],
                   fr["merge_duplicate_threshold"],
                   DEFAULT_CONFIG["face_comparison"]["similarity_threshold"]})


def hold_decisions(card, cpu, card_trace, cpu_trace, thresholds,
                   tol=TOL_DECISION):
    """26a: the card's f32 metrics against the CPU's, ``elapsed_s`` aside,
    floats (the verification means) within ``tol``. Where they differ, the
    first decision on which the two runs part must be a tie: a similarity
    that lies within ``tol`` of a threshold on both devices, on opposite
    sides of it; every similarity before it agrees within ``tol``. Returns
    None when the metrics agree, else what the tie was; fails otherwise."""
    def bare(m):
        return {k: v for k, v in m.items() if k != "elapsed_s"}

    diff = record_diff(bare(card), bare(cpu), tol, "metrics")
    if diff is None:
        return None
    for i, ((kind, a), (kind_b, b)) in enumerate(zip(card_trace, cpu_trace)):
        if kind != kind_b or len(a) != len(b):
            fail(f"26a {diff}; decision {i} is a {kind} of {len(a)} scores "
                 f"on the card, a {kind_b} of {len(b)} on the CPU, and no "
                 f"earlier decision flipped at a tie")
        for x, y in zip(a, b):
            for t in thresholds:
                if (x >= t) != (y >= t):
                    if abs(x - t) <= tol and abs(y - t) <= tol:
                        return (f"decision {i} ({kind}) flipped at a tie: "
                                f"{x:.7f} on the card, {y:.7f} on the CPU "
                                f"against {t}")
                    fail(f"26a {diff}; decision {i} ({kind}) flipped: "
                         f"{x:.7f} on the card, {y:.7f} on the CPU against "
                         f"{t}, not a tie (tolerance {tol})")
            if abs(x - y) > tol:
                fail(f"26a {diff}; decision {i} ({kind}): similarity "
                     f"{x:.7f} on the card, {y:.7f} on the CPU")
    fail(f"26a {diff}, and no similarity the engines decided on flipped at "
         f"a threshold ({len(card_trace)} and {len(cpu_trace)} decisions)")


def decision_eval_run(torch, trees, data, workdir, app):
    """One ``run_decision_eval`` of DECISIONS["eval"] on ``app``: (the
    metrics, the similarity trace, seconds)."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        exp_decisions as xd)

    c = DECISIONS["eval"]
    crops, eval_ids = data[0], data[1]
    with decision_trace() as trace:
        t = time.perf_counter()
        m = xd.run_decision_eval(trees[0], trees[1], crops, eval_ids,
                                 workdir, visits_per_id=c["visits"],
                                 n_verif_pairs=c["pairs"],
                                 seed=DECISIONS["seed"], log=lambda s: None,
                                 app=app)
        sync_all(torch)
        secs = time.perf_counter() - t
    return m, list(trace), secs


def decisions_eval(torch, rep, data, trees, tmp):
    """26a: the committed checkpoints' eval slice on the card at f32 (TF32
    off) against the same call on the CPU, then at the facade's card
    default (bf16): the machinery's counts."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        exp_decisions as xd, replay_visits as rv)

    with full_f32(torch):
        card, card_trace, card_s = decision_eval_run(
            torch, trees, data, os.path.join(tmp, "a_card_f32"),
            xd.build_app(*trees, device=DEV, dtype=torch.float32))
        cpu, cpu_trace, cpu_s = decision_eval_run(
            torch, trees, data, os.path.join(tmp, "a_cpu_f32"),
            xd.build_app(*trees, device="cpu"))
    tie = hold_decisions(card, cpu, card_trace, cpu_trace,
                         decision_thresholds())
    n = card["n_visits"]
    rep.say("26a card f32 " + json.dumps(card))
    rep.say(f"26a f32 with TF32 off: the card's metrics "
            + ("equal the CPU's" if tie is None else
               f"part from the CPU's at a tie ({tie})")
            + f" ({len(card_trace)} similarities decided on); "
            f"{1e3 * card_s / n:.1f} ms a visit on the card, "
            f"{1e3 * cpu_s / n:.1f} on the CPU (the whole eval: the visits, "
            f"the attribution, {card['verification']['pairs']} "
            f"verifications, the merge)")
    bf, _, bf_s = decision_eval_run(
        torch, trees, data, os.path.join(tmp, "a_card_bf16"),
        xd.build_app(*trees, device=DEV))
    cnt = bf["counters"]
    handled = sum(cnt[k] for k in rv.HANDLED)
    if handled != bf["n_visits"]:
        fail(f"26a bf16: the counters handle {handled} visits of "
             f"{bf['n_visits']}: {cnt}")
    if cnt["duplicate_faces"] < 2:
        fail(f"26a bf16: {cnt['duplicate_faces']} duplicate faces, not the "
             f"URL probe and the same-pixels probe: {cnt}")
    if cnt["processed"] < 1:
        fail(f"26a bf16: no visit processed: {cnt}")
    rep.say("26a card bf16 " + json.dumps(bf))
    rep.say(f"26a bf16 (the facade's card default): {handled} visits "
            f"handled of {bf['n_visits']}, {cnt['duplicate_faces']} "
            f"duplicates, {cnt['processed']} processed; "
            f"{1e3 * bf_s / n:.1f} ms a visit")
    return dict(f32=card, cpu=cpu, bf16=bf, tie=tie)


JAX_LINE_KEYS = (
    ({"curve", "step", "value", "loss", "elapsed_s"}, "decisions_det_ap50"),
    ({"stage", "scenes", "detector_hit_rate"}, "extract_aligned"),
    ({"curve", "step", "unseen_val", "seen"}, "decisions_verification"),
    ({"stage", "best_step", "best_unseen_val"}, "model_selection"))


def hold_line_keys(lines):
    """Each of the trainers' JSON lines carries the JAX tool's keys for its
    kind (a curve point past step 0 also its loss and elapsed_s)."""
    for line in lines:
        d = json.loads(line)
        kind = d.get("curve", d.get("stage"))
        want = next((k for k, name in JAX_LINE_KEYS if name == kind), None)
        if want is None:
            fail(f"26b a line of no JAX kind: {line}")
        if kind == "decisions_verification" and d["step"] > 0:
            want = want | {"loss", "elapsed_s"}
        if not want <= set(d):
            fail(f"26b the line lacks the JAX tool's {sorted(want - set(d))}"
                 f": {line}")


def tree_equal(a, b):
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(tree_equal(a[k], b[k]) for k in a))
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def decisions_train(torch, rep, data, trees, tmp):
    """26b: both trainers for a few steps at full width from the committed
    weights, the JAX tool's line keys, the checkpoints saved under build/
    and read back bit for bit, and eval from the files equal to eval from
    the trees (f32, TF32 off)."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        exp_decisions as xd)

    c = DECISIONS["train"]
    crops, _, train_ids, val_ids = data
    lines = []
    t = time.perf_counter()
    det_vars, det_curve = xd.train_detector(
        crops, train_ids, c["det_steps"], batch=c["det_batch"],
        seed=DECISIONS["seed"], eval_every=c["eval_every"], log=lines.append,
        device=DEV, init_variables=trees[0])
    det_s = time.perf_counter() - t
    t = time.perf_counter()
    emb_vars, emb_curve, best = xd.train_embedder(
        det_vars, crops, train_ids, val_ids, c["emb_steps"],
        batch=c["emb_batch"], per_id=c["per_id"], seed=DECISIONS["seed"],
        eval_every=c["eval_every"], log=lines.append, device=DEV,
        init_variables=trees[1])
    emb_s = time.perf_counter() - t
    for line in lines:
        rep.say("26b " + line)
    hold_line_keys(lines)
    ms = {}
    for line in map(json.loads, lines):
        if "ms_step" in line:
            ms[line["curve"]] = line["ms_step"]
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "smoke", "decisions")
    xd.save_checkpoints(det_vars, emb_vars, dict(best_step=best["step"]),
                        out)
    det_back, emb_back, meta = xd.load_checkpoints(out)
    if not (tree_equal(det_back, det_vars) and tree_equal(emb_back, emb_vars)
            and meta == dict(best_step=best["step"])):
        fail(f"26b the checkpoints read back from {out} differ from the "
             f"trained trees")
    with full_f32(torch):
        mem = decision_eval_run(torch, (det_vars, emb_vars), data,
                                os.path.join(tmp, "b_trees"), xd.build_app(
                                    det_vars, emb_vars, device=DEV,
                                    dtype=torch.float32))[0]
        back = decision_eval_run(torch, (det_back, emb_back), data,
                                 os.path.join(tmp, "b_files"), xd.build_app(
                                     det_back, emb_back, device=DEV,
                                     dtype=torch.float32))[0]
    mem.pop("elapsed_s")
    back.pop("elapsed_s")
    d = record_diff(back, mem, 0.0, "eval")
    if d:
        fail(f"26b eval from the saved checkpoints differs from eval from "
             f"the trees: {d}")
    rep.say(f"26b det_500m {c['det_steps']} steps at batch {c['det_batch']} "
            f"from the committed weights: AP@0.5 {det_curve}, "
            f"{ms['decisions_det_ap50']:.1f} ms a step, {det_s:.1f} s; "
            f"w600k_mbf {c['emb_steps']} steps at batch {c['emb_batch']}: "
            f"unseen / seen accuracy {[list(x) for x in emb_curve]}, best "
            f"step {best['step']}, {ms['decisions_verification']:.1f} ms a "
            f"step, {emb_s:.1f} s; saved to build/, read back bit for bit, "
            f"eval from the files equal to eval from the trees (grouping "
            f"{mem['grouping']}, verification {mem['verification']})")
    return dict(det_ms=ms["decisions_det_ap50"],
                emb_ms=ms["decisions_verification"], eval=mem)


def decisions_replay(torch, rep, data, tmp):
    """26c: ``tools.replay_visits.run`` with the tool's default models
    (det_10g + w600k_r50 at the facade's seeded init, bf16 on the card)
    over a synthetic visits JSON, some of its URLs missing from the
    in-memory md5(url) cache."""
    from scrfd_arcface_facerecognition_tpu_torch.apps import FaceAnalysis
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        exp_decisions as xd, replay_visits as rv)

    c = DECISIONS["replay"]
    crops = data[0]
    rng = np.random.default_rng(DECISIONS["seed"] + 5)
    misses = set(rng.choice(c["visits"], size=c["misses"],
                            replace=False).tolist())
    visits, cache = [], {}
    for i in range(c["visits"]):
        url = f"http://replay/visit{i:03d}.jpg"
        visits.append({"id": f"r{i:03d}", "customerId": f"cust{i:03d}",
                       "entryTime": "2026-08-19T12:00:00", "image": url})
        if i not in misses:
            cache[rv.cache_name(url)] = xd.make_scene(
                rng, crops[i % len(crops)])[0]

    def loader(source, save_path=None, timeout=30):
        return cache.get(rv.cache_name(source))

    app = FaceAnalysis(det_variant=c["det"], rec_variant=c["rec"], seed=0,
                       device=DEV)
    app.prepare(det_size=c["det_size"])
    out = rv.run({"visits": visits}, app, loader, os.path.join(tmp, "c"))
    engine = out.pop("engine")
    res = out["results"]
    persons = engine.db.stats()["total_persons"]
    rep.say("26c " + json.dumps(out))
    if out["visits_handled"] != c["visits"]:
        fail(f"26c {out['visits_handled']} visits handled of {c['visits']}")
    if res["download_failed"] != c["misses"]:
        fail(f"26c {res['download_failed']} downloads failed, not the "
             f"{c['misses']} visits missing from the cache")
    if res["processed"] != res["recognized"] + res["new_persons"]:
        fail(f"26c processed {res['processed']} != recognized "
             f"{res['recognized']} + new persons {res['new_persons']}")
    if persons != res["new_persons"]:
        fail(f"26c {persons} persons in SQLite, {res['new_persons']} new")
    rep.say(f"26c {c['det']} + {c['rec']} (seeded) at {app.dtype}: "
            f"{c['visits']} visits ({c['misses']} missing from the cache) at "
            f"{out['visits_per_sec']} visits/s; {persons} persons in SQLite "
            f"= new persons")
    return out


def phase_decisions(torch, rep):
    """26: the decision tools on the card, K1 counted over (a)-(c) and held
    to its plain version on the card's inputs; an ERROR the port logs
    fails the phase."""
    import tempfile

    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        exp_decisions as xd)

    t0 = time.perf_counter()
    data = decision_data()
    trees = xd.load_checkpoints()[:2]
    out, secs = {}, {}
    with tempfile.TemporaryDirectory() as tmp, port_log("26") as _, \
            captured_calls(ops, "warp_align_crops", key=lambda a: (
                tuple(a[0].shape), str(a[0].device))) as calls:
        wa.launches = 0
        for part, run in (
                ("a", lambda: decisions_eval(torch, rep, data, trees, tmp)),
                ("b", lambda: decisions_train(torch, rep, data, trees, tmp)),
                ("c", lambda: decisions_replay(torch, rep, data, tmp))):
            t = time.perf_counter()
            out[part] = run()
            secs[part] = time.perf_counter() - t
        launches = wa.launches
    if launches <= 0:
        fail("26 the decision tools launched K1 no time")
    dev = torch.device(DEV).type
    err, what = k1_on_path(torch, wa, [c for c in calls
                                       if c[0].device.type == dev])
    rep.say(f"26 K1 {launches} launches over (a)-(c), vs plain on the "
            f"card's inputs, {what}: max abs err {err:.6g} u8 (tolerance "
            f"{TOL_U8})")
    rep.say(f"phase 26 took {time.perf_counter() - t0:.1f} s: "
            + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()))
    return dict(launches=launches, err=err, out=out, secs=secs)


# ---------------------------------------------------------------------
# the phases a call runs: phases 1 (the toolchain and the card) and 2 (the
# build) always; --phases picks among 3-26, each with the earlier phases
# whose results it takes (PHASE_NEEDS)

PHASE_NUMBERS = tuple(range(3, 27))
PHASE_NEEDS = {5: (4,), 7: (4,), 8: (7,), 15: (13,), 16: (15,), 17: (12,),
               20: (7,), 21: (18, 19), 24: (13,)}


def parse_phases(text):
    """"1-4,26" -> {1, 2, 3, 4, 26}; a phase outside 1-26, an empty item
    or a backward range raises."""
    out = set()
    for item in text.split(","):
        item = item.strip()
        lo, sep, hi = item.partition("-")
        try:
            a = int(lo)
            b = int(hi) if sep else a
        except ValueError:
            raise ValueError(f"--phases: {item!r} is not a phase or a "
                             f"range of phases") from None
        if not 1 <= a <= b <= PHASE_NUMBERS[-1]:
            raise ValueError(f"--phases: {item!r} is not within 1-"
                             f"{PHASE_NUMBERS[-1]}")
        out.update(range(a, b + 1))
    return out


def resolve_phases(selected):
    """The phases to run, in order, for a selection: each selected phase
    and every phase it needs, transitively. Returns (phases, the ones
    added for a need, {added phase: the phase that needs it})."""
    want = {p for p in selected if p >= 3}
    why = {}
    todo = sorted(want)
    while todo:
        p = todo.pop()
        for need in PHASE_NEEDS.get(p, ()):
            if need not in want:
                want.add(need)
                why[need] = p
                todo.append(need)
    added = sorted(set(why))
    return sorted(want), added, why


def parse_args(argv):
    import argparse

    ap = argparse.ArgumentParser(
        description="Smoke run of the PyTorch port on one CUDA card.")
    ap.add_argument("--phases", default=None, metavar="LIST",
                    help="phases to run, e.g. 1-4,26 (default: all); the "
                         "phases a selected one needs run with it")
    ap.add_argument("--full-scale", action="store_true",
                    help="phase 23 at the tools' defaults "
                         "(GALLERY_SCALE_FULL); alone it runs phase 23 only")
    args = ap.parse_args(argv)
    if args.phases is not None:
        try:
            selected = parse_phases(args.phases)
        except ValueError as e:
            ap.error(str(e))
    elif args.full_scale:
        selected = {23}
    else:
        selected = set(PHASE_NUMBERS)
    if args.full_scale:
        selected.add(23)
    return args, selected


def kernel_rows(torch, wa, pq_adc, r):
    """The kernels line from the phases' results ``r`` (phase -> result):
    K1 from phases 3, 4, 11-26, K2 from 6, 7, 12, 17, 20 and 23, K3 from 9
    and 11, K4 from 10. A kernel is listed when the phase that times it
    ran (K1 4, K2 7, K3 9, K4 10), with the launches and errors of the
    phases that ran."""
    def got(p, fn, default=0):
        return fn(r[p]) if p in r else default

    k1_launches = (got(4, lambda v: v["launches"])
                   + sum(got(p, lambda v: v["launches"])
                         for p in (13, 14, 15, 16, 18, 19, 21, 22, 24, 25,
                                   26))
                   + got(17, lambda v: v["k1"]) + got(20, lambda v: v["k1"]))
    k1_err = max([got(3, lambda v: v), got(4, lambda v: v["err"]),
                  got(11, lambda v: v["err1"]),
                  got(12, lambda v: max(v["fa"]["err"], v["eng"]["err"])),
                  got(17, lambda v: v["err1"]), got(20, lambda v: v["err1"])]
                 + [got(p, lambda v: v["err"])
                    for p in (13, 14, 15, 16, 18, 19, 21, 22, 24, 25, 26)])
    k2_launches = (got(7, lambda v: v["launches"])
                   + got(17, lambda v: v["k2"]) + got(20, lambda v: v["k2"])
                   + got(23, lambda v: v["launches"]))
    k2_err = max(got(6, lambda v: v), got(7, lambda v: v["err"]),
                 got(12, lambda v: v["eng_pq"]["err"]),
                 got(17, lambda v: v["err2"]), got(20, lambda v: v["err2"]),
                 got(23, lambda v: v["err"]))

    def times(t):
        return {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")}

    rows = []
    if 4 in r:
        rows.append({
            "name": wa.NAME, "route": "cuda",
            "source": "scrfd_arcface_facerecognition_tpu_torch/csrc/"
                      "warp_align.cu",
            "replaces": "scrfd_arcface_facerecognition_tpu/ops/"
                        "pallas_warp.py:430",
            "launches": k1_launches, "max_abs_err": k1_err,
            **times(r[4]["t"])})
    if 7 in r:
        # phase 23 (23e) times the fused top-k at the lookup cell's shape:
        # its time, the plain chain's, its own bound and K2 + mask + sort
        # (``library_ms``: the sort is torch's)
        topk = got(23, lambda v: {
            "topk": dict(times(v["topk"]), shape=v["topk"]["shape"])}, {})
        rows.append({
            "name": pq_adc.NAME, "route": "cuda",
            "source": "scrfd_arcface_facerecognition_tpu_torch/csrc/"
                      "pq_adc.cu",
            "replaces": "scrfd_arcface_facerecognition_tpu/gallery/pq.py:302",
            "launches": k2_launches, "max_abs_err": k2_err,
            **times(r[7]["times"]), **topk})
    if 9 in r:
        k3 = r[9]
        rows.append({
            "name": "warp_band", "route": "cuda",
            "source": "scrfd_arcface_facerecognition_tpu_torch/csrc/"
                      "warp_band.cu",
            "replaces": "tools/exp_warp2.py:188",
            "launches": k3["launches"],
            "max_abs_err": max(k3["err"], got(11, lambda v: v["err"])),
            **times(dict(k3, library_ms=None))})
    if 10 in r:
        k4 = r[10]
        rows.append({
            "name": "conv3x3", "route": "cuda",
            "source": "scrfd_arcface_facerecognition_tpu_torch/csrc/"
                      "conv3x3.cu",
            "replaces": "tools/exp_pallas_conv.py:110",
            "launches": k4["launches"], "max_abs_err": k4["err"],
            **times(k4)})
    return rows


def main(argv=None):
    import torch

    args, selected = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from scrfd_arcface_facerecognition_tpu_torch import cuda_build
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq_adc
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    global GALLERY_SCALE
    if args.full_scale:
        GALLERY_SCALE = GALLERY_SCALE_FULL
    phases, added, why = resolve_phases(selected)
    t_start = time.perf_counter()
    card = card_line()
    rep = Report(card)
    # 1. toolchain
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    print("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    try:
        import triton
        print(f"triton {triton.__version__} imports")
    except ImportError:
        print("triton does not import")
    print(f"card: {card}")
    print("phases: 1, 2, " + ", ".join(map(str, phases))
          + "".join(f"; {p} runs for {why[p]}" for p in added)
          + ("; phase 23 at full scale" if args.full_scale else ""))

    # 2. build
    secs = cuda_build.build_all()
    rep.say("built " + ", ".join(f"{n} in {s:.2f} s" for n, s in secs.items())
            + " (nvcc, sm_90a)")

    r = {}

    def facade_and_engines():
        app, fa = phase_facade(torch, rep)
        phase_microbatch(torch, rep, app)
        eng = phase_engine(torch, rep, app)
        eng_pq = phase_engine_pq(torch, rep)
        ver = phase_verification(torch, rep, app)
        return dict(app=app, fa=fa, eng=eng, eng_pq=eng_pq, ver=ver)

    def main_path():
        launches, err, t, emb = phase_main_path(torch, rep)
        return dict(launches=launches, err=err, t=t, emb=emb)

    def card_vs_cpu():
        with full_f32(torch):       # TF32 off for this phase only
            phase_card_vs_cpu(torch, rep)

    def bf16():
        out = phase_bf16_bench(torch, rep)
        phase_bf16_checkpoints(torch, rep)
        return out

    steps = {
        3: lambda: phase_kernel_vs_plain(torch, wa, rep),
        4: main_path,
        5: card_vs_cpu,
        6: lambda: phase_k2_vs_plain(torch, pq_adc, rep),
        7: lambda: phase_gallery_path(torch, rep, r[4]["emb"]),
        8: lambda: phase_gallery_card_vs_cpu(
            torch, rep, r[7]["codec"], r[7]["rows"], r[7]["ids"],
            r[7]["queries"]),
        9: lambda: phase_k3(torch, rep),
        10: lambda: phase_k4(torch, rep),
        11: lambda: phase_standin_path(torch, rep),
        12: facade_and_engines,
        13: bf16,
        14: lambda: phase_realtime(torch, rep),
        15: lambda: phase_onnx_exec(torch, rep, r[13]["bench"]),
        16: lambda: phase_camera_apps(torch, rep, r[15]["paths"]),
        17: lambda: phase_web(torch, rep, r[12]["app"], dict(
            ms_visit=r[12]["eng"]["ms_visit"],
            ms_pair=r[12]["ver"]["ms_pair"])),
        18: lambda: phase_train(torch, rep),
        19: lambda: phase_det_train(torch, rep),
        20: lambda: phase_parallel(torch, rep, r[7]),
        21: lambda: phase_train_mesh(torch, rep, dict(
            arcface=r[18]["full"][False]["ms"], det=r[19]["full"]["ms"])),
        22: lambda: phase_signoff(torch, rep),
        23: lambda: phase_gallery_scale(torch, rep),
        24: lambda: phase_host_and_learning(
            torch, rep, r[13]["bench"]["frames_per_sec"]),
        25: lambda: phase_measure_tools(torch, rep),
        26: lambda: phase_decisions(torch, rep),
    }
    for p in phases:
        t = time.perf_counter()
        r[p] = steps[p]()
        rep.say(f"phase {p} took {time.perf_counter() - t:.1f} s (script at "
                f"{time.perf_counter() - t_start:.1f} s)")

    # the kernels
    kernels = kernel_rows(torch, wa, pq_adc, r)
    rep.say(f"chip_smoke done in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
