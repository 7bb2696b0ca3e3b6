#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths with the flagship SPT-2 semantic model
(S3DIS, bf16 compute, random weights from a seed), then nano-2 and SPT-3
on the other datasets' readers, and checks every CUDA kernel on them
against its plain PyTorch version:

1. prints the card, its power limit and the toolchain;
2. builds the kernels from the sources in this checkout, one nvcc each,
   all at once (timed);
3. compares each kernel with its plain version on the card, at the
   shapes the main paths give it and at a wide K (160) and a K off the
   kernels' 16-slot tiles (50), in f32 and bf16: K1 (dense attention) in
   both query layouts and its backward, K2 (fused-RPE attention), K3
   (K2's backward) against autograd of K2's plain version (in f64 for
   the f32 kernel) and, in bf16, against K3's plain version; times each
   kernel against its plain version as CUDA-graph replays (so that the
   host's launch cost is not counted), and K1 with a per-node query
   against SDPA, the one PyTorch call that computes it (a yardstick the
   port never calls); and GN (GraphNorm's forward without gradients,
   `ops/graph_norm.py`: three launches a call) at a DALES request's
   level 0 (1.4M x 128) and the S3DIS level-1 edge MLP (2.0M x 32),
   bf16 with the LeakyReLU, run twice (bit-equal) and held to
   GraphNorm's PyTorch path (`GraphNorm._plain`) on the same values in
   f32 and bf16, timed against it (CUDA events), each of its kernels
   profiled, and its share of two bytes bounds;
4. serving: answers three requests at the "demo room x8" size through
   `infer_batch`, counting K2 launches (7 per forward) and GN's (20),
   holds GN on its widest call there, checks the logits and
   predictions, runs the forward twice (bit-equal logits), compares the
   logits with the same model on the plain attention, and times the
   forward;
5. training: the flagship `SemanticTask` takes three AdamW steps on
   4-graph batches at about the 4-crop training caps, counting K1
   launches (7 per step) and GN's (none: gradients keep GraphNorm's
   PyTorch path), checks the losses, that the parameters moved,
   one step run twice (bit-equal loss and gradients) and against the
   same model on the plain attention; and times the step with K1 and
   with the plain attention;
6. the fused-RPE training route, `dense_attention_rpe_trainable` (K2
   forward, K3 backward) at the level-1 training shape, counting K3
   launches, and timed against the route the model takes in training
   (materialized RPE + K1);
7. the host path on preprocessed synthetic rooms: builds the C++ host
   library from `native/*.cpp` (beside the kernels, step 2),
   preprocesses 4 raw rooms of 250k points with `preprocess_cloud`,
   serves one 8-graph batch (each room twice) through `prepare_batch`,
   `from_numpy` and `infer_batch` and one raw room through
   `e2e_inference` (K2, no plain attention), checks the logits, the
   labels of every raw point and the level-1 NAG order, takes 3 flagship
   train steps (K1) on 4-graph `prepare_batch(train=True)` batches with
   caps pinned by `discover_caps`, holds K2 and K1 against their plain
   versions on the inputs of their level-1 launches there, and times the
   forward and the step on these batches beside `random_padded_nag` at
   the same node counts; then whole-cloud serving on these rooms
   (`phase_whole_cloud`, a path of its own): `voxelize_device` against
   the host grouping of the same cells, the device KNN against the same
   function on CPU tensors (ids equal) and against the native host KNN
   (recall; both timed in s per 1M raw points), `geometric_features` on
   the card against `geometric_features_np`, `preprocess_cloud` and
   `e2e_inference` with `knn_backend='device'` (K2 alone, every raw point
   labelled), `infer_nags_stacked` over the 4 rooms bit-equal to the
   per-tile `infer_nag` loop and to itself, timed against it in turns,
   with the device-to-host synchronizations of each counted
   (`torch.cuda.set_sync_debug_mode`), K2 held against its plain
   version on the stacked chunk's last tile (views at a non-zero offset
   into the stacked tensors), a flagship reference-checkpoint round trip
   (`import_reference_checkpoint`: bit-equal logits), the 4 rooms
   preprocessed with the device KNN one by one and over 4 spawned
   workers that see the card (the same nodes), and with the host KNN
   over 4 workers that see none, each timed, `device_memory_stats`,
   and `e2e_inference`'s preprocess phase in 3 pairs of fresh processes
   with the host allocator tuned and with SPT_NO_MALLOC_TUNING=1, in
   alternating order; then the multi-process paths of `parallel/`
   (`phase_parallel`), two spawned ranks that share the card over gloo
   (a correctness run: NCCL refuses two ranks on one device), the
   kernels built before they start: data-parallel, one flagship step on
   the training phase's first two batches, bit-equal to the
   single-process step that sums and halves their gradients and to its
   rerun (7 K1 launches a rank, K1 held on its widest launch there);
   graph-sharded, room 0 split over the ranks by `shard_padded_nag`, the
   sharded forward in f32 and bf16 against the unsharded forward (7 K2
   launches a rank, K2 held on its widest launch there) and a sharded
   train step in each against the unsharded step (loss, gradients,
   confusion matrix, update); the DP step, the sharded forward and a
   level-1 block's `all_gather_rows` timed a rank; then the SPT options
   that no config sets (`phase_variants`, a path of its own), at SPT-2's
   full width: the variant models of VARIANTS (an RPE variant with a
   query per edge and post-norm layer norms; no edge features with the
   attentive pool, residual fusions, batch norms and every dropout; key
   RPE alone with instance and group norms and min pooling) served on K1
   (7 launches a forward) and stepped (7, or none where attention
   dropout takes JAX's materialized route), each against the plain
   attention in f32 and bf16 and twice bit-equal (dropout reseeded), K1
   held on its widest per-node and per-edge launches and timed on the
   per-node one; EZ-SP semantic (the point CNN into and beside the point
   MLP) on the host path's rooms with `quantize_coordinates` coords,
   served on K2 and stepped on K1 likewise, its reference-keyed state
   dict imported with strict=True to bit-equal logits; the flagship
   forward's and step's model FLOPs (`utils/flops.py`), equal with the
   kernels and with the plain attention, and their mfu in bf16;
8. SuperCluster panoptic segmentation (`experiment=panoptic/s3dis`,
   SPT-2 width, random weights): 2 synthetic rooms of 250k raw points
   with instance ids through `preprocess_cloud(with_instances=True)`;
   `validate_panoptic` in bf16 over 2 batches of 4 graphs (each room
   twice) with the grid search on the first (K2, 7 launches per
   `eval_step`; finite level-1 and edge-affinity logits; PQ, SQ, RQ and
   mAP in [0, 100]); one f32 evaluation held to the plain attention; the
   same partition and metrics on ground-truth inputs, whose PQ must be
   above the random weights'; 3 `PanopticTask` train steps (K1, 7 a
   step; finite losses; the parameters and the edge-affinity head move)
   and one step held to the plain attention in f32 and bf16; times of
   each, the host's partition and grid search included; then the rest
   of the JAX package's surface (`phase_rest`), three paths of their
   own at SPT-2's full width: Delaunay serving (a host-path raw room
   through `preprocess_cloud(graph_builder='delaunay')`, whose degree is
   not capped, so K2 takes its widest K yet, K=160 at level 1; served
   through `infer_batch`, 7 K2 launches, K2 held on its widest launch,
   the logits held to the plain attention in f32 and bf16 and run twice
   bit-equal), held-out (`split_nag_spatially` of host-path room 0, then
   `run_heldout` for 3 steps of 4 crops: 7 K1 launches a step, 7 K2 for
   the evaluation; finite losses, mIoU in [0, 100], OA at most the
   partition oracle's) and the SuperCluster demo
   (`run_supercluster_demo` on panoptic room 0 for 2 steps of 2 crops,
   pseudo-instances, the grid search and the cross-oracle PQs: 7 K1 a
   step, 7 K2 for each of its 2 evaluations; pseudo-instances found, PQ,
   SQ and RQ in [0, 100]), K1 and K2 held on their widest launches of
   the last two, each part timed; then the long-tail functions
   (`phase_long_tail`, a path of its own, on the host path's room 0):
   `inliers` and `outliers` on level 0, a seeded `is_val` split of level
   1 by `select_by_key`, `shuffle` and `select_columns`; 2 flagship train
   steps on 4 `sample_khop_subgraphs` crops of the train half with
   `dropout_rows` / `dropout_columns` on `x` (7 K1 a step); 3 TTA runs of
   k-hop crops of the val half with `random_axis_flip` through
   `eval_step` (7 K2 a run), summed by `tta_accumulate` (seen and unseen
   val nodes, every one predicted, seen sums exact), held to the plain
   attention in f32 and bf16, `predict` and the `fused_rpe=False` route
   (K1's forward) checked; `confusion_matrix_update` on the card equal
   to the one-hot histogram update; K1 and K2 held on their widest
   launches there, each part timed;
9. fit and evaluate (`experiment=semantic/s3dis`'s datamodule, SPT-2,
   bf16): 5 synthetic rooms of 250k raw points written in the S3DIS
   `Annotations/*.txt` layout (training areas Area_1 and Area_2 with 2
   rooms each, the test area Area_5 with 1), read by the port's S3DIS
   reader and preprocessed into a dict (`MemoryS3DIS`); the port's
   `train(cfg, datasets)` for FIT_EPOCHS epochs with a validation each
   (K1 7 a step, K2 7 a validation forward, no plain attention), a
   resume from 'last' for one more epoch (the step, the LR and the epoch
   carry on; the loaded parameters and AdamW moments equal the saved
   ones), `evaluate(cfg, datasets)` from 'best' on the validation split
   twice (the same mIoU both times, within FIT_MIOU_TOL of the logged
   one) and on the test area with 2 TTA runs, and 2 micro-batches of
   `accumulate_grad_batches=2` held against one averaged AdamW step in
   f32, and `tune.main` (`phase_tune`: 2 trials of one epoch, each
   scored); holds K1 and K2 against their plain versions on the arguments of
   their widest launches on this path (the fit's training steps, the
   evaluations of the validation split); prints per epoch the host batch
   preparation, the steps (CUDA events), the validation and the wall
   time, and the device-busy share of the resumed epoch (its `fit` alone
   under torch.profiler, kernel time over the epoch's own wall time);
10. EZ-SP on the fit phase's rooms: stage 1, `train(cfg, datasets)`
   with `experiment=partition/s3dis_ezsp` (the sparse CNN at (32, 32,
   32) in f32, `fit_partition` for EZSP_STAGE1_EPOCHS epochs over the 2
   training areas at 50,000-voxel crops; its clouds are the fit phase's,
   same cache hash): finite losses that move, inter edges in every
   epoch, `last` and `best` written, no attention kernel launched; the
   host batch preparation and the step (CUDA events) per epoch; one
   crop's embeddings on the card (bit-equal in two runs) held to the
   same module and weights on the CPU. Stage 2,
   `experiment=semantic/s3dis_ezsp` with the stage-1
   `last` checkpoint: preprocessing with the frozen CNN on the card and
   the greedy contour-prior partition (per cloud: the CNN and the
   partition in s per 1M raw points beside the fit phase's cut pursuit,
   the node counts per level, the level 1 compressing; the level-1
   oracle mIoU of both partitions by `partition_purity`), the frozen CNN
   of one cloud on the card and on the CPU, then SPT-2 in bf16 for one
   epoch with its validation (K1 7 a step, K2 7 a forward, no plain
   attention) and `evaluate(cfg, datasets)` on the validation split; K1
   and K2 held against their plain versions on the arguments of their
   widest launches on this path, and the forward of one validation area
   timed;
11. nano-2 (`experiment=semantic/s3dis_nano`, `panoptic/s3dis_nano`:
   no level 0, 32 channels, 8 heads, bf16) on the fit phase's rooms,
   read from level 1 up with the nano datamodule: serves an 8-room batch
   through `prepare_batch(nano=True)` and `infer_batch` (3 requests, 7
   K2 launches each), its logits run twice (bit-equal) and held to the
   plain attention in f32 and bf16; 2 train steps on 4-room batches
   with the transpose tables (7 K1 each), one run twice (bit-equal) and
   held to the plain attention; one `PanopticTask` evaluation and train
   step on the panoptic phase's rooms; `train(cfg, datasets)` for one
   epoch of 2 steps, then `evaluate` from its checkpoint (its mIoU the
   logged one); K2 and K1 held to their plain versions on the arguments
   of their widest launches, and timed there against them (CUDA graph
   of 20 calls) with `kernel_cost`'s bound; the forward, request and
   step times;
12. SPT-3 (3 down stages of 3 blocks, 2 up stages of 1, 64 channels, 16
   heads, bf16; 11 K1 launches a step, 11 K2 a forward) on the DALES,
   KITTI-360 and ScanNet readers, over synthetic raw files that the
   port's writers put in each format, each dataset a path of its own:
   dales (`experiment=semantic/dales`, MiniDALES's 6 tiles of 200k
   points): `train(cfg, datasets)` for 2 epochs, `evaluate` from its
   checkpoint (its mIoU the logged one), a 4-tile batch through
   `infer_batch` (3 requests; 30 GN launches a forward, GN held on its
   widest call), a raw tile through `e2e_inference`, the
   4 tiles through `infer_nags_stacked` (twice) bit-equal to the
   per-tile `infer_nag` loop, the forward and a step timed, K1 and K2
   held and timed on the
   arguments of their widest launches; kitti360 (`semantic/kitti360`, a
   window of 200k points each for train and val): 1 epoch and
   `evaluate`; scannet (`panoptic/scannet`, a scan of 100k vertices each
   for train and val, instances from the aggregation files):
   `validate_panoptic` of the validation scan with its grid search and
   a `PanopticTask` step. On each path the logits of an evaluation batch
   and a training step's loss and gradients are held to the plain
   attention in f32 and bf16 at fixed limits, each run twice bit-equal,
   and K1's backward on its widest launch (random cotangent);
13. prints the kernel table as JSON (per kernel: its launches over every
   path and by path, max abs error, ms, plain_ms, library_ms, the bound
   from the bytes and FLOPs of `kernel_cost` and which of the two sets
   it, and the share of the bound reached; for K1 and K2 the same at
   nano's shapes and at SPT-3's, `spt3`; for GN the bytes bounds of
   `gn_bound`, strict and two-pass, at DALES level 0 and at the S3DIS
   edges, `s3dis_edges`, and its launches by phase, timings and checks
   included), the card line, and as the last line
   `{"ok": true, "device": {...}}`.

Every model run on the card repeats itself bit for bit: each phase that
compares the kernels with the plain attention first checks that the
kernel model, run twice, gives equal logits, losses, gradients or
embeddings, then holds the difference to a fixed limit. Each of the
paths 4-12 runs with the kernel counts set to 0 just before it and read
just after it. Any failed phase raises, so the script exits
non-zero without printing the last line. It needs no network and fails
without a CUDA device or outside a checkout of the repository.
"""
import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
NUM_GRAPHS = 8
# per graph: one S3DIS demo room after preprocessing
ROOM = dict(n_points=41_500, n_l1=1_250, n_l2=350)
FLAGSHIP_PARAMS = 213_434         # the JAX model's count (CPU-tested)
K2_LAUNCHES_PER_FORWARD = 7       # 3 + 3 down blocks, 1 up block
K1_LAUNCHES_PER_STEP = 7          # the same blocks, in training
# training batches: 4 graphs of about one 4-crop training cap each
# (5.1k level-1 and 2k level-2 nodes over the 4 crops)
TRAIN_GRAPHS = 4
CROP = dict(n_points=41_000, n_l1=1_280, n_l2=500)
TRAIN_STEPS = 3
# the flagship attention at level 1 of a training batch
TRAIN_L1 = dict(N=5_120, K=48, H=16, D=4, C=64, De=32)
# kernel vs plain version: the JAX kernel tests' own tolerances; both
# compute in f32 from the same inputs, in another summation order
K1_RTOL, K1_ATOL = 3e-5, 3e-5
K2_RTOL, K2_ATOL = 2e-4, 2e-5
K3_RTOL, K3_ATOL = 2e-3, 2e-4
# GraphNorm's kernels (GN, `ops/graph_norm.py`) at the serving forwards'
# widest norms, (nodes, channels, graphs, slots a node): level 0 of a
# DALES request (8 tiles of ~173k points, the point MLP), 5% padded, and
# the S3DIS level-1 edge MLP (41.6k nodes x 48 slots, ~60% valid); bf16
GN_SHAPES = {'dales_level0': (1_400_000, 128, 8, 1),
             's3dis_edges': (41_600, 32, 8, 48)}
# GN against GraphNorm's PyTorch path on the same values in f32, rounded
# once to x's dtype: in bf16 one rounding step (2^-7 relative at most) of
# the output or of the O(1) terms x * scale and shift that cancel into a
# small one (tests/test_torch_cuda.py's GN_TOL); in f32 the order of the
# f32 sums over up to ~175k rows a graph, which the variance's
# cancellation against a graph's mean (up to ~17x its spread) amplifies
# (2.7e-4 between the two PyTorch versions at 2.5k rows a graph on a CPU)
GN_TOL = {'bfloat16': (2 ** -7, 2 ** -7), 'float32': (1e-3, 1e-3)}
# GraphNorm forwards: every norm of SPT-2's MLPs and blocks, and SPT-3's
GN_PER_SPT2_FORWARD = 20
GN_PER_SPT3_FORWARD = 30
# gradients written in bf16 by both sides from the same f32 math: one
# rounding step (2^-8 relative) may separate them
BF16_GRAD_RTOL, BF16_GRAD_ATOL = 1.6e-2, 1e-3
# Every model-level run on the card repeats itself bit for bit (the
# float segment sums are a one-hot contraction or a sorted reduction, the
# attention's k/v gathers differentiate over the transpose neighbor
# table): each check below runs the kernel model twice and requires
# equal logits, losses, gradients and embeddings. The kernels then differ
# from the plain attention only by the kernels' own rounding, which the
# random-weight network amplifies; the fixed limits below are each no
# looser than the limit that the same check computed from the run-to-run
# spread before (the parent's run on an H100 80GB HBM3, 700 W).
#
# one training step, kernel vs plain attention: (loss relative,
# gradients relative L2) by path and compute dtype. In bf16 the limit also
# covers a difference by design: K1's closed-form backward computes in
# f32 where autograd through the plain version rounds its intermediate
# gradients to bf16, which alone puts the two 1.5e-2 apart on a small
# flagship-width batch on the CPU. The parent's limits on the flagship
# step: (1.103e-4, 2.144e-2) in f32, (2.205e-3, 0.300) in bf16; on the
# panoptic step (1.107e-4, 7.72e-3) and (2.162e-3, 0.1516).
TRAIN_TOL = {('flagship', None): (1e-4, 2e-2),
             ('flagship', 'bfloat16'): (2e-3, 0.25),
             ('panoptic', None): (1e-4, 7.5e-3),
             ('panoptic', 'bfloat16'): (2e-3, 0.15),
             ('nano', None): (1e-4, 2e-2),
             ('nano', 'bfloat16'): (2e-3, 0.25),
             # SPT-3 on the dataset paths (the weights of SEED), set from
             # `tools/spt3_bf16_step_cuda.py` over weight seeds 0-3 (an
             # H100 80GB HBM3 at 700 W). f32: the kernels' step read
             # 5.2e-6-7.9e-5 (dales, kitti360) and 1.3e-6-1.39e-3
             # (scannet) from the plain attention's, where scaling K1's dk
             # by 1.01 moves it 1.18e-2-2.13e-2 and 3.2e-3-3.9e-3. bf16:
             # the kernels' step read 0.273-0.453 / 0.087-0.658 /
             # 0.065-0.091 (loss 5e-5-5.35e-3) from the plain attention's.
             # That is rounding: with the same forward, K1's closed-form
             # backward lies 0.007-0.036 from autograd through the plain
             # version, and moving the plain attention's f32 output by one
             # unit in the last place moves its bf16 step 0.025-1.04. The
             # bf16 limits sit above every reading of the kernels.
             ('dales', None): (1e-4, 5e-3),
             ('dales', 'bfloat16'): (1e-2, 0.75),
             ('kitti360', None): (1e-4, 5e-3),
             ('kitti360', 'bfloat16'): (1e-2, 0.75),
             ('scannet', None): (1e-4, 2.5e-3),
             ('scannet', 'bfloat16'): (2e-3, 0.15),
             # the variant and EZ-SP SPTs (`phase_variants`): the
             # flagship's limits
             ('variants', None): (1e-4, 2e-2),
             ('variants', 'bfloat16'): (2e-3, 0.25),
             ('ezsp', None): (1e-4, 2e-2),
             ('ezsp', 'bfloat16'): (2e-3, 0.25)}
# whole model, kernel vs plain attention: in f32 the largest logit
# difference and the argmax agreement (the parent's floor: the run-twice
# agreement less 0.001, 0.99829-0.99890 on the flagship levels); in bf16
# the mean logit difference (the parent's limit: twice the run-twice mean
# plus 1e-3, 5.818e-2 and 6.722e-2) and the argmax agreement
F32_LOGIT_MAX_ABS = 5e-2
F32_ARGMAX_AGREEMENT = 0.999
BF16_LOGIT_MEAN_MAX = 5e-2
BF16_ARGMAX_AGREEMENT = 0.95
# the graph-sharded path (room 0 over two ranks) against the unsharded
# forward and train step of the same NAG, set from its readings on an
# H100 80GB HBM3 at 700 W with room on both sides: f32 level-1 logits
# 2.365e-4 max abs; bf16 logits 1.642e-2 mean, argmax agreement 0.99317;
# the bf16 step's confusion matrix off by 0.94% of the label mass. The
# sharded run sums the norm statistics and pools in another order, which
# moves the f32 logits by the reading above and flips bf16 roundings, so
# bf16 cannot hold the run-twice agreement (1.0, bit-equal); the serving
# phase's bf16 kernel-vs-plain agreement on the same model reads
# 0.98943-0.99223.
SHARDED_F32_LOGIT_MAX_ABS = 2e-3
SHARDED_BF16_LOGIT_MEAN_MAX = 3e-2
SHARDED_BF16_ARGMAX_AGREEMENT = 0.98
SHARDED_BF16_CONFMAT_OFF = 2e-2
# the multi-process phase: two ranks that share the card over gloo, each
# rank's result within PARALLEL_TIMEOUT s; steps and forwards timed over
# PARALLEL_ROUNDS calls; the search's trials
PARALLEL_RANKS = 2
PARALLEL_TIMEOUT = 300
PARALLEL_ROUNDS = 3
TUNE_TRIALS = 2
# the H100 SXM's published peaks (data sheet, dense): device memory, bf16
# on the tensor cores, f32 outside them. Every bound below is against
# them, beside the power limit that the card line prints.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12
# the yardstick SDPA call returns bf16: it may differ from K1's f32
# output by the rounding of values up to ~4
SDPA_ATOL = 3e-2
# the host path: synthetic rooms (seeds SEED..SEED+3) of raw points, and
# the training batches that pin the caps
HOST_ROOMS = 4
HOST_ROOM_POINTS = 250_000
HOST_PROBES = 2
# whole-cloud serving on the host path's rooms: the flagship voxel size;
# voxel means (f32 sums of coordinates up to ~10 m) within 1e-5 m of the
# host's f64 means; the device KNN's recall of the host (native) KNN at
# the JAX test's bound, and its distances on the card within 1e-6 of the
# same function on CPU tensors (the same separately rounded f32 ops);
# the eigen features on the card within 1e-3 of the native kernel's (a
# CPU run of the same closed form reads <= 6.2e-5 on a synthetic room),
# and the normals, where the planarity exceeds 0.05, within |cos| 0.999
VOXEL = 0.03
VOXEL_MEAN_ATOL = 1e-5
KNN_RECALL_MIN = 0.99
KNN_DIST_RTOL = 1e-6
GEOF_ATOL = 1e-3
NORMAL_PLANARITY_MIN = 0.05
NORMAL_COS_MIN = 0.999
# SuperCluster (experiment=panoptic/s3dis): 2 synthetic rooms with
# instance ids, 2 evaluation batches and 3 training batches of 4 graphs
# (each room twice)
PANOPTIC_ROOMS = 2
PANOPTIC_GRAPHS = 4
PANOPTIC_EVAL_BATCHES = 2
PANOPTIC_STEPS = 3
# the oracle's logits: ground truth at this margin
ORACLE_LOGIT = 10.0
# the oracle's PQ reads 54.68 on these rooms on an H100, and 57.8 on a
# CPU on rooms of 30k raw points: a partition, merge or PQ that lost
# much of its quality falls below this floor
ORACLE_PQ_MIN = 45.0
# fit and evaluate: rooms of raw points per area (training areas, then
# the test area), epochs, and the evaluation's limit against the logged
# validation mIoU (the evaluation repeats the validation forward bit for
# bit; the two differ only in how the confusion matrix is summed)
FIT_AREAS = {'Area_1': 2, 'Area_2': 2, 'Area_5': 1}
FIT_ROOM_POINTS = 250_000
FIT_EPOCHS = 3
FIT_TTA_RUNS = 2
FIT_MIOU_TOL = 1e-4
# gradient accumulation: the mean of 2 micro-batch gradients as
# optax.MultiSteps forms it (acc + (g - acc) / 2) vs (g0 + g1) / 2 of
# the same, bit-equal, gradients: f32 rounding of the mean alone
ACCUM_GRAD_TOL = 1e-5
# EZ-SP (experiment=partition/s3dis_ezsp, then semantic/s3dis_ezsp) on the
# fit phase's rooms: stage-1 epochs over the 2 training areas, then one
# stage-2 epoch with its validation. Stage-1 embeddings on the card are
# held to the same module and weights on the CPU: both compute in f32 in
# another summation order, within a limit far above the f32 rounding of
# the embeddings (values up to ~25 after 2 epochs on a CPU rehearsal)
# and below any real difference (the parent's limit, from the card's run-
# to-run spread: 2.602e-4)
EZSP_STAGE1_EPOCHS = 2
# nano-2 (experiment=semantic/s3dis_nano): rooms in a serving batch (the
# fit phase's 2 training areas of 2 rooms, twice)
NANO_SERVE_ROOMS = 8
EZSP_STAGE2_EPOCHS = 1
EZSP_EMB_TOL = 2.5e-4
# SPT-3 (experiment=semantic/dales, semantic/kitti360 and panoptic/
# scannet: 3 down stages of 3 blocks, 2 up stages of 1, 64 channels, 16
# heads, bf16) on synthetic raw files in each dataset's format. DALES:
# MiniDALES's 6 tiles (2 train, 2 val, 2 test), each of 200k points over
# 80 m x 50 m, ~50 points/m2, DALES's density and the aerial generator's
# own; KITTI-360: a window each for train and val, the same generator at
# the same size, with colours; ScanNet: a scan each for train and val of
# 100k vertices, about a real scan's.
SPT3_LAUNCHES = 11
DALES_TILE_POINTS = 200_000
AERIAL_EXTENT = (80.0, 50.0)
DALES_EPOCHS = 2
DALES_SERVE_TILES = 4
KITTI360_WINDOW_POINTS = 200_000
KITTI360_EPOCHS = 1
SCANNET_SCAN_POINTS = 100_000
# the SPT options no config sets (`phase_variants`), on SPT-2 at full
# width (the flagship's spt_kwargs changed): A, a query RPE through the
# shared key encoder on the negated edge features, one RPE for all heads,
# the 'g' scale, post-norm layer norms; B, no edge features (no RPE: a
# query per node), the attentive pool over vertical edge features, residual
# fusions, batch norms, every dropout and DropPath; C, key RPE alone (a
# query per node), instance norms in the blocks and group norms in the
# MLPs, min pooling. B's random node features (VARIANT_HF channels at
# levels 1 and 2) feed its pool's queries and its fusions; its vertical
# edge features (VARIANT_HF channels at levels 0 and 1) the pool's RPE.
VARIANT_HF = 4
VARIANT_DROP = 0.1
VARIANTS = {
    'A': dict(qk_share_rpe=True, q_on_minus_rpe=True, heads_share_rpe=True,
              qk_scale='g', pre_norm=False, norm='layer'),
    'B': dict(h_edge_mlp=None, in_rpe_dim=0, pool='attentive',
              node_mlp=(VARIANT_HF, 64, 64),
              v_edge_mlp=(VARIANT_HF, 32, 32), fusion='residual',
              norm='batch', mlp_norm='batch',
              down_in_mlp=((68, 64, 64), (68, 64, 64)),
              down_out_mlp=((64, 64), (64, 128)),
              up_in_mlp=((132, 64, 64),),
              **{f'{side}_{rate}': VARIANT_DROP for side in ('down', 'up')
                 for rate in ('mlp_drop', 'residual_drop', 'attn_drop',
                              'drop_path')},
              point_drop=VARIANT_DROP),
    'C': dict(q_rpe=False, v_rpe=False, norm='instance', mlp_norm='group',
              pool='min')}
# EZ-SP semantic: the sparse CNN of the stage-1 partition model's widths
# ahead of the point MLP (into it, or beside it)
POINT_CNN = (32, 32, 32)
# the rest of the JAX package's surface (`phase_rest`): the held-out run's
# steps and crops, the SuperCluster demo's; and the least count of
# pseudo-instances on a panoptic room
HELDOUT_STEPS = 3
HELDOUT_CROPS = 4
DEMO_STEPS = 2
DEMO_CROPS = 2
# the long-tail transforms, TTA and confusion update (`phase_long_tail`):
# level-0 cleanup (inliers within LONG_TAIL_INLIER_R of k_min others,
# recursively; then outliers without a neighbor in LONG_TAIL_OUTLIER_R);
# the val share of the level-1 split; 2 train steps, each on
# LONG_TAIL_CROPS k-hop crops of the train half with feature dropout;
# LONG_TAIL_TTA_RUNS k-hop crops of the val half served and accumulated
LONG_TAIL_INLIER_K, LONG_TAIL_INLIER_R = 3, 0.1
LONG_TAIL_OUTLIER_R = 0.05
LONG_TAIL_VAL_SHARE = 0.5
LONG_TAIL_STEPS = 2
LONG_TAIL_CROPS = 4
LONG_TAIL_KHOP = dict(k_hop=2, n_seeds=16, i_level=1)
LONG_TAIL_DROPOUT = 0.1
LONG_TAIL_TTA_RUNS = 3
LONG_TAIL_TTA_KHOP = dict(k_hop=2, n_seeds=32, i_level=1)


def kernel_cost(name, **shape):
    """(bytes, product FLOPs, other FLOPs) of one call of kernel `name`
    at `shape` (`ops/cost.py:kernel_cost`)."""
    from superpoint_transformer_torch.ops.cost import kernel_cost as cost
    return cost(name, **shape)


def bound(name, **shape):
    """(bound ms, 'bytes' or 'operations'): the least time the card
    could take for one call, the larger of its bytes over the memory rate
    and its FLOPs over the peak rates of their types."""
    nbytes, prod, other = kernel_cost(name, **shape)
    byte_ms = nbytes / PEAK_BYTES_S * 1e3
    op_ms = (prod / PEAK_BF16_FLOP_S + other / PEAK_F32_FLOP_S) * 1e3
    return (byte_ms, 'bytes') if byte_ms >= op_ms else (op_ms, 'operations')


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def settle():
    """Collect the garbage that the kernel checks leave (graph captures,
    large tensors) and return cached device memory, so that a main path
    is timed in a process state like a user's; restart the memory peak."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def logit_diff(a, b):
    """(max abs difference, mean abs difference, argmax agreement)."""
    d = (a - b).abs()
    agree = (a.argmax(1) == b.argmax(1)).float().mean()
    return d.max().item(), d.mean().item(), agree.item()


def hold_logits(label, kern, plain, batch, cd, num_classes=13):
    """The logits of the model `kern` (the kernels) on `batch`: finite on
    the valid rows of each level, `num_classes` wide, equal in two runs,
    and within the fixed limits of the compute dtype `cd` of the model
    `plain` (the same weights on the plain attention). Returns the first
    run's logits."""
    import torch
    with torch.inference_mode():
        logits, again, ref = kern(batch), kern(batch), plain(batch)
    for i in range(len(logits)):
        lvl = batch[i + 1]
        lg, lg2, rf = (t[i][lvl.node_mask] for t in (logits, again, ref))
        check(lg.shape == (lvl.num_nodes, num_classes)
              and bool(torch.isfinite(lg).all()),
              f'{label}level {i + 1} logits: shape {tuple(lg.shape)} or not '
              'finite')
        twice = (lg - lg2).abs().max().item()
        check(torch.equal(logits[i], again[i]),
              f'{label}{cd or "float32"} level {i + 1} logits differ between '
              f'two runs (max {twice:.3e})')
        err, mean, agree = logit_diff(lg, rf)
        print(f'{label}{cd or "float32"} level-{i + 1} logits (|x| max '
              f'{rf.abs().max().item():.3f}): kernel vs plain attention '
              f'max_abs_err={err:.3e} mean={mean:.3e} argmax agreement='
              f'{agree:.5f}; same model run twice: bit-equal (max '
              f'{twice:.1e})')
        if cd is None:
            check(err <= F32_LOGIT_MAX_ABS and agree >= F32_ARGMAX_AGREEMENT,
                  f'{label}f32 level {i + 1} logits: kernel vs plain beyond '
                  f'{F32_LOGIT_MAX_ABS}, or argmax agreement {agree:.5f} '
                  f'below {F32_ARGMAX_AGREEMENT}')
        else:
            check(mean <= BF16_LOGIT_MEAN_MAX
                  and agree >= BF16_ARGMAX_AGREEMENT,
                  f'{label}bf16 level {i + 1} logits: kernel vs plain mean '
                  f'{mean:.3e} beyond {BF16_LOGIT_MEAN_MAX} or agreement '
                  f'below {BF16_ARGMAX_AGREEMENT}')
    return logits


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of `fn()` over `iters` runs, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters):
    """Mean device time of one `fn()`: `iters` calls captured in one CUDA
    graph and replayed (after a warm-up), CUDA events around the replays.
    A kernel shorter than the host's cost to launch it is timed without
    that cost, which eager timing would add as idle gaps."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = cuda_ms(graph.replay, 3, warmup=1) / iters
    del graph
    return ms


def k2_inputs(gen, N, K, H, D, C, De, masked_rows, dtype, dev):
    import torch

    def mk(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev, dtype)

    args = [mk(N, H, D), mk(N, K, H * D), mk(N, K, C), mk(N, K, De),
            mk(De, H * D, scale=0.3), mk(H * D, scale=0.1),
            mk(De, H * D, scale=0.3), mk(H * D, scale=0.1),
            mk(De, C, scale=0.3), mk(C, scale=0.1)]
    mask = torch.rand(N, K, generator=gen) < 0.7
    mask[:, 0] = True
    if masked_rows:
        mask[-masked_rows:] = False
    scale = torch.rand(N, generator=gen) * 0.5 + 0.2
    return args + [mask.to(dev), scale.to(dev)]


def time_pair(kernel_fn, plain_fn, iters, graph=False):
    """(kernel ms, plain ms, rounds): the best of two rounds each, taken
    in the order kernel, plain, plain, kernel; each round eager
    (`cuda_ms`) or, with `graph`, replayed from a CUDA graph
    (`graph_ms`)."""
    times = {'kernel': [], 'plain': []}
    timer = graph_ms if graph else cuda_ms
    for name in ('kernel', 'plain', 'plain', 'kernel'):
        fn = kernel_fn if name == 'kernel' else plain_fn
        times[name].append(timer(fn, iters))
    return min(times['kernel']), min(times['plain']), times


def assert_close(name, got, ref, rtol, atol):
    """torch.testing.assert_close, after printing the max abs error;
    returns it."""
    import torch
    err = (got.float() - ref.float()).abs().max().item() \
        if got.numel() else 0.0
    print(f'  {name}: max_abs_err={err:.3e} (rtol {rtol}, atol {atol})')
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol, msg=name)
    return err


def hold_k2(label, args):
    """K2's output and lse vs its plain version's on `args`, and 0 on
    the rows with no valid slot; returns the output's max abs error."""
    import torch
    from superpoint_transformer_torch.ops import attention_rpe as k2
    out, lse = k2.dense_attention_rpe(*args, with_lse=True)
    ref, ref_lse = k2.dense_attention_rpe_reference(*args, with_lse=True)
    torch.cuda.synchronize()
    valid = args[10].any(1)
    err = (out - ref).abs().max().item()
    rel = ((out - ref).abs() / ref.abs().clamp(min=1e-3)).max().item()
    lse_err = (lse[:, valid] - ref_lse[:, valid]).abs().max().item()
    print(f'K2 {label}: max_abs_err={err:.3e} max_rel_err={rel:.3e} '
          f'lse_max_abs_err={lse_err:.3e} (rtol {K2_RTOL}, atol {K2_ATOL})')
    torch.testing.assert_close(out, ref, rtol=K2_RTOL, atol=K2_ATOL)
    torch.testing.assert_close(lse[:, valid], ref_lse[:, valid],
                               rtol=K2_RTOL, atol=K2_ATOL)
    check(torch.all(out[~valid] == 0), 'fully masked rows must give 0')
    return err


def phase_k2(dev):
    """K2 vs its plain version at the flagship serving level-1 shape, a
    ragged shape and a batch with fully masked rows, in f32 and bf16."""
    import torch
    from superpoint_transformer_torch.ops import attention_rpe as k2

    gen = torch.Generator().manual_seed(SEED)
    flagship = dict(N=10_240, K=48, H=16, D=4, C=64, De=32)
    cases = [('flagship', dict(flagship, masked_rows=0)),
             ('ragged', dict(N=1000, K=37, H=4, D=4, C=32, De=8,
                             masked_rows=0)),
             ('masked_rows', dict(flagship, N=4096, masked_rows=512)),
             ('wide_k', dict(flagship, N=1024, K=160, masked_rows=64)),
             ('k50', dict(flagship, N=2048, K=50, masked_rows=64))]
    worst = 0.0
    for name, shape in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = k2_inputs(gen, dtype=dtype, dev=dev, **shape)
            worst = max(worst, hold_k2(
                f'{name:11s} {str(dtype):14s} N={shape["N"]} '
                f'K={shape["K"]}', args))

    # time at the flagship level-1 shape in bf16, the serving dtype
    args = k2_inputs(gen, dtype=torch.bfloat16, dev=dev, masked_rows=0,
                     **flagship)
    ms, plain_ms, rounds = time_pair(
        lambda: k2.dense_attention_rpe(*args),
        lambda: k2.dense_attention_rpe_reference(*args), 20, graph=True)
    print(f'K2 flagship bf16 N=10240 K=48: kernel {ms:.4f} ms, plain '
          f'{plain_ms:.4f} ms; rounds {rounds} (CUDA graph of 20 calls, '
          'CUDA events)')
    # no one PyTorch call computes attention with the RPE projections
    # inside: library_ms is null
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                library_ms=None, shape=dict(flagship))


def k1_inputs(gen, N, K, H, D, CH, q_per_edge, masked_rows, dtype, dev):
    import torch

    def mk(*s):
        return torch.randn(*s, generator=gen).to(dev, dtype)

    q = mk(N, K, H, D) if q_per_edge else mk(N, H, D)
    mask = torch.rand(N, K, generator=gen) < 0.7
    mask[:, 0] = True
    if masked_rows:
        mask[-masked_rows:] = False
    scale = torch.rand(N, generator=gen) * 0.5 + 0.2
    return [q, mk(N, K, H, D), mk(N, K, H, CH), mask.to(dev), scale.to(dev)]


def hold_k1(label, args):
    """K1's output vs its plain version's on `args`, and 0 on the rows
    with no valid slot; returns the max abs error."""
    import torch
    from superpoint_transformer_torch.ops import attention as k1
    print(f'K1 {label}:')
    out = k1.dense_attention(*args)
    ref = k1.dense_attention_reference(*args)
    err = assert_close('out', out, ref, K1_RTOL, K1_ATOL)
    check(torch.all(out[~args[3].any(1)] == 0),
          'fully masked rows must give 0')
    return err


def hold_k1_backward(label, args, gen):
    """dq, dk, dv and dscale of K1's autograd function (kernel forward,
    closed-form backward) vs autograd through the plain version on
    `args`, under a random cotangent drawn from `gen`. The closed form
    differentiates the attention without the forward's rounding of
    q*scale (as the JAX backward does), so in bf16 it is held to autograd
    of the plain version on the same values in f32, whose dq, dk, dv are
    then rounded to bf16 once, as the closed form's are; dscale is f32
    on both sides and held relative to its largest entry. Returns the
    largest error of dq, dk, dv in f32 (0 in bf16; the model takes no
    dscale)."""
    import torch
    from superpoint_transformer_torch.ops import attention as k1
    q0, k0, v0, mask, scale0 = args
    N, _, H, _ = k0.shape
    w = torch.randn(N, H, v0.shape[3], generator=gen).to(k0.device)
    grads = []
    for fn, cast in ((k1.dense_attention_trainable, k0.dtype),
                     (k1.dense_attention_reference, torch.float32)):
        q, k, v = (a.to(cast, copy=True).requires_grad_()
                   for a in (q0, k0, v0))
        scale = scale0.clone().requires_grad_()
        (fn(q, k, v, mask, scale) * w).sum().backward()
        grads.append([t.grad.to(a.dtype) for t, a in
                      zip((q, k, v, scale), (q0, k0, v0, scale0))])
    print(f'K1 backward {label}:')
    worst = 0.0
    for gname, a, b in zip(('dq', 'dk', 'dv', 'dscale'), *grads):
        tol = (BF16_GRAD_RTOL, BF16_GRAD_ATOL) \
            if a.dtype == torch.bfloat16 else (K1_RTOL, K1_ATOL)
        if gname == 'dscale':
            # each row's sum over K*H*D products cancels: held relative
            # to the largest entry
            tol = (K1_RTOL, K1_ATOL + K1_RTOL * b.abs().max().item())
        err = assert_close(gname, a, b, *tol)
        if k0.dtype == torch.float32 and gname != 'dscale':
            worst = max(worst, err)
    return worst


def phase_k1(dev):
    """K1 vs its plain version in both query layouts, f32 and bf16, at
    the flagship training level-1 shape, a ragged shape and a batch with
    fully masked rows; K1's autograd function (kernel forward,
    closed-form backward) vs autograd through the plain version."""
    import torch
    from superpoint_transformer_torch.ops import attention as k1

    gen = torch.Generator().manual_seed(SEED + 1)
    L1 = TRAIN_L1
    flagship = dict(N=L1['N'], K=L1['K'], H=L1['H'], D=L1['D'],
                    CH=L1['C'] // L1['H'])
    cases = [('flagship', dict(flagship, masked_rows=0)),
             ('ragged', dict(N=1000, K=37, H=4, D=4, CH=8, masked_rows=0)),
             ('masked_rows', dict(flagship, N=2048, masked_rows=256)),
             ('wide_k', dict(flagship, N=1024, K=160, masked_rows=64)),
             ('k50', dict(flagship, N=2048, K=50, masked_rows=64))]
    worst = 0.0
    for name, shape in cases:
        for q_per_edge in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                args = k1_inputs(gen, q_per_edge=q_per_edge, dtype=dtype,
                                 dev=dev, **shape)
                worst = max(worst, hold_k1(
                    f'{name} q_{"edge" if q_per_edge else "node"} {dtype} '
                    f'N={shape["N"]} K={shape["K"]}', args))

    # the backward (`hold_k1_backward`) at the flagship shape
    for dtype in (torch.float32, torch.bfloat16):
        for q_per_edge in (True, False):
            args = k1_inputs(gen, q_per_edge=q_per_edge, dtype=dtype,
                             dev=dev, masked_rows=64, **flagship)
            worst = max(worst, hold_k1_backward(
                f'q_{"edge" if q_per_edge else "node"} {dtype} '
                f'N={flagship["N"]}', args, gen))

    # time at the flagship training level-1 shape, per-edge q, bf16
    args = k1_inputs(gen, q_per_edge=True, dtype=torch.bfloat16, dev=dev,
                     masked_rows=0, **flagship)
    ms, plain_ms, rounds = time_pair(
        lambda: k1.dense_attention(*args),
        lambda: k1.dense_attention_reference(*args), 20, graph=True)
    print(f'K1 flagship training bf16 q_edge N={flagship["N"]} K=48: '
          f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; rounds {rounds} '
          '(CUDA graph of 20 calls, CUDA events)')

    # the yardstick: with a query per node, one PyTorch call computes
    # K1's function, SDPA with q*scale folded in and a boolean mask (the
    # port never calls it). Timed in turns with K1 on the same inputs.
    import torch.nn.functional as F
    args = k1_inputs(gen, q_per_edge=False, dtype=torch.bfloat16, dev=dev,
                     masked_rows=0, **flagship)
    q, k, v, mask, scale = args
    qs = (q.float() * scale[:, None, None]).to(q.dtype)[:, :, None]
    kt, vt, am = k.transpose(1, 2), v.transpose(1, 2), mask[:, None, None]

    def sdpa():
        return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=am,
                                              scale=1.0)

    lib = sdpa()[:, :, 0].float()
    ref = k1.dense_attention(*args)
    lib_err = (lib - ref).abs().max().item()
    print(f'K1 q_node vs SDPA (bf16 out): max_abs_err={lib_err:.3e} '
          f'(atol {SDPA_ATOL})')
    check(lib_err <= SDPA_ATOL, 'SDPA does not compute K1 with a per-node '
          'query: the yardstick is wrong')
    q_node_ms, library_ms, lib_rounds = time_pair(
        lambda: k1.dense_attention(*args), sdpa, 20, graph=True)
    print(f'K1 flagship training bf16 q_node N={flagship["N"]} K=48: '
          f'kernel {q_node_ms:.4f} ms, SDPA {library_ms:.4f} ms; rounds '
          f'{lib_rounds} (CUDA graph of 20 calls, CUDA events)')
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, q_node_ms=q_node_ms,
                shape=dict(N=L1['N'], K=L1['K'], H=L1['H'], D=L1['D'],
                           C=L1['C']))


K3_GRADS = ('dq', 'dkg', 'dvg', 'd_ef', 'dwk', 'dbk', 'dwq', 'dbq', 'dwv',
            'dbv')


def phase_k3(dev):
    """K3's ten gradients vs autograd of K2's plain version (f32 kernel,
    f64 autograd), and vs K3's plain version (bf16), at the flagship
    training level-1 shape, a ragged shape, a shape off the 16-wide
    tensor-core tiles, a batch with fully masked rows, the EZ-SP stage-2
    density (K=64) and a K one past the bf16 kernel's 16-slot tiles
    (K=17); the weight gradients are the same in two runs, in both
    dtypes."""
    import torch
    from superpoint_transformer_torch.ops import attention_rpe as k2

    gen = torch.Generator().manual_seed(SEED + 2)
    cases = [('flagship', dict(TRAIN_L1, masked_rows=0)),
             ('ragged', dict(N=1000, K=37, H=4, D=4, C=32, De=8,
                             masked_rows=0)),
             ('off_tiles', dict(N=700, K=37, H=2, D=4, C=8, De=8,
                                masked_rows=9)),
             ('masked_rows', dict(TRAIN_L1, N=2048, masked_rows=256)),
             ('ezsp_k64', dict(TRAIN_L1, N=4096, K=64, masked_rows=0)),
             ('k17', dict(TRAIN_L1, N=2048, K=17, masked_rows=16))]
    worst = 0.0
    for name, shape in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = k2_inputs(gen, dtype=dtype, dev=dev, **shape)
            H, C = shape['H'], shape['C']
            g = torch.randn(shape['N'], H, C // H, generator=gen).to(dev)
            out, lse = k2.dense_attention_rpe(*args, with_lse=True)
            grads = k2.dense_attention_rpe_bwd(*args, out, lse, g)
            again = k2.dense_attention_rpe_bwd(*args, out, lse, g)
            print(f'K3 {name} {dtype} N={shape["N"]} K={shape["K"]}:')
            if dtype == torch.float32:
                # autograd of the plain version on the same values in f64:
                # the f32 one rounds its sums over N*K slots too, by up to
                # 0.97 of the tolerance in the weight gradients
                leaves = [a.double().requires_grad_() for a in args[:10]]
                (k2.dense_attention_rpe_reference(*leaves, *args[10:])
                 * g.double()).sum().backward()
                ref = [t.grad.float() for t in leaves]
            else:
                ref = k2.dense_attention_rpe_bwd_reference(*args, out, lse,
                                                           g)
            for gname, a, b in zip(K3_GRADS, grads, ref):
                bf16 = a.dtype == torch.bfloat16
                err = assert_close(gname, a, b, *(
                    (BF16_GRAD_RTOL, BF16_GRAD_ATOL) if bf16
                    else (K3_RTOL, K3_ATOL)))
                if dtype == torch.float32:
                    worst = max(worst, err)
            check(all(torch.equal(a, b) for a, b in zip(grads[4:], again[4:])),
                  'K3 weight gradients differ between two runs')

    # time at the flagship training level-1 shape in bf16
    args = k2_inputs(gen, dtype=torch.bfloat16, dev=dev, masked_rows=0,
                     **TRAIN_L1)
    g = torch.randn(TRAIN_L1['N'], TRAIN_L1['H'],
                    TRAIN_L1['C'] // TRAIN_L1['H'], generator=gen).to(dev)
    out, lse = k2.dense_attention_rpe(*args, with_lse=True)
    ms, plain_ms, rounds = time_pair(
        lambda: k2.dense_attention_rpe_bwd(*args, out, lse, g),
        lambda: k2.dense_attention_rpe_bwd_reference(*args, out, lse, g), 20,
        graph=True)
    print(f'K3 flagship training bf16 N={TRAIN_L1["N"]} K=48 on '
          f'{card_line()}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; '
          f'rounds {rounds} (CUDA graph of 20 calls, CUDA events, the delta '
          'pass included)')
    # no one PyTorch call computes the RPE attention's gradients
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                library_ms=None, shape=dict(TRAIN_L1))


def phase_serving(dev, card):
    import numpy as np
    import torch
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.experiment import (FLAGSHIP_CFG,
                                                         build_model)
    from superpoint_transformer_torch.inference import infer_batch
    from superpoint_transformer_torch.models.semantic import (
        SemanticSegmentationModel)
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.ops.attention_rpe import (
        dense_attention_rpe)
    from superpoint_transformer_torch.utils.synthetic import (
        random_padded_nag)

    def flagship(compute_dtype='auto', plain_attention=False):
        m = SemanticSegmentationModel(build_model(
            FLAGSHIP_CFG, num_graphs=NUM_GRAPHS, compute_dtype=compute_dtype,
            plain_attention=plain_attention, device=dev), 13, device=dev)
        init_weights(m, torch.Generator().manual_seed(SEED))
        return m.eval()

    settle()
    model = flagship()
    n_params = sum(p.numel() for p in model.parameters())
    print(f'flagship SPT-2: {n_params} parameters')
    check(n_params == FLAGSHIP_PARAMS,
          f'{n_params} parameters, the JAX model has {FLAGSHIP_PARAMS}')
    compute_dtype = model.net.compute_dtype

    requests = []
    for i in range(3):
        t0 = time.perf_counter()
        host = random_padded_nag(seed=SEED + 1 + i, num_graphs=NUM_GRAPHS,
                                 **ROOM)
        requests.append((host, time.perf_counter() - t0))

    # the serving path: every launch counted from here
    reset_counts()
    served = []
    with widest_norm() as gn_args:
        for host, gen_s in requests:
            before = dense_attention_rpe.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = from_numpy(host, dev, compute_dtype)
            pred = infer_batch(model, batch)
            req_s = time.perf_counter() - t0
            launched = dense_attention_rpe.launches - before
            served.append((batch, pred))
            n = [lvl.num_nodes for lvl in batch.levels]
            print(f'request: {n[0]} points, {n[1]} level-1, {n[2]} level-2 '
                  f'nodes, K={batch[1].nbr_idx.shape[1]}/'
                  f'{batch[2].nbr_idx.shape[1]}; made in {gen_s:.3f} s, '
                  f'served in {req_s * 1e3:.1f} ms (host to predictions); '
                  f'{launched} K2 launches')
            check(launched == K2_LAUNCHES_PER_FORWARD,
                  f'{launched} K2 launches in one forward, expected '
                  f'{K2_LAUNCHES_PER_FORWARD}')
            check(pred.shape == (n[1],) and pred.dtype == np.int64
                  and pred.min() >= 0 and pred.max() < 13,
                  'predictions are not a class per level-1 node')
    launches = counts()
    print(f'serving path: 3 requests answered, launches {launches}, GN '
          f'{gn_count()}')
    check(launches['K1'] == launches['K3'] == 0,
          'serving launched a training kernel')
    check(gn_count() == 3 * GN_PER_SPT2_FORWARD,
          f'serving: {gn_count()} GN launches in 3 forwards, expected '
          f'{3 * GN_PER_SPT2_FORWARD}')
    hold_gn_on_path('serving path', gn_args)
    del gn_args

    # what comes out: finite logits on valid rows, the same in two runs,
    # close to those of the same model on the plain attention, in f32 and
    # in the served bf16
    host = requests[0][0]
    batch, pred = served[0]
    for cd in (None, compute_dtype):
        kern = model if cd == compute_dtype else flagship(cd)
        plain = flagship(cd, plain_attention=True)
        b = batch if cd == compute_dtype else from_numpy(host, dev, cd)
        logits = hold_logits('', kern, plain, b, cd)
    # the served predictions are a forward's level-1 argmax in NAG order
    n1 = batch[1].num_nodes
    agree = (pred[batch.level1_node_id[:n1]]
             == logits[0][:n1].argmax(1).cpu().numpy()).mean()
    check(agree == 1.0,
          f'served predictions vs level-1 argmax in NAG order: {agree}')

    # forward time, kernel vs plain attention, in turns
    def forward(m):
        with torch.inference_mode():
            m(batch)

    times = {}
    for name, m in (('kernel', model), ('plain', plain), ('plain', plain),
                    ('kernel', model)):
        times.setdefault(name, []).append(cuda_ms(lambda: forward(m), 10))
    n0 = batch[0].num_nodes
    ms = min(times['kernel'])
    print(f'flagship forward on {card}: {ms:.3f} ms '
          f'({n0 / ms * 1e3:.4g} level-0 points/s); with the plain '
          f'attention {min(times["plain"]):.3f} ms; rounds '
          f'{times} (CUDA events, 10 forwards each, after 3 warm-up)')
    print(f'peak device memory: '
          f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB')
    return launches['K2']


def kernel_fns():
    from superpoint_transformer_torch.ops import attention, attention_rpe
    from superpoint_transformer_torch.ops.graph_norm import graph_norm
    return {'K1': attention.dense_attention,
            'K2': attention_rpe.dense_attention_rpe,
            'K3': attention_rpe.dense_attention_rpe_bwd,
            'GN': graph_norm}


# GN launches of the paths before their last reset (`gn_launches`)
GN_BEFORE_RESET = [0]


def reset_counts():
    fns = kernel_fns()
    GN_BEFORE_RESET[0] += fns['GN'].launches
    for fn in fns.values():
        fn.launches = 0


def gn_launches():
    """GN launches since the script started, across the resets."""
    return GN_BEFORE_RESET[0] + kernel_fns()['GN'].launches


def counts():
    """The attention kernels' launches since the last reset (GN's:
    `gn_count`)."""
    fns = kernel_fns()
    return {name: fns[name].launches for name in ('K1', 'K2', 'K3')}


def gn_count():
    """GN's launches since the last reset."""
    return kernel_fns()['GN'].launches


def rel_l2(a, b):
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def phase_training(dev, card):
    """The flagship semantic training step at full width: K1 launches per
    step, finite losses, moved parameters, one step's loss and gradients
    vs the same model on the plain attention, and the step time."""
    import torch
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.experiment import (FLAGSHIP_CFG,
                                                         build_task)
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.utils.synthetic import (
        random_padded_nag)

    def flagship_task(compute_dtype='auto', plain_attention=False):
        task = build_task(FLAGSHIP_CFG, num_graphs=TRAIN_GRAPHS,
                          compute_dtype=compute_dtype,
                          plain_attention=plain_attention, device=dev)
        init_weights(task.model, torch.Generator().manual_seed(SEED))
        return task

    settle()
    task = flagship_task()
    n_params = sum(p.numel() for p in task.model.parameters())
    check(n_params == FLAGSHIP_PARAMS,
          f'{n_params} parameters, the JAX model has {FLAGSHIP_PARAMS}')
    compute_dtype = task.model.net.compute_dtype
    hosts = [random_padded_nag(seed=SEED + 10 + i, num_graphs=TRAIN_GRAPHS,
                               **CROP) for i in range(TRAIN_STEPS)]
    start = [p.detach().clone() for p in task.model.parameters()]

    # the training path: every launch counted from here
    reset_counts()
    losses = []
    for step, host in enumerate(hosts):
        before = counts()['K1']
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = from_numpy(host, dev, compute_dtype, train=True)
        metrics = task.train_step(batch)
        loss = metrics['loss'].item()
        step_s = time.perf_counter() - t0
        launched = counts()['K1'] - before
        n = [lvl.num_nodes for lvl in batch.levels]
        cm = metrics['confmat']
        print(f'train step {step}: {n[0]} points, {n[1]} level-1, {n[2]} '
              f'level-2 nodes, K={batch[1].nbr_idx.shape[1]}/'
              f'{batch[2].nbr_idx.shape[1]}; lr {task.lr_at(step):.3e}; '
              f'loss {loss:.6f}; {step_s * 1e3:.1f} ms (host batch to '
              f'loss); {launched} K1 launches')
        check(launched == K1_LAUNCHES_PER_STEP,
              f'{launched} K1 launches in one step, expected '
              f'{K1_LAUNCHES_PER_STEP}')
        check(torch.isfinite(metrics['loss']).item(), f'loss {loss}')
        y = batch[1].y[:, :13][batch[1].node_mask].sum().round().long()
        check(cm.shape == (13, 13) and cm.sum() == y,
              'confusion matrix mass is not the level-1 label mass')
        losses.append(loss)
    launches = counts()
    print(f'training path: {TRAIN_STEPS} steps, launches {launches}, GN '
          f'{gn_count()}')
    check(gn_count() == 0,
          'training: GraphNorm took its serving kernels with gradients on')
    check(launches['K2'] == launches['K3'] == 0,
          'training launched a kernel the JAX training route does not use')
    moved = [not torch.equal(a, p.detach())
             for a, p in zip(start, task.model.parameters())]
    with_grad = [p.grad is not None and bool(p.grad.any())
                 for p in task.model.parameters()]
    print(f'{sum(moved)} of {len(moved)} parameter tensors moved; '
          f'{sum(with_grad)} had a non-zero gradient in the last step')
    check(all(m for m, g in zip(moved, with_grad) if g),
          'a parameter with a gradient did not move')
    del task

    # one step's loss and gradients, kernel vs plain attention, in f32
    # and in the flagship's bf16
    for cd in (None, compute_dtype):
        batch = from_numpy(hosts[0], dev, cd, train=True)
        hold_train_step('flagship', flagship_task(cd),
                        flagship_task(cd, True), batch, cd)

    # step time, K1 vs the plain attention (fresh tasks, warm-up ramp)
    batch = from_numpy(hosts[0], dev, compute_dtype, train=True)
    kern, plain = flagship_task(), flagship_task(plain_attention=True)
    torch.cuda.reset_peak_memory_stats()
    ms, plain_ms, rounds = time_pair(lambda: kern.train_step(batch),
                                     lambda: plain.train_step(batch), 10)
    n0 = batch[0].num_nodes
    print(f'flagship train step on {card}: {ms:.3f} ms ({n0 / ms * 1e3:.4g} '
          f'level-0 points/s); with the plain attention {plain_ms:.3f} ms; '
          f'rounds {rounds} (CUDA events, 10 steps each, after 3 warm-up)')
    print(f'peak device memory while timing: '
          f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB')
    return launches['K1']


def loss_grads(task, batch, seed=None):
    """(loss, all parameter gradients flattened) of one forward and
    backward of `task` on `batch`, in training mode, without an update;
    a parameter that gets no gradient counts as zeros. `seed` restarts
    the model's dropout stream first."""
    import torch
    if seed is not None:
        task.model.net.dropout_rng.manual_seed(seed)
    task.model.train()
    task.optimizer.zero_grad(set_to_none=True)
    loss, _ = task.loss(batch)
    loss.backward()
    return loss.detach().float(), torch.cat(
        [(p.grad if p.grad is not None else torch.zeros_like(p))
         .reshape(-1).float() for p in task.model.parameters()])


def step_twice(label, kern, plain, batch, cd, seed=None):
    """(kernel loss, gradients), (plain loss, gradients) of one training
    step of the tasks `kern` (the kernels) and `plain` (the same weights
    on the plain attention) on `batch`; the kernel's the same in two
    runs (each from the dropout seed `seed`, where one is given)."""
    import torch
    lk, gk = loss_grads(kern, batch, seed)
    lk2, gk2 = loss_grads(kern, batch, seed)
    lp, gp = loss_grads(plain, batch, seed)
    check(torch.isfinite(gk).all().item(), f'{label}non-finite gradients')
    twice = max(abs(lk - lk2).item(), (gk - gk2).abs().max().item())
    check(torch.equal(lk, lk2) and torch.equal(gk, gk2),
          f'{label}{cd or "float32"} train step: the loss or the gradients '
          f'differ between two runs (max {twice:.3e})')
    return (lk, gk), (lp, gp)


def hold_train_step(path, kern, plain, batch, cd, seed=None,
                    label=None):
    """One training step's loss and gradients of the task `kern` (the
    kernels): the same in two runs, and within TRAIN_TOL[(path, cd)] of
    `plain` (the same weights on the plain attention) in the compute
    dtype `cd`; each run from the dropout seed `seed` where one is given.
    Returns the kernel's (loss, gradients)."""
    if label is None:
        label = '' if path == 'flagship' else f'{path} '
    (lk, gk), (lp, gp) = step_twice(label, kern, plain, batch, cd, seed)
    loss_err = (abs(lk - lp) / lp.abs()).item()
    grad_err = rel_l2(gk, gp)
    tol_loss, tol_grad = TRAIN_TOL[(path, cd)]
    print(f'{label}{cd or "float32"} train step, kernel vs plain attention: '
          f'loss {lk.item():.6f} vs {lp.item():.6f} (rel {loss_err:.3e}, '
          f'limit {tol_loss}); gradients rel L2 {grad_err:.3e} (limit '
          f'{tol_grad}), |g| {gp.norm().item():.4g}; the same step run '
          f'twice: bit-equal')
    check(loss_err <= tol_loss and grad_err <= tol_grad,
          f'{label}{cd or "float32"} train step: kernel vs plain beyond '
          f'{TRAIN_TOL[(path, cd)]}')
    return lk, gk


def phase_fused_rpe_training(dev):
    """The fused-RPE training route, K2 forward and K3 backward through
    `dense_attention_rpe_trainable`, at the level-1 training shape in
    bf16; timed against the route the model takes in training: the RPE
    projections as one matmul added to the gathered rows, then K1 with its
    closed-form backward."""
    import torch
    import torch.nn.functional as F
    from superpoint_transformer_torch.ops.attention import (
        dense_attention_trainable)
    from superpoint_transformer_torch.ops.attention_rpe import (
        dense_attention_rpe_trainable)

    settle()
    gen = torch.Generator().manual_seed(SEED + 3)
    L1 = TRAIN_L1
    N, K, H, D, C = L1['N'], L1['K'], L1['H'], L1['D'], L1['C']
    DH = H * D
    args = k2_inputs(gen, dtype=torch.bfloat16, dev=dev, masked_rows=0,
                     **L1)
    leaves = [a.detach().requires_grad_() for a in args[:10]]
    mask, scale = args[10:]
    g = torch.randn(N, H, C // H, generator=gen).to(dev)

    def fused():
        dense_attention_rpe_trainable(*leaves, mask, scale).backward(g)

    def materialized():
        q, kg, vg, ef, wk, bk, wq, bq, wv, bv = leaves
        w_cat = torch.cat([wk, wq, wv], 1).t()
        b_cat = torch.cat([bk, bq, bv])
        r = F.linear(ef, w_cat, b_cat)
        k = (kg + r[..., :DH]).reshape(N, K, H, D)
        qe = q[:, None] + r[..., DH:2 * DH].reshape(N, K, H, D)
        v = (vg + r[..., 2 * DH:]).reshape(N, K, H, C // H)
        dense_attention_trainable(qe, k, v, mask, scale).backward(g)

    # the fused-RPE training path: every launch counted from here
    reset_counts()
    for _ in range(TRAIN_STEPS):
        fused()
    torch.cuda.synchronize()
    launches = counts()
    print(f'fused-RPE training path: {TRAIN_STEPS} forward+backward, '
          f'launches {launches}')
    check(launches['K2'] == launches['K3'] == TRAIN_STEPS
          and launches['K1'] == 0, 'fused-RPE route launch counts')
    check(all(bool(torch.isfinite(t.grad).all()) for t in leaves),
          'fused-RPE route: non-finite gradients')
    ms, mat_ms, rounds = time_pair(fused, materialized, 20)
    print(f'level-1 training attention, forward+backward, bf16 N={N} '
          f'K={K}: fused RPE (K2 + K3) {ms:.4f} ms; materialized RPE + K1 '
          f'{mat_ms:.4f} ms; rounds {rounds} (CUDA events, 20 each)')
    return launches['K3']


@contextlib.contextmanager
def plain_attention_calls():
    """Count the model's calls of the attention's plain versions (the
    names the attention block picks from) while the block runs."""
    from superpoint_transformer_torch.nn import attention as block
    calls = {'plain': 0}
    saved = {name: getattr(block, name) for name in (
        'dense_attention_reference', 'dense_attention_rpe_reference')}

    def counting(fn):
        def wrapped(*args, **kwargs):
            calls['plain'] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name, fn in saved.items():
        setattr(block, name, counting(fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(block, name, fn)


@contextlib.contextmanager
def widest_call(name, rank=lambda args: args[0].shape[0]):
    """While the block runs, keep the arguments (detached, not copied)
    of the attention block's call of `name` with the most rows (the
    first of the largest `rank`)."""
    import torch
    from superpoint_transformer_torch.nn import attention as block
    fn = getattr(block, name)
    kept = []

    def keeping(*args):
        if not kept or rank(args) > rank(kept):
            kept[:] = [a.detach() if torch.is_tensor(a) else a
                       for a in args]
        return fn(*args)

    setattr(block, name, keeping)
    try:
        yield kept
    finally:
        setattr(block, name, fn)


def hold_on_path(name, args, path='host path'):
    """Hold kernel `name` ('K1' or 'K2') against its plain version on
    the arguments that the main path `path` gave it (`widest_call`), in
    their dtype and cast to f32; K1's backward too (`hold_k1_backward`,
    under a random cotangent)."""
    import torch
    hold = {'K1': hold_k1, 'K2': hold_k2}[name]
    mask = next(a for a in args if a.dtype == torch.bool)
    variants = {args[0].dtype: args, torch.float32: [
        a.float() if a.is_floating_point() else a for a in args]}
    gen = torch.Generator().manual_seed(SEED + 7)
    for dtype, cast in variants.items():
        label = (f'{path} {dtype} N={mask.shape[0]} K={mask.shape[1]} '
                 f'({int(mask.sum())} valid slots)')
        with torch.inference_mode():
            hold(label, cast)
        if name == 'K1':
            hold_k1_backward(label, cast, gen)


@contextlib.contextmanager
def widest_norm():
    """While the block runs, keep the GraphNorm module and the arguments
    (x detached, not copied; batch, mask, leaky) of the forward that
    launched GN on the x of the most elements (the first of them)."""
    from superpoint_transformer_torch.nn.norm import GraphNorm
    forward = GraphNorm.forward
    kept = []

    def keeping(self, x, batch=None, mask=None, leaky=False):
        before = gn_launches()
        y = forward(self, x, batch=batch, mask=mask, leaky=leaky)
        if gn_launches() > before and (not kept
                                       or x.numel() > kept[1].numel()):
            kept[:] = [self, x.detach(), batch, mask, leaky]
        return y

    GraphNorm.forward = keeping
    try:
        yield kept
    finally:
        GraphNorm.forward = forward


def hold_gn(label, norm, x, batch, mask, leaky):
    """GN on x (`graph_norm` with the module `norm`'s parameters), run
    twice (bit-equal), against GraphNorm's PyTorch path
    (`GraphNorm._plain`) on the same values in f32, its LeakyReLU in f32
    with `leaky`, rounded once to x's dtype (`GN_TOL`). Returns the
    max abs error."""
    import torch
    import torch.nn.functional as F
    from superpoint_transformer_torch.ops.graph_norm import (LEAKY_SLOPE,
                                                             graph_norm)
    args = (x.contiguous(), None if batch is None else batch.long(),
            None if mask is None else mask.bool(), norm.weight, norm.bias,
            norm.mean_scale, norm.eps, norm.num_graphs)
    with torch.inference_mode():
        got = graph_norm(*args, leaky=leaky)
        again = graph_norm(*args, leaky=leaky)
        want = norm._plain(x.float(), batch, mask)
        if leaky:
            want = F.leaky_relu(want, LEAKY_SLOPE)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f'GN {label}: two runs differ')
    rtol, atol = GN_TOL[str(x.dtype).split('.')[-1]]
    return assert_close(
        f'GN {label} {x.dtype} N={x.shape[0]} C={x.shape[1]} '
        f'g={norm.num_graphs} leaky={leaky}', got.float(),
        want.to(x.dtype).float(), rtol, atol)


def hold_gn_on_path(path, kept):
    """Hold GN (`hold_gn`) on the widest call that the main path `path`
    gave it (`widest_norm`), in x's dtype and cast to f32."""
    check(bool(kept), f'{path}: no GraphNorm forward launched GN')
    norm, x, batch, mask, leaky = kept
    for cast in (x, x.float()):
        hold_gn(path, norm, cast, batch, mask, leaky)


def gn_inputs(dev, nodes, C, g, K):
    """A GraphNorm of random affine parameters and its bf16 inputs:
    `nodes` rows (or nodes x K edge rows) sorted by graph, a padded tail
    of 5% (id -1, masked out), each graph's channels off 0 by its own
    mean; with K > 1 a random ~60% of each node's slots masked in."""
    import torch
    from superpoint_transformer_torch.nn.norm import GraphNorm
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ids = torch.sort(torch.randint(0, g, (nodes,), generator=gen,
                                   device=dev)).values
    ids[nodes - nodes // 20:] = -1
    if K > 1:
        ids = ids.repeat_interleave(K)
        mask = (torch.rand(ids.shape[0], generator=gen, device=dev)
                < 0.6) & (ids >= 0)
    else:
        mask = ids >= 0
    x = (torch.randn(ids.shape[0], C, generator=gen, device=dev)
         + torch.randn(g + 1, C, generator=gen, device=dev)[
             ids.clamp(min=0)] * 2).to(torch.bfloat16)
    norm = GraphNorm(C, num_graphs=g, device=dev)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5, generator=gen)
        norm.bias.normal_(generator=gen)
        norm.mean_scale.uniform_(0, 1.5, generator=gen)
    return norm, x, ids, mask


def gn_bound(x):
    """GN's bytes bounds at x [N, C] with int64 ids and a bool mask, in
    ms at PEAK_BYTES_S: (strict: x, the ids and the mask read once and y
    written once; two-pass: x and the ids read twice, as the statistics
    and the normalisation passes must, x not fitting the L2)."""
    N, C = x.shape
    esz = x.element_size()
    strict = 2 * N * C * esz + 8 * N + N
    two_pass = 3 * N * C * esz + 16 * N + N
    return strict / PEAK_BYTES_S * 1e3, two_pass / PEAK_BYTES_S * 1e3


def phase_gn(dev):
    """GN at `GN_SHAPES` in bf16 with the LeakyReLU: held against the
    PyTorch path in bf16 and f32 (`hold_gn`), timed against it in turns
    (CUDA events, 20 calls a round), each kernel's device time
    (torch.profiler), and its share of the bytes bounds (`gn_bound`)."""
    import torch
    import torch.nn.functional as F
    from superpoint_transformer_torch.ops.graph_norm import LEAKY_SLOPE
    out = {}
    for name, (nodes, C, g, K) in GN_SHAPES.items():
        norm, x, ids, mask = gn_inputs(dev, nodes, C, g, K)
        worst = max(hold_gn(name, norm, cast, ids, mask, True)
                    for cast in (x, x.float()))

        def kernels():
            with torch.inference_mode():
                norm(x, batch=ids, mask=mask, leaky=True)

        def plain():
            with torch.inference_mode():
                F.leaky_relu(norm._plain(x, ids, mask), LEAKY_SLOPE)

        ms, plain_ms, rounds = time_pair(kernels, plain, 20)
        device_ms, top = device_profile(kernels)
        strict, two_pass = gn_bound(x)
        print(f'GN {name} bf16 N={x.shape[0]} C={C} g={g}: kernels '
              f'{ms:.4f} ms ({device_ms} ms on the device: {top}), '
              f'PyTorch path {plain_ms:.4f} ms; rounds {rounds} (CUDA '
              f'events, 20 calls each); bytes bound {strict:.4f} ms '
              f'strict ({strict / ms:.1%}), {two_pass:.4f} ms two-pass '
              f'({two_pass / ms:.1%})')
        out[name] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                         kernels_ms=dict(top), library_ms=None,
                         bound_ms=strict, bound_by='bytes',
                         bound_share=strict / ms,
                         bound_ms_two_pass=two_pass,
                         bound_share_two_pass=two_pass / ms,
                         shape=dict(N=x.shape[0], C=C, g=g))
        del norm, x, ids, mask
    settle()
    return out


def device_profile(fn, iters=3):
    """(device ms per call summed over the kernels, top 3 kernels as
    (name, ms)) from torch.profiler over `iters` calls after one warm-up
    call; (None, []) when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / iters / 1e3)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    total = sum(ms for _, ms in rows)
    if total <= 0:
        return None, []
    return total, [(name[:60], round(ms, 3)) for name, ms in rows[:3]]


def level_counts(batch):
    """(valid nodes, node capacities, level-1 and level-2 K) of a padded
    batch."""
    return ([int(lvl.num_nodes) for lvl in batch.levels],
            [lvl.capacity for lvl in batch.levels],
            [batch[i].nbr_idx.shape[1] for i in (1, 2)])


def random_twins(batch, seed, num_graphs, compute_dtype, train):
    """`random_padded_nag` at the per-graph node counts of `batch`, with
    level-1 and level-2 degrees drawn from the range of the real batch's
    level-1 degrees: the same sizes on random neighbor sets. Returns
    {'random, own caps': as bucketed, 'random, same caps': at the
    capacities of `batch`}, on the device of `batch`."""
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.utils.synthetic import (
        random_padded_nag)
    n, caps, _ = level_counts(batch)
    deg = batch[1].nbr_mask[batch[1].node_mask].sum(1)
    dev = batch[0].pos.device

    def twin(node_caps):
        host = random_padded_nag(
            seed=seed, num_graphs=num_graphs, n_points=n[0] // num_graphs,
            n_l1=n[1] // num_graphs, n_l2=n[2] // num_graphs,
            degree=(int(deg.min()), int(deg.max())), node_caps=node_caps)
        return from_numpy(host, dev, compute_dtype, train=train)

    return {'random, own caps': twin(None),
            'random, same caps': twin(dict(enumerate(caps[:3])))}


def compare_real_random(label, fn, batches, card):
    """Print CUDA-event and profiler device times of `fn(batch)` for each
    of `batches` ({name: batch}), in turns: each name once forward, then
    once backward."""
    names = list(batches)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(cuda_ms(lambda: fn(batches[name]), 5))
    for name in names:
        n, caps, k = level_counts(batches[name])
        dev_ms, top = device_profile(lambda: fn(batches[name]))
        print(f'{label} on {card}, {name}: nodes {n}, capacities {caps}, '
              f'K={k}; {min(times[name]):.3f} ms (CUDA events, 5 calls, '
              f'rounds {[round(t, 3) for t in times[name]]}); kernels '
              f'{"not measured" if dev_ms is None else f"{dev_ms:.3f} ms"}'
              f' (torch.profiler), top {top}')


def phase_host_path(dev, card):
    """The port's host NAG path on preprocessed synthetic rooms: raw
    cloud -> `preprocess_cloud` -> `prepare_batch` -> `from_numpy` ->
    `infer_batch` (K2) and `e2e_inference` (K2) on the flagship model,
    then three flagship train steps (K1) on `prepare_batch(train=True)`
    batches with caps pinned by `discover_caps`; and the forward's and
    the step's times on these batches beside their random twins."""
    import dataclasses
    import numpy as np
    import torch
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.experiment import (
        FLAGSHIP_CFG, build_model, build_task)
    from superpoint_transformer_torch.inference import (
        EVAL_BATCH_OVERRIDES, e2e_inference, infer_batch)
    from superpoint_transformer_torch.models.semantic import (
        SemanticSegmentationModel)
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.transforms.prepare import (
        BatchConfig, discover_caps, prepare_batch)
    from superpoint_transformer_torch.transforms.preprocess import (
        preprocess_cloud)
    from superpoint_transformer_torch.utils.synthetic import (
        synthetic_room_cloud)

    settle()
    # preprocessing: 4 rooms, the flagship preprocess_cloud defaults
    nags, host_s, raw_points = [], 0.0, 0
    for i in range(HOST_ROOMS):
        raw = synthetic_room_cloud(seed=SEED + i, n_points=HOST_ROOM_POINTS)
        n_raw = raw.num_nodes
        t0 = time.perf_counter()
        nag = preprocess_cloud(raw, verbose=i == 0)
        s = time.perf_counter() - t0
        host_s += s
        raw_points += n_raw
        counts_ = [(nag[j].num_nodes, nag[j].num_edges) for j in nag.levels]
        print(f'room {i}: {n_raw} raw points -> (nodes, edges) per level '
              f'{counts_}; preprocessed in {s:.2f} s on the host '
              f'({s / n_raw * 1e6:.2f} s per 1M raw points)')
        check(nag.num_levels == 4 and all(
            n > 0 for n, _ in counts_) and all(e > 0 for _, e in counts_[1:]),
            f'room {i}: a level is empty or has no graph')
        nags.append(nag)
    print(f'preprocessing: {HOST_ROOMS} rooms in {host_s:.2f} s, '
          f'{host_s / raw_points * 1e6:.2f} s per 1M raw points '
          f'({os.cpu_count()} host cores)')

    # serving: one 8-graph batch, each room twice
    model = SemanticSegmentationModel(build_model(
        FLAGSHIP_CFG, num_graphs=NUM_GRAPHS, device=dev), 13, device=dev)
    init_weights(model, torch.Generator().manual_seed(SEED))
    model.eval()
    compute_dtype = model.net.compute_dtype
    cfg = dataclasses.replace(BatchConfig(), **EVAL_BATCH_OVERRIDES)
    t0 = time.perf_counter()
    host = prepare_batch(nags * 2, cfg, train=False)
    prep_s = time.perf_counter() - t0

    reset_counts()
    with plain_attention_calls() as plain, \
            widest_call('dense_attention_rpe') as k2_args:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = from_numpy(host, dev, compute_dtype)
        pred = infer_batch(model, batch)
        serve_s = time.perf_counter() - t0
    launches = counts()
    n, caps, k = level_counts(batch)
    print(f'host-path serving: {NUM_GRAPHS} graphs, nodes {n}, '
          f'capacities {caps}, K={k}; '
          f'prepare_batch {prep_s:.2f} s on the host, from_numpy + '
          f'infer_batch {serve_s * 1e3:.1f} ms; launches {launches}, '
          f'plain attention calls {plain["plain"]}')
    check(launches['K2'] == K2_LAUNCHES_PER_FORWARD and launches['K1'] == 0
          and launches['K3'] == 0 and plain['plain'] == 0,
          'host-path serving: not 7 K2 launches, or another kernel or the '
          'plain attention ran')
    # K2 vs its plain version on the inputs of its level-1 launch
    hold_on_path('K2', k2_args)
    del k2_args
    with torch.inference_mode():
        logits = model(batch)
    for i, lg in enumerate(logits):
        lvl = batch[i + 1]
        check(bool(torch.isfinite(lg[lvl.node_mask]).all()),
              f'host-path serving: level {i + 1} logits not finite')
    # level 1 comes back in NAG order: the batch rows' node ids are a
    # permutation that the sort moved, and each row's graph is the graph
    # of the NAG row it maps to
    n1 = n[1]
    nid = batch.level1_node_id[:n1]
    check(np.array_equal(np.sort(nid), np.arange(n1))
          and not np.array_equal(nid, np.arange(n1)),
          'level-1 node ids are not a moved permutation')
    sizes = [nag[1].num_nodes for nag in nags * 2]
    graph_of_row = np.repeat(np.arange(NUM_GRAPHS), sizes)
    check(np.array_equal(graph_of_row[nid],
                         batch[1].batch[:n1].cpu().numpy()),
          'level-1 node ids map rows to another graph')
    check(pred.shape == (n1,) and pred.min() >= 0 and pred.max() < 13,
          'host-path predictions are not a class per level-1 node')
    agree = (pred[nid] == logits[0][:n1].argmax(1).cpu().numpy()).mean()
    check(agree >= BF16_ARGMAX_AGREEMENT,
          f'host-path predictions vs level-1 argmax in NAG order: {agree}')
    serve_launches = launches['K2']

    # e2e_inference on one raw room
    raw = synthetic_room_cloud(seed=SEED, n_points=HOST_ROOM_POINTS)
    n_raw = raw.num_nodes
    reset_counts()
    with plain_attention_calls() as plain:
        full, info = e2e_inference(model, raw)
    launches = counts()
    print(f'e2e_inference: {info}; launches {launches}, plain attention '
          f'calls {plain["plain"]}')
    check(full.shape == (n_raw,) and full.min() >= 0
          and full.max() < 13, 'e2e_inference: a raw point has no label')
    check(launches['K2'] > 0 and launches['K1'] == launches['K3'] == 0
          and plain['plain'] == 0,
          'e2e_inference did not run on K2 alone')
    serve_launches += launches['K2']

    # the forward on the prepared batch beside its random twin
    def forward(b):
        with torch.inference_mode():
            model(b)

    twins = random_twins(batch, SEED + 20, NUM_GRAPHS, compute_dtype,
                         train=False)
    compare_real_random('flagship forward', forward,
                        {'prepared': batch, **twins}, card)
    del batch, twins, logits, model
    settle()

    # training: 4 graphs (the 4 rooms) a batch, 4 crops each
    tcfg = BatchConfig()
    t0 = time.perf_counter()
    tcfg = discover_caps([nags] * HOST_PROBES, tcfg, train=True,
                         rng=np.random.default_rng(SEED))
    caps_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 1)
    t0 = time.perf_counter()
    hosts = [prepare_batch(nags, tcfg, train=True, rng=rng)
             for _ in range(TRAIN_STEPS)]
    print(f'host-path training: caps {tcfg.node_caps} K {tcfg.k_caps} '
          f'K_in {tcfg.k_in_caps} from {HOST_PROBES} probes in '
          f'{caps_s:.2f} s; {TRAIN_STEPS} batches prepared in '
          f'{time.perf_counter() - t0:.2f} s on the host')
    task = build_task(FLAGSHIP_CFG, num_graphs=TRAIN_GRAPHS, device=dev)
    init_weights(task.model, torch.Generator().manual_seed(SEED))
    reset_counts()
    with plain_attention_calls() as plain, \
            widest_call('dense_attention_trainable') as k1_args:
        for step, h in enumerate(hosts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = from_numpy(h, dev, compute_dtype, train=True)
            loss = task.train_step(batch)['loss'].item()
            step_s = time.perf_counter() - t0
            n, caps, k = level_counts(batch)
            print(f'host-path train step {step}: nodes {n}, capacities '
                  f'{caps}, K={k}; loss '
                  f'{loss:.6f}; {step_s * 1e3:.1f} ms (host batch to loss)')
            check(np.isfinite(loss), f'host-path train step {step}: loss '
                  f'{loss}')
    launches = counts()
    print(f'host-path training: launches {launches}, plain attention '
          f'calls {plain["plain"]}')
    check(launches['K1'] == TRAIN_STEPS * K1_LAUNCHES_PER_STEP
          and launches['K2'] == launches['K3'] == 0 and plain['plain'] == 0,
          'host-path training did not run on K1 alone')
    train_launches = launches['K1']
    # K1 vs its plain version on the inputs of its first level-1 launch
    hold_on_path('K1', k1_args)
    del k1_args

    # the step on the prepared batch beside its random twin
    twins = random_twins(batch, SEED + 21, TRAIN_GRAPHS, compute_dtype,
                         train=True)
    compare_real_random('flagship train step', task.train_step,
                        {'prepared': batch, **twins}, card)
    return {'K2': serve_launches, 'K1': train_launches}, nags


def recall(ref, got):
    """Share of the valid neighbors of the [N, k] table `ref` (-1 padded)
    that the table `got` holds in the same row."""
    import numpy as np
    n = ref.shape[0]
    rows = np.arange(n, dtype=np.int64)[:, None] * (n + 1)
    want = (rows + ref)[ref >= 0]
    have = (rows + got)[got >= 0]
    return float(np.isin(want, have).mean())


def sync_count(fn):
    """(fn(), the device-to-host synchronizations that PyTorch's sync
    debug mode reports during it)."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    return out, sum('synchroniz' in str(w.message) for w in caught)


ALLOCATOR_RUN = """
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import superpoint_transformer_torch
from superpoint_transformer_torch.inference import tile_cloud
from superpoint_transformer_torch.transforms.preprocess import (
    preprocess_cloud)
from superpoint_transformer_torch.utils import memory
from superpoint_transformer_torch.utils.synthetic import synthetic_room_cloud
raw = synthetic_room_cloud(seed=int(sys.argv[2]), n_points=int(sys.argv[1]))
t0 = time.perf_counter()
nags = [preprocess_cloud(tile) for tile, _ in tile_cloud(raw, (1, 1))]
print('ALLOCATOR ' + json.dumps({'tuned': memory._MALLOC_TUNED,
                                 'preprocess': time.perf_counter() - t0}))
"""
# fresh processes a setting of the host allocator, in pairs whose order
# alternates (tuned first, then untuned first, ...); 5 pairs resolved no
# effect on an H100 host (PERF.md), and 3 keep the run inside its time
# limit beside the multi-process phase
ALLOCATOR_PAIRS = 3


def allocator_runs(card):
    """The preprocess phase of `e2e_inference` (`preprocess_cloud` of
    each tile of a host-path room, one tile) timed in fresh processes,
    ALLOCATOR_PAIRS with the allocator tuned at import (the default) and
    as many with SPT_NO_MALLOC_TUNING=1, in alternating order; prints
    every reading, the medians and ranges, and whether the ranges are
    apart. Returns {tuned: [seconds]}."""
    import numpy as np
    out = {True: [], False: []}
    order = [t for i in range(ALLOCATOR_PAIRS)
             for t in ((True, False) if i % 2 == 0 else (False, True))]
    for tuned in order:
        env = {k: v for k, v in os.environ.items()
               if k != 'SPT_NO_MALLOC_TUNING'}
        if not tuned:
            env['SPT_NO_MALLOC_TUNING'] = '1'
        res = subprocess.run(
            [sys.executable, '-c', ALLOCATOR_RUN, str(HOST_ROOM_POINTS),
             str(SEED)], cwd=HERE, env=env, capture_output=True, text=True,
            timeout=300)
        check(res.returncode == 0, f'allocator run (tuned={tuned}) failed:\n'
              f'{res.stderr[-2000:]}')
        line = next(ln for ln in res.stdout.splitlines()
                    if ln.startswith('ALLOCATOR '))
        got = json.loads(line[len('ALLOCATOR '):])
        check(got['tuned'] is tuned, f'allocator tuned {got["tuned"]}, '
              f'expected {tuned}')
        out[tuned].append(got['preprocess'])
    on, off = out[True], out[False]
    apart = max(on) < min(off) or max(off) < min(on)
    print(f'e2e_inference\'s preprocess phase of a room of '
          f'{HOST_ROOM_POINTS} raw points on {card}\'s host, each in a fresh '
          f'process, {ALLOCATOR_PAIRS} pairs in alternating order (s): '
          f'allocator tuned (default) {on}, median {np.median(on)}, range '
          f'{min(on)}-{max(on)}; untuned (SPT_NO_MALLOC_TUNING=1) {off}, '
          f'median {np.median(off)}, range {min(off)}-{max(off)}; ranges '
          f'{"apart" if apart else "overlap: no effect resolved"}')
    return out


def preprocess_room(args):
    """(seconds, nodes per level) of `preprocess_cloud` with the KNN
    `backend` on `device` of the synthetic room `seed` of `n_points` raw
    points; a dataset worker's task (`map_in_workers`)."""
    seed, n_points, backend, device = args
    from superpoint_transformer_torch.transforms.preprocess import (
        preprocess_cloud)
    from superpoint_transformer_torch.utils.synthetic import (
        synthetic_room_cloud)
    raw = synthetic_room_cloud(seed=seed, n_points=n_points)
    t0 = time.perf_counter()
    nag = preprocess_cloud(raw, knn_backend=backend, device=device)
    return time.perf_counter() - t0, [nag[i].num_nodes for i in nag.levels]


def dataset_pool_runs(card, dev, rooms):
    """Dataset preprocessing of `rooms` host-path rooms, timed three
    ways: with the device KNN one by one in this process; with it over
    as many spawned workers that see the card (`map_in_workers`, as
    `BaseDataset.process` runs them), which must give the same nodes per
    level; with the host KNN over as many workers that see no card."""
    from superpoint_transformer_torch.datasets import base

    def tasks(backend, device):
        return [(SEED + i, HOST_ROOM_POINTS, backend, device)
                for i in range(rooms)]

    t0 = time.perf_counter()
    alone = [preprocess_room(t) for t in tasks('device', str(dev))]
    alone_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pooled = base.map_in_workers(preprocess_room, tasks('device', str(dev)),
                                 rooms, card=True)
    pool_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = base.map_in_workers(preprocess_room, tasks('host', 'cpu'), rooms)
    host_s = time.perf_counter() - t0
    rounded = lambda runs: [round(r[0], 2) for r in runs]
    print(f'dataset preprocessing of {rooms} rooms of {HOST_ROOM_POINTS} '
          f'raw points on {card} ({os.cpu_count()} host cores), wall s with '
          f'the workers\' start, then s a room: device KNN in this process '
          f'one by one {alone_s:.2f} {rounded(alone)}; device KNN over '
          f'{rooms} spawned workers that see the card {pool_s:.2f} '
          f'{rounded(pooled)}; host KNN over {rooms} workers that see no '
          f'card {host_s:.2f} {rounded(host)}')
    check([a[1] for a in alone] == [p[1] for p in pooled],
          'the dataset workers\' device preprocessing differs from this '
          'process\'s')
    check(all(len(h[1]) == 4 for h in host),
          'the host-KNN workers did not preprocess 4 levels')


def reference_state_dict(module):
    """The reference-format state_dict of a port module (the inverse of
    `import_reference_checkpoint`, `utils/import_ckpt.py`)."""
    from superpoint_transformer_torch.utils.import_ckpt import (
        reference_state_dict as state_dict)
    return state_dict(module)


def phase_whole_cloud(dev, card, nags):
    """Whole-cloud serving on the host path's rooms `nags`: the device
    preprocessing (grid KNN, voxelization, eigen features) on the card,
    held against the same functions on CPU tensors and against the host
    versions, and timed against the host KNN; `preprocess_cloud` and
    `e2e_inference` with `knn_backend='device'`; `infer_nags_stacked`
    over the rooms, bit-equal to the per-tile `infer_nag` loop and to
    itself, timed against the loop with its synchronizations counted,
    and K2 held on a stacked tile's inputs; a reference-format
    checkpoint round trip of the flagship (bit-equal logits); dataset
    preprocessing with the device KNN in this process and over workers
    that see the card; the device memory statistics and the host
    allocator's effect on `e2e_inference`'s preprocessing. Returns the K2
    launches of its serving runs."""
    import dataclasses
    import numpy as np
    import torch
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.experiment import (FLAGSHIP_CFG,
                                                         build_model)
    from superpoint_transformer_torch.inference import (
        EVAL_BATCH_OVERRIDES, e2e_inference, infer_nag, infer_nags_stacked,
        pin_signature)
    from superpoint_transformer_torch.models.semantic import (
        SemanticSegmentationModel)
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.ops.device_preprocess import (
        grid_knn_device, voxelize_device)
    from superpoint_transformer_torch.ops.geometry import (
        geometric_features, geometric_features_np)
    from superpoint_transformer_torch.transforms.prepare import (
        BatchConfig, prepare_batch, process_batch)
    from superpoint_transformer_torch.transforms.preprocess import (
        _device_knn_grid, grid_sampling, knn_search, preprocess_cloud)
    from superpoint_transformer_torch.utils.import_ckpt import (
        import_reference_checkpoint)
    from superpoint_transformer_torch.utils.memory import (
        device_memory_stats)
    from superpoint_transformer_torch.utils.synthetic import (
        synthetic_room_cloud)

    settle()
    raw = synthetic_room_cloud(seed=SEED, n_points=HOST_ROOM_POINTS)
    n_raw = raw.num_nodes
    per_m = 1e6 / n_raw

    # voxelization on the card vs the host grouping of the same cells
    pos_raw = np.asarray(raw.pos, np.float32)
    vox_cap = 1 << int(np.ceil(np.log2(n_raw)))
    t0 = time.perf_counter()
    out = voxelize_device(torch.from_numpy(pos_raw).to(dev),
                          torch.zeros((n_raw, 0), device=dev),
                          torch.ones(n_raw, dtype=torch.bool, device=dev),
                          VOXEL, vox_cap)
    nv = int(out['num_voxels'])
    vox_s = time.perf_counter() - t0
    cells = np.floor(pos_raw / np.float32(VOXEL)).astype(np.int64)
    _, inv, cnt = np.unique(cells, axis=0, return_inverse=True,
                            return_counts=True)
    sums = np.zeros((len(cnt), 3))
    np.add.at(sums, inv.ravel(), pos_raw.astype(np.float64))
    sup = out['super_index'].cpu().numpy()
    mean_err = np.abs(out['pos_mean'][:nv].cpu().numpy()
                      - sums / cnt[:, None]).max()
    vox = grid_sampling(raw.clone(), VOXEL, hist_key='y', hist_size=14)
    print(f'voxelize_device on {card}: {n_raw} raw points -> {nv} voxels '
          f'(floor cells; grid_sampling\'s rounded cells give '
          f'{vox.num_nodes}) in {vox_s * 1e3:.1f} ms with the first call; '
          f'ids and counts equal to the host grouping: '
          f'{np.array_equal(sup, inv.ravel())}, '
          f'{np.array_equal(out["counts"][:nv].cpu().numpy(), cnt)}; '
          f'mean positions max abs err {mean_err:.3e}')
    check(nv == len(cnt) and np.array_equal(sup, inv.ravel())
          and np.array_equal(out['counts'][:nv].cpu().numpy(), cnt)
          and mean_err <= VOXEL_MEAN_ATOL,
          'voxelize_device disagrees with the host grouping')

    # the KNN of the flagship preprocessing on the room's voxels: host
    # (native) vs device (torch ops on the card), each timed
    def knn(backend):
        d = grid_sampling(raw.clone(), VOXEL, hist_key='y', hist_size=14)
        t0 = time.perf_counter()
        d = knn_search(d, k=45, r_max=2.0, backend=backend, device=dev)
        return d, time.perf_counter() - t0

    knn('device')                                   # warm-up
    host_d, host_s = knn('host')
    dev_d, dev_s = knn('device')
    rec = recall(host_d.neighbor_index.astype(np.int64),
                 dev_d.neighbor_index)
    pos = np.asarray(dev_d.pos, np.float32)
    h, cell_cap, r = _device_knn_grid(pos, 2.0)
    print(f'knn_search (k=45, r_max=2) of {len(pos)} voxels on {card}: '
          f'host (native) {host_s:.3f} s = {host_s * per_m:.3f} s per 1M '
          f'raw points; device (torch) {dev_s:.3f} s = '
          f'{dev_s * per_m:.3f} s per 1M raw points (grid h={h}, '
          f'cell_cap={cell_cap}, r={r}, reach 3); device recall of the '
          f'host neighbors {rec:.5f}')
    check(rec >= KNN_RECALL_MIN, f'device KNN recall {rec} below '
          f'{KNN_RECALL_MIN}')

    # the device KNN on the card vs the same function on CPU tensors, on
    # a quarter of the room (x and y below their medians)
    q = (pos[:, 0] < np.median(pos[:, 0])) & (pos[:, 1] < np.median(pos[:, 1]))
    kw = dict(r=r, k=45, cell_cap=cell_cap, reach=3, cell_size=h,
              chunk=2048)
    sub = torch.from_numpy(pos[q])
    ones = torch.ones(len(sub), dtype=torch.bool)
    t0 = time.perf_counter()
    cpu_nbr, cpu_dist = grid_knn_device(sub, ones, **kw)
    cpu_s = time.perf_counter() - t0
    gpu_nbr, gpu_dist = grid_knn_device(sub.to(dev), ones.to(dev), **kw)
    gpu_nbr, gpu_dist = gpu_nbr.cpu(), gpu_dist.cpu()
    fin = torch.isfinite(cpu_dist)
    dist_err = ((gpu_dist[fin] - cpu_dist[fin]).abs()
                / cpu_dist[fin].clamp(min=1e-30)).max().item()
    print(f'grid_knn_device on {card} vs on CPU tensors ({len(sub)} voxels, '
          f'{os.cpu_count()} host cores, {cpu_s:.2f} s there): ids equal '
          f'{torch.equal(gpu_nbr, cpu_nbr)}, distances max rel err '
          f'{dist_err:.3e}')
    check(torch.equal(gpu_nbr, cpu_nbr)
          and torch.equal(torch.isfinite(gpu_dist), fin)
          and dist_err <= KNN_DIST_RTOL,
          'grid_knn_device on the card disagrees with the CPU')

    # eigen features on the card vs the host's native kernel
    nbr = dev_d.neighbor_index
    t0 = time.perf_counter()
    feats = geometric_features(torch.from_numpy(pos).to(dev),
                               torch.from_numpy(nbr).to(dev),
                               torch.from_numpy(nbr >= 0).to(dev), k_min=1)
    feats = {k: v.cpu().numpy() for k, v in feats.items()}
    geo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = geometric_features_np(pos, nbr, nbr >= 0, k_min=1,
                                raw_invalid=True)
    geo_np_s = time.perf_counter() - t0
    errs = {k: float(np.abs(feats[k] - ref[k]).max()) for k in ref
            if k != 'normal'}
    defined = ref['planarity'][:, 0] > NORMAL_PLANARITY_MIN
    dots = np.abs((feats['normal'] * ref['normal']).sum(1))[defined]
    print(f'geometric_features on {card} ({geo_s:.3f} s with the copies) '
          f'vs geometric_features_np (native, {geo_np_s:.3f} s): max abs '
          f'err {errs}; normals where planarity > {NORMAL_PLANARITY_MIN} '
          f'({defined.mean():.4f} of the voxels): min |cos| '
          f'{dots.min():.6f}')
    check(max(errs.values()) <= GEOF_ATOL and dots.min() >= NORMAL_COS_MIN,
          'geometric_features on the card disagrees with the host')

    # a room preprocessed with the device KNN, then e2e_inference with it
    t0 = time.perf_counter()
    dnag = preprocess_cloud(raw.clone(), knn_backend='device',
                            device=dev)
    pre_s = time.perf_counter() - t0
    check(dnag.num_levels == 4 and all(dnag[i].num_nodes > 0
                                       for i in dnag.levels),
          'preprocess_cloud(knn_backend="device"): a level is empty')
    print(f'preprocess_cloud(knn_backend="device") of room 0 on {card}: '
          f'{pre_s:.2f} s ({pre_s * per_m:.2f} s per 1M raw points), nodes '
          f'per level {[dnag[i].num_nodes for i in dnag.levels]}')
    model = SemanticSegmentationModel(build_model(
        FLAGSHIP_CFG, num_graphs=1, device=dev), 13, device=dev)
    init_weights(model, torch.Generator().manual_seed(SEED))
    model.eval()
    reset_counts()
    with plain_attention_calls() as plain:
        full, info = e2e_inference(model, raw.clone(), pre_cfg=dict(
            knn_backend='device', device=dev))
    launches = counts()
    print(f'e2e_inference with the device KNN on {card}: {info}; launches '
          f'{launches}')
    check(full.shape == (n_raw,) and full.min() >= 0 and full.max() < 13
          and launches['K2'] == 2 * K2_LAUNCHES_PER_FORWARD
          and launches['K1'] == launches['K3'] == plain['plain'] == 0,
          'e2e_inference with the device KNN: a raw point has no label, or '
          'not K2 alone (a warm-up and a forward)')
    served = launches['K2']

    # stacked serving of the 4 host-path rooms vs the per-tile loop
    cfg = dataclasses.replace(BatchConfig(), **EVAL_BATCH_OVERRIDES)
    cfg = pin_signature([process_batch([n], cfg, train=False)
                         for n in nags], cfg)
    reset_counts()
    times = {'loop': [], 'stacked': []}
    preds = {'loop': [], 'stacked': []}
    # K2 is held on the stacked run's last tile: its inputs are views at
    # a non-zero offset into the chunk's stacked tensors (the mask, the
    # 11th argument, is the batch's own)
    with widest_call('dense_attention_rpe', rank=lambda args: (
            args[0].shape[0], args[10].storage_offset())) as k2_args:
        for name in ('loop', 'stacked', 'stacked', 'loop'):
            t = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == 'loop':
                p = [infer_nag(model, n, cfg, timings=t) for n in nags]
            else:
                p = infer_nags_stacked(model, nags, cfg, timings=t)
            t['wall'] = time.perf_counter() - t0
            times[name].append(t)
            preds[name].append(p)
    launches = counts()
    check(launches['K2'] == 4 * len(nags) * K2_LAUNCHES_PER_FORWARD
          and launches['K1'] == launches['K3'] == 0,
          'stacked and loop serving: not 7 K2 launches a room')
    served += launches['K2']
    loop_p, st_p = preds['loop'], preds['stacked']
    check(all(np.array_equal(a, b) for run in loop_p + st_p[1:]
              for a, b in zip(st_p[0], run)),
          'stacked predictions differ from the per-tile loop or between '
          'two stacked runs')
    _, st_syncs = sync_count(lambda: infer_nags_stacked(model, nags, cfg))
    _, loop_syncs = sync_count(lambda: [infer_nag(model, n, cfg)
                                        for n in nags])
    fmt = lambda ts: [{k: round(v * 1e3, 2) for k, v in t.items()}
                      for t in ts]
    print(f'serving the {len(nags)} host-path rooms on {card} (ms, rounds '
          f'loop, stacked, stacked, loop): per-tile infer_nag loop '
          f'{fmt(times["loop"])}; infer_nags_stacked (one chunk of '
          f'{len(nags)}) {fmt(times["stacked"])}; predictions bit-equal '
          f'(loop = stacked, stacked twice); device-to-host '
          f'synchronizations flagged by torch.cuda.set_sync_debug_mode: '
          f'stacked {st_syncs} for the chunk, loop {loop_syncs} for '
          f'{len(nags)} tiles')
    served += counts()['K2'] - launches['K2']
    offset = k2_args[10].storage_offset()
    print(f'K2 held on the stacked chunk\'s tile {len(nags) - 1}: its mask '
          f'sits at element {offset} of its stacked tensor '
          f'({k2_args[10].untyped_storage().nbytes()} bytes)')
    check(offset > 0, 'the K2 call kept is not a stacked tile\'s')
    hold_on_path('K2', k2_args, 'whole-cloud path')

    # a reference-format checkpoint of the flagship, imported into a
    # model of other weights: the same parameters and logits, bit for bit
    twin = SemanticSegmentationModel(build_model(
        FLAGSHIP_CFG, num_graphs=1, device=dev), 13, device=dev)
    init_weights(twin, torch.Generator().manual_seed(SEED + 30))
    twin.eval()
    state = reference_state_dict(model)
    report = import_reference_checkpoint(state, twin)
    same = all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 twin.parameters()))
    batch = from_numpy(prepare_batch([nags[0]], cfg, train=False), dev,
                       model.net.compute_dtype)
    reset_counts()
    with torch.inference_mode():
        a, b = model(batch), twin(batch)
    served += counts()['K2']
    print(f'reference checkpoint round trip on {card}: '
          f'{len(report["mapped"])} tensors mapped, missing '
          f'{report["missing"]}, unused {report["unused_reference_keys"]}; '
          f'parameters equal {same}; logits bit-equal '
          f'{all(torch.equal(x, y) for x, y in zip(a, b))}')
    check(same and not report['missing']
          and not report['unused_reference_keys']
          and all(torch.equal(x, y) for x, y in zip(a, b)),
          'reference checkpoint round trip: parameters or logits differ')
    del a, b, batch, twin, model

    stats = device_memory_stats()['cuda:0']
    print('device_memory_stats cuda:0 on ' + card + ': ' + json.dumps(
        {k: stats[k] for k in ('allocated_bytes.all.peak',
                               'reserved_bytes.all.peak',
                               'allocated_bytes.all.current',
                               'num_alloc_retries', 'num_ooms')}))
    settle()
    dataset_pool_runs(card, dev, len(nags))
    settle()
    allocator_runs(card)
    return served


# ---- multi-process training and serving (parallel/), two ranks on one card
# over gloo: a correctness run, not a scaling one (NCCL refuses two ranks
# on one device)
def parallel_task(dev, shard_group=None, compute_dtype='auto'):
    """The flagship semantic task at TRAIN_GRAPHS graphs, weights from
    SEED: the same in every process."""
    import torch
    from superpoint_transformer_torch.experiment import (FLAGSHIP_CFG,
                                                         build_task)
    from superpoint_transformer_torch.nn.mlp import init_weights
    task = build_task(FLAGSHIP_CFG, num_graphs=TRAIN_GRAPHS,
                      compute_dtype=compute_dtype, device=dev,
                      shard_group=shard_group)
    init_weights(task.model, torch.Generator().manual_seed(SEED))
    return task


def flat_params(module):
    import torch
    return torch.cat([p.detach().reshape(-1).float()
                      for p in module.parameters()]).cpu()


def flat_grads(module):
    import torch
    return torch.cat([(p.grad if p.grad is not None else
                       torch.zeros_like(p)).reshape(-1).float()
                      for p in module.parameters()]).cpu()


def launch_ranks(fn, args):
    """`fn(rank, world_size, init_method, *args)` in PARALLEL_RANKS
    spawned processes (`parallel.multihost.run_ranks`); their results in
    rank order. A rank that fails, or ranks not done in PARALLEL_TIMEOUT
    s, raise."""
    from superpoint_transformer_torch.parallel import run_ranks
    return run_ranks(fn, PARALLEL_RANKS, args=args, timeout=PARALLEL_TIMEOUT)


def rank_mesh(make, rank, world_size, init_method, dev):
    import torch
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    return make(device=dev, backend='gloo', init_method=init_method,
                rank=rank, world_size=world_size)


def rank_ms(fn, rounds):
    """Mean wall ms of `fn()` over `rounds` calls after one, the card
    synchronized around them (a call holds host collectives)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / rounds * 1e3


def dp_rank(rank, world_size, init_method, dev, hosts):
    """Rank `rank` of the data-parallel phase: the flagship bf16 task on
    batch `hosts[rank]`, one DP step counted, then the same step from
    fresh weights (the rerun), K1 held on rank 0's widest launch, and the
    step timed."""
    import torch
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.parallel import (make_data_mesh,
                                                       make_dp_train_step)
    mesh = rank_mesh(make_data_mesh, rank, world_size, init_method, dev)
    runs = []
    for run in range(2):
        task = parallel_task(dev)
        step = make_dp_train_step(task, mesh)
        batch = from_numpy(hosts[rank], dev, task.model.net.compute_dtype,
                           train=True)
        reset_counts()
        with widest_call('dense_attention_trainable') as k1_args:
            m = step(batch)
        torch.cuda.synchronize()
        runs.append(dict(launches=counts(), loss=m['loss'].cpu(),
                         confmat=m['confmat'].cpu(),
                         params=flat_params(task.model)))
    if rank == 0:
        hold_on_path('K1', k1_args, 'data-parallel path')
    del k1_args
    return dict(runs=runs, step_ms=rank_ms(lambda: step(batch),
                                           PARALLEL_ROUNDS))


def sharded_rank(rank, world_size, init_method, dev, shards):
    """Rank `rank` of the graph-sharded phase on its shard of one room:
    the sharded forward in f32 and bf16 (K2 counted, held on rank 0's
    widest launch), then one sharded train step in each (K1 counted); the
    forward and the k/v all-gather of a level-1 block timed."""
    import torch
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.parallel import (
        all_gather_rows, make_shard_mesh, make_sharded_forward,
        make_sharded_train_step)
    mesh = rank_mesh(make_shard_mesh, rank, world_size, init_method, dev)
    out = {}
    for cd in (None, 'bfloat16'):
        task = parallel_task(dev, mesh.group, cd)
        fwd = make_sharded_forward(task.model, mesh)
        batch = from_numpy(shards[rank], dev, cd)
        reset_counts()
        with widest_call('dense_attention_rpe') as k2_args:
            logits = fwd(batch)
        torch.cuda.synchronize()
        out[f'forward {cd or "float32"}'] = dict(
            launches=counts(), logits=[x.float().cpu() for x in logits])
    if rank == 0:
        hold_on_path('K2', k2_args, 'graph-sharded path')
    del k2_args
    out['forward_ms'] = rank_ms(lambda: fwd(batch), PARALLEL_ROUNDS)
    # the joint k/v rows of a level-1 block, as its attention gathers them
    sa = task.model.net.down_stage_0.block_0.sa
    kv = torch.randn(shards[rank].levels[1].pos.shape[0],
                     sa.num_heads * sa.qk_dim + sa.dim,
                     device=dev).bfloat16()
    out['all_gather_ms'] = rank_ms(lambda: all_gather_rows(kv, mesh.group),
                                   4 * PARALLEL_ROUNDS)
    out['all_gather_rows'] = tuple(kv.shape)
    for cd in (None, 'bfloat16'):
        task = parallel_task(dev, mesh.group, cd)
        batch = from_numpy(shards[rank], dev, cd, train=True)
        reset_counts()
        m = make_sharded_train_step(task, mesh)(batch)
        torch.cuda.synchronize()
        out[f'train {cd or "float32"}'] = dict(
            launches=counts(), loss=m['loss'].cpu(),
            confmat=m['confmat'].cpu(), grads=flat_grads(task.model),
            params=flat_params(task.model))
    return out


def phase_parallel(dev, card, nags):
    """Data-parallel and graph-partition-parallel runs of the flagship
    over `parallel/`, two spawned ranks that share the card over gloo
    (a file store in a temporary directory): (a) one DP step of two
    4-crop random batches (the training phase's first two) against the
    single-process step on the same weights (the two gradients summed
    and halved, one AdamW update): loss, confusion matrix and parameters
    bit-equal, and a rerun bit-equal; (b) the host path's room 0 sharded
    over the two ranks (`shard_padded_nag`): the sharded forward in f32
    and bf16 against the unsharded forward of the same NAG, one sharded
    train step in each against the unsharded step (the limits:
    SHARDED_*, TRAIN_TOL). The kernels are built
    before the ranks start; the ranks only load them. Returns the
    launches of each path, summed over the ranks."""
    import dataclasses
    import numpy as np
    import torch
    from superpoint_transformer_torch.data.pad import (pad_nag,
                                                       sort_nag_by_super)
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.inference import EVAL_BATCH_OVERRIDES
    from superpoint_transformer_torch.optim.lr_scheduler import set_lr
    from superpoint_transformer_torch.parallel import shard_padded_nag
    from superpoint_transformer_torch.parallel.shard_nag import (
        shard_assignment)
    from superpoint_transformer_torch.transforms.prepare import (
        BatchConfig, process_batch)
    from superpoint_transformer_torch.utils.synthetic import (
        random_padded_nag)

    settle()
    R = PARALLEL_RANKS
    paths = {}
    # (a) data parallelism
    hosts = [random_padded_nag(seed=SEED + 10 + r, num_graphs=TRAIN_GRAPHS,
                               **CROP) for r in range(R)]
    t0 = time.perf_counter()
    ranks = launch_ranks(dp_rank, (dev, hosts))
    wall = time.perf_counter() - t0
    task = parallel_task(dev)
    cd = task.model.net.compute_dtype
    task.model.train()
    grads, losses, cm = [], [], 0
    for host in hosts:
        batch = from_numpy(host, dev, cd, train=True)
        task.optimizer.zero_grad(set_to_none=True)
        loss, logits = task.loss(batch)
        loss.backward()
        grads.append([p.grad for p in task.model.parameters()])
        losses.append(loss.detach())
        cm = cm + task._confmat(logits, batch)
    for p, *g in zip(task.model.parameters(), *grads):
        p.grad = None if g[0] is None else sum(g) / R
    set_lr(task.optimizer, task.schedules, 0, 1.0)
    task.optimizer.step()
    ref = dict(loss=(sum(losses) / R).cpu(), confmat=cm.cpu(),
               params=flat_params(task.model))
    del task, grads, batch
    for r, got in enumerate(ranks):
        first, rerun = got['runs']
        same = {k: torch.equal(first[k], ref[k]) for k in ref}
        again = all(torch.equal(first[k], rerun[k]) for k in ref)
        diff = (first['params'] - ref['params']).abs().max().item()
        print(f'data-parallel rank {r} of {R} (two ranks on one card, gloo; '
              f'correctness only): loss {first["loss"].item():.6f} vs the '
              f'single-process step {ref["loss"].item():.6f}; bit-equal '
              f'{same} (parameters max abs {diff:.3e}); rerun bit-equal '
              f'{again}; launches {first["launches"]}; DP step '
              f'{got["step_ms"]:.2f} ms on {card} (wall, {PARALLEL_ROUNDS} '
              'steps)')
        check(all(same.values()) and again,
              f'data-parallel rank {r}: not bit-equal to the single-process '
              'step or to its rerun')
        check(first['launches']['K1'] == K1_LAUNCHES_PER_STEP
              and first['launches']['K2'] == first['launches']['K3'] == 0,
              f'data-parallel rank {r}: not {K1_LAUNCHES_PER_STEP} K1 '
              'launches alone')
    paths['data-parallel'] = {'K1': sum(g['runs'][0]['launches']['K1']
                                        for g in ranks)}
    print(f'data-parallel phase: {R} ranks in {wall:.1f} s (spawn, build, '
          'steps)')

    # (b) graph-partition sharding of room 0
    settle()
    cfg = dataclasses.replace(BatchConfig(), **EVAL_BATCH_OVERRIDES)
    big = sort_nag_by_super(process_batch([nags[0]], cfg, train=False))
    shards = shard_padded_nag(big.clone(), R, num_classes=13)
    assign = shard_assignment(big, R)[1]
    host = pad_nag(big, num_classes=13, bucket_mode=cfg.bucket_mode)
    n1 = int(host.levels[1].num_nodes)
    caps = [[int(s.levels[i].pos.shape[0]) for i in range(len(s.levels))]
            for s in shards]
    t0 = time.perf_counter()
    ranks = launch_ranks(sharded_rank, (dev, shards))
    wall = time.perf_counter() - t0
    print(f'graph-sharded room 0: {[lvl.num_nodes for lvl in host.levels]} '
          f'nodes per level over {R} ranks, shard capacities {caps}; '
          f'{wall:.1f} s (spawn, build, runs)')
    for cd in (None, 'bfloat16'):
        task = parallel_task(dev, compute_dtype=cd)
        task.model.eval()
        with torch.inference_mode():
            want = task.model(from_numpy(host, dev, cd))[0][:n1].float()
        got = [o[f'forward {cd or "float32"}'] for o in ranks]
        for r, g in enumerate(got):
            lg = g['logits'][0]
            cap = lg.shape[0] // R
            lg = lg[torch.from_numpy(assign[0].astype(np.int64) * cap
                                     + assign[1])].to(want.device)
            err, mean, agree = logit_diff(lg, want)
            print(f'graph-sharded forward, rank {r}, {cd or "float32"} '
                  f'level-1 logits vs the unsharded forward: max_abs_err='
                  f'{err:.3e} mean={mean:.3e} argmax agreement {agree:.5f}; '
                  f'launches {g["launches"]}')
            if cd is None:
                check(err <= SHARDED_F32_LOGIT_MAX_ABS
                      and agree >= F32_ARGMAX_AGREEMENT,
                      f'graph-sharded f32 logits beyond '
                      f'{SHARDED_F32_LOGIT_MAX_ABS} or agreement '
                      f'{agree:.5f} below {F32_ARGMAX_AGREEMENT}')
            else:
                check(mean <= SHARDED_BF16_LOGIT_MEAN_MAX
                      and agree >= SHARDED_BF16_ARGMAX_AGREEMENT,
                      f'graph-sharded bf16 logits: mean {mean:.3e} beyond '
                      f'{SHARDED_BF16_LOGIT_MEAN_MAX} or agreement '
                      f'{agree:.5f} below {SHARDED_BF16_ARGMAX_AGREEMENT}')
            check(g['launches']['K2'] == K2_LAUNCHES_PER_FORWARD
                  and g['launches']['K1'] == g['launches']['K3'] == 0,
                  f'graph-sharded forward rank {r}: not '
                  f'{K2_LAUNCHES_PER_FORWARD} K2 launches alone')
    for cd in (None, 'bfloat16'):
        task = parallel_task(dev, compute_dtype=cd)
        p0 = flat_params(task.model)
        m = task.train_step(from_numpy(host, dev, cd, train=True))
        want = dict(loss=m['loss'].cpu(), confmat=m['confmat'].cpu(),
                    grads=flat_grads(task.model),
                    params=flat_params(task.model))
        hold_sharded_step(ranks, cd, want, p0)
    for r, o in enumerate(ranks):
        print(f'graph-sharded timing, rank {r} on {card} (two ranks on one '
              f'card, gloo; correctness only): forward '
              f'{o["forward_ms"]:.2f} ms, all_gather_rows of a level-1 '
              f'block {o["all_gather_rows"]} bf16 {o["all_gather_ms"]:.3f} ms '
              f'(wall, through the host)')
    paths['graph-sharded'] = {
        name: sum(o[f'{kind} {cd}']['launches'][name] for o in ranks
                  for cd in ('float32', 'bfloat16'))
        for name, kind in (('K1', 'train'), ('K2', 'forward'))}
    del task
    settle()
    return paths


def hold_sharded_step(ranks, cd, want, p0):
    """Each rank's sharded train step in the compute dtype `cd` against
    the unsharded one (`want`: loss, confusion matrix, gradients and
    parameters after the step, from the parameters `p0`): the loss and
    the gradients within TRAIN_TOL, and so the update where the gradient
    is above 1e-3 of its largest (AdamW's first step is lr * g / (|g| +
    eps): an entry whose gradient is rounding noise steps with an
    arbitrary sign); in f32 the confusion matrix equal; in bf16, whose
    logits round differently, the confusion matrix off by at most
    SHARDED_BF16_CONFMAT_OFF of the label mass."""
    import torch
    label = cd or 'float32'
    tol_loss, tol_grad = TRAIN_TOL[('flagship', cd)]
    big_g = want['grads'].abs() > 1e-3 * want['grads'].abs().max()
    for r, o in enumerate(ranks):
        t = o[f'train {label}']
        loss_err = (abs(t['loss'] - want['loss']) / want['loss'].abs()).item()
        grad_err = rel_l2(t['grads'], want['grads'])
        upd_err = rel_l2((t['params'] - p0)[big_g],
                         (want['params'] - p0)[big_g])
        cm_off = (t['confmat'] - want['confmat']).abs().sum().item()
        mass = want['confmat'].sum().item()
        print(f'graph-sharded {label} train step, rank {r}: loss '
              f'{t["loss"].item():.6f} vs unsharded {want["loss"].item():.6f} '
              f'(rel {loss_err:.3e}, limit {tol_loss}); gradients rel L2 '
              f'{grad_err:.3e} (limit {tol_grad}); update rel L2 '
              f'{upd_err:.3e} over {int(big_g.sum())} of {big_g.numel()} '
              f'entries; confusion matrix off by {cm_off} of {mass}; '
              f'launches {t["launches"]}')
        check(loss_err <= tol_loss and grad_err <= tol_grad
              and upd_err <= tol_grad,
              f'graph-sharded {label} train step rank {r}: the loss, the '
              'gradients or the update beyond TRAIN_TOL')
        if cd is None:
            check(cm_off == 0, f'graph-sharded f32 train step rank {r}: '
                  'another confusion matrix')
        else:
            check(cm_off <= SHARDED_BF16_CONFMAT_OFF * mass,
                  f'graph-sharded bf16 train step rank {r}: confusion '
                  f'matrix off by more than {SHARDED_BF16_CONFMAT_OFF} of '
                  'the label mass')
        check(t['launches']['K1'] == K1_LAUNCHES_PER_STEP
              and t['launches']['K2'] == t['launches']['K3'] == 0,
              f'graph-sharded train step rank {r}: not '
              f'{K1_LAUNCHES_PER_STEP} K1 launches alone')


def phase_tune(dev, card, tmp):
    """`tune.main` over the fit phase's rooms: TUNE_TRIALS trials of one
    epoch each through `train(cfg, datasets)` (the clouds are the fit
    phase's, preprocessed once), LRs drawn from seed 0; every trial must
    have a score."""
    import copy
    from superpoint_transformer_torch.config.loader import _to_config
    from superpoint_transformer_torch.experiment import FLAGSHIP_CFG
    from superpoint_transformer_torch.train import train
    from superpoint_transformer_torch.tune import main as tune_main

    settle()
    base = _to_config(copy.deepcopy(FLAGSHIP_CFG))
    for key, value in (('device', str(dev)),
                       ('datamodule.data_dir', os.path.join(tmp.name,
                                                            's3dis')),
                       ('trainer.max_epochs', 1),
                       ('trainer.check_val_every_n_epoch', 1)):
        base.set_path(key, value)

    def trial(overrides):
        cfg = copy.deepcopy(base)
        for o in overrides:
            key, _, value = o.partition('=')
            try:
                value = float(value)
            except ValueError:
                pass
            cfg.set_path(key, value)
        return train(cfg, s3dis_datasets(cfg)).best_miou

    out = os.path.join(tmp.name, 'tune')
    reset_counts()
    t0 = time.perf_counter()
    with plain_attention_calls() as plain:
        best = tune_main([f'n_trials={TUNE_TRIALS}', f'tune_dir={out}',
                          'space.model.optimizer.lr=loguniform(1e-3,1e-1)'],
                         train_main=trial)
    wall = time.perf_counter() - t0
    launches = counts()
    with open(os.path.join(out, 'tune_results.json')) as f:
        results = json.load(f)
    print(f'tune on {card}: {len(results)} trials of one epoch in '
          f'{wall:.1f} s: {results}; best {best}; launches {launches}, '
          f'plain attention calls {plain["plain"]}')
    check(len(results) == TUNE_TRIALS and all(
        r['score'] is not None for r in results) and best is not None,
          'tune: a trial failed')
    check(launches['K1'] > 0 and launches['K2'] > 0
          and launches['K3'] == 0 and plain['plain'] == 0,
          'tune: not K1 and K2 alone')
    return {'K1': launches['K1'], 'K2': launches['K2']}


class OracleTask:
    """A stand-in for a `PanopticTask` in `validate_panoptic`: its
    evaluation outputs are ground truth, not a model's. The level-1
    logits put ORACLE_LOGIT on each node's majority label, the
    edge-affinity logits are +-ORACLE_LOGIT by the target affinity of the
    instance graph. `model` is the real task's (its device and dtype)."""

    def __init__(self, model, num_classes):
        self.model = model
        self.num_classes = num_classes

    def eval_step(self, batch):
        import torch
        lvl1 = batch[1]
        y = lvl1.y[:, :self.num_classes].argmax(1)
        logits = torch.nn.functional.one_hot(
            y, self.num_classes).float() * ORACLE_LOGIT
        ea = (lvl1.obj_edge_affinity > 0.5).float() * 2 - 1
        return {'logits_level1': logits,
                'edge_affinity_logits': ea * ORACLE_LOGIT}


@contextlib.contextmanager
def host_timers(module, names):
    """Wall-clock seconds and calls of `module`'s functions `names` while
    the block runs: {name: [seconds, calls]}."""
    spent = {name: [0.0, 0] for name in names}
    saved = {name: getattr(module, name) for name in names}

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name][0] += time.perf_counter() - t0
                spent[name][1] += 1
        return wrapped

    for name, fn in saved.items():
        setattr(module, name, timed(name, fn))
    try:
        yield spent
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def phase_panoptic(dev, card):
    """SuperCluster at SPT-2 width on preprocessed synthetic rooms with
    instance ids: `preprocess_cloud(with_instances=True)`, then
    `validate_panoptic` in bf16 (K2; the instance partition, its grid
    search on the first batch, PQ and mAP on the host), one evaluation
    held to the plain attention in f32, the same partition and metrics
    on oracle inputs, and `PanopticTask.train_step`s (K1), one held to
    the plain attention; times of each."""
    import dataclasses
    import numpy as np
    import torch
    from superpoint_transformer_torch import trainer
    from superpoint_transformer_torch.data.csr import InstanceData
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.experiment import (
        NANO_CFG, PANOPTIC_CFG, build_task)
    from superpoint_transformer_torch.inference import EVAL_BATCH_OVERRIDES
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.transforms.prepare import (
        BatchConfig, prepare_batch)
    from superpoint_transformer_torch.transforms.preprocess import (
        preprocess_cloud)
    from superpoint_transformer_torch.utils.synthetic import (
        room_instances, synthetic_room_cloud)

    settle()
    dm = PANOPTIC_CFG['datamodule']
    num_classes = dm['num_classes']
    stuff = tuple(dm['stuff_classes'])
    nags = []
    for i in range(PANOPTIC_ROOMS):
        raw = synthetic_room_cloud(seed=SEED + i, n_points=HOST_ROOM_POINTS)
        raw['obj'] = room_instances(raw)
        t0 = time.perf_counter()
        # with the segment means that the nano phase's model reads
        nag = preprocess_cloud(raw, with_instances=True, segment_mean_hf=(
            NANO_CFG['datamodule']['segment_mean_hf']))
        s = time.perf_counter() - t0
        objs = [nag[j].get('obj') for j in nag.levels]
        check(all(isinstance(o, InstanceData) for o in objs)
              and all(o.num_groups == nag[j].num_nodes
                      for j, o in zip(nag.levels, objs)),
              f'panoptic room {i}: a level has no instance overlaps')
        print(f'panoptic room {i}: {raw.num_nodes} raw points, '
              f'{len(np.unique(raw.obj))} instances -> nodes per level '
              f'{[nag[j].num_nodes for j in nag.levels]}, '
              f'{objs[1].num_items} level-1 overlaps; preprocessed in '
              f'{s:.2f} s on the host')
        nags.append(nag)

    def panoptic_task(compute_dtype='auto', plain_attention=False):
        task = build_task(PANOPTIC_CFG, num_graphs=PANOPTIC_GRAPHS,
                          compute_dtype=compute_dtype,
                          plain_attention=plain_attention, device=dev)
        init_weights(task.model, torch.Generator().manual_seed(SEED))
        return task

    # serving: 2 evaluation batches of 4 graphs (each room twice), the
    # grid search on the first
    cfg = dataclasses.replace(
        BatchConfig(instance=True, instance_k_max=dm['instance_k_max'],
                    instance_radius=dm['instance_radius']),
        **EVAL_BATCH_OVERRIDES)
    loader = [nags * 2 for _ in range(PANOPTIC_EVAL_BATCHES)]
    task = panoptic_task()
    outputs = []
    eval_step = task.eval_step

    def counted_eval_step(batch):
        before = counts()['K2']
        out = eval_step(batch)
        outputs.append((batch, out, counts()['K2'] - before))
        return out

    task.eval_step = counted_eval_step
    reset_counts()
    with plain_attention_calls() as plain, \
            widest_call('dense_attention_rpe') as k2_args, \
            host_timers(trainer, ('instance_partition',
                                  'grid_search_panoptic_partition')) as spent:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = trainer.validate_panoptic(
            task, loader, cfg, num_classes, stuff_classes=stuff,
            grid_search=True)
        val_s = time.perf_counter() - t0
    del task.eval_step
    launches = counts()
    metrics = {k: result[k] for k in ('pq', 'sq', 'rq', 'map', 'map_50')}
    print(f'panoptic validation: {PANOPTIC_EVAL_BATCHES} batches of '
          f'{PANOPTIC_GRAPHS} graphs in {val_s:.2f} s; grid search '
          f'{spent["grid_search_panoptic_partition"][0]:.2f} s '
          f'(settings {result["settings"]}); partitions '
          f'{spent["instance_partition"][0]:.2f} s in '
          f'{spent["instance_partition"][1]} calls (host); '
          f'{metrics}; {result["n_pred_instances"]} predicted instances; '
          f'launches {launches}, plain attention calls {plain["plain"]}')
    for batch, out, k2 in outputs:
        lvl1 = batch[1]
        n, caps, k = level_counts(batch)
        lg = out['logits_level1'][lvl1.node_mask]
        ea = out['edge_affinity_logits'][lvl1.obj_edge_mask]
        print(f'  eval batch: nodes {n}, capacities {caps}, K={k}, '
              f'{int(lvl1.obj_edge_mask.sum())} of '
              f'{lvl1.obj_edge_mask.shape[0]} obj edges; {k2} K2 launches')
        check(k2 == K2_LAUNCHES_PER_FORWARD,
              f'{k2} K2 launches in a panoptic forward, expected '
              f'{K2_LAUNCHES_PER_FORWARD}')
        check(lg.shape == (lvl1.num_nodes, num_classes)
              and bool(torch.isfinite(lg).all())
              and ea.numel() > 0 and bool(torch.isfinite(ea).all()),
              'panoptic level-1 or edge-affinity logits not finite')
    check(len(outputs) == PANOPTIC_EVAL_BATCHES
          and launches['K1'] == launches['K3'] == 0 and plain['plain'] == 0,
          'panoptic serving: not one forward a batch, or another kernel '
          'or the plain attention ran')
    check(all(np.isfinite(v) and 0 <= v <= 100 for v in metrics.values()),
          f'panoptic metrics out of [0, 100]: {metrics}')
    serve_launches = launches['K2']
    # K2 vs its plain version on the inputs of its widest launch
    hold_on_path('K2', k2_args, 'panoptic path')
    del k2_args

    # the evaluation forward's time, and the kernel vs the plain attention
    # in f32 on the first batch
    batch = outputs[0][0]
    del outputs
    ms = cuda_ms(lambda: task.eval_step(batch), 5)
    print(f'panoptic eval_step on {card}: {ms:.3f} ms (CUDA events, 5 '
          'calls after 3 warm-up; forward, loss and confusion matrix)')
    b32 = from_numpy(prepare_batch(nags * 2, cfg, train=False), dev, None,
                     train=True)
    kern, plain_task = panoptic_task(None), panoptic_task(None, True)
    got, again, ref = (t.eval_step(b32) for t in (kern, kern, plain_task))
    lvl1 = b32[1]
    for key, rows in (('logits_level1', lvl1.node_mask),
                      ('edge_affinity_logits', lvl1.obj_edge_mask)):
        a, a2, r = (o[key][rows] for o in (got, again, ref))
        if a.dim() == 1:
            a, a2, r = a[:, None], a2[:, None], r[:, None]
        err, mean, agree = logit_diff(a, r)
        check(torch.equal(got[key], again[key]),
              f'f32 panoptic {key} differ between two runs (max '
              f'{(a - a2).abs().max().item():.3e})')
        print(f'float32 panoptic {key} (|x| max {r.abs().max().item():.3f}):'
              f' kernel vs plain attention max_abs_err={err:.3e} '
              f'mean={mean:.3e} argmax agreement={agree:.5f}; same model '
              f'run twice: bit-equal')
        check(err <= F32_LOGIT_MAX_ABS and agree >= F32_ARGMAX_AGREEMENT,
              f'f32 panoptic {key}: kernel vs plain beyond '
              f'{F32_LOGIT_MAX_ABS}, or argmax agreement {agree:.5f} below '
              f'{F32_ARGMAX_AGREEMENT}')
    del kern, plain_task, b32, got, again, ref

    # the same partition and metrics on oracle inputs
    with host_timers(trainer, ('instance_partition',
                               'grid_search_panoptic_partition')) as spent:
        t0 = time.perf_counter()
        oracle = trainer.validate_panoptic(
            OracleTask(task.model, num_classes), loader, cfg, num_classes,
            stuff_classes=stuff, grid_search=True)
        oracle_s = time.perf_counter() - t0
    print(f'panoptic oracle: pq {oracle["pq"]:.4f} sq {oracle["sq"]:.4f} '
          f'rq {oracle["rq"]:.4f} map {oracle["map"]:.4f} in {oracle_s:.2f} '
          f's (grid search {spent["grid_search_panoptic_partition"][0]:.2f}'
          f' s, settings {oracle["settings"]}); random weights pq '
          f'{result["pq"]:.4f}')
    check(oracle['pq'] > result['pq'] and oracle['pq'] >= ORACLE_PQ_MIN,
          f'the oracle PQ is not above the random weights\' PQ, or below '
          f'{ORACLE_PQ_MIN}')
    del task
    settle()

    # training: PANOPTIC_STEPS steps on 4-graph training batches
    tcfg = BatchConfig(instance=True, instance_k_max=dm['instance_k_max'],
                       instance_radius=dm['instance_radius'])
    rng = np.random.default_rng(SEED + 2)
    t0 = time.perf_counter()
    hosts = [prepare_batch(nags * 2, tcfg, train=True, rng=rng)
             for _ in range(PANOPTIC_STEPS)]
    print(f'panoptic training: {PANOPTIC_STEPS} batches prepared in '
          f'{time.perf_counter() - t0:.2f} s on the host')
    task = panoptic_task()
    compute_dtype = task.model.net.compute_dtype
    head = list(task.model.edge_affinity_head.parameters())
    start = [p.detach().clone() for p in task.model.parameters()]
    head_start = [p.detach().clone() for p in head]
    reset_counts()
    with plain_attention_calls() as plain, \
            widest_call('dense_attention_trainable') as k1_args:
        for step, h in enumerate(hosts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = from_numpy(h, dev, compute_dtype, train=True)
            loss = task.train_step(batch)['loss'].item()
            step_s = time.perf_counter() - t0
            n, caps, k = level_counts(batch)
            print(f'panoptic train step {step}: nodes {n}, capacities '
                  f'{caps}, K={k}, {int(batch[1].obj_edge_mask.sum())} obj '
                  f'edges; loss {loss:.6f}; {step_s * 1e3:.1f} ms (host '
                  'batch to loss)')
            check(np.isfinite(loss), f'panoptic train step {step}: loss '
                  f'{loss}')
    launches = counts()
    print(f'panoptic training: launches {launches}, plain attention calls '
          f'{plain["plain"]}')
    check(launches['K1'] == PANOPTIC_STEPS * K1_LAUNCHES_PER_STEP
          and launches['K2'] == launches['K3'] == 0 and plain['plain'] == 0,
          'panoptic training did not run on K1 alone, 7 a step')
    moved = [not torch.equal(a, p.detach())
             for a, p in zip(start, task.model.parameters())]
    with_grad = [p.grad is not None and bool(p.grad.any())
                 for p in task.model.parameters()]
    print(f'{sum(moved)} of {len(moved)} parameter tensors moved; '
          f'{sum(with_grad)} had a non-zero gradient in the last step')
    check(all(m for m, g in zip(moved, with_grad) if g)
          and all(not torch.equal(a, p.detach())
                  for a, p in zip(head_start, head)),
          'a parameter with a gradient, or the edge-affinity head, did '
          'not move')
    train_launches = launches['K1']
    # K1 vs its plain version on the inputs of its widest launch
    hold_on_path('K1', k1_args, 'panoptic path')
    del k1_args
    ms = cuda_ms(lambda: task.train_step(batch), 5)
    print(f'panoptic train step on {card}: {ms:.3f} ms (CUDA events, 5 '
          'steps after 3 warm-up)')
    del task
    for cd in (None, compute_dtype):
        hold_train_step('panoptic', panoptic_task(cd), panoptic_task(
            cd, plain_attention=True), from_numpy(hosts[-1], dev, cd,
                                                  train=True), cd)
    return {'K2': serve_launches, 'K1': train_launches}, nags


def write_s3dis_rooms(root, room_points, seed):
    """Synthetic rooms in the S3DIS raw layout, `raw/<area>/office_<r>/
    Annotations/<class>_1.txt` with `x y z r g b` rows, FIT_AREAS rooms
    an area, each shifted in x past the one before."""
    import numpy as np
    from superpoint_transformer_torch.datasets.s3dis import (
        S3DIS_CLASS_NAMES)
    from superpoint_transformer_torch.utils.synthetic import (
        synthetic_room_cloud)
    n = 0
    for a, (area, rooms) in enumerate(FIT_AREAS.items()):
        for r in range(rooms):
            raw = synthetic_room_cloud(seed=seed + 10 * a + r,
                                       n_points=room_points)
            pos = raw.pos + np.float32([12.0 * r, 0, 0])
            rgb = np.round(raw.rgb * 255)
            ann = os.path.join(root, 'raw', area, f'office_{r + 1}',
                               'Annotations')
            os.makedirs(ann)
            for c in np.unique(raw.y):
                rows = raw.y == c
                np.savetxt(os.path.join(
                    ann, f'{S3DIS_CLASS_NAMES[c]}_1.txt'),
                    np.concatenate([pos[rows], rgb[rows]], 1),
                    fmt='%.3f %.3f %.3f %d %d %d')
            n += raw.num_nodes
    return n


# the partitions' stages of `preprocess_cloud`, timed per cloud, and the
# other stages timed on the dataset paths
PARTITION_STAGES = ('cut_pursuit_partition', 'pretrained_cnn_features',
                    'greedy_contour_prior_partition')
PREPROCESS_STAGES = PARTITION_STAGES + ('knn_search', 'point_features',
                                        'segment_features',
                                        'radius_horizontal_graph')
# every in-memory dataset's processed NAGs, and seconds per stage, by
# processed path
MEMORY_STORE, MEMORY_STAGE_S = {}, {}


@functools.lru_cache(maxsize=None)
def memory_class(cls):
    """The port's dataset class `cls`, with its processed NAGs in
    MEMORY_STORE (the card machine has no h5py): reading the raw files,
    tiling and preprocessing are the port's own. The classes share the
    dict, so that a cloud preprocessed under one configuration's hash is
    preprocessed once; MEMORY_STAGE_S holds the seconds of each stage of
    PREPROCESS_STAGES that ran, and of the whole ('total'), per cloud.
    `split_ids` ({split: cloud ids}), where set, stands in for the
    class's own split lists."""
    from superpoint_transformer_torch.inference import without_level0
    from superpoint_transformer_torch.transforms import preprocess

    class Memory(cls):
        split_ids = None

        @property
        def all_cloud_ids(self):
            return self.split_ids or super().all_cloud_ids

        def process(self):
            for c in self.cloud_ids:
                key = self.processed_path(c)
                if key not in MEMORY_STORE:
                    t0 = time.perf_counter()
                    with host_timers(preprocess, PREPROCESS_STAGES) as spent:
                        MEMORY_STORE[key] = self.process_cloud(c)
                    MEMORY_STAGE_S[key] = {k: v[0] for k, v in spent.items()
                                           if v[1]}
                    MEMORY_STAGE_S[key]['total'] = time.perf_counter() - t0

        def load(self, cloud_id):
            nag = MEMORY_STORE[self.processed_path(cloud_id)]
            # nano datasets read their clouds from level 1 up
            return without_level0(nag) if self.nano else nag

    Memory.__name__ = f'Memory{cls.__name__}'
    return Memory


def memory_datasets(cfg, split_ids=None):
    """`build_datasets(cfg)`, each dataset then of its class's in-memory
    subclass (`memory_class`), with `split_ids` as its split lists where
    given."""
    from superpoint_transformer_torch.experiment import build_datasets
    datasets = build_datasets(cfg)
    for ds in datasets.values():
        ds.__class__ = memory_class(type(ds))
        ds.split_ids = split_ids
    return datasets


def s3dis_datasets(cfg):
    """`memory_datasets(cfg)` of an S3DIS configuration over the areas
    that the fit phase writes (FIT_AREAS): the fold's area for testing,
    the others for training and validation."""
    test = f'Area_{int(cfg["datamodule"].get("fold", 5))}'
    train = [a for a in FIT_AREAS if a != test]
    return memory_datasets(cfg, {'train': train, 'val': train,
                                 'test': [test]})


def release(datasets):
    """Drop the processed NAGs of `datasets` from MEMORY_STORE."""
    for ds in datasets.values():
        for key in ds.processed_paths:
            MEMORY_STORE.pop(key, None)


@contextlib.contextmanager
def profiled_fit():
    """While the block runs, every `Trainer.fit` runs under torch.profiler
    and nothing else of the entry point does (set-up, probe batches and
    the checkpoint's load stay outside); yields a dict that then holds
    the kernel time of the last fit in ms (`busy_ms`, None where the
    profiler records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from superpoint_transformer_torch.trainer import Trainer
    fit = Trainer.fit
    got = {}

    def profiling(self, *args, **kwargs):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fit(self, *args, **kwargs)
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total
                   for e in prof.key_averages()) / 1e3
        got['busy_ms'] = busy if busy > 0 else None
        return out

    Trainer.fit = profiling
    try:
        yield got
    finally:
        Trainer.fit = fit


def print_epochs(label, trainer, card):
    for t in trainer.epoch_times:
        step = 'not measured' if t['step_ms'] is None \
            else f'{t["step_ms"]:.1f} ms'
        val = 'no validation' if t['val_s'] is None \
            else f'validation {t["val_s"]:.2f} s'
        print(f'{label} epoch {t["epoch"]} on {card}: {t["steps"]} steps, '
              f'host batch preparation {t["prepare_s"]:.2f} s, steps '
              f'{step} (CUDA events), {val}, wall {t["wall_s"]:.2f} s')


def phase_fit(dev, card, room_points=FIT_ROOM_POINTS, epochs=FIT_EPOCHS,
              tmp=None):
    """The port's train and eval entry points, `train(cfg, datasets)` and
    `evaluate(cfg, datasets)`, at SPT-2 width in bf16 with
    `experiment=semantic/s3dis`'s datamodule on synthetic S3DIS areas;
    then gradient accumulation held to one averaged AdamW step. The rooms
    are written under `tmp` (a TemporaryDirectory that the caller keeps
    for the EZ-SP phase), or under a directory of the phase's own."""
    import copy
    import tempfile
    import numpy as np
    import torch
    from superpoint_transformer_torch.config.loader import _to_config
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.eval import evaluate
    from superpoint_transformer_torch.experiment import (
        FLAGSHIP_CFG, build_task)
    from superpoint_transformer_torch.optim.lr_scheduler import set_lr
    from superpoint_transformer_torch.train import train
    from superpoint_transformer_torch.trainer import Trainer
    from superpoint_transformer_torch.transforms.prepare import (
        prepare_batch)

    settle()
    own = tmp is None
    if own:
        tmp = tempfile.TemporaryDirectory()
    root, out = os.path.join(tmp.name, 's3dis'), os.path.join(tmp.name, 'out')
    t0 = time.perf_counter()
    n_raw = write_s3dis_rooms(root, room_points, SEED)
    write_s = time.perf_counter() - t0
    cfg = _to_config(copy.deepcopy(FLAGSHIP_CFG))
    for key, value in (('device', str(dev)), ('output_dir', out),
                       ('datamodule.data_dir', root),
                       ('trainer.max_epochs', epochs),
                       ('trainer.check_val_every_n_epoch', 1)):
        cfg.set_path(key, value)
    datasets = s3dis_datasets(cfg)
    t0 = time.perf_counter()
    for ds in datasets.values():
        ds.process()
    prep_s = time.perf_counter() - t0
    nodes = [[ds[i][j].num_nodes for j in ds[i].levels]
             for ds in datasets.values() for i in range(len(ds))]
    cp_s = [round(MEMORY_STAGE_S[ds.processed_path(c)][
        'cut_pursuit_partition'], 3) for ds in (datasets['train'],
                                                 datasets['test'])
        for c in ds.cloud_ids]
    print(f'fit: {n_raw} raw points in {sum(FIT_AREAS.values())} rooms '
          f'written as S3DIS text in {write_s:.2f} s; read and preprocessed '
          f'in {prep_s:.2f} s on the host (cut pursuit {cp_s} s by training '
          f'and test area); nodes per level, by split and area {nodes}')

    # 1. train(cfg, datasets): every launch counted from here
    reset_counts()
    with plain_attention_calls() as plain, \
            widest_call('dense_attention_trainable') as k1_args:
        t0 = time.perf_counter()
        trainer = train(cfg, datasets)
        fit_s = time.perf_counter() - t0
    launches = counts()
    steps = sum(t['steps'] for t in trainer.epoch_times)
    n_val = len(datasets['val']) * len(trainer.epoch_times)
    print_epochs('fit', trainer, card)
    print(f'fit: train(cfg, datasets) {epochs} epochs in {fit_s:.2f} s; '
          f'{steps} steps, {n_val} validation forwards; launches '
          f'{launches}, plain attention calls {plain["plain"]}; best mIoU '
          f'{trainer.best_miou:.4f}')
    check(launches['K1'] == K1_LAUNCHES_PER_STEP * steps > 0
          and launches['K2'] == K2_LAUNCHES_PER_FORWARD * n_val
          and launches['K3'] == 0 and plain['plain'] == 0,
          'fit: not 7 K1 launches a step and 7 K2 a validation forward, or '
          'K3 or the plain attention ran')
    fit_launches = dict(launches)
    hold_on_path('K1', k1_args, 'fit path')
    del k1_args
    task = trainer.task
    check(task.step == steps and task.updates == steps
          and trainer.epoch == epochs - 1, 'fit: step counts')
    def csv_rows():
        with open(os.path.join(out, 'metrics.csv')) as f:
            rows = [line.strip().split(',') for line in f]
        return rows[0], rows[1:]

    head, rows = csv_rows()
    check(sum(r[1] == 'val' for r in rows) == epochs and all(
        np.isfinite(float(r[head.index('loss')])) for r in rows),
        'fit: a validation row is missing or a loss is not finite')

    # 2. resume from 'last': the loaded state is the saved one, then one
    # more epoch carries on the step, the LR and the epoch
    last = os.path.join(out, 'checkpoints', 'last')
    fresh = Trainer(build_task(cfg, num_graphs=1, device=dev), None,
                    output_dir=os.path.join(tmp.name, 'load'))
    fresh.load_checkpoint(last)
    a, b = task.state_dict(), fresh.task.state_dict()
    check(all(torch.equal(v, b['model'][k]) for k, v in a['model'].items())
          and all(torch.equal(v, b['optimizer']['state'][i][k])
                  for i, st in a['optimizer']['state'].items()
                  for k, v in st.items())
          and (b['step'], b['updates'], fresh.epoch) == (steps, steps,
                                                          epochs),
          'resume: the loaded parameters, AdamW moments, step or epoch are '
          'not the saved ones')
    del fresh
    cfg2 = copy.deepcopy(cfg)
    cfg2.set_path('trainer.max_epochs', epochs + 1)
    cfg2.set_path('ckpt_path', last)
    reset_counts()
    with profiled_fit() as prof:
        resumed = train(cfg2, datasets)
    launches = counts()
    print_epochs('resumed fit', resumed, card)
    t = resumed.epoch_times
    head, rows = csv_rows()
    new = rows[-2:]
    check(len(t) == 1 and t[0]['epoch'] == epochs
          and resumed.task.step == steps + t[0]['steps']
          and [r[:2] for r in new] == [[str(epochs), 'train'],
                                       [str(epochs), 'val']]
          and float(new[0][head.index('lr')]) == resumed.task.lr_at(
              resumed.task.step),
          'resume: the epoch, the step or the logged LR did not carry on')
    # the share of the epoch's own wall time (training, validation and
    # checkpoints) that the card spends in kernels
    busy_ms, wall_s = prof.get('busy_ms'), t[0]['wall_s']
    share = 'not measured' if busy_ms is None else \
        f'{busy_ms / (wall_s * 1e3):.4f}'
    print(f'resumed fit: epoch {epochs} in {wall_s:.2f} s (its own clock, '
          f'under the profiler), kernels '
          f'{"not measured" if busy_ms is None else f"{busy_ms:.1f} ms"} '
          f'(torch.profiler): device-busy share {share}; launches '
          f'{launches}')
    for k in ('K1', 'K2'):
        fit_launches[k] += launches[k]

    # 3. evaluate(cfg, datasets) from 'best': on the validation split
    # twice (its mIoU vs the logged one, within the run-to-run spread),
    # then on the test area with TTA
    best_epoch = json.load(open(os.path.join(
        out, 'checkpoints', 'best', 'spt_meta.json')))['epoch'] - 1
    val_miou = {int(r[0]): float(r[head.index('miou')]) for r in rows
                if r[1] == 'val'}
    ecfg = copy.deepcopy(cfg)
    ecfg.set_path('ckpt_path', os.path.join(out, 'checkpoints', 'best'))
    ecfg.set_path('output_dir', os.path.join(tmp.name, 'eval'))
    reset_counts()
    t0 = time.perf_counter()
    with widest_call('dense_attention_rpe') as k2_args:
        runs = [evaluate(ecfg, {'test': datasets['val']})['miou']
                for _ in range(2)]
    eval_s = (time.perf_counter() - t0) / 2
    logged = val_miou[best_epoch]
    print(f'evaluate from best (epoch {best_epoch}) on the validation '
          f'split: mIoU {runs[0]!r}, {runs[1]!r} vs logged {logged!r}; '
          f'{eval_s:.2f} s each')
    check(runs[0] == runs[1], 'evaluate: two evaluations of the same '
          'checkpoint give different mIoU')
    check(abs(runs[0] - logged) <= FIT_MIOU_TOL,
          f'evaluate: mIoU {runs[0]:.6f} vs the logged {logged:.6f}, beyond '
          f'{FIT_MIOU_TOL}')
    ecfg.set_path('tta_runs', FIT_TTA_RUNS)
    t0 = time.perf_counter()
    m = evaluate(ecfg, {'test': datasets['test']})
    tta_s = time.perf_counter() - t0
    launches = counts()
    n_fwd = (2 * len(datasets['val'])
             + (1 + FIT_TTA_RUNS) * len(datasets['test']))
    print(f'evaluate on the test area with {FIT_TTA_RUNS} TTA runs: mIoU '
          f'{m["miou"]:.4f}, OA {m["oa"]:.4f} in {tta_s:.2f} s; launches '
          f'{launches}')
    check(np.isfinite(m['miou']) and m['confmat'].sum() > 0
          and launches['K2'] == K2_LAUNCHES_PER_FORWARD * n_fwd
          and launches['K1'] == launches['K3'] == 0,
          'evaluate: not 7 K2 launches a forward, or no test mass')
    fit_launches['K2'] += launches['K2']
    hold_on_path('K2', k2_args, 'fit path')
    del k2_args

    # 4. accumulate_grad_batches=2 over 2 loader batches, in f32, against
    # one averaged AdamW step on them from the same weights
    acfg = copy.deepcopy(cfg)
    acfg.set_path('trainer.accumulate_grad_batches', 2)
    bcfg = trainer.batch_cfg
    rng = np.random.default_rng(SEED + 5)
    hosts = [prepare_batch([datasets['train'][i]], bcfg, train=True,
                           rng=rng) for i in range(2)]
    batches = [from_numpy(h, dev, None, train=True) for h in hosts]

    def f32_task(k):
        t_ = build_task(acfg if k > 1 else cfg, num_graphs=1,
                        compute_dtype=None, device=dev)
        t_.model.load_state_dict(task.model.state_dict())
        return t_

    acc = f32_task(2)
    start = [p.detach().clone() for p in acc.model.parameters()]
    reset_counts()
    acc.train_step(batches[0])
    check(all(torch.equal(a_, p.detach()) for a_, p in
              zip(start, acc.model.parameters())) and acc.updates == 0,
          'accumulation: the parameters moved after the first micro-batch')
    acc.train_step(batches[1])
    launches = counts()
    check(acc.updates == 1 and acc.step == 2 and launches['K1']
          == 2 * K1_LAUNCHES_PER_STEP, 'accumulation: no update after the '
          'second micro-batch, or not 7 K1 launches a micro-batch')
    mean = [p.grad.detach().clone() if p.grad is not None else None
            for p in acc.model.parameters()]

    def averaged(t_):
        """The mean gradient of the two batches, from two backward
        passes, without an update."""
        gs = [loss_grads(t_, b)[1] for b in batches]
        return (gs[0] + gs[1]) / 2

    ref = f32_task(1)
    g_ref = averaged(ref)
    check(torch.equal(averaged(ref), g_ref), 'accumulation: two backward '
          'passes on the same batches give different gradients')
    g_acc = torch.cat([(g if g is not None else torch.zeros_like(p))
                       .reshape(-1).float() for g, p in
                       zip(mean, acc.model.parameters())])
    err = rel_l2(g_acc, g_ref)
    print(f'accumulation: mean gradient of 2 micro-batches vs the average '
          f'of 2 backward passes rel L2 {err:.3e} (limit {ACCUM_GRAD_TOL}; '
          'the backward passes bit-equal run to run)')
    check(err <= ACCUM_GRAD_TOL, f'accumulation: the mean gradient is '
          f'beyond {ACCUM_GRAD_TOL}')
    # the update itself: one AdamW step of the reference task on the same
    # mean gradient, from the same weights and LR, gives the same weights
    ref = f32_task(1)
    ref.optimizer.zero_grad(set_to_none=True)
    for p, g in zip(ref.model.parameters(), mean):
        p.grad = None if g is None else g.clone()
    set_lr(ref.optimizer, ref.schedules, 0)
    ref.optimizer.step()
    check(all(torch.equal(p.detach(), q.detach()) for p, q in zip(
        ref.model.parameters(), acc.model.parameters())),
        'accumulation: the update is not one AdamW step on the mean '
        'gradient')
    print('accumulation: 2 micro-batches made one AdamW update, equal to '
          'one step on their mean gradient')
    if own:
        tmp.cleanup()
    return {'K1': fit_launches['K1'], 'K2': fit_launches['K2']}


def phase_ezsp(dev, card, tmp, stage1_epochs=EZSP_STAGE1_EPOCHS):
    """EZ-SP through the port's train and eval entry points on the fit
    phase's rooms (under `tmp`): stage 1, `train(cfg, datasets)` with
    `experiment=partition/s3dis_ezsp` (the sparse CNN at (32, 32, 32),
    f32, `fit_partition` on 50,000-voxel crops); stage 2, the datasets of
    `experiment=semantic/s3dis_ezsp` with the stage-1 `last` checkpoint
    (the frozen CNN on the card, then the greedy contour-prior partition),
    SPT-2 in bf16 trained for an epoch with a validation, and
    `evaluate(cfg, datasets)` on the validation split."""
    import copy
    import csv
    import numpy as np
    import torch
    from superpoint_transformer_torch import trainer as trainer_mod
    from superpoint_transformer_torch.config.loader import _to_config
    from superpoint_transformer_torch.data.data import Data
    from superpoint_transformer_torch.data.padded import (
        from_numpy, point_cloud_from_numpy)
    from superpoint_transformer_torch.eval import evaluate
    from superpoint_transformer_torch.experiment import (
        EZSP_CFG, EZSP_PARTITION_CFG, build_batch_config)
    from superpoint_transformer_torch.metrics.semantic import (
        miou_from_confmat)
    from superpoint_transformer_torch.models.partition import (
        partition_purity)
    from superpoint_transformer_torch.train import train
    from superpoint_transformer_torch.transforms import preprocess
    from superpoint_transformer_torch.transforms.prepare import (
        prepare_batch, prepare_partition_batch)

    settle()
    root = os.path.join(tmp.name, 's3dis')
    check(os.path.isdir(root), "ezsp: the fit phase's rooms are missing")

    def config(base, out, paths):
        cfg = _to_config(copy.deepcopy(base))
        for key, value in [('device', str(dev)), ('output_dir', out),
                           ('datamodule.data_dir', root)] + paths:
            cfg.set_path(key, value)
        return cfg

    # 1. stage 1: the partition task. Its datamodule preprocesses as the
    # fit phase's (one hash), so its clouds come from the same dict
    out1 = os.path.join(tmp.name, 'ezsp_stage1')
    cfg1 = config(EZSP_PARTITION_CFG, out1,
                  [('trainer.max_epochs', stage1_epochs)])
    data1 = s3dis_datasets(cfg1)
    n_stored = len(MEMORY_STORE)
    fits = []
    fit_partition = trainer_mod.fit_partition

    def keeping(*args, **kwargs):
        fits.append(fit_partition(*args, **kwargs))
        return fits[-1]

    trainer_mod.fit_partition = keeping
    reset_counts()
    try:
        t0 = time.perf_counter()
        returned = train(cfg1, data1)
        s1 = time.perf_counter() - t0
    finally:
        trainer_mod.fit_partition = fit_partition
    launches = counts()
    check(returned is None and len(fits) == 1,
          'ezsp stage 1: train() did not run fit_partition alone')
    check(len(MEMORY_STORE) == n_stored, 'ezsp stage 1 preprocessed its '
          "clouds again: its cache hash is not the fit phase's")
    check(not any(launches.values()),
          f'ezsp stage 1 launched attention kernels: {launches}')
    tr1 = fits[0]
    with open(os.path.join(out1, 'metrics.csv')) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r['loss']) for r in rows]
    inter = [int(r['n_inter_edge']) for r in rows]
    for t in tr1.epoch_times:
        step = 'not measured' if t['step_ms'] is None else \
            f'{t["step_ms"] / t["steps"]:.2f} ms a step'
        print(f'ezsp stage 1 epoch {t["epoch"]} on {card}: {t["steps"]} '
              f'steps, prepare_partition_batch {t["prepare_s"]:.2f} s, '
              f'{step} (CUDA events), wall {t["wall_s"]:.2f} s')
    print(f'ezsp stage 1: train(cfg, datasets) {stage1_epochs} epochs in '
          f'{s1:.2f} s; epoch losses {losses}, inter edges {inter}')
    ckpt = os.path.join(out1, 'checkpoints', 'last')
    check(len(rows) == stage1_epochs and all(np.isfinite(losses))
          and len(set(losses)) == len(losses) and min(inter) > 0
          and all(os.path.exists(os.path.join(out1, 'checkpoints', n,
                                              'state.pt'))
                  for n in ('last', 'best')),
          'ezsp stage 1: a loss is not finite or did not move, an epoch '
          'saw no inter edge, or a checkpoint is missing')

    # the trained CNN's embeddings of one crop, card vs CPU
    task1 = tr1.task
    host = prepare_partition_batch(
        [data1['train'][0]], build_batch_config(cfg1), train=True,
        rng=np.random.default_rng(SEED + 7))
    cpu_model = copy.deepcopy(task1.model).cpu().eval()
    task1.model.eval()
    with torch.no_grad():
        on_card = point_cloud_from_numpy(host, dev)
        runs = [task1.model(on_card).cpu() for _ in range(2)]
        ref = cpu_model(point_cloud_from_numpy(host, 'cpu'))
    del on_card
    err = (runs[0] - ref).abs().max().item()
    print(f'ezsp stage 1 embeddings of {host.num_nodes} voxels, card vs CPU: '
          f'max abs {err:.3e} (limit {EZSP_EMB_TOL}; values up to '
          f'{ref.abs().max().item():.2f}); the card run twice: '
          f'{"bit-equal" if torch.equal(runs[0], runs[1]) else "differ"}')
    check(torch.equal(runs[0], runs[1]), 'ezsp stage 1: the embeddings '
          'differ between two runs on the card')
    check(err <= EZSP_EMB_TOL, 'ezsp stage 1: the embeddings on the card '
          "are not the CPU's")
    if dev.type == 'cuda':
        # where a stage-1 step's time goes (after the checkpoints: these
        # steps move the task's weights, not the saved ones)
        crop = point_cloud_from_numpy(host, dev)
        step_ms = cuda_ms(lambda: task1.train_step(crop), 5)
        dev_ms, top = device_profile(lambda: task1.train_step(crop))
        print(f'ezsp stage 1 step on that crop on {card}: {step_ms:.2f} ms '
              f'(CUDA events, 5 steps); kernels '
              f'{"not measured" if dev_ms is None else f"{dev_ms:.2f} ms"} '
              f'(torch.profiler), top {top}')
        del crop

    # 2. stage-2 preprocessing: the frozen CNN on the card, the greedy
    # contour-prior partition on the host
    out2 = os.path.join(tmp.name, 'ezsp_stage2')
    cfg2 = config(EZSP_CFG, out2, [
        ('datamodule.pretrained_cnn_ckpt_path', ckpt),
        ('trainer.max_epochs', EZSP_STAGE2_EPOCHS),
        ('trainer.check_val_every_n_epoch', 1)])
    data2 = s3dis_datasets(cfg2)
    t0 = time.perf_counter()
    for ds in data2.values():
        ds.process()
    prep_s = time.perf_counter() - t0
    stage_s = MEMORY_STAGE_S
    n_cls = int(cfg2['datamodule']['num_classes'])
    cms = {'learned': np.zeros((n_cls, n_cls), np.int64),
           'cut pursuit': np.zeros((n_cls, n_cls), np.int64)}
    for split in ('train', 'test'):
        ds2, ds1 = data2[split], data1[split]
        for i, c in enumerate(ds2.cloud_ids):
            nag2, nag1 = ds2[i], ds1[i]
            raw = nag2[0].sub.num_items
            per = 1e6 / raw
            st2, st1 = stage_s[ds2.processed_path(c)], \
                stage_s[ds1.processed_path(c)]
            n2 = [nag2[j].num_nodes for j in nag2.levels]
            n1 = [nag1[j].num_nodes for j in nag1.levels]
            print(f'ezsp stage 2 {c} on {card}: {raw} raw points; s per 1M '
                  f'raw points: pretrained_cnn '
                  f'{st2["pretrained_cnn_features"] * per:.3f}, '
                  f'greedy_contour_prior_partition '
                  f'{st2["greedy_contour_prior_partition"] * per:.3f}, cut '
                  f'pursuit (fit phase) '
                  f'{st1["cut_pursuit_partition"] * per:.3f}; nodes per '
                  f'level {n2}, cut pursuit {n1}')
            check(raw == nag1[0].sub.num_items
                  and FIT_AREAS[c] < n2[1] < n2[0],
                  f'ezsp stage 2 {c}: the learned partition does not '
                  'compress the voxels, or no more than to one node a room')
            for name, nag in (('learned', nag2), ('cut pursuit', nag1)):
                cms[name] += partition_purity(nag[0].super_index, nag[0].y,
                                              n_cls)
    oracle = {k: miou_from_confmat(v) for k, v in cms.items()}
    print(f'ezsp stage 2: preprocessing {prep_s:.2f} s for '
          f'{len(data2["train"]) + len(data2["test"])} clouds; level-1 '
          f'oracle mIoU (partition_purity) learned {oracle["learned"]:.2f} '
          f'vs cut pursuit {oracle["cut pursuit"]:.2f}')
    check(all(np.isfinite(list(oracle.values()))), 'ezsp: oracle mIoU')

    # where the frozen CNN runs: one cloud on the card and on the CPU
    nag = data1['test'][0]
    x = preprocess.add_keys_to(
        Data(**{k: nag[0][k] for k in cfg2['datamodule']['partition_hf']}),
        list(cfg2['datamodule']['partition_hf'])).x
    cnn = {}
    for where in (dev, torch.device('cpu')):
        data = Data(pos=nag[0].pos, x=x)
        t0 = time.perf_counter()
        cnn[where.type] = preprocess.pretrained_cnn_features(
            data, ckpt_path=ckpt, channels=tuple(
                cfg2['datamodule']['pretrained_cnn_channels']),
            voxel=float(cfg2['datamodule']['voxel']), device=where).x
        cnn[where.type + ' s'] = time.perf_counter() - t0
    print(f'ezsp frozen CNN on {nag[0].num_nodes} voxels (rulebook '
          f'included): {dev.type} {cnn[dev.type + " s"]:.3f} s, cpu '
          f'{cnn["cpu s"]:.3f} s ({torch.get_num_threads()} torch threads); '
          f'max abs difference '
          f'{np.abs(cnn[dev.type] - cnn["cpu"]).max():.3e}')

    # 3. stage 2: SPT-2 on the learned partition, then its evaluation
    ecfg = copy.deepcopy(cfg2)
    ecfg.set_path('ckpt_path', os.path.join(out2, 'checkpoints', 'best'))
    ecfg.set_path('output_dir', os.path.join(tmp.name, 'ezsp_eval'))
    reset_counts()
    with plain_attention_calls() as plain, \
            widest_call('dense_attention_trainable') as k1_args, \
            widest_call('dense_attention_rpe') as k2_args:
        t0 = time.perf_counter()
        trainer2 = train(cfg2, data2)
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        m = evaluate(ecfg, {'test': data2['val']})
        eval_s = time.perf_counter() - t0
    launches = counts()
    steps = sum(t['steps'] for t in trainer2.epoch_times)
    n_fwd = len(data2['val']) * (len(trainer2.epoch_times) + 1)
    print_epochs('ezsp stage 2 fit', trainer2, card)
    print(f'ezsp stage 2: train(cfg, datasets) {fit_s:.2f} s, {steps} steps; '
          f'evaluate on the validation split {eval_s:.2f} s: mIoU '
          f'{m["miou"]:.4f}; launches {launches}, plain attention calls '
          f'{plain["plain"]}')
    check(launches['K1'] == K1_LAUNCHES_PER_STEP * steps > 0
          and launches['K2'] == K2_LAUNCHES_PER_FORWARD * n_fwd
          and launches['K3'] == 0 and plain['plain'] == 0,
          'ezsp stage 2: not 7 K1 launches a step and 7 K2 a forward, or '
          'K3 or the plain attention ran')
    check(np.isfinite(m['miou']) and m['confmat'].sum() > 0,
          'ezsp stage 2: the evaluation has no finite mIoU or no mass')
    hold_on_path('K1', k1_args, 'ezsp path')
    hold_on_path('K2', k2_args, 'ezsp path')
    del k1_args, k2_args
    if dev.type == 'cuda':
        task2 = trainer2.task
        vb = from_numpy(prepare_batch([data2['val'][0]],
                                      trainer2.eval_batch_cfg, train=False),
                        dev, task2.model.net.compute_dtype, train=True)
        fwd_ms = cuda_ms(lambda: task2.eval_step(vb), 5)
        print(f'ezsp stage 2 forward (eval_step) of one validation area '
              f'on {card}: {fwd_ms:.3f} ms (CUDA events, 5 calls); nodes '
              f'{[lvl.num_nodes for lvl in vb.levels]}')
    return {'K1': launches['K1'], 'K2': launches['K2']}


def time_on_path(name, args):
    """Kernel `name` ('K1' or 'K2') and its plain version timed on the
    arguments that a main path gave it (`widest_call`), as CUDA-graph
    replays of 20 calls in turns; returns (ms, plain ms, bound ms, bound
    by, shape) with the bound of `kernel_cost` at that shape."""
    from superpoint_transformer_torch.ops import attention as k1
    from superpoint_transformer_torch.ops import attention_rpe as k2
    if name == 'K1':
        q, k, v = args[:3]
        N, K, H, D = k.shape
        shape = dict(N=N, K=K, H=H, D=D, C=H * v.shape[3])
        fn, plain = k1.dense_attention, k1.dense_attention_reference
        cost = dict(shape, q_per_edge=q.dim() == 4)
    else:
        q, kg, vg, ef = args[:4]
        N, H, D = q.shape
        shape = dict(N=N, K=kg.shape[1], H=H, D=D, C=vg.shape[2],
                     De=ef.shape[2])
        fn, plain = k2.dense_attention_rpe, k2.dense_attention_rpe_reference
        cost = shape
    ms, plain_ms, rounds = time_pair(lambda: fn(*args), lambda: plain(*args),
                                     20, graph=True)
    bound_ms, by = bound(name, elem=args[0].element_size(), **cost)
    return ms, plain_ms, bound_ms, by, shape, rounds


def phase_nano(dev, card, tmp, pan_nags):
    """nano-2 (`experiment=semantic/s3dis_nano` and `panoptic/s3dis_nano`:
    no level 0, 32 channels, 8 heads, bf16) on the fit phase's rooms
    (under `tmp`), read from level 1 up: serving an 8-room batch through
    `prepare_batch(nano=True)` and `infer_batch` (K2), train steps on
    4-room batches with the transpose tables (K1), each held to the plain
    attention and run twice; one `PanopticTask` evaluation and train step
    on the panoptic phase's rooms `pan_nags` (with their segment means);
    `train(cfg, datasets)` for one epoch of 2 steps, then
    `evaluate(cfg, datasets)` from its checkpoint; K1 and K2 timed and
    bounded at the shapes of their widest launches."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from superpoint_transformer_torch.config.loader import _to_config
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.eval import evaluate
    from superpoint_transformer_torch.experiment import (
        NANO_CFG, PANOPTIC_NANO_CFG, build_batch_config, build_model,
        build_task)
    from superpoint_transformer_torch.inference import (
        EVAL_BATCH_OVERRIDES, infer_batch, without_level0)
    from superpoint_transformer_torch.models.semantic import (
        SemanticSegmentationModel)
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.train import train
    from superpoint_transformer_torch.transforms.prepare import (
        prepare_batch)

    settle()
    root, out = os.path.join(tmp.name, 's3dis'), os.path.join(tmp.name,
                                                               'nano')
    cfg = _to_config(copy.deepcopy(NANO_CFG))
    for key, value in (('device', str(dev)), ('output_dir', out),
                       ('datamodule.data_dir', root),
                       ('trainer.max_epochs', 1),
                       ('trainer.check_val_every_n_epoch', 1)):
        cfg.set_path(key, value)
    datasets = s3dis_datasets(cfg)
    t0 = time.perf_counter()
    for ds in datasets.values():
        ds.process()
    prep_s = time.perf_counter() - t0
    areas = [datasets['train'][i] for i in range(len(datasets['train']))]
    check(all(a.start_i_level == 1 for a in areas),
          'nano: the datasets did not load the clouds from level 1')
    bcfg = build_batch_config(cfg)
    check(bcfg.nano, 'nano: the batch config is not nano')
    print(f'nano: {len(areas)} training areas read and preprocessed with '
          f'the nano datamodule in {prep_s:.2f} s on the host; nodes per '
          f'level {[[a[j].num_nodes for j in a.levels] for a in areas]}')
    serve_graphs = NANO_SERVE_ROOMS // 2

    def nano_model(compute_dtype='auto', plain_attention=False):
        m = SemanticSegmentationModel(build_model(
            cfg, num_graphs=serve_graphs, compute_dtype=compute_dtype,
            plain_attention=plain_attention, device=dev), 13, device=dev)
        init_weights(m, torch.Generator().manual_seed(SEED))
        return m.eval()

    def nano_task(compute_dtype='auto', plain_attention=False, c=cfg):
        task = build_task(c, num_graphs=serve_graphs,
                          compute_dtype=compute_dtype,
                          plain_attention=plain_attention, device=dev)
        init_weights(task.model, torch.Generator().manual_seed(SEED))
        return task

    # 1. serving: one 8-room batch (the training areas twice), 3 requests
    ecfg = dataclasses.replace(bcfg, **EVAL_BATCH_OVERRIDES)
    t0 = time.perf_counter()
    host = prepare_batch(areas * (serve_graphs // len(areas)), ecfg,
                         train=False)
    prep_s = time.perf_counter() - t0
    model = nano_model()
    cd = model.net.compute_dtype
    reset_counts()
    req_ms = []
    with plain_attention_calls() as plain, \
            widest_call('dense_attention_rpe') as k2_args:
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = from_numpy(host, dev, cd)
            pred = infer_batch(model, batch)
            req_ms.append((time.perf_counter() - t0) * 1e3)
    launches = counts()
    n, caps, k = level_counts(batch)
    print(f'nano serving on {card}: {NANO_SERVE_ROOMS} rooms, nodes {n}, '
          f'capacities {caps}, K={k}; batch prepared in {prep_s:.2f} s on '
          f'the host; requests {[round(t, 1) for t in req_ms]} ms (host '
          f'batch to predictions); launches {launches}')
    check(batch.start_i_level == 1 and batch[1].nbr_in_idx is None
          and launches['K2'] == 3 * K2_LAUNCHES_PER_FORWARD
          and launches['K1'] == launches['K3'] == 0
          and plain['plain'] == 0,
          'nano serving: not a nano batch, or not 7 K2 launches a forward')
    check(pred.shape == (n[0],) and pred.min() >= 0 and pred.max() < 13,
          'nano predictions are not a class per level-1 node')
    serve_launches = launches['K2']
    hold_on_path('K2', k2_args, 'nano path')
    for dt in (None, cd):
        kern = model if dt == cd else nano_model(dt)
        b = batch if dt == cd else from_numpy(host, dev, dt)
        hold_logits('nano ', kern, nano_model(dt, True), b, dt)
    fwd_ms = cuda_ms(lambda: infer_batch(model, batch), 10)
    print(f'nano forward on {card}: {fwd_ms:.3f} ms (CUDA events, 10 '
          'forwards with the level-1 argmax, after 3 warm-up)')
    k2 = time_on_path('K2', k2_args)
    del k2_args, kern, b

    # 2. training: 4-room batches (the training areas, cropped), K1
    rng = np.random.default_rng(SEED + 20)
    hosts = [prepare_batch(areas, bcfg, train=True, rng=rng)
             for _ in range(2)]
    task = nano_task()
    start = [p.detach().clone() for p in task.model.parameters()]
    reset_counts()
    step_ms = []
    with plain_attention_calls() as plain, \
            widest_call('dense_attention_trainable') as k1_args:
        for h in hosts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = from_numpy(h, dev, cd, train=True)
            loss = task.train_step(batch)['loss'].item()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            check(np.isfinite(loss) and batch[1].nbr_in_idx is not None,
                  f'nano train step: loss {loss}, or no transpose tables')
    launches = counts()
    n, caps, k = level_counts(batch)
    print(f'nano training on {card}: nodes {n}, capacities {caps}, K={k}, '
          f'K_in={batch[1].nbr_in_idx.shape[1]}; steps '
          f'{[round(t, 1) for t in step_ms]} ms (host batch to loss); '
          f'launches {launches}')
    check(launches['K1'] == 2 * K1_LAUNCHES_PER_STEP
          and launches['K2'] == launches['K3'] == 0 and plain['plain'] == 0,
          'nano training: not 7 K1 launches a step')
    check(all(not torch.equal(a, p.detach()) for a, p in
              zip(start, task.model.parameters()) if p.grad is not None
              and bool(p.grad.any())),
          'nano training: a parameter with a gradient did not move')
    train_launches = launches['K1']
    hold_on_path('K1', k1_args, 'nano path')
    ms = cuda_ms(lambda: task.train_step(batch), 5)
    print(f'nano train step on {card}: {ms:.3f} ms (CUDA events, 5 steps '
          'after 3 warm-up)')
    del task
    for dt in (None, cd):
        hold_train_step('nano', nano_task(dt), nano_task(dt, True),
                        from_numpy(hosts[0], dev, dt, train=True), dt)
    k1 = time_on_path('K1', k1_args)
    del k1_args
    for name, (ms_, plain_ms, bound_ms, by, shape, rounds) in (
            ('K1', k1), ('K2', k2)):
        print(f'{name} at nano shape {shape} on {card}: kernel {ms_:.4f} '
              f'ms, plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms '
              f'({by}), share {bound_ms / ms_:.3f}; rounds {rounds} (CUDA '
              'graph of 20 calls, CUDA events)')

    # 3. panoptic nano: one evaluation and one train step
    pcfg = _to_config(copy.deepcopy(PANOPTIC_NANO_CFG))
    pbcfg = build_batch_config(pcfg)
    pan = [without_level0(nag) for nag in pan_nags]
    ptask = nano_task(c=pcfg)
    reset_counts()
    b = from_numpy(prepare_batch(pan * 2, dataclasses.replace(
        pbcfg, **EVAL_BATCH_OVERRIDES), train=False), dev, cd, train=True)
    res = ptask.eval_step(b)
    ea = res['edge_affinity_logits'][b[1].obj_edge_mask]
    head = [p.detach().clone()
            for p in ptask.model.edge_affinity_head.parameters()]
    h = prepare_batch(pan * 2, pbcfg, train=True,
                      rng=np.random.default_rng(SEED + 21))
    loss = ptask.train_step(from_numpy(h, dev, cd, train=True))['loss']
    launches = counts()
    print(f'nano panoptic: eval_step on nodes {level_counts(b)[0]}, '
          f'{ea.numel()} obj edges; train step loss {loss.item():.6f}; '
          f'launches {launches}')
    check(bool(torch.isfinite(res['logits_level1']).all()) and ea.numel()
          and bool(torch.isfinite(ea).all()) and torch.isfinite(loss)
          and launches['K2'] == K2_LAUNCHES_PER_FORWARD
          and launches['K1'] == K1_LAUNCHES_PER_STEP
          and all(not torch.equal(a, p.detach()) for a, p in zip(
              head, ptask.model.edge_affinity_head.parameters())),
          'nano panoptic: non-finite logits or loss, not 7 launches a '
          'forward and a step, or the edge-affinity head did not move')
    serve_launches += launches['K2']
    train_launches += launches['K1']
    del ptask, b

    # 4. train(cfg, datasets), then evaluate(cfg, datasets) from 'last'
    reset_counts()
    t0 = time.perf_counter()
    trainer = train(cfg, datasets)
    fit_s = time.perf_counter() - t0
    launches = counts()
    steps = sum(t['steps'] for t in trainer.epoch_times)
    n_val = len(datasets['val'])
    print_epochs('nano fit', trainer, card)
    check(steps == 2 and launches['K1'] == K1_LAUNCHES_PER_STEP * steps
          and launches['K2'] == K2_LAUNCHES_PER_FORWARD * n_val,
          'nano fit: not 2 steps of 7 K1 launches and 7 K2 a validation '
          'forward')
    with open(os.path.join(out, 'metrics.csv')) as f:
        rows = [line.strip().split(',') for line in f]
    logged = float(next(r for r in rows[1:] if r[1] == 'val')[
        rows[0].index('miou')])
    ecfg2 = copy.deepcopy(cfg)
    ecfg2.set_path('ckpt_path', os.path.join(out, 'checkpoints', 'last'))
    ecfg2.set_path('output_dir', os.path.join(tmp.name, 'nano_eval'))
    t0 = time.perf_counter()
    m = evaluate(ecfg2, {'test': datasets['val']})
    eval_s = time.perf_counter() - t0
    launches2 = counts()
    print(f'nano: train(cfg, datasets) 1 epoch in {fit_s:.2f} s, logged '
          f'validation mIoU {logged!r}; evaluate from last in {eval_s:.2f} '
          f's: mIoU {m["miou"]!r}; launches {launches2}')
    check(abs(m['miou'] - logged) <= FIT_MIOU_TOL
          and launches2['K2'] == launches['K2']
          + K2_LAUNCHES_PER_FORWARD * n_val,
          f'nano evaluate: mIoU {m["miou"]} vs the logged {logged} beyond '
          f'{FIT_MIOU_TOL}, or not 7 K2 launches a forward')
    timings = {name: dict(zip(('ms', 'plain_ms', 'bound_ms', 'bound_by',
                               'shape'), t[:5])) for name, t in (
        ('K1', k1), ('K2', k2))}
    return {'K1': train_launches + launches2['K1'],
            'K2': serve_launches + launches2['K2']}, timings


def write_dataset_roots(root):
    """Synthetic raw files in the DALES, KITTI-360 and ScanNet layouts
    under `root`/<dataset>/raw, written with the port's writers; returns
    {dataset: {cloud: raw points}} and the seconds it took."""
    from superpoint_transformer_torch.datasets.dales import DALES_TILES
    from superpoint_transformer_torch.utils import synthetic as syn
    t0 = time.perf_counter()
    raw = {'dales': {}, 'kitti360': {}, 'scannet': {}}
    seed = SEED + 100
    for split, tiles in DALES_TILES.items():
        for tile in tiles[:2]:
            cloud, planted = syn.synthetic_aerial_cloud(
                seed=seed, n_points=DALES_TILE_POINTS, extent=AERIAL_EXTENT)
            cloud['planted'] = planted
            d = os.path.join(root, 'dales', 'raw')
            os.makedirs(d, exist_ok=True)
            syn.write_dales_tile(os.path.join(d, f'{tile}.ply'), cloud)
            raw['dales'][tile] = cloud.num_nodes
            seed += 1
    for split, seq in (('train', '2013_05_28_drive_0000_sync'),
                       ('val', '2013_05_28_drive_0002_sync')):
        cloud, _ = syn.synthetic_aerial_cloud(
            seed=seed, n_points=KITTI360_WINDOW_POINTS, extent=AERIAL_EXTENT)
        d = os.path.join(root, 'kitti360', 'raw', 'data_3d_semantics', split,
                         seq, 'static')
        os.makedirs(d)
        syn.write_kitti360_window(
            os.path.join(d, '0000000002_0000000385.ply'), cloud)
        raw['kitti360'][f'{seq}/0000000002_0000000385'] = cloud.num_nodes
        seed += 1
    for split, scan in (('train', 'scene0000_00'), ('val', 'scene0001_00')):
        cloud = syn.synthetic_room_cloud(seed=seed,
                                         n_points=SCANNET_SCAN_POINTS)
        d = os.path.join(root, 'scannet', 'raw')
        syn.write_scannet_scan(os.path.join(d, 'scans', scan), cloud)
        with open(os.path.join(d, f'scannetv2_{split}.txt'), 'w') as f:
            f.write(scan + '\n')
        raw['scannet'][scan] = cloud.num_nodes
        seed += 1
    return raw, time.perf_counter() - t0


def spt3_cfg(base, dev, data_dir, out, epochs=1, mini=False):
    """`base` (a builtin SPT-3 config) as a `Config` for this run."""
    import copy
    from superpoint_transformer_torch.config.loader import _to_config
    cfg = _to_config(copy.deepcopy(base))
    for key, value in (('device', str(dev)), ('output_dir', out),
                       ('datamodule.data_dir', data_dir),
                       ('datamodule.mini', mini),
                       ('trainer.max_epochs', epochs),
                       ('trainer.check_val_every_n_epoch', 1)):
        cfg.set_path(key, value)
    return cfg


def process_datasets(name, cfg, raw, card):
    """Read and preprocess the clouds of `cfg`'s datasets (in memory);
    prints the seconds per 1M raw points, by stage, and the nodes per
    level; returns the datasets."""
    datasets = memory_datasets(cfg)
    t0 = time.perf_counter()
    for ds in datasets.values():
        ds.process()
    prep_s = time.perf_counter() - t0
    stages, n_raw, nodes = {}, 0, {}
    for ds in datasets.values():
        for i, c in enumerate(ds.cloud_ids):
            nag = ds[i]
            check(nag.num_levels == 4 and all(
                nag[j].num_nodes > 1 for j in nag.levels),
                f'{name} {c}: not 4 levels of more than one node')
            nodes[c] = [nag[j].num_nodes for j in nag.levels]
            if c in raw:
                n_raw += raw.pop(c)
                for k, v in MEMORY_STAGE_S[ds.processed_path(c)].items():
                    stages[k] = stages.get(k, 0.0) + v
    per = 1e6 / n_raw
    print(f'{name}: {len(nodes)} clouds, {n_raw} raw points read and '
          f'preprocessed in {prep_s:.2f} s on the host ({os.cpu_count()} '
          f'cores; {stages.get("total", 0) * per:.3f} s per 1M raw points: '
          + ', '.join(f'{k} {v * per:.3f}' for k, v in sorted(
              stages.items(), key=lambda kv: -kv[1]) if k != 'total')
          + f'); nodes per level {nodes}')
    return datasets


def fit_and_evaluate(name, cfg, datasets, card):
    """`train(cfg, datasets)` (K1 a step, K2 a validation forward), then
    `evaluate` from 'last' on the validation split: its mIoU the logged
    one. Returns (launches, widest K1 arguments, widest K2 arguments,
    trainer)."""
    import copy
    from superpoint_transformer_torch.eval import evaluate
    from superpoint_transformer_torch.train import train
    out = str(cfg['output_dir'])
    reset_counts()
    with plain_attention_calls() as plain, \
            widest_call('dense_attention_trainable') as k1_args:
        t0 = time.perf_counter()
        trainer = train(cfg, datasets)
        fit_s = time.perf_counter() - t0
    launches = counts()
    steps = sum(t['steps'] for t in trainer.epoch_times)
    n_val = len(datasets['val']) * len(trainer.epoch_times)
    print_epochs(f'{name} fit', trainer, card)
    print(f'{name}: train(cfg, datasets) {len(trainer.epoch_times)} epochs '
          f'in {fit_s:.2f} s; {steps} steps, {n_val} validation forwards; '
          f'launches {launches}, plain attention calls {plain["plain"]}')
    check(launches['K1'] == SPT3_LAUNCHES * steps > 0
          and launches['K2'] == SPT3_LAUNCHES * n_val > 0
          and launches['K3'] == 0 and plain['plain'] == 0,
          f'{name} fit: not {SPT3_LAUNCHES} K1 launches a step and '
          f'{SPT3_LAUNCHES} K2 a validation forward')
    with open(os.path.join(out, 'metrics.csv')) as f:
        rows = [line.strip().split(',') for line in f]
    logged = float([r for r in rows[1:] if r[1] == 'val'][-1][
        rows[0].index('miou')])
    ecfg = copy.deepcopy(cfg)
    ecfg.set_path('ckpt_path', os.path.join(out, 'checkpoints', 'last'))
    ecfg.set_path('output_dir', out + '_eval')
    before = counts()
    with widest_call('dense_attention_rpe') as k2_args:
        t0 = time.perf_counter()
        m = evaluate(ecfg, {'test': datasets['val']})
        eval_s = time.perf_counter() - t0
    launches = counts()
    print(f'{name}: evaluate from last on the validation split in '
          f'{eval_s:.2f} s: mIoU {m["miou"]!r} vs the logged {logged!r}; '
          f'launches {launches}')
    check(abs(m['miou'] - logged) <= FIT_MIOU_TOL
          and launches['K2'] - before['K2']
          == SPT3_LAUNCHES * len(datasets['val']),
          f'{name} evaluate: mIoU {m["miou"]} vs the logged {logged} beyond '
          f'{FIT_MIOU_TOL}, or not {SPT3_LAUNCHES} K2 launches a forward')
    return launches, k1_args, k2_args, trainer


def hold_spt3(name, cfg, eval_nags, train_nags, dev, rng_seed):
    """The kernel model against the plain attention at SPT-3 width: the
    logits of an evaluation batch of `eval_nags` in f32 and bf16, and one
    training step's loss and gradients on a batch of `train_nags` in f32
    and bf16 (`hold_train_step`, at TRAIN_TOL[(name, dtype)]). Each run
    twice bit-equal."""
    import dataclasses
    import numpy as np
    import torch
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.experiment import (build_batch_config,
                                                         build_task)
    from superpoint_transformer_torch.inference import EVAL_BATCH_OVERRIDES
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.transforms.prepare import (
        prepare_batch)
    n_cls = int(cfg['datamodule']['num_classes'])
    panoptic = str(cfg['model'].get('task', 'semantic')) == 'panoptic'
    bcfg = build_batch_config(cfg)
    ev = prepare_batch(eval_nags, dataclasses.replace(
        bcfg, **EVAL_BATCH_OVERRIDES), train=False)
    tr = prepare_batch(train_nags, bcfg, train=True,
                       rng=np.random.default_rng(rng_seed))

    def task(cd, plain=False, graphs=len(train_nags)):
        t = build_task(cfg, num_graphs=graphs, compute_dtype=cd,
                       plain_attention=plain, device=dev)
        init_weights(t.model, torch.Generator().manual_seed(SEED))
        return t

    def logits(cd, plain=False):
        model = task(cd, plain, len(eval_nags)).model.eval()
        # the semantic logits; a panoptic model also gives edge affinities
        return (lambda b: model(b)[0]) if panoptic else model

    for cd in (None, 'bfloat16'):
        hold_logits(f'{name} ', logits(cd), logits(cd, True),
                    from_numpy(ev, dev, cd, train=panoptic), cd, n_cls)
    for cd in (None, 'bfloat16'):
        hold_train_step(name, task(cd), task(cd, True),
                        from_numpy(tr, dev, cd, train=True), cd)


def dales_serving(cfg, datasets, raw_dir, dev, card):
    """A 4-tile batch served through `infer_batch` (3 requests), one raw
    tile through `e2e_inference`, and the 4 tiles through
    `infer_nags_stacked` (twice, bit-equal to the per-tile `infer_nag`
    loop), by SPT-3 in bf16; the forward and a training step timed.
    Returns (K2 launches, widest K2 arguments)."""
    import dataclasses
    import numpy as np
    import torch
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.datasets.dales import read_dales_tile
    from superpoint_transformer_torch.experiment import (
        _pre_transform_config, build_batch_config, build_model, build_task)
    from superpoint_transformer_torch.inference import (
        EVAL_BATCH_OVERRIDES, e2e_inference, infer_batch, infer_nag,
        infer_nags_stacked, pin_signature)
    from superpoint_transformer_torch.models.semantic import (
        SemanticSegmentationModel)
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.transforms.prepare import (
        prepare_batch, process_batch)
    n_cls = int(cfg['datamodule']['num_classes'])
    tiles = [datasets[s][i] for s in ('train', 'val')
             for i in range(len(datasets[s]))][:DALES_SERVE_TILES]
    ecfg = dataclasses.replace(build_batch_config(cfg),
                               **EVAL_BATCH_OVERRIDES)
    t0 = time.perf_counter()
    host = prepare_batch(tiles, ecfg, train=False)
    prep_s = time.perf_counter() - t0
    model = SemanticSegmentationModel(build_model(
        cfg, num_graphs=len(tiles), device=dev), n_cls, device=dev)
    init_weights(model, torch.Generator().manual_seed(SEED))
    model.eval()
    cd = model.net.compute_dtype
    reset_counts()
    req_ms = []
    with plain_attention_calls() as plain, \
            widest_call('dense_attention_rpe') as k2_args, \
            widest_norm() as gn_args:
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = from_numpy(host, dev, cd)
            pred = infer_batch(model, batch)
            req_ms.append((time.perf_counter() - t0) * 1e3)
    launches = counts()
    n, caps, k = level_counts(batch)
    print(f'dales serving on {card}: {len(tiles)} tiles, nodes {n}, '
          f'capacities {caps}, K={k}; batch prepared in {prep_s:.2f} s on '
          f'the host; requests {[round(t, 1) for t in req_ms]} ms (host '
          f'batch to predictions); launches {launches}, GN {gn_count()}')
    check(launches['K2'] == 3 * SPT3_LAUNCHES and launches['K1'] == 0
          and launches['K3'] == 0 and plain['plain'] == 0,
          f'dales serving: not {SPT3_LAUNCHES} K2 launches a forward')
    check(gn_count() == 3 * GN_PER_SPT3_FORWARD,
          f'dales serving: {gn_count()} GN launches in 3 forwards, '
          f'expected {3 * GN_PER_SPT3_FORWARD}')
    hold_gn_on_path('dales serving', gn_args)
    del gn_args
    check(pred.shape == (n[1],) and pred.min() >= 0 and pred.max() < n_cls,
          'dales predictions are not a class per level-1 node')
    served = launches['K2']
    fwd_ms = cuda_ms(lambda: infer_batch(model, batch), 10)
    print(f'dales SPT-3 forward on {card}: {fwd_ms:.3f} ms (CUDA events, '
          f'10 forwards of the {len(tiles)}-tile batch with the level-1 '
          'argmax, after 3 warm-up)')
    del batch

    # one raw tile, end to end
    tile = datasets['test'].cloud_ids[0]
    raw = read_dales_tile(os.path.join(raw_dir, f'{tile}.ply'))
    pre = dict(_pre_transform_config(cfg), num_classes=n_cls)
    reset_counts()
    with plain_attention_calls() as plain:
        full, info = e2e_inference(model, raw, pre_cfg=pre, batch_cfg=ecfg,
                                   tiling=(1, 1))
    launches = counts()
    print(f'dales e2e_inference of {tile} on {card}: {info}; launches '
          f'{launches}')
    check(full.shape == (raw.num_nodes,) and full.min() >= 0
          and full.max() < n_cls and launches['K2'] > 0
          and launches['K2'] % SPT3_LAUNCHES == 0
          and launches['K1'] == launches['K3'] == plain['plain'] == 0,
          'dales e2e_inference: a raw point has no label, or not K2 alone')
    served += launches['K2']

    # the served tiles through infer_nags_stacked (twice) vs the per-tile
    # infer_nag loop, at their shared signature
    pcfg = pin_signature([process_batch([t], ecfg, train=False)
                          for t in tiles], ecfg)
    reset_counts()
    tl, ts = {}, {}
    loop = [infer_nag(model, t, pcfg, timings=tl) for t in tiles]
    stacked = [infer_nags_stacked(model, tiles, pcfg, timings=ts)
               for _ in range(2)]
    launches = counts()
    print(f'dales stacked serving of {len(tiles)} tiles on {card}: '
          f'per-tile loop {tl}, stacked (2 runs) {ts} (s); launches '
          f'{launches}')
    check(all(np.array_equal(a, b) for run in stacked
              for a, b in zip(run, loop))
          and launches['K2'] == 3 * len(tiles) * SPT3_LAUNCHES,
          'dales: stacked predictions differ from the per-tile loop or '
          'between two stacked runs')
    served += launches['K2']
    del model

    # a training step on the 2 training tiles, timed
    task = build_task(cfg, num_graphs=len(datasets['train']), device=dev)
    init_weights(task.model, torch.Generator().manual_seed(SEED))
    h = prepare_batch([datasets['train'][i]
                       for i in range(len(datasets['train']))],
                      build_batch_config(cfg), train=True,
                      rng=np.random.default_rng(SEED + 40))
    batch = from_numpy(h, dev, cd, train=True)
    step_ms = cuda_ms(lambda: task.train_step(batch), 5)
    n, caps, k = level_counts(batch)
    print(f'dales SPT-3 train step on {card}: {step_ms:.3f} ms (CUDA '
          f'events, 5 steps after 3 warm-up) on nodes {n}, capacities '
          f'{caps}, K={k}')
    return served, k2_args


def phase_datasets(dev, card, tmp):
    """SPT-3 at full width (64 channels, 16 heads, qk_dim 4, bf16) on the
    DALES, KITTI-360 and ScanNet readers, with synthetic raw files in
    each format under `tmp`, each dataset its own path:
    - dales: `train(cfg, datasets)` with `experiment=semantic/dales` and
      `datamodule.mini=True` for DALES_EPOCHS epochs, `evaluate` from its
      checkpoint, a 4-tile batch through `infer_batch` and one raw tile
      through `e2e_inference`;
    - kitti360: `train` with `experiment=semantic/kitti360` for
      KITTI360_EPOCHS epoch and `evaluate`;
    - scannet: `experiment=panoptic/scannet`: one `validate_panoptic` of
      the validation split (grid search included) and one
      `PanopticTask.train_step`.
    Each holds the logits of an evaluation batch and a training step's
    loss and gradients against the plain attention in f32 and bf16 (each
    run twice, bit-equal), at TRAIN_TOL and the logit limits, and K1
    (forward and backward) and K2 against their plain versions on the
    arguments of their widest launches; the evaluation's mIoU is the
    logged one. K1 and K2 are timed on the arguments of their widest
    launches over the three paths. Returns ({path: launches}, timings)."""
    import dataclasses
    import numpy as np
    import torch
    from superpoint_transformer_torch import trainer as trainer_mod
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.experiment import (
        DALES_CFG, KITTI360_CFG, PANOPTIC_SCANNET_CFG, build_batch_config,
        build_task)
    from superpoint_transformer_torch.inference import EVAL_BATCH_OVERRIDES
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.transforms.prepare import (
        prepare_batch)

    settle()
    root = os.path.join(tmp.name, 'datasets')
    raw, write_s = write_dataset_roots(root)
    print(f'datasets: {sum(len(v) for v in raw.values())} clouds '
          f'({sum(sum(v.values()) for v in raw.values())} raw points) '
          f'written in the DALES, KITTI-360 and ScanNet formats in '
          f'{write_s:.2f} s')
    paths = {}

    # dales: fit, evaluate, serve, e2e
    cfg = spt3_cfg(DALES_CFG, dev, os.path.join(root, 'dales'),
                   os.path.join(tmp.name, 'dales_out'), DALES_EPOCHS,
                   mini=True)
    datasets = process_datasets('dales', cfg, raw['dales'], card)
    launches, k1_args, k2_fit, trainer = fit_and_evaluate(
        'dales', cfg, datasets, card)
    served, k2_args = dales_serving(cfg, datasets,
                                    os.path.join(root, 'dales', 'raw'), dev,
                                    card)
    paths['dales'] = {'K1': launches['K1'], 'K2': launches['K2'] + served}
    del trainer
    # the arguments of the widest K1 and K2 launches over the three paths
    widest = {}

    def hold_widest(path, k1_args, *k2_args):
        hold_on_path('K1', k1_args, f'{path} path')
        for name, args in [('K1', k1_args)] + [('K2', a) for a in k2_args]:
            if args[0].shape[0] > widest.get(name, (None, 0))[1]:
                widest[name] = (path, args[0].shape[0], args)
        for args in k2_args:
            hold_on_path('K2', args, f'{path} path')

    hold_widest('dales', k1_args, k2_fit, k2_args)
    del k1_args, k2_fit, k2_args
    hold_spt3('dales', cfg, [datasets['val'][i] for i in range(2)],
              [datasets['train'][i] for i in range(2)], dev, SEED + 41)
    release(datasets)
    del datasets
    settle()

    # kitti360: fit and evaluate
    cfg = spt3_cfg(KITTI360_CFG, dev, os.path.join(root, 'kitti360'),
                   os.path.join(tmp.name, 'kitti360_out'), KITTI360_EPOCHS)
    datasets = process_datasets('kitti360', cfg, raw['kitti360'], card)
    launches, k1_args, k2_args, _ = fit_and_evaluate(
        'kitti360', cfg, datasets, card)
    paths['kitti360'] = {'K1': launches['K1'], 'K2': launches['K2']}
    hold_widest('kitti360', k1_args, k2_args)
    del k1_args, k2_args
    hold_spt3('kitti360', cfg, [datasets['val'][0]], [datasets['train'][0]],
              dev, SEED + 42)
    release(datasets)
    del datasets
    settle()

    # scannet: panoptic validation and a train step
    cfg = spt3_cfg(PANOPTIC_SCANNET_CFG, dev, os.path.join(root, 'scannet'),
                   os.path.join(tmp.name, 'scannet_out'))
    datasets = process_datasets('scannet', cfg, raw['scannet'], card)
    nags = [datasets['train'][0], datasets['val'][0]]
    dm = cfg['datamodule']
    n_cls = int(dm['num_classes'])
    ids = nags[0][0].obj.obj
    check(bool((ids == -1).any()) and bool((ids >= 0).any()),
          'scannet: no vertex outside the aggregation groups (object -1)')
    task = build_task(cfg, num_graphs=len(nags), device=dev)
    init_weights(task.model, torch.Generator().manual_seed(SEED))
    cd = task.model.net.compute_dtype
    bcfg = build_batch_config(cfg)
    reset_counts()
    with plain_attention_calls() as plain, \
            widest_call('dense_attention_rpe') as k2_args:
        t0 = time.perf_counter()
        result = trainer_mod.validate_panoptic(
            task, [[datasets['val'][i] for i in range(len(datasets['val']))]],
            dataclasses.replace(bcfg, **EVAL_BATCH_OVERRIDES),
            n_cls, stuff_classes=tuple(dm['stuff_classes']),
            grid_search=True)
        val_s = time.perf_counter() - t0
    val_launches = counts()
    metrics = {k: result[k] for k in ('pq', 'sq', 'rq', 'map', 'map_50')}
    print(f'scannet: validate_panoptic of the validation scan in '
          f'{val_s:.2f} s (grid search included, settings '
          f'{result["settings"]}): '
          f'{metrics}; {result["n_pred_instances"]} predicted instances; '
          f'launches {val_launches}')
    check(val_launches['K2'] == SPT3_LAUNCHES and val_launches['K1'] == 0
          and plain['plain'] == 0 and all(
              0 <= result[k] <= 100 for k in ('pq', 'sq', 'rq')),
          f'scannet validation: not {SPT3_LAUNCHES} K2 launches, or PQ out '
          'of [0, 100]')
    head = [p.detach().clone()
            for p in task.model.edge_affinity_head.parameters()]
    h = prepare_batch(nags, bcfg, train=True,
                      rng=np.random.default_rng(SEED + 43))
    reset_counts()
    with widest_call('dense_attention_trainable') as k1_args:
        loss = task.train_step(from_numpy(h, dev, cd, train=True))['loss']
    launches = counts()
    print(f'scannet: PanopticTask train step loss {loss.item():.6f}; '
          f'launches {launches}')
    check(bool(torch.isfinite(loss)) and launches['K1'] == SPT3_LAUNCHES
          and launches['K2'] == 0 and all(
              not torch.equal(a, p.detach()) for a, p in zip(
                  head, task.model.edge_affinity_head.parameters())),
          f'scannet train step: loss not finite, not {SPT3_LAUNCHES} K1 '
          'launches, or the edge-affinity head did not move')
    paths['scannet'] = {'K1': launches['K1'], 'K2': val_launches['K2']}
    del task
    hold_widest('scannet', k1_args, k2_args)
    del k1_args, k2_args
    hold_spt3('scannet', cfg, nags, nags, dev, SEED + 44)
    release(datasets)
    del datasets, nags
    settle()
    print(f'launches on the dataset paths: {paths}')
    for path, got in paths.items():
        check(got['K1'] > 0 and got['K2'] > 0,
              f'the {path} path did not launch K1 and K2')
    timings = {}
    for name, (path, _, args) in sorted(widest.items()):
        ms_, plain_ms, bound_ms, by, shape, rounds = time_on_path(name, args)
        print(f'{name} at the widest SPT-3 shape {shape} ({path} path) on '
              f'{card}: kernel {ms_:.4f} ms, plain {plain_ms:.4f} ms; bound '
              f'{bound_ms:.4f} ms ({by}), share {bound_ms / ms_:.3f}; rounds '
              f'{rounds} (CUDA graph of 20 calls, CUDA events)')
        timings[name] = dict(ms=ms_, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=by, shape=shape, path=path)
    return paths, timings


def variant_host(seed, num_graphs, size, variant):
    """A `random_padded_nag` (host) batch for the variant model `variant`:
    for B, random node features at levels 1 and 2 and vertical edge
    features at levels 0 and 1 (VARIANT_HF channels, zero on padded rows)
    and no horizontal edge features."""
    import dataclasses
    import numpy as np
    from superpoint_transformer_torch.utils.synthetic import (
        random_padded_nag)
    host = random_padded_nag(seed=seed, num_graphs=num_graphs, **size)
    rng = np.random.default_rng(seed + 100)

    def feats(lvl):
        f = rng.standard_normal((lvl.capacity, VARIANT_HF)).astype(
            np.float32)
        return f * lvl.node_mask[:, None]

    if variant != 'B':
        return host
    levels = []
    for i, lvl in enumerate(host.levels):
        kw = {'edge_feat': None}
        if i > 0:
            kw['x'] = feats(lvl)
        if i < 2:
            kw['v_edge_attr'] = feats(lvl)
        levels.append(dataclasses.replace(lvl, **kw))
    return dataclasses.replace(host, levels=tuple(levels))


def phase_variants(dev, card, nags):
    """The SPT options that no config sets, at SPT-2's full width:
    (a) the variant models A, B, C (VARIANTS) served on K1 (a query per
    edge in A, per node in B and C) and trained for one step, each held
    to the same weights on the plain attention in f32 and bf16 and run
    twice bit-equal (dropout streams reseeded); K1 held and timed on the
    arguments of its widest per-node and per-edge launches; (b) EZ-SP
    semantic, SPT-2 with the point CNN into and beside the point MLP, on
    the host path's rooms `nags` with `quantize_coordinates` coords,
    served on K2 and trained on K1, and its reference-keyed state dict
    imported with strict=True; (c) the model-FLOP count of the flagship
    forward and step with the kernels and with the plain attention
    (equal), and the mfu of the bf16 forward and step. Returns the
    launches of the main paths and K1's per-node timing."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.experiment import (
        FLAGSHIP_CFG, build_model, build_task, spt_kwargs)
    from superpoint_transformer_torch.inference import EVAL_BATCH_OVERRIDES
    from superpoint_transformer_torch.models.semantic import (
        SemanticSegmentationModel, SemanticTask)
    from superpoint_transformer_torch.models.spt import SPT
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.transforms.prepare import (
        BatchConfig, prepare_batch)
    from superpoint_transformer_torch.utils.synthetic import (
        random_padded_nag)
    from superpoint_transformer_torch.transforms.preprocess import (
        quantize_coordinates)
    from superpoint_transformer_torch.utils.flops import matmul_flops
    from superpoint_transformer_torch.utils.import_ckpt import (
        import_reference_checkpoint, reference_state_dict)

    t_phase = time.perf_counter()
    settle()

    def net(over, num_graphs, cd, plain=False):
        kw = spt_kwargs(FLAGSHIP_CFG, num_graphs=num_graphs,
                        compute_dtype=cd, plain_attention=plain, device=dev)
        kw.update(over)
        return SPT(**kw)

    def model(over, cd, plain=False):
        m = SemanticSegmentationModel(net(over, NUM_GRAPHS, cd, plain), 13,
                                      device=dev)
        init_weights(m, torch.Generator().manual_seed(SEED))
        return m.eval()

    def task(over, cd, plain=False):
        t = SemanticTask(net(over, TRAIN_GRAPHS, cd, plain), num_classes=13,
                         lr=1e-3)
        init_weights(t.model, torch.Generator().manual_seed(SEED))
        return t

    def calibrated(m, batch):
        """`m` with its BatchNorms' running statistics set to those of
        `batch` (one training forward at momentum 0), as a trained model
        has them: at their initial values (0 and 1) a random model's
        logits reach ~140."""
        from superpoint_transformer_torch.nn.norm import BatchNorm
        norms = [n for n in m.modules() if isinstance(n, BatchNorm)]
        for n in norms:
            n.momentum = 0.0
        m.net.dropout_rng.manual_seed(SEED)
        with torch.no_grad():
            m.train()(batch)
        for n in norms:
            n.momentum = 0.9
        return m.eval()

    def one_forward(m, batch):
        reset_counts()
        with torch.inference_mode():
            m(batch)
        return counts()

    def one_step(t, batch):
        reset_counts()
        loss_grads(t, batch, seed=SEED)
        return counts()

    served = {'K1': 0, 'K2': 0}
    trained = {'K1': 0}
    widest = {}
    for name, over in VARIANTS.items():
        serve_host = variant_host(SEED + 40, NUM_GRAPHS, ROOM, name)
        train_host = variant_host(SEED + 41, TRAIN_GRAPHS, CROP, name)
        for cd in (None, 'bfloat16'):
            batch = from_numpy(serve_host, dev, cd)
            kern = calibrated(model(over, cd), batch)
            plain = model(over, cd, True)
            plain.load_state_dict(kern.state_dict())
            with widest_call('dense_attention') as k1_args:
                got = one_forward(kern, batch)
            check(got == {'K1': K1_LAUNCHES_PER_STEP, 'K2': 0, 'K3': 0},
                  f'variant {name}: launches {got} in one forward, expected '
                  f'{K1_LAUNCHES_PER_STEP} K1')
            served['K1'] += got['K1']
            hold_logits(f'variant {name} ', kern, plain, batch, cd)
            if cd == 'bfloat16':
                widest[name] = k1_args
            t = task(over, cd)
            tb = from_numpy(train_host, dev, cd, train=True)
            got = one_step(t, tb)
            # attention dropout in training takes JAX's materialized route
            want = 0 if over.get('down_attn_drop') else K1_LAUNCHES_PER_STEP
            check(got == {'K1': want, 'K2': 0, 'K3': 0},
                  f'variant {name}: launches {got} in one step, expected '
                  f'{want} K1')
            trained['K1'] += got['K1']
            hold_train_step('variants', t, task(over, cd, True), tb, cd,
                            seed=SEED, label=f'variant {name} ')
            del kern, plain, t, batch, tb
        print(f'variant {name}: {K1_LAUNCHES_PER_STEP} K1 launches a '
              f'forward, {want} a training step')
    # K1 on its widest launches: a query per node (B), per edge (A)
    for name in ('A', 'B'):
        q = widest[name][0]
        check((q.dim() == 3) == (name == 'B'),
              f'variant {name}: K1 took a query of {q.dim()} dims')
        hold_on_path('K1', widest[name], path=f'variant {name}')
    k1_node = time_on_path('K1', widest['B'])
    ms, plain_ms, bound_ms, by, shape, rounds = k1_node
    print(f'K1 with a query per node at variant B\'s widest level '
          f'({shape}, bf16) on {card}: {ms:.4f} ms, plain version '
          f'{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}, '
          f'{bound_ms / ms:.1%} of it reached); rounds {rounds}')
    del widest
    settle()

    # (b) EZ-SP semantic: the rooms' level-0 voxels quantized
    rooms = []
    for nag in nags:
        nag = copy.deepcopy(nag)
        quantize_coordinates(nag[0], size=VOXEL)
        rooms.append(nag)
    host = prepare_batch(rooms * 2, dataclasses.replace(
        BatchConfig(), **EVAL_BATCH_OVERRIDES), train=False)
    thost = prepare_batch(rooms, BatchConfig(), train=True,
                          rng=np.random.default_rng(SEED + 2))
    tbl = host.levels[0].cnn_nbr_idx
    check(tbl is not None and tbl.dtype == np.int32,
          'pad_nag built no int32 cnn_nbr_idx from the level-0 coords')
    print(f'ezsp: cnn_nbr_idx {tbl.shape} int32 on the host '
          f'({tbl.nbytes / 2**20:.1f} MiB; int64 on the card), '
          f'{(tbl[:host.levels[0].num_nodes] >= 0).sum(1).mean():.2f} '
          'voxels a kernel on average')
    point_hf = spt_kwargs(FLAGSHIP_CFG, device='cpu')['point_hf_dim']
    ezsp = {'K1': 0, 'K2': 0}
    for into in (True, False):
        mlp = (4 + POINT_CNN[-1], 32, 64, 128) if into \
            else (4 + point_hf, 32, 64, 128 - POINT_CNN[-1])
        over = dict(point_cnn=POINT_CNN, point_cnn_into_mlp=into,
                    point_mlp=mlp)
        label = f'ezsp (CNN {"into" if into else "beside"} the MLP) '
        for cd in (None, 'bfloat16'):
            kern = model(over, cd)
            batch = from_numpy(host, dev, cd)
            got = one_forward(kern, batch)
            check(got == {'K1': 0, 'K2': K2_LAUNCHES_PER_FORWARD, 'K3': 0},
                  f'{label}launches {got} in one forward')
            ezsp['K2'] += got['K2']
            logits = hold_logits(label, kern, model(over, cd, True), batch,
                                 cd)
            t = task(over, cd)
            tb = from_numpy(thost, dev, cd, train=True)
            got = one_step(t, tb)
            check(got == {'K1': K1_LAUNCHES_PER_STEP, 'K2': 0, 'K3': 0},
                  f'{label}launches {got} in one step')
            ezsp['K1'] += got['K1']
            hold_train_step('ezsp', t, task(over, cd, True), tb, cd,
                            label=label)
            if into and cd == 'bfloat16':
                state = reference_state_dict(kern)
                twin = SemanticSegmentationModel(
                    net(over, NUM_GRAPHS, cd), 13, device=dev).eval()
                report = import_reference_checkpoint(state, twin)
                with torch.inference_mode():
                    again = twin(batch)
                same = all(torch.equal(a, b) for a, b in zip(logits, again))
                kernel = state['net.first_stage.cnn_blocks.0.conv.kernel']
                print(f'{label}reference state dict: {len(state)} keys '
                      f'(cnn_blocks.0.conv.kernel {tuple(kernel.shape)}), '
                      f'imported with strict=True: {len(report["mapped"])} '
                      f'tensors, served logits bit-equal: {same}')
                check(same and not report['missing'],
                      f'{label}the imported reference state dict serves '
                      'other logits')
            del kern, t, batch, tb
    del rooms, host, thost
    settle()

    # (c) the model-FLOP count of the flagship forward and step
    fhost = random_padded_nag(seed=SEED + 1, num_graphs=NUM_GRAPHS, **ROOM)
    thost = random_padded_nag(seed=SEED + 10, num_graphs=TRAIN_GRAPHS,
                              **CROP)
    flops = {}
    for plain in (False, True):
        m = SemanticSegmentationModel(build_model(
            FLAGSHIP_CFG, num_graphs=NUM_GRAPHS, plain_attention=plain,
            device=dev), 13, device=dev).eval()
        init_weights(m, torch.Generator().manual_seed(SEED))
        cd = m.net.compute_dtype
        fb = from_numpy(fhost, dev, cd)
        with torch.inference_mode():
            fwd = matmul_flops(m, fb)
        t = build_task(FLAGSHIP_CFG, num_graphs=TRAIN_GRAPHS,
                       plain_attention=plain, device=dev)
        init_weights(t.model, torch.Generator().manual_seed(SEED))
        tb = from_numpy(thost, dev, cd, train=True)
        step = matmul_flops(lambda: loss_grads(t, tb))
        flops[plain] = (fwd, step)
        if not plain:
            def forward():
                with torch.inference_mode():
                    m(fb)
            fwd_ms = min(cuda_ms(forward, 10) for _ in range(2))
            step_ms = min(cuda_ms(lambda: t.train_step(tb), 5)
                          for _ in range(2))
    print(f'flagship model FLOPs (contractions, ops/cost.py for the '
          f'kernels): forward {flops[False][0]:,} with the kernels, '
          f'{flops[True][0]:,} with the plain attention; training step '
          f'(forward and backward) {flops[False][1]:,} / {flops[True][1]:,}')
    check(flops[False] == flops[True],
          'the FLOP count differs between the kernels and the plain '
          'attention')
    mfu_fwd = flops[False][0] / (fwd_ms * 1e-3 * PEAK_BF16_FLOP_S)
    mfu_step = flops[False][1] / (step_ms * 1e-3 * PEAK_BF16_FLOP_S)
    print(f'flagship bf16 on {card}: forward {fwd_ms:.3f} ms, mfu '
          f'{mfu_fwd:.4%}; train step {step_ms:.3f} ms (with the AdamW '
          f'update), mfu {mfu_step:.4%} (of {PEAK_BF16_FLOP_S:.3g} '
          'FLOP/s, CUDA events)')
    print(f'variants phase: {time.perf_counter() - t_phase:.1f} s')
    timing = dict(zip(('ms', 'plain_ms', 'bound_ms', 'bound_by', 'shape'),
                      k1_node[:5]))
    return ({'K1': served['K1'] + trained['K1'] + ezsp['K1'],
             'K2': ezsp['K2']}, timing)


def phase_rest(dev, card, room, pan_room):
    """The last of the JAX package's surface, at SPT-2's full width, three
    paths of their own: (a) Delaunay serving, one raw room of the host
    path through `preprocess_cloud(graph_builder='delaunay')` (its degree
    not capped, so K2's K is the widest yet), served through
    `infer_batch` (K2, 7 launches), K2 held on its widest launch, the
    logits held to the plain attention in f32 and bf16 and run twice
    bit-equal; (b) held-out, `split_nag_spatially` of the host path's
    `room` and `run_heldout` for HELDOUT_STEPS steps of HELDOUT_CROPS
    crops (K1 on the steps, K2 on the evaluation), finite losses, mIoU in
    [0, 100], OA at most the partition oracle's; (c) the SuperCluster
    demo, `run_supercluster_demo` on the panoptic phase's `pan_room` for
    DEMO_STEPS steps of DEMO_CROPS crops with the grid search and the
    cross-oracle PQ (K1 on the steps, K2 on the two evaluations),
    pseudo-instances found, PQ, SQ and RQ in [0, 100]. On (b) and (c) K1
    and K2 are held on their widest launches. Returns the launches by
    path."""
    import dataclasses
    import numpy as np
    import torch
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.experiment import (
        FLAGSHIP_CFG, PANOPTIC_CFG, build_model, build_task)
    from superpoint_transformer_torch.inference import (
        EVAL_BATCH_OVERRIDES, infer_batch)
    from superpoint_transformer_torch.models.semantic import (
        SemanticSegmentationModel)
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.transforms.prepare import (
        BatchConfig, prepare_batch)
    from superpoint_transformer_torch.transforms.preprocess import (
        preprocess_cloud)
    from superpoint_transformer_torch.utils.heldout import (
        run_heldout, split_nag_spatially)
    from superpoint_transformer_torch.utils.supercluster_demo import (
        run_supercluster_demo)
    from superpoint_transformer_torch.utils.synthetic import (
        synthetic_room_cloud)

    def widest(args):
        return args[1].shape[0] * args[1].shape[1]   # N * K of k gathered

    # (a) Delaunay serving
    settle()
    t_part = time.perf_counter()
    raw = synthetic_room_cloud(seed=SEED, n_points=HOST_ROOM_POINTS)
    t0 = time.perf_counter()
    nag = preprocess_cloud(raw, graph_builder='delaunay')
    pre_s = time.perf_counter() - t0
    degrees = []
    for i in nag.levels[1:]:
        deg = np.bincount(nag[i].edge_index.ravel(),
                          minlength=nag[i].num_nodes)
        check(nag[i].num_nodes > 0 and nag[i].edge_index.shape[1] > 0,
              f'delaunay: level {i} is empty or has no graph')
        degrees.append((nag[i].num_nodes, nag[i].edge_index.shape[1],
                        int(deg.max())))
    print(f'delaunay: {raw.num_nodes} raw points preprocessed in '
          f'{pre_s:.2f} s on the host; (nodes, edges, max degree) per level '
          f'{degrees}')

    def flagship(cd='auto', plain_attention=False):
        m = SemanticSegmentationModel(build_model(
            FLAGSHIP_CFG, num_graphs=NUM_GRAPHS, compute_dtype=cd,
            plain_attention=plain_attention, device=dev), 13, device=dev)
        init_weights(m, torch.Generator().manual_seed(SEED))
        return m.eval()

    model = flagship()
    compute_dtype = model.net.compute_dtype
    cfg = dataclasses.replace(BatchConfig(), **EVAL_BATCH_OVERRIDES)
    host = prepare_batch([nag], cfg, train=False)
    reset_counts()
    with plain_attention_calls() as plain, \
            widest_call('dense_attention_rpe', widest) as k2_args:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = from_numpy(host, dev, compute_dtype)
        pred = infer_batch(model, batch)
        serve_s = time.perf_counter() - t0
    launches = counts()
    n, caps, _ = level_counts(batch)
    ks = [batch[i].nbr_idx.shape[1] for i in (1, 2, 3)]
    print(f'delaunay serving: nodes {n}, capacities {caps}, K per level '
          f'{ks}; from_numpy + infer_batch {serve_s * 1e3:.1f} ms; '
          f'launches {launches}, plain attention calls {plain["plain"]}')
    check(launches['K2'] == K2_LAUNCHES_PER_FORWARD and launches['K1'] == 0
          and launches['K3'] == 0 and plain['plain'] == 0,
          'delaunay serving: not 7 K2 launches, or another kernel or the '
          'plain attention ran')
    delaunay = {'K2': launches['K2']}
    check(ks[0] == max(16, -(-degrees[0][2] // 16) * 16),
          f'delaunay: level-1 K {ks[0]} is not the max degree '
          f'{degrees[0][2]} rounded up to 16 slots')
    hold_on_path('K2', k2_args, path='delaunay serving')
    del k2_args
    for cd in (None, compute_dtype):
        kern = model if cd == compute_dtype else flagship(cd)
        b = batch if cd == compute_dtype else from_numpy(host, dev, cd)
        logits = hold_logits('delaunay ', kern,
                             flagship(cd, plain_attention=True), b, cd)
        if cd == compute_dtype:
            n1 = n[1]
            agree = (pred[batch.level1_node_id[:n1]]
                     == logits[0][:n1].argmax(1).cpu().numpy()).mean()
            check(agree == 1.0, f'delaunay predictions vs level-1 argmax in '
                  f'NAG order: {agree}')

    def forward():
        with torch.inference_mode():
            model(batch)

    print(f'delaunay forward on {card}: {cuda_ms(forward, 5):.3f} ms (CUDA '
          f'events, 5 forwards after 3 warm-up); part (a) in '
          f'{time.perf_counter() - t_part:.1f} s')
    del model, batch, logits, b, kern
    settle()

    # (b) held-out training and evaluation
    t_part = time.perf_counter()
    lo, hi = split_nag_spatially(room)
    check(lo[1].num_nodes > 0 and hi[1].num_nodes > 0,
          'split_nag_spatially: an empty half')
    task = build_task(FLAGSHIP_CFG, num_graphs=HELDOUT_CROPS,
                      total_steps=HELDOUT_STEPS, device=dev)
    init_weights(task.model, torch.Generator().manual_seed(SEED))
    reset_counts()
    with plain_attention_calls() as plain, \
            widest_call('dense_attention_trainable', widest) as k1_args, \
            widest_call('dense_attention_rpe', widest) as k2_args:
        res = run_heldout(lo, hi, steps=HELDOUT_STEPS, crops=HELDOUT_CROPS,
                          seed=SEED, task=task, log=print)
    launches = counts()
    print(f'held-out: halves of {lo[1].num_nodes} and {hi[1].num_nodes} '
          f'level-1 nodes; {res}; launches {launches}, plain attention '
          f'calls {plain["plain"]}')
    check(launches['K1'] == HELDOUT_STEPS * K1_LAUNCHES_PER_STEP
          and launches['K2'] == K2_LAUNCHES_PER_FORWARD
          and launches['K3'] == 0 and plain['plain'] == 0,
          'held-out: not 7 K1 launches a step and 7 K2 launches for the '
          'evaluation, or another kernel or the plain attention ran')
    check(all(np.isfinite(res[k]) for k in ('loss_first', 'loss_last')),
          f'held-out losses {res["loss_first"]}, {res["loss_last"]}')
    check(0 <= res['miou'] <= 100, f'held-out mIoU {res["miou"]}')
    check(res['oa'] <= res['oracle_oa'] + 1e-9,
          f'held-out OA {res["oa"]} above the oracle {res["oracle_oa"]}')
    heldout = {'K1': launches['K1'], 'K2': launches['K2']}
    hold_on_path('K1', k1_args, path='held-out training')
    hold_on_path('K2', k2_args, path='held-out evaluation')
    del k1_args, k2_args, task
    print(f'held-out part (b) in {time.perf_counter() - t_part:.1f} s')
    settle()

    # (c) the SuperCluster demo
    t_part = time.perf_counter()
    ptask = build_task(PANOPTIC_CFG, num_graphs=DEMO_CROPS,
                       total_steps=DEMO_STEPS, device=dev)
    init_weights(ptask.model, torch.Generator().manual_seed(SEED))
    reset_counts()
    with plain_attention_calls() as plain, \
            widest_call('dense_attention_trainable', widest) as k1_args, \
            widest_call('dense_attention_rpe', widest) as k2_args:
        res = run_supercluster_demo(pan_room, steps=DEMO_STEPS,
                                    crops=DEMO_CROPS, seed=SEED, task=ptask,
                                    log=print)
    launches = counts()
    print(f'supercluster demo: {res}; launches {launches}, plain attention '
          f'calls {plain["plain"]}')
    check(launches['K1'] == DEMO_STEPS * K1_LAUNCHES_PER_STEP
          and launches['K2'] == 2 * K2_LAUNCHES_PER_FORWARD
          and launches['K3'] == 0 and plain['plain'] == 0,
          'supercluster demo: not 7 K1 launches a step and 7 K2 launches '
          'for each of its 2 evaluations, or another kernel or the plain '
          'attention ran')
    check(res['n_pseudo_instances'] > 0, 'supercluster demo: no '
          'pseudo-instance')
    check(all(np.isfinite(res[k]) for k in ('loss_first', 'loss_last')),
          f'supercluster demo losses {res["loss_first"]}, '
          f'{res["loss_last"]}')
    for k in ('pq', 'sq', 'rq'):
        check(0 <= res[k] <= 100, f'supercluster demo {k} {res[k]}')
    demo = {'K1': launches['K1'], 'K2': launches['K2']}
    hold_on_path('K1', k1_args, path='supercluster demo training')
    hold_on_path('K2', k2_args, path='supercluster demo evaluation')
    del k1_args, k2_args, ptask
    print(f'supercluster demo part (c) in {time.perf_counter() - t_part:.1f}'
          ' s')
    settle()
    return {'delaunay-serving': delaunay, 'heldout': heldout,
            'supercluster-demo': demo}


def phase_long_tail(dev, card, room):
    """The JAX package's long-tail transforms, multi-run TTA, `predict`
    and the confusion update, at SPT-2's full width, on the host path's
    `room` (a path of its own): (a) cleanup and split, `inliers`
    (recursive) and `outliers` on level 0, an `is_val` mask drawn from
    SEED over level 1 and `select_by_key` into val and train halves,
    `shuffle` and `select_columns` on the train half; (b) LONG_TAIL_STEPS
    `SemanticTask.train_step`s, each on LONG_TAIL_CROPS
    `sample_khop_subgraphs` crops of the train half through
    `process_batch`, `dropout_rows` / `dropout_columns` on `x`, then
    `pad_nag` (prepare_batch's two halves around the dropout): K1, 7
    launches a step, finite losses, the parameters move; (c)
    LONG_TAIL_TTA_RUNS k-hop crops of the val half with
    `random_axis_flip`, each served through `eval_step` (K2, 7 launches a
    run) and summed by `tta_accumulate` with the radius-kNN fill of the
    nodes no run saw: seen and unseen shares above 0, every val node
    predicted, the seen sums equal to the runs' own, the same runs on the
    plain attention within the serving limits (f32 max abs, bf16 argmax
    agreement), `predict` equal to eval_step's argmax, and the
    `fused_rpe=False` route (K1's forward on the materialized RPE) within
    the f32 limit of the K2 route; (d) `confusion_matrix_update` on the
    card equal to `confusion_matrix_from_histogram` of one-hot labels;
    (e) K1 and K2 held on their widest launches of (b) and (c). Returns
    the launches of (b) and (c)."""
    import dataclasses
    import numpy as np
    import torch
    import torch.nn.functional as F
    from superpoint_transformer_torch.data.pad import pad_nag
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.experiment import (
        FLAGSHIP_CFG, build_model, build_task)
    from superpoint_transformer_torch.inference import (
        EVAL_BATCH_OVERRIDES, level1_node_id, to_nag_order)
    from superpoint_transformer_torch.metrics.semantic import (
        confusion_matrix_from_histogram, confusion_matrix_update)
    from superpoint_transformer_torch.models.output import tta_accumulate
    from superpoint_transformer_torch.models.semantic import (
        SemanticSegmentationModel)
    from superpoint_transformer_torch.nn.attention import (
        set_pallas_attention)
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.ops.native import radius_knn
    from superpoint_transformer_torch.transforms import runtime as T
    from superpoint_transformer_torch.transforms.prepare import (
        BatchConfig, prepare_batch, process_batch)

    num_classes = 13
    parts = {}

    def nodes(nag):
        return [nag[i].num_nodes for i in nag.levels]

    def widest(args):
        return args[1].shape[0] * args[1].shape[1]   # N * K of k gathered

    # (a) cleanup and split
    settle()
    t_part = time.perf_counter()
    nag = room.clone()
    print(f'long-tail: room nodes per level {nodes(nag)}')
    nag = T.inliers(nag, k_min=LONG_TAIL_INLIER_K, r_max=LONG_TAIL_INLIER_R,
                    recursive=True)
    print(f'long-tail: inliers(k_min={LONG_TAIL_INLIER_K}, '
          f'r_max={LONG_TAIL_INLIER_R}, recursive) -> {nodes(nag)}')
    nbr, _ = radius_knn(nag[0].pos, r=LONG_TAIL_OUTLIER_R, k=4,
                        exclude_self=True)
    nag[0]['neighbor_index'] = nbr
    nag = T.outliers(nag, k_min=1)
    nag[0].neighbor_index = None
    print(f'long-tail: outliers(k_min=1) over a {LONG_TAIL_OUTLIER_R} m '
          f'neighbor search -> {nodes(nag)}')
    check(all(n > 0 for n in nodes(nag)), 'long-tail: a level emptied by '
          'the cleanup')
    n1 = nag[1].num_nodes
    nag[1]['is_val'] = np.random.default_rng(SEED).random(n1) \
        < LONG_TAIL_VAL_SHARE
    val = T.select_by_key(nag, 'is_val', level=1)
    train = T.select_by_key(nag, 'is_val', level=1, negation=True)
    check('is_val' not in val[1].keys() and 'is_val' not in train[1].keys()
          and val[1].num_nodes + train[1].num_nodes == n1,
          'select_by_key: the halves do not split level 1, or kept the key')
    print(f'long-tail: select_by_key(is_val) -> val {nodes(val)}, train '
          f'{nodes(train)}')
    before = train[0].pos.copy()
    train = T.shuffle(train, np.random.default_rng(SEED), level=0)
    check(train[0].num_nodes == before.shape[0] and not np.array_equal(
        train[0].pos, before), 'shuffle: level 0 not permuted')
    y0 = [train[i].y.copy() for i in train.levels]
    train = T.select_columns(train, 'y', np.arange(num_classes + 1))
    check(all(np.array_equal(train[i].y, y) for i, y in zip(train.levels,
                                                            y0)),
          'select_columns: the label columns changed')
    print(f'long-tail: shuffle(level 0) and select_columns(y, {num_classes + 1}'
          f' columns) -> train {nodes(train)}')
    parts['cleanup and split'] = time.perf_counter() - t_part

    # (b) training on k-hop crops with feature dropout
    t_part = time.perf_counter()
    task = build_task(FLAGSHIP_CFG, num_graphs=LONG_TAIL_CROPS,
                      total_steps=LONG_TAIL_STEPS, device=dev)
    init_weights(task.model, torch.Generator().manual_seed(SEED))
    compute_dtype = task.model.net.compute_dtype
    cfg_train = dataclasses.replace(BatchConfig(), sample_graph_r=-1)
    rng = np.random.default_rng(SEED)
    batches, crop_nodes = [], []
    for _ in range(LONG_TAIL_STEPS):
        crops = [T.sample_khop_subgraphs(train, rng, **LONG_TAIL_KHOP)
                 for _ in range(LONG_TAIL_CROPS)]
        crop_nodes.append([c[1].num_nodes for c in crops])
        big = process_batch(crops, cfg_train, train=True, rng=rng)
        zero = (~big[0].x.any(1)).sum()
        big = T.dropout_rows(big, rng, key='x', p=LONG_TAIL_DROPOUT)
        big = T.dropout_columns(big, rng, key='x', p=LONG_TAIL_DROPOUT)
        dropped = (~big[0].x.any(1)).sum()
        check(zero < dropped < big[0].num_nodes,
              'dropout_rows / dropout_columns: no row of x zeroed, or all')
        host = pad_nag(big, num_classes=cfg_train.num_classes,
                       bucket_mode=cfg_train.bucket_mode)
        batches.append(from_numpy(host, dev, compute_dtype, train=True))
    host_s = time.perf_counter() - t_part
    before = [p.detach().clone() for p in task.model.parameters()]
    reset_counts()
    with plain_attention_calls() as plain, \
            widest_call('dense_attention_trainable', widest) as k1_args:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [task.train_step(b)['loss'] for b in batches]
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    train_launches = counts()
    losses = torch.stack(losses).float().cpu().tolist()
    moved = sum(not torch.equal(a, p.detach())
                for a, p in zip(before, task.model.parameters()))
    print(f'long-tail training: {LONG_TAIL_STEPS} steps of '
          f'{LONG_TAIL_CROPS} k-hop crops ({LONG_TAIL_KHOP}; level-1 nodes '
          f'per crop {crop_nodes}), batch levels {level_counts(batches[0])}; '
          f'losses {losses}; {moved} of {len(before)} parameter tensors '
          f'moved; host crops + process_batch + dropout + pad_nag '
          f'{host_s:.2f} s, steps {step_s * 1e3:.1f} ms; launches '
          f'{train_launches}, plain attention calls {plain["plain"]}')
    check(train_launches == {'K1': LONG_TAIL_STEPS * K1_LAUNCHES_PER_STEP,
                             'K2': 0, 'K3': 0} and plain['plain'] == 0,
          'long-tail training: not 7 K1 launches a step, or another kernel '
          'or the plain attention ran')
    check(all(np.isfinite(losses)) and moved > 0,
          'long-tail training: a loss is not finite, or no parameter moved')
    parts['training'] = time.perf_counter() - t_part

    # (c) multi-run TTA serving of the val half
    t_part = time.perf_counter()
    n_val = val[1].num_nodes
    val[1]['val_id'] = np.arange(n_val)
    cfg_eval = dataclasses.replace(BatchConfig(), **EVAL_BATCH_OVERRIDES)
    rng = np.random.default_rng(SEED + 1)
    hosts, run_ids = [], []
    for _ in range(LONG_TAIL_TTA_RUNS):
        crop = T.sample_khop_subgraphs(val, rng, **LONG_TAIL_TTA_KHOP)
        crop = T.random_axis_flip(crop, rng)
        hosts.append(prepare_batch([crop], cfg_eval, train=False))
        run_ids.append(crop[1].val_id)

    def serve(fn, cd):
        """Level-1 logits of each run in NAG order (host f32), with
        `fn(batch)` the level-1 logits."""
        out = []
        for host in hosts:
            b = from_numpy(host, dev, cd, train=True)
            n = b[1].num_nodes
            lg = fn(b)[:n].float().cpu().numpy()
            out.append(to_nag_order(lg, level1_node_id(b, n)))
        return out

    def accumulate(run_logits):
        return tta_accumulate(run_logits, run_ids, n_val, num_classes,
                              pos=val[1].pos)

    reset_counts()
    with plain_attention_calls() as plain, \
            widest_call('dense_attention_rpe', widest) as k2_args:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_logits = serve(lambda b: task.eval_step(b)['logits_level1'],
                           compute_dtype)
        acc = accumulate(run_logits)
        serve_s = time.perf_counter() - t0
    serve_launches = counts()
    seen = np.zeros(n_val, bool)
    for ids in run_ids:
        seen[ids] = True
    print(f'long-tail TTA: {LONG_TAIL_TTA_RUNS} runs of k-hop crops '
          f'({LONG_TAIL_TTA_KHOP}) of {n_val} val nodes, '
          f'{[len(i) for i in run_ids]} nodes a run; seen share '
          f'{seen.mean():.4f}, unseen share {1 - seen.mean():.4f}; served '
          f'and accumulated in {serve_s * 1e3:.1f} ms; launches '
          f'{serve_launches}, plain attention calls {plain["plain"]}')
    check(serve_launches == {'K1': 0, 'K2': LONG_TAIL_TTA_RUNS
                             * K2_LAUNCHES_PER_FORWARD, 'K3': 0}
          and plain['plain'] == 0,
          'long-tail TTA: not 7 K2 launches a run, or another kernel or '
          'the plain attention ran')
    check(0 < seen.mean() < 1, f'long-tail TTA: seen share {seen.mean()}: '
          'the runs must leave some val nodes seen and some unseen')
    sums = np.zeros_like(acc)
    for lg, ids in zip(run_logits, run_ids):
        sums[ids] += lg
    check(np.array_equal(acc[seen], sums[seen]),
          'tta_accumulate: the seen nodes are not the sums of their runs')
    check(np.isfinite(acc).all() and (np.abs(acc[~seen]).sum(1) > 0).all(),
          'tta_accumulate: a val node got no prediction')
    pred = acc.argmax(1)

    # the same runs on twins of the trained model: the plain attention in
    # f32 and bf16, the kernels in f32, the fused_rpe=False route in f32
    def twin(cd, plain_attention=False):
        m = SemanticSegmentationModel(build_model(
            FLAGSHIP_CFG, num_graphs=LONG_TAIL_CROPS, compute_dtype=cd,
            plain_attention=plain_attention, device=dev), num_classes,
            device=dev)
        m.load_state_dict(task.model.state_dict())
        return m.eval()

    def forward(model):
        def fn(b):
            with torch.inference_mode():
                return model(b)[0]
        return fn

    accs = {}
    for cd in (None, compute_dtype):
        for plain_attention in (False, True):
            if cd == compute_dtype and not plain_attention:
                continue
            accs[cd, plain_attention] = accumulate(serve(
                forward(twin(cd, plain_attention)), cd))
    accs[compute_dtype, False] = acc
    f32_err = np.abs(accs[None, False] - accs[None, True]).max()
    bf16_agree = (accs[compute_dtype, False].argmax(1)
                  == accs[compute_dtype, True].argmax(1)).mean()
    print(f'long-tail TTA accumulated logits, kernels vs plain attention: '
          f'f32 max abs {f32_err:.3e} (limit {F32_LOGIT_MAX_ABS}), '
          f'{compute_dtype} argmax agreement {bf16_agree:.5f} (limit '
          f'{BF16_ARGMAX_AGREEMENT})')
    check(f32_err <= F32_LOGIT_MAX_ABS
          and bf16_agree >= BF16_ARGMAX_AGREEMENT,
          'long-tail TTA: kernels vs plain attention beyond the serving '
          'limits')
    unfused = set_pallas_attention(twin(None), True, fused_rpe=False)
    reset_counts()
    acc_k1 = accumulate(serve(forward(unfused), None))
    k1_route = counts()
    k1_err = np.abs(acc_k1 - accs[None, False]).max()
    print(f'long-tail TTA, fused_rpe=False (materialized RPE, K1 forward) '
          f'vs K2 in f32: max abs {k1_err:.3e}; launches {k1_route}')
    check(k1_route == {'K1': LONG_TAIL_TTA_RUNS * K2_LAUNCHES_PER_FORWARD,
                       'K2': 0, 'K3': 0} and k1_err <= F32_LOGIT_MAX_ABS,
          'long-tail TTA: the fused_rpe=False route did not run K1 alone, '
          'or it is beyond the f32 limit of the K2 route')
    b = from_numpy(hosts[0], dev, compute_dtype, train=True)
    got = task.predict(b)
    want = task.eval_step(b)['logits_level1'].argmax(1)
    check(got.device == want.device and torch.equal(got, want),
          'predict: not the argmax of eval_step logits on the device')
    del unfused, b, got, want
    parts['TTA serving'] = time.perf_counter() - t_part

    # (d) the confusion update on the card
    t_part = time.perf_counter()
    labels = torch.from_numpy(val[1].y.argmax(1)).to(dev)
    pred_t = torch.from_numpy(pred).to(dev)
    for mask in (None, torch.from_numpy(seen).to(dev)):
        cm = confusion_matrix_update(pred_t, labels, num_classes,
                                     node_mask=mask)
        ref = confusion_matrix_from_histogram(
            pred_t, F.one_hot(labels, num_classes + 1), num_classes,
            node_mask=mask)
        valid = labels < num_classes
        if mask is not None:
            valid &= mask
        check(cm.device == labels.device and torch.equal(cm, ref)
              and cm.sum().item() == valid.sum().item(),
              'confusion_matrix_update: not the histogram update of one-hot '
              'labels on the card')
    print(f'long-tail confusion update on {card}: equal to the one-hot '
          f'histogram update with and without the seen mask; '
          f'{cm.sum().item()} labelled seen val nodes')
    parts['confusion update'] = time.perf_counter() - t_part

    # (e) the kernels on the arguments of their widest launches
    t_part = time.perf_counter()
    hold_on_path('K1', k1_args, path='long-tail training')
    hold_on_path('K2', k2_args, path='long-tail TTA serving')
    del k1_args, k2_args, task, batches
    parts['holds'] = time.perf_counter() - t_part
    print(f'long-tail phase on {card}, wall seconds by part: ' + ', '.join(
        f'{k} {v:.2f}' for k, v in parts.items()))
    settle()
    return {'long-tail': {'K1': train_launches['K1'],
                          'K2': serve_launches['K2']}}


def main():
    t_start = time.perf_counter()
    check(os.path.isdir(os.path.join(HERE, 'superpoint_transformer_torch')),
          'run from a checkout of the repository (the port package '
          'superpoint_transformer_torch/ is not beside this script)')
    sys.path.insert(0, HERE)
    import torch
    check(torch.cuda.is_available(), 'no CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    nvcc = subprocess.run(
        [os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                      'bin', 'nvcc'), '--version'],
        capture_output=True, text=True).stdout.strip().splitlines()
    print(f'card: {card}')
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{nvcc[-1] if nvcc else "nvcc not found"}')
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)

    from superpoint_transformer_torch.ops import cuda_build, native
    t0 = time.perf_counter()
    # the host path's C++ library builds beside the kernels
    with ThreadPoolExecutor(1) as pool:
        host_lib = pool.submit(native.build, force=True)
        reports = cuda_build.build(force=True)
        host_lib = host_lib.result()
    host_cmd = host_lib.with_name(f'{host_lib.name}.cmd').read_text()
    print(f'built {", ".join(cuda_build.KERNELS)} with '
          f'{cuda_build.NVCC_FLAGS}, in parallel, and {host_lib} from '
          f'native/*.cpp, in {time.perf_counter() - t0:.2f} s; host '
          f'library command: {host_cmd.strip()}')
    for name, report in reports.items():
        print(f'{name}:\n{report.strip()}')

    # GN launches by phase: every call of its forwards, checks and
    # timings (in this process: the parallel ranks' are not counted)
    gn_paths = {}

    def on_path(name, phase, *args, **kwargs):
        before = gn_launches()
        got = phase(*args, **kwargs)
        gn_paths[name] = gn_launches() - before
        return got

    results = {'K1': phase_k1(dev), 'K2': phase_k2(dev), 'K3': phase_k3(dev),
               'GN': on_path('kernel checks', phase_gn, dev)}
    launches = {'K2': on_path('serving', phase_serving, dev, card),
                'K1': on_path('training', phase_training, dev, card),
                'K3': phase_fused_rpe_training(dev)}
    host_path, host_nags = on_path('host', phase_host_path, dev, card)
    whole_cloud = {'K2': on_path('whole-cloud', phase_whole_cloud, dev,
                                 card, host_nags)}
    parallel = phase_parallel(dev, card, host_nags)
    variants, variants_timing = on_path('variants', phase_variants, dev,
                                        card, host_nags)
    rest_room = host_nags[0]
    del host_nags
    panoptic, pan_nags = on_path('panoptic', phase_panoptic, dev, card)
    t0 = time.perf_counter()
    rest = on_path('rest', phase_rest, dev, card, rest_room, pan_nags[0])
    print(f'rest phase (Delaunay serving, held-out, SuperCluster demo) in '
          f'{time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    long_tail = on_path('long-tail', phase_long_tail, dev, card, rest_room)
    print(f'long-tail phase (cleanup, k-hop training, TTA serving, '
          f'confusion update) in {time.perf_counter() - t0:.1f} s')
    del rest_room
    # the fit phase's rooms serve the EZ-SP and nano phases too
    rooms = tempfile.TemporaryDirectory()
    try:
        fit = on_path('fit-and-evaluate', phase_fit, dev, card, tmp=rooms)
        tune = on_path('tune', phase_tune, dev, card, rooms)
        ezsp = on_path('ezsp', phase_ezsp, dev, card, rooms)
        nano, nano_timing = on_path('nano', phase_nano, dev, card, rooms,
                                    pan_nags)
        datasets, spt3_timing = on_path('dales/kitti360/scannet',
                                        phase_datasets, dev, card, rooms)
    finally:
        rooms.cleanup()
    paths = {'serving/training/fused-RPE': launches, 'host': host_path,
             'whole-cloud': whole_cloud, **parallel, 'variants': variants,
             'panoptic': panoptic, **rest, **long_tail,
             'fit-and-evaluate': fit, 'tune': tune, 'ezsp': ezsp,
             'nano': nano, **datasets}
    print(f'launches by path: serving/training/fused-RPE {launches}, '
          f'host path {host_path}, whole-cloud serving {whole_cloud}')
    print(f'launches on the panoptic path: {panoptic}')
    print(f'launches on the Delaunay-serving, held-out and SuperCluster-demo '
          f'paths: {rest}')
    print(f'launches on the long-tail path: {long_tail}')
    print(f'launches on the data-parallel and graph-sharded paths (both '
          f'ranks): {parallel}')
    print(f'launches on the fit-and-evaluate path: {fit}')
    print(f'launches on the tune path: {tune}')
    print(f'launches on the EZ-SP path: {ezsp}')
    print(f'launches on the variants path: {variants}')
    print(f'launches on the nano path: {nano}')
    print(f'launches on the dales, kitti360 and scannet paths: {datasets}')
    for path, got in paths.items():
        for name, n in got.items():
            check(n > 0, f'the {path} path launched no {name} kernel')
    print(f'GN launches by phase: {gn_paths}')
    table = []
    for name, fn, line in (('K1', 'dense_attention', 74),
                           ('K2', 'dense_attention_rpe', 256),
                           ('K3', 'dense_attention_rpe_bwd', 487)):
        res = dict(results[name])
        bound_ms, bound_by = bound(name, **res.pop('shape'))
        table.append({
            'name': fn, 'route': 'cuda',
            'source': f'superpoint_transformer_torch/csrc/{fn}.cu',
            'replaces': 'superpoint_transformer_tpu/ops/pallas_attention.py'
                        f':{line}',
            'launches': sum(p.get(name, 0) for p in paths.values()),
            'launches_by_path': {k: p[name] for k, p in paths.items()
                                 if name in p},
            **res, 'bound_ms': bound_ms,
            'bound_by': bound_by, 'bound_share': bound_ms / res['ms']})
        for key, timing in (('nano', nano_timing), ('spt3', spt3_timing),
                            ('variants_per_node_query',
                             {'K1': variants_timing})):
            if name in timing:
                t = timing[name]
                table[-1][key] = dict(t, bound_share=t['bound_ms'] / t['ms'])
    gn = results['GN']
    table.append({
        'name': 'graph_norm', 'route': 'cuda',
        'source': 'superpoint_transformer_torch/csrc/graph_norm.cu',
        'replaces': None, 'launches': sum(gn_paths.values()),
        'launches_by_path': gn_paths, **gn['dales_level0'],
        's3dis_edges': gn['s3dis_edges']})
    print(f'all phases passed in {time.perf_counter() - t_start:.1f} s '
          '(builds included)')
    print(json.dumps({'kernels': table}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
