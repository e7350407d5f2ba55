#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure raises and the script exits nonzero):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. the three kernels built from ``rsgnet_tpu_torch/csrc`` at once (one
   ``nvcc`` each); the hand-written CUDA DARK kernel (ptxas registers and
   spills, shared memory and maps per SM
   of the blur-11 instantiations) against its plain PyTorch version on
   synthetic peaks at the serving shape (64, 17, 96, 72), blur 11 and 3,
   and at ViTPose-H's (64, 17, 64, 48), blur 11,
   plus edge cases (zero map, border peak, tie, N*K no block multiple) and
   the ten hard cases of ``rsgnet_tpu_torch/data/synthetic.py::HARD_DARK``
   (blur 1/5/31, maps smaller than the blur, a plateau tie over rows,
   peaks on the Newton border, an all-negative map, a blurred max off the
   raw peak, 64x64, N*K = 21), a 16-byte-misaligned batch and an odd width
   (the kernel's 4-byte path): peaks identical, maxvals and coords
   bit-equal;
34. (run after phase 2) the ConvBN epilogue kernel
   (``csrc/convbn_epilogue.cu``) against its plain version at W48 @
   384x288's plane sizes, 27,648 px (the stem at 192x144) down to 108 px
   (branch 4 at 12x9), bf16 and fp32, alone, with ReLU and with a residual
   and ReLU, and at ViTPose-H's decoder's channels-last (256, 32, 24) and
   (256, 64, 48) with ReLU: within 8 fp32 ulps of the terms' magnitudes,
   one launch a call, the vector width it picks logged (read from the
   kernel's name in a trace); then held and timed at the largest planes
   at a batch of 64, the stem's (64, 64, 192, 144) bf16 with ReLU and
   layer1's block tail (64, 256, 96, 72) with a residual and ReLU (CUDA
   events, L2 flushed, mean of 20), beside its byte bound at 3.35 TB/s and
   the plain chain's time (upcast, cuDNN's inference BatchNorm, add,
   ReLU);
3. a small-input reference: the tiny float32 RSGNet through the inference
   function on the card and on the CPU, same weights: preds atol 1e-2 px,
   maxvals atol 1e-4;
4. serving, the main path: ``rsgnet_tpu_torch.serve`` builds RSGNet-W48 @
   384x288 with DARK decode from ``experiments/coco/rsgnet/w48_384x288.yaml``
   at full width in bf16 with a seeded init, warms buckets 1/8/32/64 and
   serves HTTP on 127.0.0.1; concurrent /v1/predict and /v1/predict_image
   requests must come back finite and of the right shape, and the kernel's
   launch count must equal the engine's batch count for that window, the
   ConvBN epilogue's 293 a forward (586 a flip-test batch); the
   kernel's peaks and maxvals on one served batch's heatmaps must equal the
   plain version's, and the epilogue on each of that batch's 586
   BatchNorm inputs must lie within phase 34's bound of its plain version;
5. timings with CUDA events: the kernel and its plain version at buckets
   1, 8, 32 and 64 (L2 flushed before each launch), each beside its bound,
   the share of the bound it reaches and the time of a plain read of the
   same maps (``amax``), with the timer's floor (an op on one float); one
   inference call at bucket
   32, the request latencies of phase 4, and a torch.profiler breakdown
   (device busy share, device time by kernel class) of one inference call
   at buckets 32 and 1; the bucket-32 call's kernel count must not exceed
   the 5,205 the serving path had before the train slice;
6. the hand-written CUDA shear-warp kernel against its plain PyTorch
   version at the train shape (32, 640, 640, 3) uint8 -> 256x192, on
   matrices from the port's own augmentation draws, plus fixed rotations
   0/+-30/+-90/179, a flip and the transposed frame, a float32 source, an
   odd size, and the five hard matrices of
   ``rsgnet_tpu_torch/data/synthetic.py::HARD_WARPS`` (4x zoom-out at 45
   degrees, 0.05x zoom-in, a crop off a corner, a crop wholly outside the
   source, -135 degrees flipped) on uint8 and float32 sources: every case
   bit-equal, and max |diff| <= 1e-3 on the 0-255 scale;
7. a small-input reference for training: one tiny fp32 train step (SGD)
   on the card and on the CPU, same weights and draws: loss rtol 1e-4,
   each gradient tensor within 5e-2 of its max (3e-3 on average), updated
   params within lr times that;
8. training, the main path of the train slice: RSGNet-W32 @ 256x192 from
   ``experiments/coco/rsgnet/w32_256x192.yaml`` at full width and depth,
   bf16, Adam, seeded init, ``train_one_epoch`` over 8 steps of one
   repeated synthetic raw batch of 32 (640x640 uint8 canvases, boxes, 17
   joints): finite loss at every step, the loss falls, the shear-warp
   kernel ran once per step and the DARK kernel never;
9. timings of the train slice: the shear-warp kernel, its plain version
   and ``F.grid_sample`` (the gather warp, the nearest library call) at
   the train shape, L2 flushed, beside the kernel's bound; the wall time of
   a train step at batch 32; a torch.profiler breakdown of one step;
10. eval, the main path of the eval slice: ``write_synthetic_coco``
   writes 64 synthetic 640x480 images (86 person instances with GT boxes)
   to a temporary directory, and ``core/validate.py::validate`` scores
   RSGNet-W48 @ 384x288 with DARK from
   ``experiments/coco/rsgnet/w48_384x288.yaml`` at full width in bf16 with
   a seeded init, batch 24 (the YAML's), pipeline "device" (uint8 canvases
   to the card, separable crop, flip-test, DARK, canvas un-mapping,
   rescoring, device OKS-NMS, COCOeval): the AP table must be finite, the
   DARK kernel must run once per eval batch, the ConvBN epilogue 586 times
   (293 BatchNorms a forward, flip-test) and the shear warp never. Then
   ``TEST.WARP=shear``: the shear-warp kernel runs once per eval batch;
   with the same seeded weights in fp32 every prediction agrees with the
   separable crop's within 1 px (in bf16 the random-weight model is
   chaotic under the crops' ~3e-3 grey-level difference: logged). GT
   keypoints through ``evaluate`` with device NMS on the card give AP 1.0,
   and the device OKS-NMS keep sets (greedy and soft) on the card equal
   the host path's (the C++ library) on the run's own predictions, alone
   and with a jittered duplicate of every instance. Then, on one eval
   batch at the eval shapes: the shear-warp kernel at (24, 640, 640, 3)
   uint8 -> (24, 3, 384, 288) bit-equal to its plain version (and within
   1e-3 on 0-255 of the plain version on the CPU); the model inputs of the
   bf16 e2e function (crop and mirror) under TEST.WARP separable and shear
   equal to the crop called alone and within 2e-2 on 0-255 of the exact
   gather warp; DARK on that batch's flip-averaged heatmaps (24, 17, 96,
   72), blur 11, bit-equal to its plain version;
11. timings of the eval slice: instances/s of ``collect_predictions`` on a
   fresh dataset object (warm model and kernels, cold decode cache), the
   pieces of a batch's wall time alone (the loader's decode and collate,
   the pinned copy, the e2e call from host or card canvases), no
   synchronizing CUDA call in the e2e call (``torch.cuda.
   set_sync_debug_mode("error")``), a
   torch.profiler breakdown of one eval batch, and the separable crop at
   (24, 640, 640, 3) uint8 -> (24, 3, 384, 288) beside ``F.grid_sample``
   (bilinear, zeros) and the shear-warp kernel on the same crops, L2
   flushed;
13. training end to end, the main path of the fit slice:
   ``write_synthetic_coco`` writes 128 synthetic images (171 person
   instances with GT boxes, the train and the val set) to a temporary
   directory; the shear-warp kernel on fit's first batch and its
   augmentation matrices is held bit-equal to its plain version; ``python
   -m rsgnet_tpu_torch.train`` on the W32 YAML for 2 epochs runs in a
   subprocess (exit 0, a finite loss and AP every epoch,
   ``checkpoint.pt`` and ``model_best.pt`` written); then, in process,
   under deterministic cuDNN (``configure_cudnn`` with the CLIs' keys
   ``CUDNN.DETERMINISTIC True CUDNN.BENCHMARK False``; ``fit`` itself sets
   no cuDNN state), ``fit`` (a) for 2 epochs, (b) for 1 epoch and again with
   auto-resume (asynchronous checkpoints), (c) stopped by a
   ``PreemptionGuard`` at step 2 of epoch 1 and resumed: each run's
   shear-warp launches equal its train steps and DARK's are 0 (W32
   validates with the quarter offset), and (a), (b), (c) end bitwise equal
   (else within twice the spread of two uninterrupted runs, which is then
   printed, with the ops torch names non-deterministic); the
   checkpoint written by ``save_checkpoint`` and by ``AsyncCheckpointer``
   loads back bitwise; timings: wall per train step inside ``fit`` in
   torch's default mode (read from the CLI's epoch lines) against phase
   9's bare step, and under deterministic cuDNN (run (a)); validation
   seconds per epoch,
   ``save_checkpoint`` seconds, the train loop's stall under
   ASYNC_CHECKPOINT, checkpoint bytes;
14. the eval CLI: ``rsgnet_tpu_torch.test.main`` in process on phase 13's
   ``model_best.pt`` at W32 (finite AP table, no kernel launch) and on
   W48 @ 384x288 DARK with the seeded init (DARK once per eval batch,
   held bit-equal to its plain version on a batch of the same set); the
   server's loader takes the same ``model_best.pt``;
15. SimpleBaseline ResNet-152 @ 384x288, the main path of the
   pose_resnet slice, from
   ``experiments/coco/resnet/res152_384x288_d256x3_adam_lr1e-3.yaml`` at
   full depth (three 256-wide kernel-4 deconvs, bf16 convs, fp32 BN, Adam,
   batch 32) with a seeded init, on phase 13's 128 synthetic images: the
   shear-warp kernel on fit's first batch and its augmentation matrices,
   (32, 640, 640, 3) uint8 -> (32, 3, 384, 288), bit-equal to its plain
   version and timed (L2 flushed) beside its plain version,
   ``F.grid_sample`` and its bound; ``python -m rsgnet_tpu_torch.train``
   for one epoch in a subprocess (exit 0, finite loss and AP,
   ``checkpoint.pt`` and ``model_best.pt``; the shear warp launched once
   per step, DARK never, counted in that process); the bare train step's
   wall time, a torch.profiler breakdown and peak device memory; the test
   CLI on its ``model_best.pt`` (finite table); ``TEST.FOLD_BN`` on that
   model in fp32: the flag's run equals the weights folded by hand, the
   model's weights come back bitwise, and every pred lies within the JAX
   package's 5e-3 px of the unfolded run unless it is a quarter-offset
   decode tie within the heatmaps' fold rounding (itself under 1e-4 of
   their scale);
16. CrowdPose RSGNet-W48 @ 384x288
   (``experiments/crowdpose/rsgnet/w48_384x288.yaml``, full width, bf16,
   batch 16) through ``validate`` on 48 synthetic CrowdPose images
   (``write_synthetic_crowdpose``): the 9-key table finite; GT keypoints
   through ``evaluate`` with device NMS give AP 1.0 and AP (easy / medium /
   hard) 1.0;
17. MPII HRNet-W32 @ 256x256 (``experiments/mpii/hrnet/
   w32_256x256_adam_lr1e-3.yaml``, full width) through the test CLI on 32
   synthetic MPII images (``write_synthetic_mpii``): the PCKh table
   finite, ``pred.mat`` written; GT joints through ``evaluate`` give Mean
   100;
18. ``python -m rsgnet_tpu_torch.infer --cfg <the ResNet-152 YAML> --ckpt
   <phase 15's model_best.pt> --demo --out <png>``: exit 0, 2 boxes x 17
   finite keypoints, the overlay written;
19. data parallelism, the main path of the DDP slice: ``fit`` of
   RSGNet-W32 @ 256x192 (the W32 YAML, full width and depth) on two ranks,
   processes of this script (``--dp-worker``) with torchrun's environment,
   sharing the card over gloo (``initialize_distributed(backend="gloo")``:
   NCCL refuses two ranks on one device; gloo stages CUDA tensors through
   the host), batch 32 a rank, global 64, over phase 13's set for one
   epoch, validating through ``validate_distributed``, deterministic
   cuDNN: gloo's all_reduce and broadcast of CUDA tensors (fp32, fp64)
   first; the two ranks' weights, BatchNorm statistics, Adam moments and
   per-step metrics bitwise equal; the shear warp once per step on each
   rank, DARK never; rank 0 alone writing checkpoints; a stop before step
   1 of an fp32 run on both; against one process at batch 64 from the same
   weights and draws: each step's loss (the first within 1e-3, all within
   5e-2), the weights (within 3 x lr a step), BatchNorm statistics and
   Adam moments (printed); the step wall on each rank beside the gradient
   all-reduce (~114 MB fp32 through the host) and the BatchNorm
   all-reduces timed alone;
20. ``python -m rsgnet_tpu_torch.test`` on W48 @ 384x288 DARK (seeded
   init) on two such ranks over phase 13's set: DARK once per eval batch
   on each rank, the two ranks' AP tables equal, the gathered predictions
   equal one process's (in this script) within the eval tolerances;
21. ``TRAIN.REMAT`` on the W48 @ 384x288 train step at batch 32,
   deterministic cuDNN: loss, gradients and running statistics with and
   without it; peak device memory and step wall of each;
22. ``MODEL.FUSE_MERGED``: kernels per W48 bucket-32 inference call and per
   W32 train step, merged and not; fp32 W48 heatmaps and an fp32 W32
   train forward and backward, merged and not, each against the fp64
   model (the merged path as accurate as the unmerged one);
23. ``MODEL.S2D_STEM`` on the W48 and ResNet-152 stems at (32, 3, 384,
   288): the rearranged conv against the plain and the exact conv, timed,
   and the W48 model's fp32 heatmaps against the fp64 model's;
25. the process loader: ``fit`` of W32 for one epoch over phase 13's set
   with TRAIN.LOADER "threads" and "grain" (2 spawned worker processes),
   deterministic cuDNN: bitwise equal, the shear warp once a step, DARK
   never; ``collect_predictions`` with TEST.LOADER "grain" equal to
   "threads", through one loader for two passes as ``fit``'s epochs
   validate; both loaders' instances/s, through ``collect_predictions``
   and alone (a first pass and a second with the workers up);
26. the trace windows: the threaded run above with ``profile_steps=3``
   and ``python -m rsgnet_tpu_torch.test --profile 2`` on W48 DARK write
   Chrome traces whose CUDA kernels include ``shear_warp_kernel`` and
   ``dark_decode_kernel`` respectively;
27. the JPEG decoder the dataset uses on this machine (native libjpeg,
   else cv2, else PIL);
24. serving from an exported artifact, the main path of the export slice:
   ``python -m rsgnet_tpu_torch.export --raw-uint8`` on the W48 YAML (bf16,
   DARK, seeded init) in a subprocess writes a ``.pt2`` with a symbolic
   batch; ``serve --artifact`` loads it, warms buckets 1/8/32/64 and
   answers concurrent /v1/predict requests over HTTP (finite, right
   shapes), DARK launched once per engine batch, the ConvBN epilogue 586
   times a batch and the shear warp never;
   in this process the artifact at buckets 2 and 32 launches DARK once per
   call, equals the unexported ``DevicePipeline`` bitwise and
   ``make_inference_fn`` on the same weights per ``preds_agree``
   (bitwise, else within ``assert_preds_close``'s tolerances, the gaps
   printed); its bucket-32 call time beside the eager call's; then the
   end-to-end artifact (``export_e2e``, TEST.WARP=shear, bf16 as the
   YAML) at (2|8, 640, 640, 3) uint8: the shear warp and DARK once each
   per call, bitwise the unexported pipeline, ``make_e2e_fn`` per
   ``preds_agree``;
28. the bench, a child process: ``python -m rsgnet_tpu_torch.bench`` at
   its defaults (headline, e2e, full, res50, train at full width, batches
   128 and 192): every stdout line is JSON, each of the five has a value
   and names the card and ``torch``'s device name, the headline is last,
   and the train line counts a shear-warp launch in each of its 1 warm +
   10 timed steps and no DARK launch; then in process, at the train
   section's shape (its first batch and draw: (128, 640, 640, 3) uint8 ->
   (128, 3, 256, 192)), the shear-warp kernel bit-equal to its plain
   version, its times, bound and ``F.grid_sample``'s time, and a
   torch.profiler trace of one of the section's steps (busy share); and
   the ``full`` section's rescoring and OKS-NMS at (8, 16, 17, 3) on the
   card under ``torch.cuda.set_sync_debug_mode("error")`` (no
   synchronizing call), keep sets equal to the CPU's;
29. ``python -m rsgnet_tpu_torch.tools.profile_serving --config w32
   --batches 1 8 32 --e2e``: every row finite, p50 <= p95, the card named;
30. ``python -m rsgnet_tpu_torch.tools.profile_batcher --clients 1,16,64
   --seconds 2``: goodput > 0 and mean fill >= 1 at each level, no expired
   request at 1 client; phases 28-30 print their seconds;
31. the path dissections, seven children started at once at reduced
   batches and iterations (``PROFILERS``): ``profile_memory --config w48
   w32``, ``profile_roofline``, ``profile_config_sweep --config w48``,
   ``profile_paths``, ``profile_train_dissect``, ``profile_bwd`` and
   ``profile_update``. Each exits 0, and every row names the card and
   torch's device name, has no failure and only finite numbers. The
   memory rows are measured (peak above weights + batch, at most the
   card's memory) or out of memory; every roofline rate is at most 105%
   of its spec-sheet peak; the DARK kernel ran once per W48 DARK e2e call
   (``profile_memory``, ``profile_config_sweep``), the shear-warp kernel
   once per train step and per augmentation or whole-warp call, and
   neither anywhere else. The phase prints its seconds (budget 150 s);
32. the A/B scripts, eight children started at reduced sizes together
   with phase 31's seven (``AB_SCRIPTS``): ``profile_s2d``, ``profile_fuse_merged``,
   ``profile_fold_bn``, ``profile_eval_warp``, ``profile_shear``,
   ``profile_nms``, ``profile_loader`` and ``profile_shear_ab_seeds``.
   Each exits 0, and every row names the card and torch's device name,
   has no failure and only finite numbers (the crop differences
   included); every NMS row's keep sets agree; the shear-warp kernel ran
   once per call or step of each row that runs it (the S2D and
   FUSE_MERGED train steps, the "shear" and "pallas" rows, the
   shear-trained steps of ``profile_shear_ab_seeds``), and neither kernel
   anywhere else. The phase prints its seconds (budget 150 s);
33. data parallelism over NCCL, a card for each rank, on every card up to
   four where the machine has two or more (on one card it prints that it
   needs two and runs nothing; nothing runs gloo in NCCL's place). Its
   first line names the backend, NCCL's version, each rank's card and the
   link topology (``nvidia-smi topo -m``). 33a: ``fit`` of RSGNet-W32 @
   256x192 as phase 19, on ranks of this script (``--dp-worker``) with
   ``backend="nccl"``, batch 32 a rank, over a synthetic set of 256
   images: the ranks bitwise equal, each on its card, the shear warp once
   per step on each and DARK never, only rank 0 writing checkpoints, a
   stop asked for on the last rank alone stopping all at the same step,
   and against one process at the global batch phase 19's tolerances;
   each rank's steady step wall and the images/s of all against one
   process at batch 32; rank 0's profile of one step (the NCCL kernels'
   count and time, the gradient, BatchNorm and metrics all-reduces apart)
   and the step's collectives and elements against the parameter count.
   33b: ``python -m torch.distributed.run --nproc_per_node=<cards>`` of
   the test CLI on W48 DARK (held as phase 20, the AP tables equal to one
   process's) and of the train CLI for one epoch (exit 0, the shear warp
   once per step on each rank), whose checkpoint the train CLI resumes in
   one process. The phase prints its seconds (budget 240 s);
12. a ``{"kernels": [...]}`` JSON line (each kernel with its launches on
   the eval path, ``eval_launches``: DARK's in the main path's
   ``validate`` run, the shear warp's in the TEST.WARP=shear run; in
   phase 13's uninterrupted ``fit``, ``fit_launches``; in phase 14's
   test CLI runs, ``test_cli_launches``; in phase 15's ResNet-152 train
   CLI run, ``resnet_fit_launches``; the shear warp's times at the
   ResNet-152 shape under ``resnet``; per rank in phase 19's two-rank
   ``fit``, ``dp_fit_launches_per_rank``, and in phase 20's two-rank test
   CLI, ``dp_test_cli_launches_per_rank``; in phase 24,
   ``export_launches``: over the artifact server's requests ("serve") and
   the end-to-end artifact's calls ("e2e"), and DARK's
   ``export_call_ms``; in phase 25's grain ``fit``,
   ``grain_fit_launches``; in phase 28's bench train section,
   ``bench_train_launches`` (read from its line), and the shear warp's
   times and bound at that section's shape under ``bench_train``; in
   phases 31-32, ``profilers_launches``: each tool's launches over its
   rows; per rank in phase 33, ``nccl_fit_launches_per_rank`` and
   ``nccl_test_cli_launches_per_rank``, and the shear warp's in its train
   CLI, ``nccl_train_cli_launches_per_rank``, all null on one card; the
   ConvBN epilogue with its launches in phase 4's serving, phase 10's
   ``validate`` and phase 24's artifacts, each held to 293 a W48 forward,
   and phase 34's times),
   the card line, and last the
   ``{"ok": true, "device": {...}}`` line.

Without a CUDA card, or outside a checkout, it exits nonzero and prints no
result. ``--dp-worker MODE ARGS`` is how phases 19-20 and 33a start a
rank, ``--cli-rank OUT_DIR MODULE ARGV`` runs a CLI counting the kernels'
launches (phase 15, and a rank of phase 33b under
``torch.distributed.run``).

    python3 chip_smoke.py --nccl     # on a machine with 2-4 cards

runs phases 1-2, the shear-warp kernel against its plain version at the
train shape, both kernels' times, then phase 33 alone, and prints the
result lines with phase 33's launches; with one card it exits nonzero.
"""
import contextlib
import copy
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
W48_YAML = os.path.join(ROOT, "experiments", "coco", "rsgnet",
                        "w48_384x288.yaml")
W32_YAML = os.path.join(ROOT, "experiments", "coco", "rsgnet",
                        "w32_256x192.yaml")
RES152_YAML = os.path.join(ROOT, "experiments", "coco", "resnet",
                           "res152_384x288_d256x3_adam_lr1e-3.yaml")
CROWD_YAML = os.path.join(ROOT, "experiments", "crowdpose", "rsgnet",
                          "w48_384x288.yaml")
MPII_YAML = os.path.join(ROOT, "experiments", "mpii", "hrnet",
                         "w32_256x256_adam_lr1e-3.yaml")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
BUCKETS = "1,8,32,64"
SERVE_KERNELS_BEFORE = 5205      # bucket-32 inference call, before this slice
TRAIN_STEPS = 8
CANVAS = 640                     # square uint8 source canvas of the train set
EVAL_IMAGES = 64                 # synthetic COCO images of the eval phases
FIT_IMAGES = 128                 # synthetic COCO images of phases 13-14
FIT_EPOCHS = 2
CROWD_IMAGES = 48                # synthetic CrowdPose images of phase 16
MPII_IMAGES = 32                 # synthetic MPII images (2 people each)
DP_WORLD = 2                     # ranks of phases 19-20, sharing card 0
DP_EPOCHS = 1                    # epochs of phase 19's two-rank fit
# phase 19: two ranks vs one process after one fp32 step, relative gaps
# over all tensors, ~7-9x the H100's readings (exp_avg 6.9e-3, exp_avg_sq
# 3.5e-3, the statistics' moves 5.4e-7); a gradient summed over the ranks
# instead of averaged parts exp_avg by 1.0
DP_MOMENT_TOL = 5e-2             # exp_avg, exp_avg_sq
DP_STATS_TOL = 5e-6              # the BatchNorm statistics' moves
NCCL_MAX_WORLD = 4               # phase 33's ranks, a card each, at most
NCCL_IMAGES = 256                # synthetic COCO images of phase 33
NCCL_EPOCHS = 2                  # epochs of phase 33a's fit
NCCL_STEADY_STEPS = 6            # steps a rank's step wall is the mean of
NCCL_TIMEOUT_S = 120             # a collective waiting longer fails a rank
NCCL_CLI_TIMEOUT_S = 300         # one launch of phase 33's ranks
NCCL_BUDGET_S = 240
# the CLI overrides of the bitwise phases' mode (``_deterministic``)
DETERMINISTIC_OPTS = ["CUDNN.DETERMINISTIC", "True", "CUDNN.BENCHMARK",
                      "False"]


_T0 = time.perf_counter()


def log(msg):
    """A line of the run's log, with the seconds since the script began."""
    print(f"[chip_smoke +{time.perf_counter() - _T0:.0f}s] {msg}", flush=True)


def synthetic_heatmaps(n, k, h, w, seed, sigma=3.0):
    """(N, K, H, W) Gaussian peaks at random sub-pixel spots + noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx = rng.uniform(2, w - 3, (n, k, 1, 1)).astype(np.float32)
    cy = rng.uniform(2, h - 3, (n, k, 1, 1)).astype(np.float32)
    hm = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sigma ** 2))
    hm += rng.uniform(0, 0.01, hm.shape)
    return hm.astype(np.float32)


def kernel_vs_plain(torch, dark_decode, reference, hm, blur):
    """Kernel vs plain version on the card: peaks, maxvals and coords
    bit-equal. Returns the max coord diff (0)."""
    c_k, v_k, p_k = dark_decode(hm, blur, return_peaks=True)
    c_p, v_p = reference(hm, blur)
    p_p = torch.argmax(hm.reshape(hm.shape[0], hm.shape[1], -1), dim=2)
    torch.cuda.synchronize()
    if not torch.equal(p_k.long(), p_p):
        raise AssertionError(f"kernel peaks differ from the plain version's "
                             f"in {int((p_k.long() != p_p).sum())} maps")
    if not torch.equal(v_k, v_p):
        raise AssertionError("kernel maxvals are not bit-equal to the plain "
                             "version's")
    if not torch.equal(c_k, c_p):
        raise AssertionError(f"kernel coords are not bit-equal to the plain "
                             f"version's: max |diff| "
                             f"{float((c_k - c_p).abs().max()):.3e}")
    return float((c_k - c_p).abs().max())


def dark_bound_ms(n, k, h, w, blur):
    """Least time for the DARK decode of (n, k, h, w) maps on an H100: each
    heatmap read once, coords and maxvals written once, against the blur's
    fp32 multiply-adds (2 passes x blur taps x 2 ops per pixel)."""
    nbytes = n * k * h * w * 4 + n * k * 3 * 4
    flops = n * k * h * w * 2 * blur * 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def forward_flops(torch, model, x):
    """FLOPs (2 per multiply-add) of the convs and linears in one forward
    of ``x``, counted from their weight and output shapes."""
    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.ConvTranspose2d):
            # every input element meets Cout/groups * kh * kw weights
            total[0] += 2 * inp[0].numel() * mod.weight[0].numel()
            return
        per_out = mod.weight[0].numel()          # Cin/groups * kh * kw, or in
        total[0] += 2 * out.numel() * per_out

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                               torch.nn.Linear))]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for hk in hooks:
            hk.remove()
    return total[0]


def _kernel_class(name):
    n = name.lower()
    if "nccl" in n:
        return "nccl"
    if "dark_decode" in n:
        return "dark_decode"
    if "shear_warp" in n:
        return "shear_warp"
    if "multi_tensor" in n:
        return "optimizer"
    if "reduce" in n:
        return "reduction"
    if "nchwtonhwc" in n or "nhwctonchw" in n:
        return "layout"
    if any(s in n for s in ("bn_fw", "batch_norm", "batchnorm")):
        return "batch_norm"
    if any(s in n for s in ("copy_kernel", "direct_copy")):
        return "dtype cast/copy"
    if any(s in n for s in ("conv", "xmma", "gemm", "cudnn", "cutlass",
                            "sm90", "implicit")):
        return "conv/gemm"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise"
    return "other"


def profile_device(torch, fn, card, flops, label):
    """Device-time breakdown of one call of ``fn()`` with torch.profiler
    (after one warm call): device busy share of the call's wall time (union
    of kernel intervals), device time by kernel class, the rate the
    conv/gemm kernels reach on ``flops``, and the top kernels by name.
    Returns the number of kernels the call launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        log(f"[{card}] profile: no device events (device time not measured)")
        return 0
    busy = _busy_us(kernels)
    by_class, by_name = {}, {}
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        c = _kernel_class(e.name)
        by_class[c] = by_class.get(c, 0.0) + d
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + d, n + 1)
    total = sum(by_class.values())
    log(f"[{card}] profile of {label}: wall {wall_us / 1e3:.2f} ms, "
        f"{len(kernels)} kernels, device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}% of wall), kernel time "
        f"{total / 1e3:.2f} ms: " + ", ".join(
            f"{c} {v / 1e3:.2f} ms ({100 * v / total:.1f}%)"
            for c, v in sorted(by_class.items(), key=lambda x: -x[1])))
    if by_class.get("conv/gemm"):
        log(f"[{card}]   conv/gemm kernels: {flops / 1e12:.3f} TFLOP in "
            f"{by_class['conv/gemm'] / 1e3:.2f} ms = "
            f"{flops / by_class['conv/gemm'] / 1e6:.1f} TFLOP/s")
    for name, (t, n) in sorted(by_name.items(), key=lambda x: -x[1][0])[:8]:
        log(f"[{card}]   {t / 1e3:8.3f} ms  x{n:<4d} {name[:110]}")
    return len(kernels)


def shear_matrices(torch, n, size, cfg, seed):
    """(n + 8, 2, 3) src->dst matrices: the port's augmentation geometry on
    a seeded raw batch of n, then rotations 0/+-30/+-90/179 about the
    canvas center and two flip-composed ones (30 and 90 degrees)."""
    from rsgnet_tpu_torch.data.augment import augment_geometry, draw_augment
    from rsgnet_tpu_torch.data.skeletons import get_spec
    from rsgnet_tpu_torch.data.synthetic import synthetic_train_batch
    from rsgnet_tpu_torch.ops.affine import get_affine_transform_t
    b = synthetic_train_batch(n, size, seed=seed)
    trans = augment_geometry(
        draw_augment(torch.Generator().manual_seed(seed), n),
        torch.from_numpy(b["joints"]), torch.from_numpy(b["joints_vis"]),
        torch.from_numpy(b["center"]), torch.from_numpy(b["scale"]),
        float(size), cfg, get_spec("coco"))[0]
    rots = torch.tensor([0.0, 30.0, -30.0, 90.0, -90.0, 179.0])
    fixed = get_affine_transform_t(
        torch.full((6, 2), size / 2.0), torch.full((6, 2), size / 300.0),
        rots, tuple(cfg.MODEL.IMAGE_SIZE))
    f = fixed[[1, 3]]
    flipped = torch.stack([-f[:, :, 0], f[:, :, 1],
                           f[:, :, 0] * (size - 1) + f[:, :, 2]], dim=-1)
    return torch.cat([trans, fixed, flipped])


def shear_vs_plain(torch, shear_warp, images, pos):
    """Kernel vs plain shear warp on the card: (max |diff|, bit-equal)."""
    from rsgnet_tpu_torch.ops.shear_warp import shear_warp_reference
    got = shear_warp(images, pos)
    ref = shear_warp_reference(images, pos)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"shear warp output {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)} or non-finite")
    return float((got - ref).abs().max()), bool(torch.equal(got, ref))


def shear_bound_ms(torch, images, pos):
    """Least time for the shear warp of ``images`` at ``pos`` on an H100:
    the fp32 output written once plus the source pixels it depends on read
    once (every pixel a nonzero-weight tap of either pass reaches, counted
    on this run's matrices), against ~15 fp32 operations per element of
    each pass. Returns (ms, "bytes" | "operations", bytes)."""
    n, size, _, ch = images.shape
    out_w, out_h = pos.p_a.shape[1], pos.p_b.shape[1]

    def split(p, s):             # (.., a, b) bases and weights per tap
        pf, sf = torch.floor(p), torch.floor(s)
        phi = (p - pf) + (s - sf)
        w0 = torch.clamp_min(1.0 - phi, 0.0)
        w2 = torch.clamp_min(phi - 1.0, 0.0)
        return (pf + sf).long(), (w0, 1.0 - w0 - w2, w2)

    # pass B: rows r(y, x) = base_b + j with weight wb_j
    base_b, wb = split(pos.p_b[:, :, None], pos.s_b[:, None, :])  # (N,oh,ow)
    seen = torch.zeros(n, size * size, dtype=torch.bool, device=images.device)
    bidx = torch.arange(n, device=images.device)[:, None, None].expand(
        n, out_h, out_w)
    for j in range(3):
        r = base_b + j
        ok_b = (wb[j] > 0) & (r >= 0) & (r < size)
        rc = r.clamp(0, size - 1)
        # pass A at row r, column x: cols base_a + i with weight wa_i
        p_a = pos.p_a[:, None, :].expand(n, out_h, out_w)
        s_a = torch.gather(pos.s_a, 1, rc.reshape(n, -1)).reshape(rc.shape)
        base_a, wa = split(p_a, s_a)
        for i in range(3):
            c = base_a + i
            ok = ok_b & (wa[i] > 0) & (c >= 0) & (c < size)
            flat = rc * size + c.clamp(0, size - 1)
            seen[bidx[ok], flat[ok]] = True
    src_bytes = int(seen.sum()) * ch * images.element_size()
    nbytes = src_bytes + n * ch * out_h * out_w * 4
    ops = 15 * (n * size * out_w * ch + n * ch * out_h * out_w)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, src_bytes)


def grid_sample_ms(torch, canvases, trans, out_size):
    """The nearest library call to the shear warp: ``F.grid_sample``
    (bilinear, zeros), the gather warp, on a float32 NCHW copy of the
    (N, S, S, C) canvases with the grid of the (N, 2, 3) matrices, both
    made outside the timed region. Returns its cold time in ms."""
    from rsgnet_tpu_torch.ops.warp import invert_affine
    from rsgnet_tpu_torch.tools._profiling import cuda_event_ms
    side, dev = canvases.shape[1], canvases.device
    inv = invert_affine(trans)
    gx = torch.arange(out_size[0], dtype=torch.float32, device=dev)
    gy = torch.arange(out_size[1], dtype=torch.float32, device=dev)[:, None]
    u = inv[:, 0, 0, None, None] * gx + inv[:, 0, 1, None, None] * gy \
        + inv[:, 0, 2, None, None]
    v = inv[:, 1, 0, None, None] * gx + inv[:, 1, 1, None, None] * gy \
        + inv[:, 1, 2, None, None]
    grid = torch.stack([2 * u / (side - 1) - 1, 2 * v / (side - 1) - 1],
                       dim=-1)
    src_f = canvases.permute(0, 3, 1, 2).float().contiguous()
    return cuda_event_ms(lambda: torch.nn.functional.grid_sample(
        src_f, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True))


def nms_groups(preds, boxes, ids, in_vis_thre):
    """Per-image (keypoints (m, K, 3), rescored scores (m,), areas (m,))
    lists, rescored as ``COCODataset.evaluate`` does."""
    kp_l, sc_l, ar_l = [], [], []
    for img in np.unique(ids):
        sel = np.where(ids == img)[0]
        kp = preds[sel]
        vis = kp[:, :, 2] > in_vis_thre
        kscore = np.where(vis.any(1), (kp[:, :, 2] * vis).sum(1)
                          / np.maximum(vis.sum(1), 1), 0.0)
        kp_l.append(kp)
        sc_l.append((kscore * boxes[sel, 5]).astype(np.float32))
        ar_l.append(boxes[sel, 4])
    return kp_l, sc_l, ar_l


def nms_keep_sets_agree(groups, sigmas, thresh):
    """Device OKS-NMS on the card vs the host C++ library, greedy and soft:
    raises unless every image's keep set is identical. Returns the counts
    kept (greedy) and of instances."""
    from rsgnet_tpu_torch.ops.nms import batched_oks_nms, batched_soft_oks_nms
    from rsgnet_tpu_torch.ops.nms_native import oks_nms_cpp, soft_oks_nms_cpp
    kp_l, sc_l, ar_l = groups
    greedy = batched_oks_nms(kp_l, sc_l, ar_l, sigmas, thresh, device="cuda")
    soft = batched_soft_oks_nms(kp_l, sc_l, ar_l, sigmas, thresh,
                                device="cuda")
    for i, (kp, sc, ar) in enumerate(zip(kp_l, sc_l, ar_l)):
        db = [{"keypoints": k, "score": float(c), "area": float(a)}
              for k, c, a in zip(kp, sc, ar)]
        host = sorted(int(j) for j in oks_nms_cpp(db, thresh, sigmas))
        host_soft = sorted(int(j) for j in
                           soft_oks_nms_cpp(db, thresh, sigmas)[0])
        if greedy[i].tolist() != host or soft[i][0].tolist() != host_soft:
            raise AssertionError(f"image {i}: device keep {greedy[i]} / "
                                 f"{soft[i][0]} vs host {host} / "
                                 f"{host_soft}")
    return sum(len(g) for g in greedy), sum(len(k) for k in kp_l)


def eval_holds(torch, cfg, model, ds, batch, dev):
    """The eval path's crop and kernels held at the shapes it gives them,
    on one eval batch ``batch`` (a collated dict of canvases and rot-0
    boxes) of ``ds``: the shear-warp kernel bit-equal to its plain version,
    the bf16 e2e function's model inputs under TEST.WARP separable and
    shear, and DARK on its flip-averaged heatmaps bit-equal to the plain
    version. Raises on any disagreement; returns the batch's canvases on
    the card, its (N, 2, 3) matrices and shear positions."""
    from rsgnet_tpu_torch.core.inference import (heatmaps_with_flip_test,
                                                 make_e2e_fn)
    from rsgnet_tpu_torch.data.skeletons import get_spec
    from rsgnet_tpu_torch.ops.affine import get_affine_transform_t
    from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode
    from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp
    from rsgnet_tpu_torch.ops.decode import dark_decode_reference
    from rsgnet_tpu_torch.ops.shear_warp import (shear_prepare,
                                                 shear_warp_reference)
    from rsgnet_tpu_torch.ops.warp import IMAGENET_STD, crop_and_normalize
    out_size = tuple(cfg.MODEL.IMAGE_SIZE)
    bs = len(batch["image"])
    canvases = torch.from_numpy(batch["image"]).to(dev)
    side = canvases.shape[1]
    # solved on the card, where the e2e function solves them
    trans = get_affine_transform_t(
        torch.from_numpy(batch["center"]).to(dev),
        torch.from_numpy(batch["scale"]).to(dev),
        torch.zeros(bs, device=dev), out_size)
    pos = shear_prepare(trans, side, out_size)
    held_err, held_eq = shear_vs_plain(torch, shear_warp, canvases, pos)
    cpu_err = float((shear_warp(canvases, pos).cpu() - shear_warp_reference(
        canvases.cpu(), type(pos)(*(t.cpu() for t in pos)))).abs().max())
    log(f"shear_warp kernel vs plain, eval shape ({bs}, {side}, {side}, 3) "
        f"uint8 -> ({bs}, 3, {out_size[1]}, {out_size[0]}), rot-0 boxes: "
        f"max |diff| {held_err:.3e}, bit-equal {held_eq}; vs the plain "
        f"version on the CPU (same positions) max |diff| {cpu_err:.3e} on "
        f"0-255")
    if not held_eq or cpu_err > 1e-3:
        raise AssertionError(f"shear_warp at the eval shape: kernel vs "
                             f"plain {held_err}, vs the CPU {cpu_err}")

    # the model inputs that the bf16 e2e function builds for this batch,
    # caught on their way into the model (the crop, then its mirror for
    # flip-test), against the crop called alone (bit-equal) and against the
    # exact 4-tap gather warp of the same canvases. The samplers round a
    # 640 px source coordinate differently in fp32: one ulp there (6.1e-5
    # px) across a full 0-255 step is 1.6e-2 grey levels, while a crop off
    # by a pixel, unflipped or misplaced is off by tens.
    passes = 2 if cfg.TEST.FLIP_TEST else 1
    std = torch.tensor(IMAGENET_STD, device=dev)[:, None, None]
    gather = crop_and_normalize(canvases, trans, out_size, warp="gather")
    seen = []
    hook = model.register_forward_pre_hook(
        lambda _, args: seen.append(args[0].clone()))
    try:
        for warp in ("separable", "shear"):
            cfg.TEST.WARP = warp
            make_e2e_fn(cfg, model, ds.src_size, device=dev)(
                batch["image"], batch["center"], batch["scale"])
            torch.cuda.synchronize()
    finally:
        hook.remove()
        cfg.TEST.WARP = "separable"
    for i, warp in enumerate(("separable", "shear")):
        x = seen[i * passes:(i + 1) * passes]
        alone = crop_and_normalize(canvases, trans, out_size, warp=warp)
        want = [alone, torch.flip(alone, dims=(3,))][:passes]
        ref = [gather, torch.flip(gather, dims=(3,))][:passes]
        same = all(torch.equal(a, b) for a, b in zip(x, want))
        err = max(float(((a - b) * std * 255.0).abs().max())
                  for a, b in zip(x, ref))
        log(f"bf16 e2e model inputs, TEST.WARP={warp}, {passes} pass(es) of "
            f"{tuple(x[0].shape)}: equal to the crop alone {same}; vs the "
            f"gather warp max |diff| {err:.3e} on 0-255")
        if len(x) != passes or not same or err > 2e-2:
            raise AssertionError(f"e2e crop under TEST.WARP={warp}: "
                                 f"{len(x)} passes, equal {same}, vs gather "
                                 f"{err}")
    # DARK on this batch's flip-averaged heatmaps, as the e2e decodes them
    perm = torch.as_tensor(get_spec(cfg.DATASET.DATASET).flip_perm,
                           device=dev)
    with torch.inference_mode():
        hm = heatmaps_with_flip_test(model, seen[0], cfg, perm).contiguous()
        dark_err = kernel_vs_plain(torch, dark_decode, dark_decode_reference,
                                   hm, cfg.TEST.BLUR_KERNEL)
    log(f"dark_decode kernel vs plain on one eval batch's flip-averaged "
        f"heatmaps {tuple(hm.shape)} {hm.dtype}, blur "
        f"{cfg.TEST.BLUR_KERNEL} (max {float(hm.amax()):.4g}): peaks, "
        f"maxvals and coords bit-equal (max |coord diff| {dark_err:.3e})")
    if tuple(hm.shape) != (bs, ds.num_joints,
                           *tuple(cfg.MODEL.HEATMAP_SIZE)[::-1]):
        raise AssertionError(f"eval heatmaps {tuple(hm.shape)}")
    return canvases, trans, pos


def eval_phases(torch, cfg, root, card, dev, per_image):
    """Phases 10 and 11 on a synthetic COCO set written under ``root``.
    Returns the eval-path launches of DARK and of the ConvBN epilogue on
    the main path's ``validate`` run and of the shear warp under
    TEST.WARP=shear."""
    from rsgnet_tpu_torch.core.inference import make_e2e_fn, to_device
    from rsgnet_tpu_torch.core.validate import (collect_predictions,
                                                validate)
    from rsgnet_tpu_torch.data import get_dataset
    from rsgnet_tpu_torch.data.loader import BatchLoader
    from rsgnet_tpu_torch.data.synthetic import write_synthetic_coco
    from rsgnet_tpu_torch.models import get_pose_net, init_weights
    from rsgnet_tpu_torch.ops.cuda.convbn_epilogue import convbn_epilogue
    from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode
    from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp
    from rsgnet_tpu_torch.ops.nms_native import available as native_nms
    from rsgnet_tpu_torch.ops.warp import invert_affine, separable_warp_batch
    from rsgnet_tpu_torch.tools._profiling import cuda_event_ms

    # -- 10. the main path: validate() ------------------------------------
    t0 = time.perf_counter()
    write_synthetic_coco(root, n_images=EVAL_IMAGES, seed=0)
    cfg.DATASET.ROOT = root
    cfg.DATASET.TEST_SET = "val"
    ds = get_dataset(cfg)
    bs = cfg.TEST.BATCH_SIZE_PER_GPU
    n_batches = -(-len(ds) // bs)
    model = init_weights(get_pose_net(cfg), seed=0)
    log(f"eval set: {EVAL_IMAGES} synthetic 640x480 images, {len(ds)} "
        f"instances (GT boxes), batch {bs}, {n_batches} batches (the last "
        f"padded); model {cfg.MODEL.NAME} "
        f"W{cfg.MODEL.EXTRA.STAGE2.NUM_CHANNELS[0]} "
        f"{cfg.MODEL.IMAGE_SIZE[1]}x{cfg.MODEL.IMAGE_SIZE[0]} DTYPE "
        f"{cfg.DTYPE} DECODE {cfg.TEST.DECODE} TEST.WARP {cfg.TEST.WARP} "
        f"DEVICE_NMS {cfg.TEST.DEVICE_NMS}; set-up "
        f"{time.perf_counter() - t0:.1f} s")
    if (cfg.TEST.DECODE != "dark" or bs != 24 or cfg.TEST.WARP != "separable"
            or not cfg.TEST.DEVICE_NMS):
        raise AssertionError("the W48 YAML no longer evaluates with DARK, "
                             "batch 24, the separable crop and device NMS")
    t0 = time.perf_counter()
    # main path starts here
    dark_decode.launches = shear_warp.launches = convbn_epilogue.launches = 0
    name_value, ap = validate(cfg, ds, model, device="cuda")
    torch.cuda.synchronize()
    dark_n, shear_n = dark_decode.launches, shear_warp.launches  # ends here
    bn_n = convbn_epilogue.launches
    log(f"validate (first pass, build of the eval path included) in "
        f"{time.perf_counter() - t0:.1f} s: AP table " + ", ".join(
            f"{k} {v:.4f}" for k, v in name_value.items())
        + f"; dark_decode launches {dark_n}, shear_warp launches {shear_n}, "
        f"ConvBN epilogue launches {bn_n}")
    if not all(np.isfinite(v) for v in name_value.values()):
        raise AssertionError(f"non-finite AP table {dict(name_value)}")
    if dark_n != n_batches or shear_n != 0:
        raise AssertionError(f"dark_decode launches {dark_n} != eval "
                             f"batches {n_batches}, or the shear warp ran "
                             f"({shear_n})")
    epilogue_launches_hold("validate", bn_n,
                           n_batches * (2 if cfg.TEST.FLIP_TEST else 1))

    # warm second pass on a fresh dataset object (cold decode cache):
    # phase 11's instances/s, and the separable run's predictions
    ds2 = get_dataset(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sep = collect_predictions(cfg, ds2, model, device="cuda")
    eval_s = time.perf_counter() - t0

    cfg.TEST.WARP = "shear"
    dark_decode.launches = shear_warp.launches = 0
    shear_out = collect_predictions(cfg, ds2, model, device="cuda")
    torch.cuda.synchronize()
    eval_dark, eval_shear = dark_decode.launches, shear_warp.launches
    cfg.TEST.WARP = "separable"
    moved = np.abs(shear_out[0][..., :2] - sep[0][..., :2]).max(-1)
    log(f"TEST.WARP=shear, {cfg.DTYPE}: shear_warp launches {eval_shear}, "
        f"dark_decode launches {eval_dark}; {int((moved > 1).sum())} of "
        f"{moved.size} preds move more than 1 px from the separable run's "
        f"(median {np.median(moved):.3f} px; heatmap maxima median "
        f"{np.median(sep[0][..., 2]):.4g}, DARK's log clips at 50)")
    if eval_shear != n_batches or eval_dark != n_batches:
        raise AssertionError(f"under TEST.WARP=shear: shear_warp launches "
                             f"{eval_shear}, dark_decode {eval_dark}, eval "
                             f"batches {n_batches}")
    if not (np.array_equal(shear_out[1], sep[1])
            and np.array_equal(shear_out[2], sep[2])):
        raise AssertionError("shear and separable runs differ in boxes or "
                             "image ids")
    # the two crops' predictions agree where the model is not chaotic: the
    # same seeded weights computed in fp32
    cfg32 = copy.deepcopy(cfg)
    cfg32.DTYPE = "float32"
    model32 = init_weights(get_pose_net(cfg32), seed=0)
    runs = {}
    for warp in ("separable", "shear"):
        cfg32.TEST.WARP = warp
        runs[warp] = collect_predictions(cfg32, ds2, model32, device="cuda")
    del model32
    diff = np.abs(runs["shear"][0][..., :2] - runs["separable"][0][..., :2])
    log(f"TEST.WARP=shear vs separable, the same weights in fp32: max |pred "
        f"diff| {diff.max():.4f} px, mean {diff.mean():.5f} px; max |maxval "
        f"diff| {np.abs(runs['shear'][0][..., 2] - runs['separable'][0][..., 2]).max():.3e}")
    if not diff.max() <= 1.0:
        raise AssertionError(f"shear and separable eval preds differ by "
                             f"{diff.max()} px in fp32")

    # GT keypoints through evaluate() with device NMS on the card
    n, k = len(ds), ds.num_joints
    gt = np.zeros((n, k, 3), np.float32)
    gt_boxes = np.zeros((n, 6), np.float32)
    for i, rec in enumerate(ds.db):
        gt[i, :, :2] = rec["joints"][:, :2]
        gt[i, :, 2] = rec["joints_vis"][:, 0]
        gt_boxes[i] = [*rec["center"], *rec["scale"],
                       np.prod(rec["scale"] * 200.0), rec["score"]]
    ids = np.array([rec["image_id"] for rec in ds.db])
    gt_nv, gt_ap = ds.evaluate(gt, gt_boxes, ids, device="cuda")
    log(f"evaluate on GT keypoints, device NMS on the card: AP {gt_ap:.6f}, "
        f"AR {gt_nv['AR']:.6f}")
    if gt_ap != 1.0:
        raise AssertionError(f"GT keypoints give AP {gt_ap}, not 1.0")

    # device OKS-NMS on the card vs the host path on the run's predictions
    preds, boxes, ids = sep
    rng = np.random.RandomState(13)
    dup = preds.copy()
    dup[..., :2] += rng.normal(0, 1.0, dup[..., :2].shape).astype(
        np.float32)
    thresh, sigmas = cfg.TEST.OKS_THRE, ds.spec.sigmas
    for label, p, b, i in (
            ("the run's predictions", preds, boxes, ids),
            ("with a jittered duplicate of each", np.concatenate([preds, dup]),
             np.concatenate([boxes, boxes]), np.concatenate([ids, ids]))):
        kept, total = nms_keep_sets_agree(
            nms_groups(p, b, i, cfg.TEST.IN_VIS_THRE), sigmas, thresh)
        log(f"device OKS-NMS on the card == host "
            f"({'C++ library' if native_nms() else 'NumPy fallback'}), "
            f"greedy and soft, {label}: greedy keeps {kept} of {total}")

    # the eval path's crop and kernels, held at the shapes it gives them
    batch = ds2.collate(range(bs))
    canvases, trans, pos = eval_holds(torch, cfg, model, ds, batch, dev)
    out_size, side = tuple(cfg.MODEL.IMAGE_SIZE), canvases.shape[1]
    passes = 2 if cfg.TEST.FLIP_TEST else 1

    # -- 11. eval timings ----------------------------------------------------
    log(f"[{card}] collect_predictions, warm second pass (fresh dataset, "
        f"decode included): {len(ds2)} instances in {eval_s:.3f} s = "
        f"{len(ds2) / eval_s:.1f} instances/s ({n_batches} batches of "
        f"{bs}; DARK {n_batches} launches, 1 per batch)")
    # the pieces of a batch's wall time, each alone: decode + collate on
    # the loader's threads, the pinned host-to-card copy, the e2e call
    t0 = time.perf_counter()
    for _ in BatchLoader(get_dataset(cfg), bs):
        pass
    load_ms = (time.perf_counter() - t0) * 1e3 / n_batches
    fn = make_e2e_fn(cfg, model, ds.src_size, device="cuda")
    on_card = to_device(batch["image"], dev)
    walls = {"host canvases": [], "canvases on the card": [],
             "pinned copy alone": []}
    for _ in range(5):
        for label, call in (
                ("host canvases", lambda: fn(batch["image"], batch["center"],
                                             batch["scale"])),
                ("canvases on the card", lambda: fn(on_card, batch["center"],
                                                    batch["scale"])),
                ("pinned copy alone", lambda: to_device(batch["image"],
                                                        dev))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls[label].append((time.perf_counter() - t0) * 1e3)
    # the e2e call never makes the host wait for the card: a synchronizing
    # call (a pageable host-to-card copy of a constant, a solve that checks
    # its result) would stall the batches in flight
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(batch["image"], batch["center"], batch["scale"])
    except RuntimeError as e:
        raise AssertionError(f"the e2e call synchronizes: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("the e2e call from host canvases under torch.cuda."
        "set_sync_debug_mode('error'): no synchronizing CUDA call")
    log(f"[{card}] per eval batch of {bs}: loader alone (decode + collate, "
        f"8 threads) {load_ms:.2f} ms; " + "; ".join(
            f"{k} median {np.median(v):.2f} ms (min {min(v):.2f})"
            for k, v in walls.items()))
    profile_device(torch, lambda: fn(batch["image"], batch["center"],
                                     batch["scale"]), card,
                   bs * passes * per_image,
                   f"one eval batch ({bs} uint8 canvases in from the host, "
                   f"separable crop, flip-test, DARK)")
    sep_ms = cuda_event_ms(lambda: separable_warp_batch(canvases, trans,
                                                           out_size))
    shear_ms = cuda_event_ms(lambda: shear_warp(canvases, pos))
    inv = invert_affine(trans)
    gx = torch.arange(out_size[0], dtype=torch.float32, device=dev)
    gy = torch.arange(out_size[1], dtype=torch.float32, device=dev)[:, None]
    u = (inv[:, 0, 0, None, None] * gx + inv[:, 0, 2, None, None]).expand(
        bs, out_size[1], out_size[0])
    v = (inv[:, 1, 1, None, None] * gy + inv[:, 1, 2, None, None]).expand(
        bs, out_size[1], out_size[0])
    grid = torch.stack([2 * u / (side - 1) - 1, 2 * v / (side - 1) - 1],
                       dim=-1)
    src_f = canvases.permute(0, 3, 1, 2).float().contiguous()
    gs_ms = cuda_event_ms(lambda: torch.nn.functional.grid_sample(
        src_f, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True))
    got = separable_warp_batch(canvases, trans, out_size)
    ref = torch.nn.functional.grid_sample(src_f, grid, mode="bilinear",
                                          padding_mode="zeros",
                                          align_corners=True)
    warp_err = float((got - ref).abs().max())
    shear_err = float((got - shear_warp(canvases, pos)).abs().max())
    n_src = canvases.numel()
    flops = 2 * bs * out_size[1] * side * side * 3 \
        + 2 * bs * 3 * out_size[1] * side * out_size[0]
    nbytes = n_src + got.numel() * 4
    bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    log(f"[{card}] eval crop at ({bs}, {side}, {side}, 3) uint8 -> ({bs}, 3, "
        f"{out_size[1]}, {out_size[0]}) fp32: separable (two fp32 bmm, TF32 "
        f"off) {sep_ms:.4f} ms, F.grid_sample (bilinear, zeros, fp32 NCHW "
        f"source) {gs_ms:.4f} ms, shear_warp kernel {shear_ms:.4f} ms; "
        f"separable vs grid_sample max |diff| {warp_err:.2e}, vs the shear "
        f"kernel {shear_err:.2e} on 0-255; the "
        f"matmul form's bound {bound:.4f} ms ({flops / 1e9:.1f} GFLOP fp32, "
        f"{nbytes / 1e6:.1f} MB)")
    # grid_sample's normalized coordinates carry ~4e-5 px of rounding at
    # 640 px, up to ~1e-2 on the 0-255 scale; a wrong map is off by tens
    if warp_err > 5e-2:
        raise AssertionError(f"separable crop vs grid_sample: {warp_err}")
    return dark_n, eval_shear, bn_n


def max_state_diff(torch, a, b):
    """{'model', 'optimizer'}: the largest |difference| between two train
    states' model state dicts (weights and BatchNorm statistics) and
    optimizer states (Adam's moments and step counts); raises if their
    names, shapes or steps differ."""
    out = {}
    sa, sb = a.model.state_dict(), b.model.state_dict()
    if list(sa) != list(sb) or a.step != b.step:
        raise AssertionError(f"states differ in names or step ({a.step} vs "
                             f"{b.step})")
    out["model"] = max(float((sa[k].double() - sb[k].double()).abs().max())
                       for k in sa)
    oa = a.optimizer.state_dict()["state"]
    ob = b.optimizer.state_dict()["state"]
    if sorted(oa) != sorted(ob):
        raise AssertionError("optimizer states cover other parameters")
    diffs = [0.0]
    for i in oa:
        for key in oa[i]:
            x, y = oa[i][key], ob[i][key]
            if x.shape != y.shape:
                raise AssertionError(f"optimizer state {i}/{key}: shapes "
                                     f"{tuple(x.shape)} vs {tuple(y.shape)}")
            diffs.append(float((x.double().cpu() - y.double().cpu())
                               .abs().max()))
    out["optimizer"] = max(diffs)
    return out


def states_equal(torch, a, b):
    """Bitwise equality of two train states: every model tensor, every
    optimizer tensor and the step."""
    if a.step != b.step:
        return False
    sa, sb = a.model.state_dict(), b.model.state_dict()
    if list(sa) != list(sb) or not all(torch.equal(sa[k], sb[k])
                                       for k in sa):
        return False
    oa = a.optimizer.state_dict()["state"]
    ob = b.optimizer.state_dict()["state"]
    return sorted(oa) == sorted(ob) and all(
        list(oa[i]) == list(ob[i]) and all(
            torch.equal(oa[i][k].cpu(), ob[i][k].cpu()) for k in oa[i])
        for i in oa)


def fit_phases(torch, card, dev, root, bare_step_s):
    """Phase 13 on a synthetic COCO set written under ``root``: the train
    CLI in a subprocess, then ``fit`` in process three ways (uninterrupted;
    one epoch, then an auto-resume; a stop at step 2 of epoch 1, then a
    resume) under deterministic cuDNN, the checkpoint round trip and the
    fit timings. Returns (the CLI run's model_best.pt, the shear-warp
    launches of the uninterrupted fit, which equal its steps)."""
    import logging
    import re
    import warnings
    from rsgnet_tpu_torch.config.defaults import load_config, opts_to_dict
    from rsgnet_tpu_torch.core.function import (PreemptionGuard, epoch_seed,
                                                fit, step_generator)
    from rsgnet_tpu_torch.core.train import create_train_state
    from rsgnet_tpu_torch.data import get_dataset
    from rsgnet_tpu_torch.data.augment import augment_geometry, draw_augment
    from rsgnet_tpu_torch.data.loader import BatchLoader
    from rsgnet_tpu_torch.data.synthetic import write_synthetic_coco
    from rsgnet_tpu_torch.models import get_pose_net, init_weights
    from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode
    from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp
    from rsgnet_tpu_torch.ops.shear_warp import shear_prepare
    from rsgnet_tpu_torch.utils.checkpoint import (AsyncCheckpointer,
                                                   load_checkpoint,
                                                   peek_checkpoint,
                                                   save_checkpoint)

    t0 = time.perf_counter()
    write_synthetic_coco(root, n_images=FIT_IMAGES, seed=1)
    opts = ["DATASET.ROOT", root, "DATASET.TRAIN_SET", "val",
            "DATASET.TEST_SET", "val", "TRAIN.END_EPOCH", str(FIT_EPOCHS)]
    cfg = load_config(W32_YAML, overrides=opts_to_dict(opts))
    train_ds = get_dataset(cfg, is_train=True)
    val_ds = get_dataset(cfg, is_train=False)
    bs = cfg.TRAIN.BATCH_SIZE_PER_GPU
    spe = len(train_ds) // bs
    log(f"fit set: {FIT_IMAGES} synthetic 640x480 images, {len(train_ds)} "
        f"train instances (SELECT_DATA {cfg.DATASET.SELECT_DATA}), "
        f"{len(val_ds)} val instances (GT boxes); W32 batch {bs} drop_last: "
        f"{spe} steps per epoch, {FIT_EPOCHS} epochs; TEST.DECODE "
        f"{cfg.TEST.DECODE}; set-up {time.perf_counter() - t0:.1f} s")
    if (cfg.MODEL.NAME != "pose_rsgnet" or cfg.DTYPE != "bfloat16" or bs != 32
            or cfg.TRAIN.OPTIMIZER != "adam" or cfg.TEST.DECODE == "dark"
            or spe < 3):
        raise AssertionError("the W32 YAML no longer trains bf16 Adam "
                             "RSGNet at batch 32 with quarter-offset eval, or "
                             "the set holds fewer than 3 steps an epoch")

    # the shear-warp kernel at the shapes fit gives it: epoch 0's first
    # batch and its augmentation draws, as the train step makes them
    loader = BatchLoader(train_ds, bs, shuffle=True, drop_last=True)
    loader.set_epoch(0)
    batches = iter(loader)
    batch = next(batches)
    batches.close()
    trans = augment_geometry(
        draw_augment(step_generator(epoch_seed(0), 0), bs),
        *(torch.from_numpy(batch[k]) for k in ("joints", "joints_vis",
                                               "center", "scale")),
        float(batch["image"].shape[2]), cfg, train_ds.spec)[0]
    images = torch.from_numpy(batch["image"]).to(dev)
    pos = shear_prepare(trans.to(dev), images.shape[1],
                        tuple(cfg.MODEL.IMAGE_SIZE))
    err, equal = shear_vs_plain(torch, shear_warp, images, pos)
    log(f"shear_warp kernel vs plain on fit's first batch "
        f"{tuple(images.shape)} uint8 with its augmentation matrices: max "
        f"|diff| {err:.3e}, bit-equal {equal}")
    if not equal:
        raise AssertionError(f"shear_warp at fit's shapes: {err}")
    del images, pos, batch

    # -- the train CLI in a subprocess --------------------------------------
    cli_out = os.path.join(root, "cli")
    cmd = [sys.executable, "-m", "rsgnet_tpu_torch.train", "--cfg",
           W32_YAML, "--workers", "8", *opts, "OUTPUT_DIR",
           os.path.join(cli_out, "output"), "LOG_DIR",
           os.path.join(cli_out, "log"), "PRINT_FREQ", "1"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    cli_s = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise AssertionError(f"python -m rsgnet_tpu_torch.train exited "
                             f"{proc.returncode}:\n{text[-4000:]}")
    # (epoch, loss, AP, best, steps, train s, validate s, checkpoint s)
    epochs = re.findall(r"epoch (\d+): loss (\S+) perf (\S+) best (\S+); "
                        r"(\d+) steps in (\S+) s, validate (\S+) s, "
                        r"checkpoint (\S+) s", text)
    run_dir = os.path.join(cli_out, "output", "coco", "pose_rsgnet",
                           "w32_256x192")
    best_pt = os.path.join(run_dir, "model_best.pt")
    log(f"python -m rsgnet_tpu_torch.train ... TRAIN.END_EPOCH "
        f"{FIT_EPOCHS}: exit 0 in {cli_s:.1f} s (interpreter start and "
        f"build included); " + "; ".join(
            f"epoch {e[0]}: loss {e[1]} AP {e[2]}" for e in epochs)
        + f"; files {sorted(os.listdir(run_dir))}")
    if ([int(e[0]) for e in epochs] != list(range(FIT_EPOCHS))
            or not all(np.isfinite(float(e[1])) and np.isfinite(float(e[2]))
                       for e in epochs)):
        raise AssertionError(f"the CLI's epoch lines: {epochs}")
    if not all(os.path.exists(os.path.join(run_dir, f))
               for f in ("checkpoint.pt", "model_best.pt")):
        raise AssertionError(f"the CLI wrote {os.listdir(run_dir)}")

    # -- fit in process, three ways, deterministic --------------------------
    class Guard(PreemptionGuard):
        def __init__(self, stop_after=None):
            super().__init__()
            self.steps, self.stop_after = 0, stop_after

        def should_stop(self, step):
            if self.stop_after is not None and self.steps >= self.stop_after:
                return True
            self.steps += 1
            return False

    stats = []

    class Stats(logging.Handler):
        def emit(self, record):
            if hasattr(record, "epoch_stats"):
                stats.append(record.epoch_stats)

    logger = logging.getLogger("chip_smoke.fit")
    logger.propagate = False
    logger.setLevel(logging.INFO)
    logger.addHandler(Stats())
    runs_dir = os.path.join(root, "runs")

    def run(name, epochs, stop_after=None, async_ckpt=False):
        c = copy.deepcopy(cfg)
        c.TRAIN.ASYNC_CHECKPOINT = async_ckpt
        guard = Guard(stop_after)
        model = init_weights(get_pose_net(c), seed=0)
        del stats[:]
        t = time.perf_counter()
        shear_warp.launches = dark_decode.launches = 0  # main path starts
        state, best = fit(c, model, train_ds, val_ds,
                          output_dir=os.path.join(runs_dir, name),
                          logger=logger, num_workers=8, max_epochs=epochs,
                          preempt_guard=guard, device="cuda")
        torch.cuda.synchronize()
        launches = (shear_warp.launches, dark_decode.launches)   # ends
        wall = time.perf_counter() - t
        log(f"fit {name}: {guard.steps} steps in {wall:.1f} s, step "
            f"{state.step}, best AP {best:.4f}; shear_warp launches "
            f"{launches[0]}, dark_decode launches {launches[1]}; epochs "
            + "; ".join(f"{s['epoch']}: loss {s['loss']:.5f} AP "
                        f"{s['perf']:.4f} ({s['steps']} steps "
                        f"{s['train_s']:.2f} s, validate "
                        f"{s['validate_s']:.2f} s, checkpoint "
                        f"{s['checkpoint_s']:.2f} s)" for s in stats))
        if launches != (guard.steps, 0):
            raise AssertionError(f"fit {name}: shear_warp launches "
                                 f"{launches[0]} != {guard.steps} steps, or "
                                 f"dark_decode ran ({launches[1]})")
        if not all(np.isfinite(s["loss"]) and np.isfinite(s["perf"])
                   for s in stats):
            raise AssertionError(f"fit {name}: non-finite {stats}")
        return state, guard.steps, list(stats)

    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    _deterministic(torch)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            a, a_steps, a_stats = run("a_uninterrupted", FIT_EPOCHS)
            run("b_resumed", 1, async_ckpt=True)
            b, _, _ = run("b_resumed", FIT_EPOCHS, async_ckpt=True)
            run("c_preempted", FIT_EPOCHS, stop_after=spe + 2)
            c_ckpt = os.path.join(runs_dir, "c_preempted", "checkpoint.pt")
            meta = peek_checkpoint(c_ckpt)
            c, _, _ = run("c_preempted", FIT_EPOCHS)
            same = {"b": states_equal(torch, a, b),
                    "c": states_equal(torch, a, c)}
            spread = None
            if not all(same.values()):
                a2, _, _ = run("a_again", FIT_EPOCHS)
                spread = max_state_diff(torch, a, a2)
                del a2
        nondet = sorted({str(w.message).split(".")[0] for w in caught
                         if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    log(f"mid-epoch checkpoint of the stopped run: {meta}")
    if meta["epoch"] != 1 or meta["batch_in_epoch"] != 2:
        raise AssertionError(f"the guard stopped at {meta}, not epoch 1 "
                             f"batch 2")
    log(f"ops without a deterministic CUDA implementation on the path: "
        f"{nondet or 'none'}")
    if all(same.values()):
        log(f"(a) uninterrupted, (b) boundary resume, (c) mid-epoch resume: "
            f"weights, BatchNorm statistics, Adam moments and steps "
            f"bitwise equal ({a.step} steps)")
    else:
        diffs = {k: max_state_diff(torch, a, s) for k, s in (("b", b),
                                                              ("c", c))}
        log(f"not bitwise ({same}): max |diff| vs (a): {diffs}; two "
            f"uninterrupted runs: {spread}")
        for k, d in diffs.items():
            for part in ("model", "optimizer"):
                if d[part] > 2 * spread[part]:
                    raise AssertionError(f"({k}) differs from (a) by "
                                         f"{d[part]} in {part}, over twice "
                                         f"the spread {spread[part]}")
    del b, c

    # -- the checkpoint round trip, sync and async --------------------------
    sizes = {}
    walls = {}
    for name in ("sync", "async"):
        out = os.path.join(root, "roundtrip", name)
        t = time.perf_counter()
        if name == "sync":
            save_checkpoint(out, a, 1, 0.5, True, best_perf=0.5)
            walls["save"] = time.perf_counter() - t
        else:
            writer = AsyncCheckpointer()
            writer.save(out, a, 1, 0.5, True, best_perf=0.5)
            walls["stall"] = time.perf_counter() - t
            writer.close()
            walls["async total"] = time.perf_counter() - t
        st = create_train_state(cfg, get_pose_net(cfg), device="cuda",
                                steps_per_epoch=spe)
        st, epoch, best, batch = load_checkpoint(
            os.path.join(out, "checkpoint.pt"), st)
        if not (states_equal(torch, a, st) and (epoch, best, batch)
                == (1, 0.5, 0) and st.optimizer.param_groups[0]["lr"]
                == a.optimizer.param_groups[0]["lr"]):
            raise AssertionError(f"{name} checkpoint round trip is not "
                                 f"bitwise")
        sizes = {f: os.path.getsize(os.path.join(out, f))
                 for f in ("checkpoint.pt", "model_best.pt")}
        del st
    log(f"load_checkpoint of save_checkpoint's and AsyncCheckpointer's "
        f"files: weights, BatchNorm statistics, Adam moments, step and lr "
        f"bitwise equal; bytes {sizes}")

    # -- timings --------------------------------------------------------------
    # the CLI's run is in torch's default mode, as phase 9's bare step;
    # run (a) is under deterministic cuDNN, which may cost time of its own
    cli_ms = [1e3 * float(e[5]) / max(int(e[4]), 1) for e in epochs]
    det_ms = [1e3 * s["train_s"] / max(s["steps"], 1) for s in a_stats]
    log(f"[{card}] fit, W32 batch {bs}, {spe} steps an epoch: wall per "
        f"train step (loader, prefetch, step; epoch 0 with the warm-up), "
        f"default mode (the train CLI's run) " + ", ".join(
            f"epoch {i}: {ms:.2f} ms" for i, ms in enumerate(cli_ms))
        + f", the warm epoch {cli_ms[-1] / (1e3 * bare_step_s):.3f}x the "
        f"bare step of phase 9, {1e3 * bare_step_s:.2f} ms; under "
        f"deterministic cuDNN (run (a)) " + ", ".join(
            f"epoch {i}: {ms:.2f} ms" for i, ms in enumerate(det_ms))
        + f"; validation per epoch ({len(val_ds)} instances) default mode "
        + ", ".join(f"{float(e[6]):.3f} s" for e in epochs)
        + ", deterministic " + ", ".join(
            f"{s['validate_s']:.3f} s" for s in a_stats)
        + f"; checkpoint in fit " + ", ".join(
            f"{float(e[7]):.3f} s" for e in epochs) + ", deterministic "
        + ", ".join(f"{s['checkpoint_s']:.3f} s" for s in a_stats))
    log(f"[{card}] save_checkpoint {walls['save']:.3f} s; under "
        f"ASYNC_CHECKPOINT the train loop stalls {walls['stall']:.3f} s "
        f"(host copy), the write ends {walls['async total']:.3f} s after "
        f"the call; checkpoint.pt {sizes['checkpoint.pt']} bytes, "
        f"model_best.pt {sizes['model_best.pt']} bytes")
    return best_pt, a_steps


def test_cli_phase(torch, card, dev, root, best_pt):
    """Phase 14: ``rsgnet_tpu_torch.test.main`` in process on phase 13's
    model_best.pt at W32 and on W48 @ 384x288 DARK with the seeded init,
    DARK held against its plain version on a W48 eval batch, and
    ``serve.py``'s loader on the same model_best.pt. Returns DARK's
    launches in the W48 run."""
    from rsgnet_tpu_torch import serve
    from rsgnet_tpu_torch import test as test_cli
    from rsgnet_tpu_torch.config.defaults import load_config, opts_to_dict
    from rsgnet_tpu_torch.core.inference import heatmaps_with_flip_test
    from rsgnet_tpu_torch.data import get_dataset
    from rsgnet_tpu_torch.data.skeletons import get_spec
    from rsgnet_tpu_torch.models import get_pose_net
    from rsgnet_tpu_torch.ops.affine import get_affine_transform_t
    from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode
    from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp
    from rsgnet_tpu_torch.ops.decode import dark_decode_reference
    from rsgnet_tpu_torch.ops.warp import crop_and_normalize
    from rsgnet_tpu_torch.utils.checkpoint import load_weights

    opts = ["DATASET.ROOT", root, "DATASET.TEST_SET", "val", "OUTPUT_DIR",
            os.path.join(root, "test_cli", "output"), "LOG_DIR",
            os.path.join(root, "test_cli", "log")]
    runs = {}
    for label, yaml_path, extra in (
            ("W32, phase 13's model_best.pt", W32_YAML,
             ["TEST.MODEL_FILE", best_pt]),
            ("W48 DARK, the seeded init", W48_YAML, [])):
        cfg = load_config(yaml_path, overrides=opts_to_dict(opts + extra))
        n_batches = -(-len(get_dataset(cfg)) // cfg.TEST.BATCH_SIZE_PER_GPU)
        t = time.perf_counter()
        dark_decode.launches = shear_warp.launches = 0  # main path starts
        name_value, ap = test_cli.main(["--cfg", yaml_path, "--workers", "8",
                                        *opts, *extra])
        torch.cuda.synchronize()
        launches = (dark_decode.launches, shear_warp.launches)   # ends
        log(f"python -m rsgnet_tpu_torch.test, {label}: "
            f"{time.perf_counter() - t:.1f} s; AP table " + ", ".join(
                f"{k} {v:.4f}" for k, v in name_value.items())
            + f"; {n_batches} eval batches, dark_decode launches "
            f"{launches[0]}, shear_warp launches {launches[1]}")
        if not all(np.isfinite(v) for v in name_value.values()):
            raise AssertionError(f"{label}: AP table {dict(name_value)}")
        want_dark = n_batches if cfg.TEST.DECODE == "dark" else 0
        if launches != (want_dark, 0):
            raise AssertionError(f"{label}: launches {launches}, expected "
                                 f"DARK {want_dark} and no shear warp")
        runs[label] = (cfg, launches[0])

    # DARK at the W48 test CLI's shapes, against its plain version
    cfg = runs["W48 DARK, the seeded init"][0]
    ds = get_dataset(cfg)
    bs = cfg.TEST.BATCH_SIZE_PER_GPU
    batch = ds.collate(range(bs))
    model = load_weights(cfg, get_pose_net(cfg), "").to(dev).eval()
    size = tuple(cfg.MODEL.IMAGE_SIZE)
    trans = get_affine_transform_t(               # on the card, as the e2e
        torch.from_numpy(batch["center"]).to(dev),
        torch.from_numpy(batch["scale"]).to(dev),
        torch.zeros(bs, device=dev), size)
    perm = torch.as_tensor(get_spec(cfg.DATASET.DATASET).flip_perm,
                           device=dev)
    with torch.inference_mode():
        x = crop_and_normalize(torch.from_numpy(batch["image"]).to(dev),
                               trans, size)
        hm = heatmaps_with_flip_test(model, x, cfg, perm).contiguous()
        kernel_vs_plain(torch, dark_decode, dark_decode_reference, hm,
                        cfg.TEST.BLUR_KERNEL)
    log(f"dark_decode kernel vs plain on a W48 test-CLI batch "
        f"{tuple(hm.shape)}, blur {cfg.TEST.BLUR_KERNEL}: peaks, maxvals "
        f"and coords bit-equal")
    del model, x, hm

    # serve.py's loader takes the same file
    args = serve.parse_args(["--cfg", W32_YAML, "--model-file", best_pt])
    _, served = serve.load_model(args)
    want = torch.load(best_pt, map_location="cpu", weights_only=True)["model"]
    got = served.state_dict()
    if list(got) != list(want) or not all(torch.equal(got[k], want[k])
                                          for k in want):
        raise AssertionError("serve.load_model did not load model_best.pt")
    log(f"serve.load_model --model-file model_best.pt: {len(want)} tensors "
        f"equal the file's")
    return runs["W48 DARK, the seeded init"][1]


def decode_ties(torch, hm_a, hm_b, tol):
    """(N, K) mask of the maps whose quarter-offset decode sits on a tie
    within ``tol`` in ``hm_a``: the value at ``hm_b``'s argmax within tol of
    ``hm_a``'s max, or, at either argmax, a neighbour difference that sets
    the quarter offset's sign within tol of zero."""
    n, k, h, w = hm_a.shape
    fa, fb = hm_a.reshape(n, k, -1), hm_b.reshape(n, k, -1)
    ia, ib = fa.argmax(-1), fb.argmax(-1)
    tie = (fa.max(-1).values - fa.gather(-1, ib[..., None])[..., 0]) <= tol
    pad = torch.nn.functional.pad(hm_a, (1, 1, 1, 1))
    for idx in (ia, ib):
        y, x = idx // w + 1, idx % w + 1
        flat = pad.reshape(n, k, -1)

        def at(yy, xx):
            return flat.gather(-1, (yy * (w + 2) + xx)[..., None])[..., 0]

        tie |= (at(y, x + 1) - at(y, x - 1)).abs() <= tol
        tie |= (at(y + 1, x) - at(y - 1, x)).abs() <= tol
    return tie


def fold_phase(torch, card, dev, cfg, best_pt):
    """Phase 15's fold check, on phase 15's model_best.pt in fp32:
    TEST.FOLD_BN against the unfolded run (the JAX package's 5e-3 px) and
    against the same weights folded by hand, the unfolded run against
    itself, and the caller's weights restored. A pred may move further
    only where its quarter-offset decode is a tie within the heatmaps'
    fold rounding, itself under 1e-4 of their scale, as the maxvals (the
    heatmaps' peaks) are. Returns the largest move from the unfolded
    run."""
    from rsgnet_tpu_torch.core.inference import heatmaps_with_flip_test
    from rsgnet_tpu_torch.core.validate import collect_predictions
    from rsgnet_tpu_torch.data import get_dataset
    from rsgnet_tpu_torch.data.skeletons import get_spec
    from rsgnet_tpu_torch.models import get_pose_net
    from rsgnet_tpu_torch.models.fold_bn import (bn_folded, count_convbn,
                                                 fold_bn_variables)
    from rsgnet_tpu_torch.ops.affine import get_affine_transform_t
    from rsgnet_tpu_torch.ops.warp import crop_and_normalize
    from rsgnet_tpu_torch.utils.checkpoint import load_weights
    cfg = copy.deepcopy(cfg)
    cfg.DTYPE = "float32"
    ds = get_dataset(cfg)
    model = load_weights(cfg, get_pose_net(cfg), best_pt).to(dev)
    own = {k: v.clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    runs = {"plain": collect_predictions(cfg, ds, model, device="cuda"),
            "plain again": collect_predictions(cfg, ds, model,
                                               device="cuda")}
    cfg.TEST.FOLD_BN = True
    runs["flag"] = collect_predictions(cfg, ds, model, device="cuda")
    fold_s = time.perf_counter() - t0
    after = model.state_dict()
    restored = all(torch.equal(after[k], v) for k, v in own.items())
    by_hand = copy.deepcopy(model)
    by_hand.load_state_dict(fold_bn_variables(model))
    cfg.TEST.FOLD_BN = False
    runs["by hand"] = collect_predictions(cfg, ds, by_hand, device="cuda")
    same_boxes = all(np.array_equal(r[1], runs["plain"][1])
                     and np.array_equal(r[2], runs["plain"][2])
                     for r in runs.values())

    def moved(a, b):
        return np.abs(runs[a][0][..., :2] - runs[b][0][..., :2]).max(-1)

    names = {"flag vs plain": ("flag", "plain"),
             "flag vs by hand": ("flag", "by hand"),
             "plain vs plain again": ("plain", "plain again")}
    pairs = {k: moved(*ab) for k, ab in names.items()}
    # maxvals are heatmap peaks: held relative to their scale, as heatmaps
    peak = float(np.abs(runs["plain"][0][..., 2]).max())
    maxval_rel = {k: float(np.abs(runs[a][0][..., 2] - runs[b][0][..., 2])
                           .max()) / max(peak, 1.0)
                  for k, (a, b) in names.items()}
    bad = {(int(i), int(j)) for m in pairs.values()
           for i, j in np.argwhere(m > 5e-3)}
    # the heatmaps of the moved instances (the first batch when none
    # moved), folded and not
    idx = sorted({i for i, _ in bad}) or list(range(min(
        len(ds), cfg.TEST.BATCH_SIZE_PER_GPU)))
    batch = ds.collate(idx)
    size = tuple(cfg.MODEL.IMAGE_SIZE)
    trans = get_affine_transform_t(               # on the card, as the e2e
        torch.from_numpy(batch["center"]).to(dev),
        torch.from_numpy(batch["scale"]).to(dev),
        torch.zeros(len(idx), device=dev), size)
    perm = torch.as_tensor(get_spec(cfg.DATASET.DATASET).flip_perm,
                           device=dev)
    with torch.inference_mode():
        x = crop_and_normalize(torch.from_numpy(batch["image"]).to(dev),
                               trans, size)
        hm_plain = heatmaps_with_flip_test(model, x, cfg, perm)
        with bn_folded(model):
            hm_fold = heatmaps_with_flip_test(model, x, cfg, perm)
    hm_err = float((hm_fold - hm_plain).abs().max())
    hm_scale = float(hm_plain.abs().max())
    tol = 4 * hm_err
    tie = (decode_ties(torch, hm_plain, hm_fold, tol)
           | decode_ties(torch, hm_fold, hm_plain, tol)).cpu().numpy()
    row = {i: r for r, i in enumerate(idx)}
    unexplained = sorted(b for b in bad if not tie[row[b[0]], b[1]])
    log(f"[{card}] TEST.FOLD_BN on phase 15's model_best.pt, fp32, "
        f"{count_convbn(model)} conv/BN pairs folded, {len(ds)} instances "
        f"({len(runs)} runs in {fold_s:.1f} s): " + "; ".join(
            f"{k}: max |pred diff| {m.max():.3e} px, median "
            f"{np.median(m):.3e}, {int((m > 0).sum())} of {m.size} preds "
            f"differ, {int((m > 5e-3).sum())} beyond 5e-3 px, maxvals "
            f"within {maxval_rel[k]:.3e} of their max {peak:.3e}"
            for k, m in pairs.items())
        + f"; heatmaps folded vs not on {len(idx)} instances: max |diff| "
        f"{hm_err:.3e} of max {hm_scale:.3e}; preds beyond 5e-3 px that are "
        f"no quarter-offset decode tie within {tol:.3e}: {unexplained[:8]}; "
        f"boxes and ids equal {same_boxes}; the model's weights restored "
        f"bitwise {restored}")
    if (unexplained or hm_err > 1e-4 * max(hm_scale, 1.0) or not restored
            or not same_boxes or max(maxval_rel.values()) > 1e-4):
        raise AssertionError("TEST.FOLD_BN check failed (see the line "
                             "above)")
    return float(pairs["flag vs plain"].max())


def resnet_phases(torch, card, dev, root):
    """Phase 15 on phase 13's synthetic COCO set under ``root``:
    SimpleBaseline ResNet-152 @ 384x288 from its YAML at full depth, the
    shear-warp kernel at its train shape, the train CLI for one epoch in a
    subprocess, the bare train step's wall time, profile and memory, the
    test CLI on its model_best.pt and TEST.FOLD_BN. Returns a dict of the
    numbers the kernels line and phase 18 take."""
    import re
    from rsgnet_tpu_torch.tools._profiling import cuda_event_ms
    from rsgnet_tpu_torch import test as test_cli
    from rsgnet_tpu_torch.config.defaults import load_config, opts_to_dict
    from rsgnet_tpu_torch.core.function import (epoch_seed, step_generator,
                                                train_one_epoch)
    from rsgnet_tpu_torch.core.train import (create_train_state,
                                             make_train_step)
    from rsgnet_tpu_torch.data import get_dataset
    from rsgnet_tpu_torch.data.augment import augment_geometry, draw_augment
    from rsgnet_tpu_torch.data.loader import BatchLoader
    from rsgnet_tpu_torch.data.synthetic import synthetic_train_batch
    from rsgnet_tpu_torch.models import get_pose_net, init_weights
    from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode
    from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp
    from rsgnet_tpu_torch.ops.shear_warp import (shear_prepare,
                                                 shear_warp_reference)

    t0 = time.perf_counter()
    opts = ["DATASET.ROOT", root, "DATASET.TRAIN_SET", "val",
            "DATASET.TEST_SET", "val", "TRAIN.END_EPOCH", "1"]
    cfg = load_config(RES152_YAML, overrides=opts_to_dict(opts))
    extra = cfg.MODEL.EXTRA
    model = init_weights(get_pose_net(cfg), seed=0)
    n_params = sum(q.numel() for q in model.parameters())
    train_ds = get_dataset(cfg, is_train=True)
    bs = cfg.TRAIN.BATCH_SIZE_PER_GPU
    spe = len(train_ds) // bs
    size = tuple(cfg.MODEL.IMAGE_SIZE)
    log(f"model {cfg.MODEL.NAME} ResNet-{extra.NUM_LAYERS} "
        f"{size[1]}x{size[0]}, deconvs {extra.NUM_DECONV_FILTERS} kernels "
        f"{extra.NUM_DECONV_KERNELS}, DTYPE {cfg.DTYPE}, optimizer "
        f"{cfg.TRAIN.OPTIMIZER} lr {cfg.TRAIN.LR}, batch {bs}: {n_params} "
        f"params, seeded init in {time.perf_counter() - t0:.1f} s; "
        f"{len(train_ds)} train instances, {spe} steps an epoch")
    if (extra.NUM_LAYERS != 152 or tuple(extra.NUM_DECONV_FILTERS)
            != (256,) * 3 or tuple(extra.NUM_DECONV_KERNELS) != (4,) * 3
            or cfg.DTYPE != "bfloat16" or cfg.TRAIN.OPTIMIZER != "adam"
            or bs != 32 or size != (288, 384) or cfg.TEST.DECODE == "dark"):
        raise AssertionError("the ResNet-152 YAML no longer trains bf16 "
                             "Adam at batch 32 at 384x288 with three 256-"
                             "wide kernel-4 deconvs")

    # -- the shear-warp kernel at fit's first batch and its matrices -------
    loader = BatchLoader(train_ds, bs, shuffle=True, drop_last=True)
    loader.set_epoch(0)
    batches = iter(loader)
    batch = next(batches)
    batches.close()
    trans = augment_geometry(
        draw_augment(step_generator(epoch_seed(0), 0), bs),
        *(torch.from_numpy(batch[k]) for k in ("joints", "joints_vis",
                                               "center", "scale")),
        float(batch["image"].shape[2]), cfg, train_ds.spec)[0].to(dev)
    images = torch.from_numpy(batch["image"]).to(dev)
    pos = shear_prepare(trans, images.shape[1], size)
    err, equal = shear_vs_plain(torch, shear_warp, images, pos)
    out_shape = tuple(shear_warp(images, pos).shape)
    log(f"shear_warp kernel vs plain on the ResNet-152 fit's first batch "
        f"{tuple(images.shape)} uint8 -> {out_shape} with its augmentation "
        f"matrices: max |diff| {err:.3e}, bit-equal {equal}")
    if not equal or out_shape != (bs, 3, size[1], size[0]):
        raise AssertionError(f"shear_warp at the ResNet-152 shape: {err}, "
                             f"{out_shape}")
    warp = {"ms": cuda_event_ms(lambda: shear_warp(images, pos)),
            "plain_ms": cuda_event_ms(lambda: shear_warp_reference(
                images, pos)),
            "library_ms": grid_sample_ms(torch, images, trans, size)}
    warp["bound_ms"], warp["bound_by"], nbytes, src_bytes = shear_bound_ms(
        torch, images, pos)
    warp["max_abs_err"] = err
    log(f"[{card}] shear_warp at ({bs}, {images.shape[1]}, "
        f"{images.shape[2]}, 3) uint8 -> ({bs}, 3, {size[1]}, {size[0]}) "
        f"fp32: kernel {warp['ms']:.4f} ms, plain {warp['plain_ms']:.4f} ms, "
        f"F.grid_sample {warp['library_ms']:.4f} ms, bound "
        f"{warp['bound_ms']:.4f} ms ({warp['bound_by']}: {nbytes / 1e6:.1f} "
        f"MB = output {(nbytes - src_bytes) / 1e6:.1f} MB + source footprint "
        f"{src_bytes / 1e6:.1f} MB); {100 * warp['bound_ms'] / warp['ms']:.1f}"
        f"% of the bound, {warp['ms'] / warp['library_ms']:.3f}x the time of "
        f"F.grid_sample")
    del images, pos, batch

    # -- the train CLI in a subprocess, one epoch ---------------------------
    out_dir = os.path.join(root, "res152")
    cmd = [sys.executable, os.path.abspath(__file__), "--cli-rank", out_dir,
           "rsgnet_tpu_torch.train",
           "--cfg", RES152_YAML, "--workers", "8", *opts, "OUTPUT_DIR",
           os.path.join(out_dir, "output"), "LOG_DIR",
           os.path.join(out_dir, "log"), "PRINT_FREQ", "1"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    cli_s = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise AssertionError(f"python -m rsgnet_tpu_torch.train (ResNet-152) "
                             f"exited {proc.returncode}:\n{text[-4000:]}")
    epochs = re.findall(r"epoch (\d+): loss (\S+) perf (\S+) best (\S+); "
                        r"(\d+) steps in (\S+) s, validate (\S+) s, "
                        r"checkpoint (\S+) s", text)
    launches = torch.load(os.path.join(out_dir, "cli_0.pt"),
                          weights_only=False)["launches"]
    run_dir = os.path.join(out_dir, "output", "coco", "pose_resnet",
                           "res152_384x288_d256x3_adam_lr1e-3")
    best_pt = os.path.join(run_dir, "model_best.pt")
    log(f"python -m rsgnet_tpu_torch.train ResNet-152 TRAIN.END_EPOCH 1: "
        f"exit 0 in {cli_s:.1f} s (interpreter start and init included); "
        + "; ".join(f"epoch {e[0]}: loss {e[1]} AP {e[2]}, {e[4]} steps in "
                    f"{e[5]} s, validate {e[6]} s, checkpoint {e[7]} s"
                    for e in epochs)
        + f"; shear_warp launches {launches['shear_warp']}, dark_decode "
        f"launches {launches['dark_decode']}; files "
        f"{sorted(os.listdir(run_dir))}")
    if (len(epochs) != 1 or not np.isfinite(float(epochs[0][1]))
            or not np.isfinite(float(epochs[0][2]))):
        raise AssertionError(f"the CLI's epoch lines: {epochs}")
    if not all(os.path.exists(os.path.join(run_dir, f))
               for f in ("checkpoint.pt", "model_best.pt")):
        raise AssertionError(f"the CLI wrote {os.listdir(run_dir)}")
    if launches != {"shear_warp": spe, "dark_decode": 0}:
        raise AssertionError(f"train CLI launches {launches}, expected the "
                             f"shear warp once per step ({spe}), DARK 0")

    # -- the bare train step at batch 32 ------------------------------------
    state = create_train_state(cfg, model, device="cuda")
    step_fn = make_train_step(cfg, train_ds.spec)
    raw = synthetic_train_batch(bs, CANVAS, seed=21)
    train_one_epoch(step_fn, state, [raw] * 2, seed=22)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = 6
    t0 = time.perf_counter()
    train_one_epoch(step_fn, state, [raw] * steps, seed=23)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    peak = torch.cuda.max_memory_allocated()
    log(f"[{card}] ResNet-152 train step, batch {bs} (host batch in, pinned "
        f"copy, augmentation, forward, backward, Adam): {1e3 * step_s:.2f} "
        f"ms = {bs / step_s:.1f} images/s (mean of {steps} steps); peak "
        f"device memory {peak / 2**30:.2f} GiB")
    draws = draw_augment(torch.Generator().manual_seed(24), bs)
    sbatch = {kk: torch.from_numpy(v) for kk, v in raw.items()}
    sbatch["image"] = sbatch["image"].to(dev)
    with torch.no_grad():
        fwd = forward_flops(torch, state.model.eval(), torch.zeros(
            1, 3, size[1], size[0], device=dev))
    n_kernels = profile_device(
        torch, lambda: step_fn(state, sbatch, draws), card, 3 * bs * fwd,
        f"one ResNet-152 train step at batch {bs} (forward "
        f"{fwd / 1e9:.2f} GFLOP per image; x3 for fwd+bwd)")
    del state, step_fn, model, sbatch
    torch.cuda.empty_cache()

    # -- the test CLI on model_best.pt; TEST.FOLD_BN ------------------------
    topts = opts + ["OUTPUT_DIR", os.path.join(out_dir, "test"), "LOG_DIR",
                    os.path.join(out_dir, "test_log"), "TEST.MODEL_FILE",
                    best_pt]
    t0 = time.perf_counter()
    dark_decode.launches = shear_warp.launches = 0
    name_value, ap = test_cli.main(["--cfg", RES152_YAML, "--workers", "8",
                                    *topts])
    torch.cuda.synchronize()
    test_launches = (dark_decode.launches, shear_warp.launches)
    log(f"python -m rsgnet_tpu_torch.test, ResNet-152 model_best.pt: "
        f"{time.perf_counter() - t0:.1f} s; AP table " + ", ".join(
            f"{k} {v:.4f}" for k, v in name_value.items())
        + f"; dark_decode launches {test_launches[0]}, shear_warp launches "
        f"{test_launches[1]}")
    if not all(np.isfinite(v) for v in name_value.values()) \
            or test_launches != (0, 0):
        raise AssertionError(f"ResNet-152 test CLI: {dict(name_value)}, "
                             f"launches {test_launches}")
    fold_err = fold_phase(torch, card, dev, load_config(
        RES152_YAML, overrides=opts_to_dict(opts)), best_pt)
    return {"warp": warp, "fit_launches": launches["shear_warp"],
            "best_pt": best_pt, "step_ms": 1e3 * step_s,
            "step_kernels": n_kernels, "peak_gib": peak / 2**30,
            "fold_err_px": float(fold_err)}


def crowdpose_phase(torch, card, root):
    """Phase 16: CrowdPose RSGNet-W48 @ 384x288 through ``validate`` at
    the YAML's batch 16, bf16, full width, on a synthetic CrowdPose set;
    ground truth through ``evaluate`` with device NMS."""
    from rsgnet_tpu_torch.config.defaults import load_config, opts_to_dict
    from rsgnet_tpu_torch.core.validate import validate
    from rsgnet_tpu_torch.data import get_dataset
    from rsgnet_tpu_torch.data.synthetic import write_synthetic_crowdpose
    from rsgnet_tpu_torch.models import get_pose_net, init_weights
    from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode
    from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp
    write_synthetic_crowdpose(root, n_images=CROWD_IMAGES)
    cfg = load_config(CROWD_YAML, overrides=opts_to_dict(
        ["DATASET.ROOT", root]))
    ds = get_dataset(cfg)
    bs = cfg.TEST.BATCH_SIZE_PER_GPU
    model = init_weights(get_pose_net(cfg), seed=0)
    if (cfg.DATASET.DATASET != "crowdpose" or cfg.MODEL.NUM_JOINTS != 14
            or bs != 16 or cfg.DTYPE != "bfloat16"
            or cfg.MODEL.EXTRA.STAGE2.NUM_CHANNELS[0] != 48):
        raise AssertionError("the CrowdPose YAML no longer evaluates W48 "
                             "bf16 with 14 joints at batch 16")
    t0 = time.perf_counter()
    dark_decode.launches = shear_warp.launches = 0
    name_value, ap = validate(cfg, ds, model, device="cuda")
    torch.cuda.synchronize()
    launches = (dark_decode.launches, shear_warp.launches)
    val_s = time.perf_counter() - t0
    splits = {}
    for rec in ds.db:
        ci = ds.coco.imgs[rec["image_id"]]["crowdIndex"]
        lbl = "easy" if ci < 0.1 else "medium" if ci < 0.8 else "hard"
        splits[lbl] = splits.get(lbl, 0) + 1
    log(f"CrowdPose: {CROWD_IMAGES} synthetic images, {len(ds)} instances "
        f"({splits}), RSGNet-W48 @ 384x288 bf16, batch {bs}: validate in "
        f"{val_s:.1f} s (build included), {len(ds) / val_s:.1f} instances/s; "
        f"table " + ", ".join(f"{k} {v:.4f}" for k, v in name_value.items())
        + f"; dark_decode launches {launches[0]}, shear_warp {launches[1]}")
    if list(name_value) != ds.STAT_KEYS or not all(
            np.isfinite(v) for v in name_value.values()):
        raise AssertionError(f"CrowdPose table {dict(name_value)}")
    n, k = len(ds), ds.num_joints
    gt = np.zeros((n, k, 3), np.float32)
    boxes = np.zeros((n, 6), np.float32)
    for i, rec in enumerate(ds.db):
        gt[i, :, :2] = rec["joints"][:, :2]
        gt[i, :, 2] = rec["joints_vis"][:, 0]
        boxes[i] = [*rec["center"], *rec["scale"],
                    np.prod(rec["scale"] * 200.0), rec["score"]]
    ids = np.array([rec["image_id"] for rec in ds.db])
    gt_nv, gt_ap = ds.evaluate(gt, boxes, ids, device="cuda")
    log(f"CrowdPose evaluate on GT keypoints, device NMS on the card: "
        + ", ".join(f"{k} {v:.6f}" for k, v in gt_nv.items()))
    if gt_ap != 1.0 or any(gt_nv[f"AP ({s})"] != 1.0 for s in splits):
        raise AssertionError(f"CrowdPose GT table {dict(gt_nv)}")
    return len(ds) / val_s


def mpii_phase(torch, card, root):
    """Phase 17: MPII HRNet-W32 @ 256x256 through the test CLI at full
    width on a synthetic MPII set; GT joints through ``evaluate``."""
    from rsgnet_tpu_torch import test as test_cli
    from rsgnet_tpu_torch.config.defaults import load_config, opts_to_dict
    from rsgnet_tpu_torch.data import get_dataset
    from rsgnet_tpu_torch.data.synthetic import write_synthetic_mpii
    from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode
    from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp
    write_synthetic_mpii(os.path.join(root, "data"), n_images=MPII_IMAGES)
    opts = ["DATASET.ROOT", os.path.join(root, "data"), "OUTPUT_DIR",
            os.path.join(root, "output"), "LOG_DIR",
            os.path.join(root, "log")]
    cfg = load_config(MPII_YAML, overrides=opts_to_dict(opts))
    ds = get_dataset(cfg)
    if (cfg.DATASET.DATASET != "mpii" or cfg.MODEL.NUM_JOINTS != 16
            or tuple(cfg.MODEL.IMAGE_SIZE) != (256, 256)
            or cfg.MODEL.EXTRA.STAGE2.NUM_CHANNELS[0] != 32):
        raise AssertionError("the MPII YAML no longer evaluates HRNet-W32 "
                             "at 256x256 with 16 joints")
    t0 = time.perf_counter()
    dark_decode.launches = shear_warp.launches = 0
    name_value, mean = test_cli.main(["--cfg", MPII_YAML, "--workers", "8",
                                      *opts])
    torch.cuda.synchronize()
    launches = (dark_decode.launches, shear_warp.launches)
    pred_mats = [os.path.join(d, f) for d, _, fs in
                 os.walk(os.path.join(root, "output")) for f in fs
                 if f == "pred.mat"]
    log(f"MPII: {MPII_IMAGES} synthetic images, {len(ds)} people, "
        f"HRNet-W32 @ 256x256 {cfg.DTYPE}: python -m rsgnet_tpu_torch.test "
        f"in {time.perf_counter() - t0:.1f} s; PCKh " + ", ".join(
            f"{k} {v:.4f}" for k, v in name_value.items())
        + f"; pred.mat {pred_mats}; dark_decode launches {launches[0]}, "
        f"shear_warp {launches[1]}")
    if (list(name_value)[-2:] != ["Mean", "Mean@0.1"]
            or not all(np.isfinite(v) for v in name_value.values())
            or len(pred_mats) != 1):
        raise AssertionError(f"MPII table {dict(name_value)}, pred.mat "
                             f"{pred_mats}")
    gt = np.stack([rec["joints"] for rec in ds.db]).astype(np.float32)
    gt_nv, gt_mean = ds.evaluate(
        gt, np.zeros((len(ds), 6), np.float32),
        np.array([rec["image_id"] for rec in ds.db]))
    log(f"MPII evaluate on GT joints: " + ", ".join(
        f"{k} {v:.6f}" for k, v in gt_nv.items()))
    if abs(gt_mean - 100.0) > 1e-5:
        raise AssertionError(f"MPII GT PCKh Mean {gt_mean}")
    return mean


def infer_phase(card, root, best_pt):
    """Phase 18: ``python -m rsgnet_tpu_torch.infer`` on the ResNet-152
    YAML with phase 15's model_best.pt, the demo image and an overlay."""
    png = os.path.join(root, "infer_overlay.png")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "rsgnet_tpu_torch.infer", "--cfg",
         RES152_YAML, "--ckpt", best_pt, "--demo", "--out", png],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"python -m rsgnet_tpu_torch.infer exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout[proc.stdout.index("["):])
    kps = np.array([[(j["x"], j["y"], j["score"]) for j in p["keypoints"]]
                    for p in out])
    log(f"python -m rsgnet_tpu_torch.infer --cfg <ResNet-152> --ckpt "
        f"model_best.pt --demo --out: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s; {len(out)} boxes x "
        f"{kps.shape[1]} keypoints, x in [{kps[..., 0].min():.1f}, "
        f"{kps[..., 0].max():.1f}], y in [{kps[..., 1].min():.1f}, "
        f"{kps[..., 1].max():.1f}]; overlay {os.path.getsize(png)} bytes")
    if kps.shape != (2, 17, 3) or not np.isfinite(kps).all():
        raise AssertionError(f"infer printed {kps.shape}")


# -- phases 19-23: data parallelism and the execution knobs ----------------


def _deterministic(torch):
    """Deterministic cuDNN and cuBLAS for the rest of the process, as a CLI
    sets them under ``CUDNN.DETERMINISTIC True CUDNN.BENCHMARK False``
    (the library functions never set them)."""
    from rsgnet_tpu_torch.config.defaults import load_config, opts_to_dict
    from rsgnet_tpu_torch.core.inference import configure_cudnn
    configure_cudnn(load_config(overrides=opts_to_dict(DETERMINISTIC_OPTS)))


def free_port():
    """A free TCP port on 127.0.0.1 for a process group's rendezvous."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_ranks(mode, args, workdir, world=DP_WORLD, timeout=600):
    """Run ``world`` processes of ``python3 chip_smoke.py --dp-worker MODE
    ARGS`` with torchrun's environment on a free localhost port: rank r is
    LOCAL_RANK r, so under NCCL (``args["backend"]``) it computes on card r,
    and over gloo on card r modulo the cards (all on card 0 of one card).
    As torchrun does, each rank gets OMP_NUM_THREADS=1 unless it is set. A
    rank that fails, or the time running out, kills the others and fails
    the phase. Returns (each rank's result, each rank's output, wall
    seconds)."""
    import torch
    port = free_port()
    args_path = os.path.join(workdir, f"{mode}_args.json")
    with open(args_path, "w") as f:
        json.dump(args, f)
    procs, logs = [], []
    t0 = time.perf_counter()
    for r in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        env.setdefault("OMP_NUM_THREADS", "1")
        logs.append(open(os.path.join(workdir, f"{mode}_{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-worker", mode,
             args_path], stdout=logs[-1], stderr=subprocess.STDOUT, env=env,
            cwd=ROOT))
    log(f"--dp-worker {mode}: {world} ranks, OMP_NUM_THREADS="
        f"{env['OMP_NUM_THREADS']} each, backend "
        f"{args.get('backend', 'gloo')}")
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    texts = []
    for r in range(world):
        with open(os.path.join(workdir, f"{mode}_{r}.log")) as f:
            texts.append(f.read())
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"--dp-worker {mode}: exit codes "
                             f"{[p.returncode for p in procs]}\n" + "\n".join(
                                 f"--- rank {r}\n{t[-3000:]}"
                                 for r, t in enumerate(texts)))
    results = [torch.load(os.path.join(workdir, f"{mode}_{r}.pt"),
                          weights_only=False) for r in range(world)]
    return results, texts, wall


def first_step_guard():
    """A ``PreemptionGuard`` that stops ``fit`` before its second step."""
    from rsgnet_tpu_torch.core.function import PreemptionGuard

    class FirstStep(PreemptionGuard):
        def should_stop(self, step):
            return step >= 1

    return FirstStep()


def step_gaps(torch, a, b, model):
    """How far state ``a`` lies from state ``b`` (``_state_cpu``), as
    relative gaps ||a - b|| / ||b|| over all tensors together: exp_avg,
    exp_avg_sq and the BatchNorm statistics' moves from their start in
    ``model``; and the worst single tensor of each kind, by name."""
    names = [n for n, _ in model.named_parameters()]
    start = model.state_dict()
    sums = {k: [0.0, 0.0] for k in ("exp_avg", "exp_avg_sq", "stats")}
    worst = {"moment": (0.0, ""), "stat": (0.0, "")}

    def add(kind, slot, ta, tb, name):
        d2, b2 = float(((ta - tb) ** 2).sum()), float((tb ** 2).sum())
        sums[kind][0] += d2
        sums[kind][1] += b2
        g = (d2 / max(b2, 1e-300)) ** 0.5
        if g > worst[slot][0]:
            worst[slot] = (g, name)

    for i in b["optimizer"]:
        for k in ("exp_avg", "exp_avg_sq"):
            add(k, "moment", a["optimizer"][i][k].double(),
                b["optimizer"][i][k].double(), f"{names[i]} {k}")
    for k, tb in b["model"].items():
        if k.endswith(("running_mean", "running_var")):
            s0 = start[k].double()
            add("stats", "stat", a["model"][k].double() - s0,
                tb.double() - s0, k)
    gaps = {k: (d2 / b2) ** 0.5 for k, (d2, b2) in sums.items()}
    gaps.update(worst)
    return gaps


def _state_cpu(state):
    return {"model": {k: v.detach().cpu().clone()
                      for k, v in state.model.state_dict().items()},
            "optimizer": {i: {k: v.detach().cpu().clone()
                              for k, v in s.items() if hasattr(v, "cpu")}
                          for i, s in state.optimizer.state_dict()
                          ["state"].items()},
            "step": state.step}


def _fit_stats_logger(name):
    import logging
    stats = []

    class Stats(logging.Handler):
        def emit(self, record):
            if hasattr(record, "epoch_stats"):
                stats.append(record.epoch_stats)

    logger = logging.getLogger(name)
    logger.handlers.clear()
    logger.propagate = False
    logger.setLevel(logging.INFO)
    logger.addHandler(Stats())
    return logger, stats


def collective_probe(torch, rank, world):
    """The main group's ``all_reduce`` and ``broadcast`` on CUDA tensors in
    fp32 and fp64 (gloo stages them through the host; NCCL runs them on
    the cards): raises unless every rank gets the sum and rank 0's
    values."""
    want = float(world * (world + 1) // 2)
    for dtype in (torch.float32, torch.float64):
        x = torch.full((3,), float(rank + 1), device="cuda", dtype=dtype)
        torch.distributed.all_reduce(x)
        y = torch.full((3,), float(rank + 7), device="cuda", dtype=dtype)
        torch.distributed.broadcast(y, 0)
        if (x.device.type != "cuda" or x.tolist() != [want] * 3
                or y.tolist() != [7.0] * 3):
            raise AssertionError(f"{torch.distributed.get_backend()} "
                                 f"all_reduce / broadcast of {dtype} on "
                                 f"the card: {x}, {y}")


def dp_worker(mode, args_path):
    """One rank of phases 19-20 and 33a (``--dp-worker``): the process group
    over ``args["backend"]`` ("gloo": ranks sharing the card; "nccl": a card
    each, with ``args["timeout"]``), then ``fit`` (mode "fit") or the test
    CLI (mode "test"); the result goes to ``<workdir>/<mode>_<rank>.pt``."""
    import torch
    sys.path.insert(0, ROOT)
    from rsgnet_tpu_torch.core import validate as tval
    from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode
    from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp
    from rsgnet_tpu_torch.parallel.distributed import (all_reduce_sum,
                                                       average_gradients,
                                                       initialize_distributed,
                                                       process_count,
                                                       process_index,
                                                       shutdown_distributed)
    from rsgnet_tpu_torch.utils import checkpoint as ckpt_io
    with open(args_path) as f:
        args = json.load(f)
    backend = args.get("backend", "gloo")
    _deterministic(torch)
    if not initialize_distributed(backend=backend, device="cuda",
                                  timeout=args.get("timeout")):
        raise RuntimeError("no launcher environment")
    rank, world = process_index(), process_count()
    out = {"rank": rank, "card": torch.cuda.current_device(),
           "backend": torch.distributed.get_backend(),
           "omp_threads": os.environ.get("OMP_NUM_THREADS")}
    done = False
    try:
        collective_probe(torch, rank, world)
        if mode == "fit":
            from rsgnet_tpu_torch.config.defaults import (load_config,
                                                          opts_to_dict)
            from rsgnet_tpu_torch.core.function import fit
            from rsgnet_tpu_torch.data import get_dataset
            from rsgnet_tpu_torch.models import get_pose_net, init_weights
            from rsgnet_tpu_torch.models.hrnet import BatchNorm
            cfg = load_config(W32_YAML, overrides=opts_to_dict(args["opts"]))
            train_ds = get_dataset(cfg, is_train=True)
            val_ds = get_dataset(cfg, is_train=False)
            model = init_weights(get_pose_net(cfg), seed=0)
            logger, stats = _fit_stats_logger("chip_smoke.dp_fit")
            losses, restore = step_metrics()
            writes, write_payload = [], ckpt_io._write_payload

            def counted(out_dir, payload, is_best):
                writes.append(payload["epoch"])
                return write_payload(out_dir, payload, is_best)

            ckpt_io._write_payload = counted
            shear_warp.launches = dark_decode.launches = 0  # main path starts
            try:
                state, best = fit(cfg, model, train_ds, val_ds,
                                  output_dir=args["out"], logger=logger,
                                  num_workers=4, device="cuda")
            finally:
                restore()
                ckpt_io._write_payload = write_payload
            torch.cuda.synchronize()
            out["launches"] = {"shear_warp": shear_warp.launches,
                               "dark_decode": dark_decode.launches}  # ends
            out.update(_state_cpu(state), losses=losses, best=best,
                       stats=stats, writes=writes)
            if backend == "nccl":
                out["probes"] = nccl_step_probes(torch, cfg, state, rank)
            # the collectives of a step, timed alone on this run's tensors
            params = list(state.model.parameters())
            out["grad_bytes"] = sum(p.grad.numel() * 4 for p in params)
            walls = []
            for _ in range(4):
                torch.cuda.synchronize()
                t = time.perf_counter()
                average_gradients(params)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
            out["grad_allreduce_s"] = walls[1:]
            widths = [m.weight.numel() for m in state.model.modules()
                      if isinstance(m, BatchNorm)]
            stat = torch.zeros(2 * max(widths) + 1, device="cuda",
                               dtype=torch.float64)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(50):
                all_reduce_sum(stat)
            torch.cuda.synchronize()
            out["bn_allreduce_s"] = (time.perf_counter() - t) / 50
            out["n_bn"] = len(widths)
            # the state after one fp32 step from the same weights, held
            # against one process's: the Adam moments follow the averaged
            # gradient. The stop after it is asked for on ``stop_rank``
            # alone when the args name one, else on every rank
            del state, params
            cfg.DTYPE = "float32"
            stop_rank = args.get("stop_rank")
            state, _ = fit(cfg, init_weights(get_pose_net(cfg), seed=0),
                           train_ds, None, output_dir=args["out"] + "_step1",
                           num_workers=4, device="cuda",
                           preempt_guard=first_step_guard()
                           if stop_rank in (None, rank) else None)
            out["step1"] = _state_cpu(state)
        elif mode == "test":
            from rsgnet_tpu_torch import test as test_cli
            captured = {}
            evaluate = tval._evaluate_and_log

            def capture(dataset, preds, boxes, ids, *rest):
                captured.update(preds=preds, boxes=boxes, ids=ids)
                return evaluate(dataset, preds, boxes, ids, *rest)

            tval._evaluate_and_log = capture
            t = time.perf_counter()
            shear_warp.launches = dark_decode.launches = 0  # main path starts
            name_value, ap = test_cli.main(args["argv"])
            torch.cuda.synchronize()
            out["launches"] = {"shear_warp": shear_warp.launches,
                               "dark_decode": dark_decode.launches}  # ends
            out.update(captured, name_value=dict(name_value), ap=ap,
                       wall_s=time.perf_counter() - t)
            print("AP_TABLE " + json.dumps(out["name_value"]), flush=True)
        else:
            raise ValueError(mode)
        torch.save(out, os.path.join(args["workdir"], f"{mode}_{rank}.pt"))
        done = True
    finally:
        shutdown_distributed(wait=done)
    return 0


def steady_step_s(torch, step_fn, state, raw, steps):
    """Mean wall of ``steps`` train steps over the repeated raw batch
    ``raw`` after two warm ones, through ``train_one_epoch`` as ``fit``
    runs it (host batch in, pinned copy, augmentation, forward, backward,
    Adam and, in a process group, its collectives and the stop sync)."""
    from rsgnet_tpu_torch.core.function import train_one_epoch
    from rsgnet_tpu_torch.parallel.distributed import is_distributed
    sync = is_distributed()
    train_one_epoch(step_fn, state, [raw] * 2, seed=10, stop_sync=sync)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_one_epoch(step_fn, state, [raw] * steps, seed=11, stop_sync=sync)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps


def _busy_us(events):
    """Union of the events' device intervals, in µs."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def nccl_step_probes(torch, cfg, state, rank):
    """Phase 33a's step measurements on one rank, on its state after
    ``fit``: the mean wall of ``NCCL_STEADY_STEPS`` steps over a repeated
    synthetic raw batch of its 32 rows (``steady_step_s``); every
    collective of one more step, recorded as (call, group, dtype,
    elements) by wrapping ``torch.distributed``'s calls; and on rank 0 a
    torch.profiler trace of that step, whose NCCL kernels are matched in
    order to the main group's collectives (the gradient all-reduce is the
    fp32 one of the most elements, the BatchNorm ones are fp64, the
    metrics' the other fp32)."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rsgnet_tpu_torch.core.function import train_one_epoch
    from rsgnet_tpu_torch.core.train import make_train_step
    from rsgnet_tpu_torch.data.skeletons import get_spec
    from rsgnet_tpu_torch.data.synthetic import synthetic_train_batch
    from rsgnet_tpu_torch.parallel.distributed import host_group
    raw = synthetic_train_batch(cfg.TRAIN.BATCH_SIZE_PER_GPU, CANVAS,
                                seed=20 + rank)
    step_fn = make_train_step(cfg, get_spec("coco"))
    out = {"step_s": steady_step_s(torch, step_fn, state, raw,
                                   NCCL_STEADY_STEPS)}
    calls, real = [], {name: getattr(dist, name) for name in
                       ("all_reduce", "broadcast", "all_gather", "barrier")}

    def recording(name, fn):
        def call(*args, **kw):
            t = args[0] if args and torch.is_tensor(args[0]) else None
            group = kw.get("group")
            calls.append((name, "host" if group is not None
                          and group is host_group() else "main",
                          None if t is None else str(t.dtype)[6:],
                          0 if t is None else t.numel()))
            return fn(*args, **kw)
        return call

    for name, fn in real.items():
        setattr(dist, name, recording(name, fn))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) if rank == 0 \
                else contextlib.nullcontext() as prof:
            t0 = time.perf_counter()
            train_one_epoch(step_fn, state, [raw], seed=31, stop_sync=True)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
    out["collectives"] = calls
    if rank != 0:
        return out
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    nccl = sorted((e for e in kernels if "nccl" in e.name.lower()),
                  key=lambda e: e.time_range.start)
    main = [c for c in calls if c[1] == "main"]
    grad_n = max((c[3] for c in main if c[2] == "float32"), default=0)
    by_kind = {}
    if len(nccl) == len(main):
        for e, c in zip(nccl, main):
            kind = ("batchnorm" if c[2] == "float64" else "gradient"
                    if c[3] == grad_n else "metrics")
            n, us = by_kind.get(kind, (0, 0.0))
            by_kind[kind] = (n + 1, us + e.time_range.end
                             - e.time_range.start)
    out["profile"] = {
        "wall_us": wall_us, "kernels": len(kernels),
        "kernel_us": sum(e.time_range.end - e.time_range.start
                         for e in kernels),
        "busy_us": _busy_us(kernels) if kernels else 0.0,
        "nccl": len(nccl), "nccl_us": sum(e.time_range.end
                                          - e.time_range.start
                                          for e in nccl),
        "nccl_busy_us": _busy_us(nccl) if nccl else 0.0,
        "by_kind": by_kind, "names": sorted({e.name[:60] for e in nccl})}
    return out


def ranks_equal(torch, a, b):
    """Two ranks' results of ``--dp-worker fit``: weights, BatchNorm
    statistics, Adam moments and per-step metrics bitwise equal."""
    return (a["losses"] == b["losses"] and all(
        torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
        and all(torch.equal(a["optimizer"][i][k], b["optimizer"][i][k])
                for i in a["optimizer"] for k in a["optimizer"][i]))


def dp_fit_phase(torch, card, dev, root, world=DP_WORLD, backend="gloo",
                 epochs=DP_EPOCHS):
    """Phase 19 (two ranks sharing the card over gloo) and phase 33a
    (``world`` ranks over NCCL, a card each): RSGNet-W32 @ 256x192 through
    ``fit`` (batch 32 a rank, ``epochs`` epochs over ``root``'s set,
    validating through ``validate_distributed``), against one process at
    the global batch from the same weights and draws. Under NCCL the stop
    after the fp32 step is asked for on the last rank alone, each rank must
    sit on its own card, and ``nccl_step_report`` follows. Returns the
    shear warp's launches per rank."""
    from rsgnet_tpu_torch.config.defaults import load_config, opts_to_dict
    from rsgnet_tpu_torch.core.function import fit
    from rsgnet_tpu_torch.data import get_dataset
    from rsgnet_tpu_torch.models import get_pose_net, init_weights
    from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode
    from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp

    work = os.path.join(root, f"dp_{backend}")
    os.makedirs(work, exist_ok=True)
    opts = ["DATASET.ROOT", root, "DATASET.TRAIN_SET", "val",
            "DATASET.TEST_SET", "val", "TRAIN.END_EPOCH", str(epochs),
            "PRINT_FREQ", "1000"]
    cfg = load_config(W32_YAML, overrides=opts_to_dict(opts))
    per_rank = cfg.TRAIN.BATCH_SIZE_PER_GPU
    train_ds = get_dataset(cfg, is_train=True)
    steps = epochs * (len(train_ds) // (per_rank * world))
    args = {"opts": opts, "out": os.path.join(work, "ranks"),
            "workdir": work, "backend": backend}
    if backend == "nccl":
        args.update(timeout=NCCL_TIMEOUT_S, stop_rank=world - 1)
    where = ("sharing the card over gloo" if backend == "gloo" else
             "over NCCL, a card each")
    torch.cuda.empty_cache()
    ranks, texts, wall = spawn_ranks(
        "fit", args, work, world=world,
        timeout=600 if backend == "gloo" else NCCL_CLI_TIMEOUT_S)
    r0 = ranks[0]
    same = all(ranks_equal(torch, r0, r) for r in ranks[1:])
    log(f"fit on {world} ranks {where}, W32 batch {per_rank} a rank (global "
        f"{per_rank * world}), {epochs} epoch(s): {wall:.1f} s for the "
        f"{world} processes (start-up, build load, validation included); "
        f"backend {r0['backend']}, cards " + ", ".join(
            f"rank {r['rank']} -> card {r['card']}" for r in ranks)
        + f"; steps {r0['step']}; per-step global loss " + ", ".join(
            f"{x[1]:.6f}" for x in r0["losses"]) + "; launches " + ", ".join(
            f"rank {r['rank']} {r['launches']}" for r in ranks)
        + f"; checkpoint writes per rank {[len(r['writes']) for r in ranks]}"
        f"; weights, BatchNorm statistics, Adam moments and per-step metrics "
        f"of the {world} ranks bitwise equal: {same}; best AP " + " / ".join(
            f"{r['best']:.4f}" for r in ranks))
    if not same or r0["step"] != steps:
        raise AssertionError(f"the ranks differ ({same}) or ran "
                             f"{r0['step']} steps, not {steps}")
    for r in ranks:
        if r["launches"] != {"shear_warp": steps, "dark_decode": 0}:
            raise AssertionError(f"rank {r['rank']}: launches "
                                 f"{r['launches']}, expected the shear warp "
                                 f"once per step ({steps}) and no DARK")
        if r["backend"] != backend:
            raise AssertionError(f"rank {r['rank']} ran {r['backend']}")
        if backend == "nccl" and r["card"] != r["rank"]:
            raise AssertionError(f"rank {r['rank']} computed on card "
                                 f"{r['card']}")
        if bool(r["writes"]) != (r["rank"] == 0):
            raise AssertionError(f"rank {r['rank']} wrote checkpoints of "
                                 f"epochs {r['writes']}")
    files = sorted(os.listdir(args["out"]))
    if not {"checkpoint.pt", "model_best.pt"} <= set(files):
        raise AssertionError(f"rank 0 wrote {files}")
    stopped = [r["step1"]["step"] for r in ranks]
    log(f"the fp32 run with a stop asked for on "
        f"{'every rank' if backend == 'gloo' else f'rank {world - 1} alone'}"
        f" before step 1: the ranks stopped after steps {stopped}")
    if stopped != [1] * world:
        raise AssertionError(f"the ranks stopped after steps {stopped}")

    # one process at the global batch, same weights and draws
    one_cfg = copy.deepcopy(cfg)
    one_cfg.TRAIN.BATCH_SIZE_PER_GPU = per_rank * world
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    _deterministic(torch)
    losses, restore = step_metrics()
    try:
        shear_warp.launches = dark_decode.launches = 0
        state, _ = fit(one_cfg, init_weights(get_pose_net(one_cfg), seed=0),
                       train_ds, get_dataset(one_cfg, is_train=False),
                       output_dir=os.path.join(work, "one"), num_workers=4,
                       device="cuda")
        torch.cuda.synchronize()
        one_launches = shear_warp.launches
        restore()
        one = _state_cpu(state)
        del state
        one_cfg.DTYPE = "float32"
        state, _ = fit(one_cfg, init_weights(get_pose_net(one_cfg), seed=0),
                       train_ds, None,
                       output_dir=os.path.join(work, "one_step1"),
                       num_workers=4, device="cuda",
                       preempt_guard=first_step_guard())
        one_step1 = _state_cpu(state)
        del state
        if backend == "nccl":
            nccl_step_report(torch, card, dev, cfg, ranks)
    finally:
        restore()
        torch.use_deterministic_algorithms(False)
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    torch.cuda.empty_cache()
    rel = [abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(r0["losses"], losses)]
    lr = cfg.TRAIN.LR
    weights = max(float((a.double() - one["model"][k].double()).abs().max())
                  for k, a in r0["model"].items()
                  if a.is_floating_point() and not k.endswith(
                      ("running_mean", "running_var")))
    first = step_gaps(torch, r0["step1"], one_step1,
                      init_weights(get_pose_net(cfg), seed=0))
    log(f"one process at batch {per_rank * world}, same weights and "
        f"draws: per-step loss " + ", ".join(f"{x[1]:.6f}" for x in losses)
        + f"; |{world} ranks - one| / one per step " + ", ".join(
            f"{x:.2e}" for x in rel) + f"; weights after {steps} steps "
        f"{weights / lr:.2f} x lr apart; shear_warp launches {one_launches}"
        f". After one fp32 step from the same weights, ||{world} ranks - one||"
        f" / ||one|| over all tensors: exp_avg {first['exp_avg']:.3e}, "
        f"exp_avg_sq {first['exp_avg_sq']:.3e}, the BatchNorm statistics' "
        f"moves {first['stats']:.3e}; worst tensor: moment "
        f"{first['moment'][0]:.3e} ({first['moment'][1]}), statistic "
        f"{first['stat'][0]:.3e} ({first['stat'][1]})")
    # tolerances: the first step runs the same weights on the same samples,
    # where batch 32 and the global batch may pick other cuDNN algorithms.
    # Adam moves each weight by about lr a step whatever its gradient, so
    # the weights can part by about 2 x lr a step (held at 3 x lr a step)
    # and say little of the gradient. After the first step exp_avg is 0.1 x
    # the averaged gradient and the statistics have moved once from their
    # start, so those are held, in fp32: in bf16 the gradients of this
    # random-weight model part by ~44% between batch 32 x 2 and 64 on the
    # H100, too close to the 100% of a gradient summed, not averaged
    if rel[0] > 1e-3 or max(rel) > 5e-2:
        raise AssertionError(f"{world} ranks vs one process: loss gaps {rel}")
    if weights > 3 * lr * steps:
        raise AssertionError(f"{world} ranks vs one process: weights part by "
                             f"{weights}")
    if (first["exp_avg"] > DP_MOMENT_TOL or first["exp_avg_sq"]
            > DP_MOMENT_TOL or first["stats"] > DP_STATS_TOL):
        raise AssertionError(f"{world} ranks vs one process after the first "
                             f"step: {first}")
    if one_launches != steps:
        raise AssertionError(f"one process: shear_warp launches "
                             f"{one_launches} != {steps}")

    # where a rank's step goes: the step wall inside fit against the
    # collectives timed alone
    def fit_step_s(r):
        warm = [s for s in r["stats"] if s["epoch"] > 0] or r["stats"]
        return sum(s["train_s"] for s in warm) / max(
            sum(s["steps"] for s in warm), 1)

    step_s = fit_step_s(r0)
    grad_s = float(np.mean(r0["grad_allreduce_s"]))
    bn_s = r0["bn_allreduce_s"] * r0["n_bn"] * 2
    log(f"[{card}] {world} ranks {where}, W32 batch {per_rank} a rank: wall "
        f"per step inside fit (epochs after the first, else the first with "
        f"its warm-up; loader and validation excluded) "
        + ", ".join(f"rank {r['rank']} {1e3 * fit_step_s(r):.1f} ms"
                    for r in ranks)
        + f"; the gradient all-reduce ({r0['grad_bytes'] / 1e6:.1f} MB fp32"
        f"{' through the host' if backend == 'gloo' else ''}) timed alone "
        f"{1e3 * grad_s:.3f} ms = {100 * grad_s / step_s:.1f}% of the step; "
        f"{r0['n_bn']} BatchNorm all-reduces forward and as many backward at "
        f"{1e3 * r0['bn_allreduce_s']:.3f} ms each = {1e3 * bn_s:.1f} ms = "
        f"{100 * bn_s / step_s:.1f}% of the step; validation per epoch "
        + ", ".join(f"{s['validate_s']:.2f} s" for s in r0["stats"]))
    return [r["launches"]["shear_warp"] for r in ranks]


def nccl_step_report(torch, card, dev, cfg, ranks):
    """Phase 33a's step lines from the ranks' ``nccl_step_probes``: each
    rank's steady step wall and the images/s of all ranks beside one
    process's steady step at the same batch a rank on card 0 (timed here,
    deterministic cuDNN as the ranks); rank 0's profile of one step (the
    NCCL kernels' count and device time, the gradient all-reduce, the
    BatchNorm and the metrics all-reduces apart, their share of the step);
    and the step's collectives and elements against the parameter count,
    the counterpart of ``__graft_entry__.py::_flagship_aot_check``'s line.
    Holds one gradient all-reduce of the parameter count's fp32 elements
    a step."""
    from rsgnet_tpu_torch.core.train import (create_train_state,
                                             make_train_step)
    from rsgnet_tpu_torch.data.skeletons import get_spec
    from rsgnet_tpu_torch.data.synthetic import synthetic_train_batch
    from rsgnet_tpu_torch.models import get_pose_net, init_weights
    world, bs = len(ranks), cfg.TRAIN.BATCH_SIZE_PER_GPU
    model = init_weights(get_pose_net(cfg), seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    state = create_train_state(cfg, model, device=dev)
    one_s = steady_step_s(torch, make_train_step(cfg, get_spec("coco")),
                          state, synthetic_train_batch(bs, CANVAS, seed=20),
                          NCCL_STEADY_STEPS)
    del state, model
    walls = [r["probes"]["step_s"] for r in ranks]
    log(f"[{card}] x {world}, W32 batch {bs} a rank, deterministic cuDNN, "
        f"mean of {NCCL_STEADY_STEPS} steps after 2 warm: step wall "
        + ", ".join(f"rank {r['rank']} {1e3 * w:.1f} ms"
                    for r, w in zip(ranks, walls))
        + f" = {world * bs / max(walls):.1f} images/s over the {world} "
        f"ranks (the slowest rank paces them); one process alone at batch "
        f"{bs} on card 0 {1e3 * one_s:.1f} ms = {bs / one_s:.1f} images/s; "
        f"{world} ranks give {one_s * world / max(walls):.2f}x one card's "
        f"images/s ({100 * one_s / max(walls):.1f}% scaling efficiency); "
        f"OMP_NUM_THREADS per rank {ranks[0]['omp_threads']}")
    p = ranks[0]["probes"]["profile"]
    if not p["kernels"]:
        log(f"[{card}] profile of one step on rank 0: no device events "
            f"(the NCCL kernels' time not measured)")
    else:
        kinds = "; ".join(f"{k} {n} kernels {us / 1e3:.3f} ms "
                          f"({100 * us / p['wall_us']:.1f}% of the step)"
                          for k, (n, us) in sorted(p["by_kind"].items()))
        log(f"[{card}] profile of one step on rank 0 (train_one_epoch, stop"
            f" sync on): wall {p['wall_us'] / 1e3:.2f} ms, {p['kernels']} "
            f"kernels, device busy {p['busy_us'] / 1e3:.2f} ms "
            f"({100 * p['busy_us'] / p['wall_us']:.1f}%), kernel time "
            f"{p['kernel_us'] / 1e3:.2f} ms; NCCL: {p['nccl']} kernels, "
            f"{p['nccl_us'] / 1e3:.3f} ms "
            f"({100 * p['nccl_us'] / p['wall_us']:.1f}% of the step wall, "
            f"{100 * p['nccl_us'] / p['kernel_us']:.1f}% of kernel time; "
            f"their union {p['nccl_busy_us'] / 1e3:.3f} ms); "
            + (kinds or "the NCCL kernels do not match the main group's "
               "collectives one to one, so no split")
            + f"; kernel names {p['names']}")
    calls = ranks[0]["probes"]["collectives"]
    groups = {}
    for name, group, dtype, n in calls:
        c, e = groups.get((group, name, dtype), (0, 0))
        groups[(group, name, dtype)] = (c + 1, e + n)
    main_elems = sum(n for _, group, _, n in calls if group == "main")
    log(f"[{card}] collectives of one step on rank 0: " + "; ".join(
        f"{group} group {name} {dtype}: {c} calls, {e:,} elements"
        for (group, name, dtype), (c, e) in sorted(groups.items()))
        + f"; the main group's {sum(1 for c in calls if c[1] == 'main')} "
        f"calls move {main_elems:,} elements = "
        f"{main_elems / n_params:.3f}x the {n_params:,} parameters (the JAX "
        f"package's W32 step on a mesh: 513 all-reduces, 1.003x the "
        f"parameter volume, __graft_entry__.py::_flagship_aot_check)")
    grads = [c for c in calls if c[1] == "main" and c[2] == "float32"
             and c[3] == n_params]
    if len(grads) != 1:
        raise AssertionError(f"one step made {len(grads)} gradient "
                             f"all-reduces of {n_params} elements: {groups}")


def remat_phase(torch, card, dev):
    """Phase 21: TRAIN.REMAT on the RSGNet-W48 @ 384x288 train step at
    batch 32, one process, deterministic cuDNN: the loss, every gradient
    and every running statistic after one step with and without the knob;
    peak device memory and step wall of each; the BatchNorm layers whose
    statistics all-reduce a data-parallel recompute repeats."""
    from rsgnet_tpu_torch.config.defaults import load_config
    from rsgnet_tpu_torch.core.train import create_train_state, make_train_step
    from rsgnet_tpu_torch.data.augment import draw_augment
    from rsgnet_tpu_torch.data.skeletons import get_spec
    from rsgnet_tpu_torch.data.synthetic import synthetic_train_batch
    from rsgnet_tpu_torch.models import get_pose_net, init_weights
    from rsgnet_tpu_torch.models.hrnet import BatchNorm, HighResolutionModule

    cfg = load_config(W48_YAML)
    bs = cfg.TRAIN.BATCH_SIZE_PER_GPU = 32
    model = init_weights(get_pose_net(cfg), seed=0)
    start = model.state_dict()
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    n_remat = sum(isinstance(m, BatchNorm) for h in model.modules()
                  if isinstance(h, HighResolutionModule)
                  for m in h.modules())
    raw = synthetic_train_batch(bs, CANVAS, seed=21)
    draws = draw_augment(torch.Generator().manual_seed(22), bs)
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    _deterministic(torch)
    res = {}
    try:
        for remat in (False, True):
            c = copy.deepcopy(cfg)
            c.TRAIN.REMAT = remat
            model = get_pose_net(c)
            model.load_state_dict(start)
            state = create_train_state(c, model, device="cuda")
            step = make_train_step(c, get_spec(c.DATASET.DATASET))
            batch = {k: torch.from_numpy(v) for k, v in raw.items()}
            batch["image"] = batch["image"].to(dev)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            state, metrics = step(state, batch, draws)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            grads = {k: p.grad.detach().clone()
                     for k, p in state.model.named_parameters()}
            stats = {k: v.detach().clone()
                     for k, v in state.model.named_buffers()}
            walls = []
            for _ in range(3):
                t = time.perf_counter()
                step(state, batch, draws)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
            res[remat] = (float(metrics["loss"]), grads, stats, peak, walls)
            del state, step, model, batch
    finally:
        torch.use_deterministic_algorithms(False)
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    (l0, g0, s0, p0, w0), (l1, g1, s1, p1, w1) = res[False], res[True]
    g_bit = all(torch.equal(g0[k], g1[k]) for k in g0)
    s_bit = all(torch.equal(s0[k], s1[k]) for k in s0)
    g_rel = max(float((g0[k] - g1[k]).abs().max())
                / max(float(g0[k].abs().max()), 1e-30) for k in g0)
    s_rel = max(float((s0[k] - s1[k]).abs().max())
                / max(float(s0[k].abs().max()), 1e-30) for k in s0)
    log(f"[{card}] TRAIN.REMAT on the W48 @ 384x288 train step, batch {bs}, "
        f"deterministic cuDNN: loss {l0:.6f} without, {l1:.6f} with; "
        f"gradients bitwise equal {g_bit} (max rel diff {g_rel:.2e}), "
        f"running statistics after the step bitwise equal {s_bit} (max rel "
        f"{s_rel:.2e}); peak device memory {p0 / 2**30:.2f} GiB without, "
        f"{p1 / 2**30:.2f} GiB with; step wall " + ", ".join(
            f"{1e3 * x:.1f}" for x in w0) + " ms without, " + ", ".join(
            f"{1e3 * x:.1f}" for x in w1) + " ms with; under data "
        f"parallelism the recompute repeats the statistics all-reduce of "
        f"{n_remat} of the {n_bn} BatchNorm layers: {2 * n_bn + n_remat} "
        f"all-reduces a step instead of {2 * n_bn}")
    if l0 != l1 or g_rel > 1e-5 or s_rel > 1e-6:
        raise AssertionError(f"REMAT changes the step: loss {l0} vs {l1}, "
                             f"grads {g_rel}, statistics {s_rel}")
    if p1 >= p0:
        raise AssertionError(f"REMAT did not lower peak memory ({p1} >= "
                             f"{p0})")
    torch.cuda.empty_cache()


def _float64(torch, model):
    """A float64 copy of ``model``: every parameter, buffer and cast layer
    (the exact reference of phases 22-23)."""
    model = copy.deepcopy(model).double()
    for mod in model.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    return model


def _rel_errors(torch, got, exact):
    """Per tensor: max |got - exact| over max |exact|."""
    return [float((got[k].double() - exact[k]).abs().max())
            / max(float(exact[k].abs().max()), 1e-30) for k in exact]


def fuse_phase(torch, card, dev):
    """Phase 22: MODEL.FUSE_MERGED on the W48 bucket-32 inference call
    (kernels per call in bf16) and on the W32 train step (kernels per step
    in bf16); in fp32, the merged and the unmerged model each against the
    exact (fp64) one: W48 heatmaps at batch 2, and a W32 train forward and
    backward at batch 8 (loss, gradients, running statistics). The merged
    path must be as accurate as the unmerged one (within three times its
    error + 1e-6 of the scale: one sample's largest error varies): on these deep random-weight models fp32 rounding
    alone moves the heatmaps by ~1e-3 of their scale, so the JAX test's
    2e-5 between the two paths (a tiny model) does not carry over."""
    from rsgnet_tpu_torch.config.defaults import load_config
    from rsgnet_tpu_torch.core.inference import make_inference_fn
    from rsgnet_tpu_torch.core.loss import make_loss
    from rsgnet_tpu_torch.core.train import create_train_state, make_train_step
    from rsgnet_tpu_torch.data.augment import augment_from_draws, draw_augment
    from rsgnet_tpu_torch.data.skeletons import get_spec
    from rsgnet_tpu_torch.data.synthetic import synthetic_train_batch
    from rsgnet_tpu_torch.models import get_pose_net, init_weights

    def pair(yaml_path, dtype=None):
        cfg = load_config(yaml_path)
        if dtype:
            cfg.DTYPE = dtype
        merged_cfg = copy.deepcopy(cfg)
        merged_cfg.MODEL.FUSE_MERGED = True
        plain = init_weights(get_pose_net(cfg), seed=0)
        merged = get_pose_net(merged_cfg)
        merged.load_state_dict(plain.state_dict())
        if list(merged.state_dict()) != list(plain.state_dict()):
            raise AssertionError("FUSE_MERGED changes the state dict")
        return (cfg, plain), (merged_cfg, merged)

    # W48 bucket 32, bf16: kernels per inference call
    cfg = load_config(W48_YAML)
    h, w = cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0]
    req = (np.random.RandomState(31).randint(0, 256, (32, h, w, 3))
           .astype(np.uint8), np.full((32, 2), 200.0, np.float32),
           np.full((32, 2), 1.5, np.float32))
    kernels, walls = {}, {}
    for label, (c, m) in zip(("unmerged", "merged"), pair(W48_YAML)):
        fn = make_inference_fn(c, m, True, device="cuda")
        kernels[label] = profile_device(torch, lambda: fn(*req), card, 0,
                                        f"one bucket-32 W48 inference call, "
                                        f"{label} fusion")
        ws = []
        for _ in range(5):
            t = time.perf_counter()
            fn(*req)
            torch.cuda.synchronize()
            ws.append(time.perf_counter() - t)
        walls[label] = min(ws)
        del fn, m
    torch.cuda.empty_cache()
    # fp32 heatmaps of both paths against the fp64 model
    (c, plain), (_, merged) = pair(W48_YAML, "float32")
    exact_model = _float64(torch, plain).to(dev).eval()
    plain, merged = plain.to(dev).eval(), merged.to(dev).eval()
    x = torch.from_numpy(np.random.RandomState(32).uniform(
        -2, 2, (2, 3, h, w)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        exact = exact_model(x.double())
        hm = {"unmerged": plain(x), "merged": merged(x)}
    scale = float(exact.abs().max())
    err = {k: float((v.double() - exact).abs().max()) / scale
           for k, v in hm.items()}
    between = float((hm["merged"] - hm["unmerged"]).abs().max()) / scale
    del plain, merged, exact_model, x, hm, exact
    torch.cuda.empty_cache()
    log(f"[{card}] MODEL.FUSE_MERGED, W48 bucket-32 inference call (bf16): "
        f"{kernels['unmerged']} kernels unmerged, {kernels['merged']} merged; "
        f"min wall {1e3 * walls['unmerged']:.2f} ms unmerged, "
        f"{1e3 * walls['merged']:.2f} ms merged; fp32 heatmaps at batch 2 "
        f"against the fp64 model: unmerged {err['unmerged']:.2e}, merged "
        f"{err['merged']:.2e} of their scale ({scale:.3e}); merged vs "
        f"unmerged {between:.2e}")
    if err["merged"] > 3 * err["unmerged"] + 1e-6:
        raise AssertionError(f"FUSE_MERGED heatmaps: {err}")

    # W32 train step: kernels per step in bf16 at batch 32
    step_kernels = {}
    raw = synthetic_train_batch(32, CANVAS, seed=33)
    draws = draw_augment(torch.Generator().manual_seed(34), 32)
    for label, (c, m) in zip(("unmerged", "merged"), pair(W32_YAML)):
        state = create_train_state(c, m, device="cuda")
        step = make_train_step(c, get_spec(c.DATASET.DATASET))
        batch = {k: torch.from_numpy(v) for k, v in raw.items()}
        batch["image"] = batch["image"].to(dev)
        step_kernels[label] = profile_device(
            torch, lambda: step(state, batch, draws), card, 0,
            f"one W32 train step at batch 32, {label} fusion")
        del state, step, batch
    torch.cuda.empty_cache()
    # fp32 train forward and backward at batch 8, against fp64
    (c, plain), (_, merged) = pair(W32_YAML, "float32")
    models = {"exact": _float64(torch, plain), "unmerged": plain,
              "merged": merged}
    raw = synthetic_train_batch(8, CANVAS, seed=35)
    draws = draw_augment(torch.Generator().manual_seed(36), 8)
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    aug = augment_from_draws(draws, batch["image"].to(dev), batch["joints"],
                             batch["joints_vis"], batch["center"],
                             batch["scale"], c, get_spec(c.DATASET.DATASET))
    loss_fn = make_loss(c)
    res = {}
    for label, m in models.items():
        m = m.to(dev).train()
        dt = torch.float64 if label == "exact" else torch.float32
        final, initial = m(aug.inputs.to(dt), return_aux=True)
        t, tw = aug.target.to(dt), aug.target_weight.to(dt)
        loss = loss_fn(final, t, tw) + 0.5 * loss_fn(initial, t, tw)
        loss.backward()
        res[label] = (float(loss.detach()),
                      {k: p.grad.detach().double()
                       for k, p in m.named_parameters()},
                      {k: v.detach().double() for k, v in m.named_buffers()})
        models[label] = None
        del m, final, initial, loss
    torch.cuda.empty_cache()
    ex = res["exact"]
    summary = {}
    for label in ("unmerged", "merged"):
        loss, grads, stats = res[label]
        g = _rel_errors(torch, grads, ex[1])
        st = _rel_errors(torch, stats, ex[2])
        summary[label] = (abs(loss - ex[0]) / abs(ex[0]), max(g),
                          float(np.mean(g)), max(st))
    log(f"[{card}] MODEL.FUSE_MERGED, W32 train step (bf16, batch 32): "
        f"{step_kernels['unmerged']} kernels unmerged, "
        f"{step_kernels['merged']} merged; fp32 forward and backward at "
        f"batch 8 against fp64 (loss, gradients max / mean over tensors, "
        f"running statistics, relative): " + "; ".join(
            f"{k} {v[0]:.2e}, {v[1]:.2e} / {v[2]:.2e}, {v[3]:.2e}"
            for k, v in summary.items()))
    u, mg = summary["unmerged"], summary["merged"]
    if any(mg[i] > 3 * u[i] + 1e-6 for i in range(4)):
        raise AssertionError(f"FUSE_MERGED train step: {summary}")
    return kernels, step_kernels


def s2d_phase(torch, card, dev):
    """Phase 23: MODEL.S2D_STEM on the W48 stem (3x3/2) and the
    ResNet-152 stem (7x7/2) at 384x288, batch 32: the rearranged conv
    against the plain conv and the exact (fp64) one in fp32 (no further
    from the exact than three times the plain conv's error + 2e-6) and in the
    models' bf16 (2e-2 of the scale: bf16 outputs), timed; the W48
    model's fp32 heatmaps with and without the knob against the fp64
    model's (as accurate: within three times the plain stem's error +
    1e-6 of the scale; fp32 rounding alone moves this deep random-weight model's
    heatmaps by ~1e-3 of their scale, phase 22)."""
    from rsgnet_tpu_torch.config.defaults import load_config
    from rsgnet_tpu_torch.models import get_pose_net, init_weights
    from rsgnet_tpu_torch.models.hrnet import space_to_depth_conv
    from rsgnet_tpu_torch.tools._profiling import cuda_event_ms

    x = torch.from_numpy(np.random.RandomState(41).uniform(
        -2, 2, (32, 3, 384, 288)).astype(np.float32)).to(dev)
    for label, yaml_path, name in (("W48 stem1 3x3/2", W48_YAML, "stem1"),
                                   ("ResNet-152 stem 7x7/2", RES152_YAML,
                                    "stem")):
        cfg = load_config(yaml_path)
        model = init_weights(get_pose_net(cfg), seed=0)
        conv = getattr(getattr(model, "backbone", model), name).conv.to(dev)
        out = {}
        for dtype in (torch.float32, torch.bfloat16):
            conv.compute_dtype = dtype
            with torch.inference_mode():
                plain = conv(x).float()
                s2d = space_to_depth_conv(x, conv).float()
            ms = (cuda_event_ms(lambda: conv(x)),
                  cuda_event_ms(lambda: space_to_depth_conv(x, conv)))
            out[dtype] = (float((s2d - plain).abs().max()), ms, plain[:4],
                          s2d[:4], float(plain.abs().max()))
        # fp32 against the exact conv (fp64) on 4 images: the rearranged
        # conv is as accurate as the plain one
        conv64 = copy.deepcopy(conv).double()
        conv64.compute_dtype = torch.float64
        with torch.inference_mode():
            exact = conv64(x[:4].double())
        f32, b16 = out[torch.float32], out[torch.bfloat16]
        e_plain = float((f32[2].double() - exact).abs().max())
        e_s2d = float((f32[3].double() - exact).abs().max())
        del model, conv, conv64, exact
        log(f"[{card}] MODEL.S2D_STEM, {label} at (32, 3, 384, 288): fp32 "
            f"max |s2d - plain| {f32[0]:.2e} (scale {f32[4]:.2f}); against "
            f"the fp64 conv on 4 images: plain {e_plain:.2e}, s2d "
            f"{e_s2d:.2e}; plain {f32[1][0]:.4f} ms, s2d {f32[1][1]:.4f} ms; "
            f"bf16 max |diff| {b16[0]:.2e} (scale {b16[4]:.2f}), plain "
            f"{b16[1][0]:.4f} ms, s2d {b16[1][1]:.4f} ms (L2 flushed; the "
            f"s2d time includes the rearrangement)")
        # the JAX test's atol 2e-6 / rtol 2e-6 is for 27 products of
        # values below 1; here both convs are held to the fp64 result
        if e_s2d > 3 * e_plain + 2e-6 or b16[0] > 2e-2 * b16[4]:
            raise AssertionError(f"S2D {label}: fp32 error {e_s2d} vs the "
                                 f"plain conv's {e_plain}; bf16 {b16[0]}")
    # the whole W48 model in fp32, both stems against the fp64 model
    cfg = load_config(W48_YAML)
    cfg.DTYPE = "float32"
    s2d_cfg = copy.deepcopy(cfg)
    s2d_cfg.MODEL.S2D_STEM = True
    plain = init_weights(get_pose_net(cfg), seed=0)
    exact_model = _float64(torch, plain).to(dev).eval()
    s2d = get_pose_net(s2d_cfg)
    s2d.load_state_dict(plain.state_dict())
    plain, s2d = plain.to(dev).eval(), s2d.to(dev).eval()
    with torch.inference_mode():
        exact = exact_model(x[:2].double())
        scale = float(exact.abs().max())
        err = {k: float((m(x[:2]).double() - exact).abs().max()) / scale
               for k, m in (("plain", plain), ("s2d", s2d))}
    log(f"[{card}] MODEL.S2D_STEM, W48 model in fp32 at batch 2 against the "
        f"fp64 model: plain stem {err['plain']:.2e}, s2d stem "
        f"{err['s2d']:.2e} of the heatmaps' scale ({scale:.3e})")
    if err["s2d"] > 3 * err["plain"] + 1e-6:
        raise AssertionError(f"S2D W48 heatmaps: {err}")
    del plain, s2d, exact_model, x, exact
    torch.cuda.empty_cache()


def dp_test_cli_phase(torch, card, dev, root):
    """Phase 20: ``python -m rsgnet_tpu_torch.test`` on W48 @ 384x288 DARK
    (seeded init) over phase 13's set on two ranks sharing the card over
    gloo, held by ``test_cli_holds``. Returns DARK's launches per rank."""
    work = os.path.join(root, "dp_test")
    os.makedirs(work, exist_ok=True)
    opts = test_cli_opts(root, work)
    argv = ["--cfg", W48_YAML, "--workers", "4", "--backend", "gloo", *opts]
    torch.cuda.empty_cache()
    ranks, texts, wall = spawn_ranks("test", {"argv": argv, "workdir": work},
                                     work)
    return test_cli_holds(torch, f"python -m rsgnet_tpu_torch.test on "
                          f"{DP_WORLD} ranks sharing the card over gloo",
                          ranks, wall, argv, opts)


def test_cli_opts(root, work):
    """The test CLI's overrides in phases 20 and 33b: ``root``'s set, files
    under ``work``, and the deterministic mode the comparison with one
    process needs (the CLI sets cuDNN from these keys)."""
    return ["DATASET.ROOT", root, "DATASET.TEST_SET", "val", "OUTPUT_DIR",
            os.path.join(work, "output"), "LOG_DIR",
            os.path.join(work, "log"), *DETERMINISTIC_OPTS]


def test_cli_holds(torch, label, ranks, wall, argv, opts):
    """The holds of a data-parallel test CLI run on W48 @ 384x288 DARK
    (phases 20 and 33b), from each rank's result (its kernel launches, the
    gathered predictions, boxes and ids, its AP table; ``argv`` holds the
    overrides ``opts``): each rank scored
    its contiguous slice, DARK once per eval batch a rank and the shear
    warp never, the ranks' AP tables equal each other and a one-process run
    of ``argv`` (in this process), and the gathered predictions equal that
    run's within the eval tolerances (preds 1e-2 px or 1e-3 heatmap pixel;
    maxvals 1e-4 or 1e-6 of their scale). Returns DARK's launches per
    rank."""
    from rsgnet_tpu_torch import test as test_cli
    from rsgnet_tpu_torch.config.defaults import load_config, opts_to_dict
    from rsgnet_tpu_torch.core import validate as tval
    from rsgnet_tpu_torch.data import get_dataset
    from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode
    from rsgnet_tpu_torch.parallel.distributed import shard_bounds

    world = len(ranks)
    cfg = load_config(W48_YAML, overrides=opts_to_dict(opts))
    n = len(get_dataset(cfg))
    bs = cfg.TEST.BATCH_SIZE_PER_GPU
    shards = [shard_bounds(n, r, world) for r in range(world)]
    want_batches = [-(-(hi - lo) // bs) for lo, hi in shards]
    tables = [r["name_value"] for r in ranks]
    launches = [r["launches"]["dark_decode"] for r in ranks]
    log(f"{label}, W48 DARK, {n} instances ("
        + " + ".join(str(hi - lo) for lo, hi in shards)
        + f"), batch {bs}: {wall:.1f} s for the {world} processes; each "
        f"rank's test CLI " + ", ".join(f"{r['wall_s']:.1f}" for r in ranks)
        + f" s; dark_decode launches per rank {launches} (eval batches "
        f"{want_batches}); rank 0's AP table " + ", ".join(
            f"{k} {v:.4f}" for k, v in tables[0].items())
        + f"; the {world} ranks' tables equal: "
        f"{all(t == tables[0] for t in tables)}")
    if any(t != tables[0] for t in tables) or launches != want_batches or any(
            r["launches"]["shear_warp"] for r in ranks):
        raise AssertionError(f"tables {tables}, launches "
                             f"{[r['launches'] for r in ranks]}")
    if not all(np.isfinite(v) for v in tables[0].values()):
        raise AssertionError(f"AP table {tables[0]}")

    # one process, the same weights and set
    captured = {}
    evaluate = tval._evaluate_and_log

    def capture(dataset, preds, boxes, ids, *rest):
        captured.update(preds=preds, boxes=boxes, ids=ids)
        return evaluate(dataset, preds, boxes, ids, *rest)

    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    _deterministic(torch)
    tval._evaluate_and_log = capture
    try:
        dark_decode.launches = 0
        one_table, _ = test_cli.main([a for a in argv if a not in
                                      ("--backend", "gloo")])
        one_launches = dark_decode.launches
    finally:
        tval._evaluate_and_log = evaluate
        torch.use_deterministic_algorithms(False)
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    r0 = ranks[0]
    if not (np.array_equal(r0["ids"], captured["ids"])
            and r0["ids"].dtype == np.int64):
        raise AssertionError("gathered image ids differ from one process's")
    scale = captured["boxes"][:, 2:4] * 200.0
    hm = np.asarray(cfg.MODEL.HEATMAP_SIZE, np.float64)
    atol = np.maximum(1e-2, 1e-3 * scale / hm)[:, None, :]
    perr = np.abs(r0["preds"][..., :2].astype(np.float64)
                  - captured["preds"][..., :2])
    verr = np.abs(r0["preds"][..., 2] - captured["preds"][..., 2])
    vtol = np.maximum(1e-4, 1e-6 * np.abs(captured["preds"][..., 2]))
    log(f"one process, same weights and set: dark_decode launches "
        f"{one_launches}; AP table equal to the ranks': "
        f"{dict(one_table) == tables[0]}; gathered preds vs one process: max "
        f"|diff| {perr.max():.3e} px ({int((perr > atol).sum())} beyond the "
        f"tolerance), maxvals max |diff| {verr.max():.3e} "
        f"({int((verr > vtol).sum())} beyond)")
    if (perr > atol).any() or (verr > vtol).any():
        raise AssertionError("the gathered predictions differ from one "
                             "process's")
    if dict(one_table) != tables[0]:
        raise AssertionError(f"one process's AP table {dict(one_table)}")
    return launches


# -- phases 24-27: the serving export, the process loader, traces, JPEG ----


def preds_agree(p, v, p_ref, v_ref, scales, heatmap_size):
    """Hold an artifact's (preds, maxvals) against an eager function's on
    the same inputs: bitwise, else within ``tests/_torch_port_common.py::
    assert_preds_close``'s tolerances (maxvals 1e-4; preds 1e-2 px, or
    1e-3 heatmap pixels where one spans more than 10 image pixels).
    Returns a report of the gaps; raises on disagreement."""
    p, v, p_ref, v_ref = (np.asarray(t.cpu(), np.float64)
                          for t in (p, v, p_ref, v_ref))
    per_hm_px = np.asarray(scales, np.float64) * 200.0 / np.asarray(
        heatmap_size, np.float64)
    atol = np.maximum(1e-2, 1e-3 * per_hm_px)[:, None, :]
    err = np.abs(p - p_ref)
    rep = {"bitwise": bool((p == p_ref).all() and (v == v_ref).all()),
           "pred_gap_px": float(err.max()),
           "maxval_gap": float(np.abs(v - v_ref).max()),
           "keypoints": int(err.shape[0] * err.shape[1])}
    if not ((err <= atol).all() and rep["maxval_gap"] <= 1e-4):
        raise AssertionError(f"artifact vs eager function: {rep}")
    return rep


def export_phase(torch, card, dev, tmp):
    """Phase 24: the export CLI on the W48 DARK YAML in a subprocess, then
    ``serve --artifact`` over HTTP in this process (DARK once per engine
    batch), the artifact at buckets 2 and 32 against the unexported
    ``DevicePipeline`` (bitwise) and ``make_inference_fn`` on the same
    seeded weights (``preds_agree``), its call time at bucket 32 beside the
    eager call's; then the end-to-end artifact under TEST.WARP=shear on
    (b, 640, 640, 3) canvases (shear warp and DARK once each per call),
    held the same way against ``make_e2e_fn``; the ConvBN epilogue once
    for each BatchNorm of every forward. Returns the launch counts
    (DARK's, the shear warp's, the epilogue's)."""
    from rsgnet_tpu_torch import serve
    from rsgnet_tpu_torch.core.inference import (DevicePipeline,
                                                 make_e2e_fn,
                                                 make_inference_fn)
    from rsgnet_tpu_torch.ops.cuda.convbn_epilogue import convbn_epilogue
    from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode
    from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp
    from rsgnet_tpu_torch.serving.http_server import predict_remote
    from rsgnet_tpu_torch.utils.export import export_e2e, load_exported

    path = os.path.join(tmp, "w48_384x288_dark.pt2")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "rsgnet_tpu_torch.export", "--cfg", W48_YAML,
         "--out", path, "--raw-uint8", "--seed", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"python -m rsgnet_tpu_torch.export exited "
                             f"{proc.returncode}:\n"
                             f"{(proc.stdout + proc.stderr)[-4000:]}")
    log(f"python -m rsgnet_tpu_torch.export --cfg <W48 YAML> --raw-uint8: "
        f"exit 0 in {time.perf_counter() - t0:.1f} s (interpreter start "
        f"and seeded init included); {os.path.getsize(path)} bytes; "
        f"{proc.stdout.strip()}")

    # -- serve --artifact over HTTP, the slice's main path -------------------
    cfg, model = serve.load_model(serve.parse_args(["--cfg", W48_YAML,
                                                    "--seed", "0"]))
    h, w = cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0]
    k = cfg.MODEL.NUM_JOINTS
    args = serve.parse_args(["--artifact", path, "--port", "0",
                             "--buckets", BUCKETS, "--max-wait-ms", "5",
                             "--in-flight", "2"])
    t0 = time.perf_counter()
    engine, batcher, server = serve.build_server(args)
    if (engine.image_shape, engine.image_dtype) != ((h, w, 3), np.uint8):
        raise AssertionError(f"the artifact takes {engine.image_shape} "
                             f"{engine.image_dtype} crops")
    log(f"serve --artifact: loaded and warmed buckets {engine.buckets} in "
        f"{time.perf_counter() - t0:.1f} s; min s/dispatch "
        f"{engine.bucket_cost}")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    url = "http://%s:%d" % server.server_address
    rng = np.random.RandomState(30)
    reqs = [(rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
             rng.uniform(100, 500, (n, 2)).astype(np.float32),
             rng.uniform(0.8, 2.5, (n, 2)).astype(np.float32))
            for n in (1, 8, 3, 5, 2, 8, 4, 7)]
    results, errors = {}, []

    def client(i, req):
        try:
            results[i] = predict_remote(url, *req, timeout=300)
        except BaseException as e:          # re-raised below
            errors.append((i, e))

    # main path starts here
    dark_decode.launches = shear_warp.launches = convbn_epilogue.launches = 0
    batches_before = engine.stats()["batches"]
    try:
        threads = [threading.Thread(target=client, args=(i, r))
                   for i, r in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        served = (dark_decode.launches, shear_warp.launches,
                  convbn_epilogue.launches)               # ends here
        batches = engine.stats()["batches"] - batches_before
        stats = batcher.stats()
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        th.join(60)
    if errors:
        raise RuntimeError(f"requests failed: {errors}") from errors[0][1]
    if len(results) != len(reqs):
        raise RuntimeError("not every request came back")
    for i, req in enumerate(reqs):
        p, v = results[i]
        n = req[0].shape[0]
        if p.shape != (n, k, 2) or v.shape != (n, k, 1) or not (
                np.isfinite(p).all() and np.isfinite(v).all()):
            raise AssertionError(f"request {i}: {p.shape} {v.shape}, or "
                                 f"not finite")
    log(f"served {len(reqs)} concurrent requests "
        f"({sum(r[0].shape[0] for r in reqs)} crops) from the artifact in "
        f"{batches} engine batches {stats['engine']['bucket_calls']}; "
        f"dark_decode launches {served[0]}, shear_warp {served[1]}, ConvBN "
        f"epilogue {served[2]}")
    if served[0] < 1 or served[:2] != (batches, 0):
        raise AssertionError(f"artifact server: launches {served[:2]} != "
                             f"({batches} engine batches, 0)")
    passes = 2 if cfg.TEST.FLIP_TEST else 1
    epilogue_launches_hold("artifact server", served[2], passes * batches)

    # -- the artifact in this process, against the eager function -----------
    fn = engine._fn
    model = model.to(dev)
    eager = make_inference_fn(cfg, model, normalize_input=True,
                              device="cuda")
    pipe = DevicePipeline(cfg, model, normalize_input=True)
    for n in (2, 32):
        req = (rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
               rng.uniform(100, 500, (n, 2)).astype(np.float32),
               rng.uniform(0.8, 2.5, (n, 2)).astype(np.float32))
        dark_decode.launches = 0
        p1, v1 = fn(*req)
        torch.cuda.synchronize()
        if dark_decode.launches != 1:
            raise AssertionError(f"artifact at {n}: {dark_decode.launches} "
                                 f"DARK launches")
        with torch.inference_mode():
            pp, vp = pipe(*(torch.from_numpy(a).to(dev) for a in req))
        if not (torch.equal(p1, pp) and torch.equal(v1, vp)):
            raise AssertionError(f"artifact at {n} differs from the "
                                 f"unexported pipeline")
        rep = preds_agree(p1, v1, *eager(*req), req[2],
                          cfg.MODEL.HEATMAP_SIZE)
        log(f"artifact at bucket {n}: DARK launched once; bitwise the "
            f"unexported DevicePipeline; vs make_inference_fn: {rep}")
    req32 = (rng.randint(0, 256, (32, h, w, 3)).astype(np.uint8),
             np.full((32, 2), 200.0, np.float32),
             np.full((32, 2), 1.5, np.float32))
    walls = {"artifact": [], "eager": []}
    for _ in range(5):
        for name, f in (("artifact", fn), ("eager", eager)):
            t0 = time.perf_counter()
            f(*req32)
            torch.cuda.synchronize()
            walls[name].append(1e3 * (time.perf_counter() - t0))
    call_ms = {name: float(np.median(ws)) for name, ws in walls.items()}
    log(f"[{card}] bucket-32 call (uint8 crops in, flip-test, DARK, image "
        f"coords out), median of 5 in turns: artifact "
        f"{call_ms['artifact']:.2f} ms, eager {call_ms['eager']:.2f} ms; "
        f"all: " + str({n: [round(x, 2) for x in ws]
                        for n, ws in walls.items()}))
    del engine, batcher, server, fn, eager, pipe
    torch.cuda.empty_cache()

    # -- the end-to-end artifact under TEST.WARP=shear ----------------------
    # bf16, as the YAML: both paths solve the crop transforms on the card
    # and map the keypoints back in closed form, so they see the same bits
    ecfg = copy.deepcopy(cfg)
    ecfg.TEST.WARP = "shear"
    t0 = time.perf_counter()
    efn = load_exported(export_e2e(ecfg, model, (CANVAS, CANVAS)))
    log(f"export_e2e ({ecfg.DTYPE}, TEST.WARP=shear, {CANVAS}x{CANVAS} "
        f"canvases) and load in {time.perf_counter() - t0:.1f} s")
    e2e = make_e2e_fn(ecfg, model, (CANVAS, CANVAS), device="cuda")
    epipe = DevicePipeline(ecfg, model, src_size=(CANVAS, CANVAS))
    e2e_launches = [0, 0, 0]
    for n in (2, 8):
        req = (rng.randint(0, 256, (n, CANVAS, CANVAS, 3)).astype(np.uint8),
               rng.uniform(200, 440, (n, 2)).astype(np.float32),
               rng.uniform(0.8, 2.0, (n, 2)).astype(np.float32))
        dark_decode.launches = shear_warp.launches = 0
        convbn_epilogue.launches = 0
        p1, v1 = efn(*req)
        torch.cuda.synchronize()
        got = (dark_decode.launches, shear_warp.launches,
               convbn_epilogue.launches)
        if got[:2] != (1, 1):
            raise AssertionError(f"e2e artifact at {n}: launches {got[:2]}")
        epilogue_launches_hold(f"e2e artifact at {n}", got[2], passes)
        e2e_launches = [a + b for a, b in zip(e2e_launches, got)]
        with torch.inference_mode():
            pp, vp = epipe(*(torch.from_numpy(a).to(dev) for a in req))
        if not (torch.equal(p1, pp) and torch.equal(v1, vp)):
            raise AssertionError(f"e2e artifact at {n} differs from the "
                                 f"unexported pipeline")
        rep = preds_agree(p1, v1, *e2e(*req), req[2],
                          ecfg.MODEL.HEATMAP_SIZE)
        log(f"e2e artifact at ({n}, {CANVAS}, {CANVAS}, 3): shear_warp and "
            f"DARK launched once each, the ConvBN epilogue {got[2]} times; "
            f"bitwise the unexported "
            f"DevicePipeline; vs make_e2e_fn: {rep}")
    del efn, e2e, epipe, model
    torch.cuda.empty_cache()
    return {"serve": served, "e2e": tuple(e2e_launches), "call_ms": call_ms}


def grain_phase(torch, card, dev, root):
    """Phases 25-27 on phase 13's set under ``root``: the JPEG decoder the
    dataset uses here; ``fit`` of W32 for one epoch with TRAIN.LOADER
    "threads" (traced: ``profile_steps=3``) and "grain" (2 worker
    processes), deterministic cuDNN, bitwise equal, the shear warp once a
    step; ``collect_predictions`` with TEST.LOADER "grain" against
    "threads", two passes through one loader each, and both loaders'
    instances/s; the test CLI with
    ``--profile 2`` on W48 DARK. Each trace's CUDA kernels must include
    the kernel the traced path runs. Returns the grain fit's launches."""
    import glob
    import shutil as _shutil
    from rsgnet_tpu_torch import test as test_cli
    from rsgnet_tpu_torch.config.defaults import load_config, opts_to_dict
    from rsgnet_tpu_torch.core.function import fit
    from rsgnet_tpu_torch.core.validate import (collect_predictions,
                                                make_eval_loader)
    from rsgnet_tpu_torch.data import get_dataset
    from rsgnet_tpu_torch.data.grain_pipeline import GrainEvalLoader
    from rsgnet_tpu_torch.data.loader import BatchLoader
    from rsgnet_tpu_torch.models import get_pose_net, init_weights
    from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode
    from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp
    from rsgnet_tpu_torch.utils.imageio import jpeg_decoder

    def trace_kernels(directory):
        names = set()
        for f in glob.glob(os.path.join(directory, "*.json")):
            with open(f) as fh:
                names |= {e["name"] for e in json.load(fh)["traceEvents"]
                          if e.get("cat") == "kernel"}
        return names

    # -- 27. the JPEG decoder ----------------------------------------------
    log(f"JPEG decoder of the dataset on this machine: {jpeg_decoder()} "
        f"(g++ {'found' if _shutil.which('g++') else 'missing'}; the "
        f"native libjpeg loader needs g++ and libjpeg's headers, else cv2, "
        f"else PIL, as the JAX package)")

    opts = ["DATASET.ROOT", root, "DATASET.TRAIN_SET", "val",
            "DATASET.TEST_SET", "val"]
    cfg = load_config(W32_YAML, overrides=opts_to_dict(opts))
    train_ds = get_dataset(cfg, is_train=True)

    # -- 25. fit with the process loader, 26. fit's trace window ------------
    def run(loader, profile_steps):
        c = copy.deepcopy(cfg)
        c.TRAIN.LOADER = loader
        model = init_weights(get_pose_net(c), seed=0)
        out = os.path.join(root, "grain_runs", loader)
        t = time.perf_counter()
        shear_warp.launches = dark_decode.launches = 0  # main path starts
        state, _ = fit(c, model, train_ds, None, output_dir=out,
                       num_workers=2 if loader == "grain" else 8,
                       max_epochs=1, profile_steps=profile_steps,
                       device="cuda")
        torch.cuda.synchronize()
        launches = (shear_warp.launches, dark_decode.launches)   # ends
        wall = time.perf_counter() - t
        log(f"fit TRAIN.LOADER={loader}, 1 epoch: {state.step} steps in "
            f"{wall:.1f} s (worker start included); shear_warp launches "
            f"{launches[0]}, dark_decode {launches[1]}")
        if launches != (state.step, 0) or state.step < 3:
            raise AssertionError(f"fit {loader}: launches {launches}, "
                                 f"steps {state.step}")
        return state, launches, out

    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    _deterministic(torch)
    try:
        threads_state, _, threads_out = run("threads", 3)
        grain_state, grain_launches, _ = run("grain", 0)
    finally:
        torch.use_deterministic_algorithms(False)
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    if not states_equal(torch, threads_state, grain_state):
        raise AssertionError("fit with the grain loader is not bitwise the "
                             "threaded run: " + str(max_state_diff(
                                 torch, threads_state, grain_state)))
    log("fit: TRAIN.LOADER grain (2 spawned workers) and threads end "
        "bitwise equal (weights, BatchNorm statistics, Adam moments, step)")
    names = trace_kernels(os.path.join(threads_out, "profile"))
    warp_names = sorted(n for n in names if "shear_warp_kernel" in n)
    log(f"fit(profile_steps=3) trace: {len(names)} CUDA kernel names, the "
        f"shear warp's: {warp_names}")
    if not warp_names:
        raise AssertionError("fit's trace holds no shear_warp_kernel")

    # -- the eval loaders: predictions and instances/s ----------------------
    # through one loader for two passes, as fit's epochs validate: the
    # first pass starts the workers on a cold decode cache, the second
    # finds them running
    model = grain_state.model.eval()
    preds, rates = {}, {}
    for name in ("threads", "grain"):
        c = copy.deepcopy(cfg)
        c.TEST.LOADER = name
        ds = get_dataset(c)                 # a cold decode cache
        loader = make_eval_loader(c, ds,
                                  num_workers=2 if name == "grain" else 8)
        try:
            for rep in ("cold", "warm"):
                t = time.perf_counter()
                preds[name, rep] = collect_predictions(
                    c, ds, model, device="cuda", loader=loader)
                rates[name, rep] = len(ds) / (time.perf_counter() - t)
        finally:
            loader.close()
    want = preds["threads", "cold"]
    if not all(np.array_equal(a, b) for got in preds.values()
               for a, b in zip(want, got)):
        raise AssertionError("collect_predictions: the passes or the "
                             "loaders differ")
    alone = {}
    for name, make in (
            ("threads", lambda ds: BatchLoader(ds, 32, num_workers=8)),
            ("grain", lambda ds: GrainEvalLoader(ds, 32, num_workers=2))):
        ds = get_dataset(cfg)
        loader = make(ds)
        for rep in ("cold", "warm"):     # warm: the decode cache, workers up
            t = time.perf_counter()
            n = sum(int(b["num_valid"]) for b in loader)
            alone[name, rep] = n / (time.perf_counter() - t)
        loader.close()
    log(f"[{card}] collect_predictions, W32, {len(want[0])} instances, "
        f"one loader, first pass (cold decode cache) / second pass: "
        f"predictions equal; instances/s threads (8) "
        f"{rates['threads', 'cold']:.1f} / {rates['threads', 'warm']:.1f}, "
        f"grain (2 processes) {rates['grain', 'cold']:.1f} (worker start "
        f"included) / {rates['grain', 'warm']:.1f}; the loaders alone "
        f"(decode and collate, batch 32), first pass / second pass: "
        f"threads {alone['threads', 'cold']:.1f} / "
        f"{alone['threads', 'warm']:.1f}, grain {alone['grain', 'cold']:.1f}"
        f" (worker start included) / {alone['grain', 'warm']:.1f} (each "
        f"worker's own decode cache warm)")
    del model, grain_state, threads_state
    torch.cuda.empty_cache()

    # -- 26. the test CLI's trace window on W48 DARK ------------------------
    out = os.path.join(root, "profile_cli")
    cli_opts = opts + ["OUTPUT_DIR", os.path.join(out, "output"), "LOG_DIR",
                       os.path.join(out, "log")]
    dark_decode.launches = 0
    test_cli.main(["--cfg", W48_YAML, "--workers", "8", "--profile", "2",
                   *cli_opts])
    torch.cuda.synchronize()
    names = trace_kernels(os.path.join(out, "output", "coco", "pose_rsgnet",
                                       "w48_384x288", "profile"))
    dark_names = sorted(n for n in names if "dark_decode_kernel" in n)
    log(f"python -m rsgnet_tpu_torch.test --profile 2 (W48 DARK): DARK "
        f"launches {dark_decode.launches}; trace: {len(names)} CUDA kernel "
        f"names, DARK's: {dark_names}")
    if not dark_names:
        raise AssertionError("the test CLI's trace holds no "
                             "dark_decode_kernel")
    return grain_launches


# -- phases 28-30: the bench and the serving profilers ----------------------


def run_module(module, args, timeout):
    """``python -m module args`` from the checkout's root as a child:
    (the finished process, the JSON objects of its stdout)."""
    p = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    rows = [json.loads(ln) for ln in p.stdout.splitlines()
            if ln.startswith("{")]
    return p, rows


def bench_phase(torch, card, kind, dev):
    """Phase 28: ``python -m rsgnet_tpu_torch.bench`` at its defaults (the
    five default sections at full width, batches 128 and 192): every line
    parses, each has a value and names the card, the headline is last, and
    the train line counts one shear-warp launch a step (warm and timed)
    and no DARK launch; then, in this process, the train section's warp
    and step (``bench_train_holds``), and ``full``'s rescoring and
    OKS-NMS on the card, which waits for nothing (no synchronizing call)
    and keeps what the CPU keeps. Returns (the train line's kernel
    launches, the shear warp's numbers at the train section's shape)."""
    from rsgnet_tpu_torch import bench

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "rsgnet_tpu_torch.bench"],
                       cwd=ROOT, capture_output=True, text=True, timeout=700)
    wall = time.perf_counter() - t0
    out = [ln for ln in p.stdout.splitlines() if ln.strip()]
    lines = [json.loads(ln) for ln in out]           # every line parses
    for rec in lines:
        log(f"bench: {json.dumps(rec)}")
    want = [bench._SECTION_METRICS[n] for n in bench._SECTION_ORDER[1:]]
    want.append(bench._HEADLINE_METRIC)
    if p.returncode != 0 or [r["metric"] for r in lines] != want:
        raise AssertionError(f"bench: rc {p.returncode}, metrics "
                             f"{[r['metric'] for r in lines]}; stderr "
                             f"{p.stderr[-3000:]}")
    for rec in lines:
        if (rec["value"] is None or rec.get("card") != card
                or rec.get("device") != kind):
            raise AssertionError(f"bench line without a value or the card: "
                                 f"{rec}")
    train = lines[want.index(bench._SECTION_METRICS["train"])]
    launches = train["kernel_launches"]
    if (train["steps"] != bench.TRAIN_ITERS + 1
            or launches != {"shear_warp": train["steps"], "dark_decode": 0}):
        raise AssertionError(f"bench train: launches {launches} in "
                             f"{train['steps']} steps")
    step_ms = 1e3 * train["batch"] / train["value"]
    log(f"[{card}] python -m rsgnet_tpu_torch.bench: {wall:.1f} s; headline "
        f"{lines[-1]['value']} images/s, train {train['value']} images/s "
        f"at batch {train['batch']} ({step_ms:.2f} ms a step), launches "
        f"{launches} in {train['steps']} steps (1 warm + {train['iters']} "
        f"timed)")
    warp = bench_train_holds(torch, card, dev, step_ms)

    # the full section's post-processing at its shape, on the card
    from rsgnet_tpu_torch.data.skeletons import get_spec
    rng = np.random.RandomState(7)
    b, k = bench.BATCH, 17
    base = rng.uniform(100, 540, (b // bench.PER_IMG, 3, k, 2))
    jitter = rng.uniform(0.5, 40.0, (b // bench.PER_IMG, bench.PER_IMG, 1,
                                     1))
    preds = (base[:, np.arange(bench.PER_IMG) % 3] + rng.randn(
        b // bench.PER_IMG, bench.PER_IMG, k, 2) * jitter).reshape(b, k, 2)
    host = [torch.from_numpy(a.astype(np.float32)) for a in (
        preds, rng.uniform(0, 1, (b, k, 1)),
        np.stack([rng.uniform(0.8, 1.5, b) * 0.75,
                  rng.uniform(0.8, 1.5, b)], -1),
        rng.uniform(0.3, 1.0, b), np.asarray(get_spec("coco").sigmas))]
    args = [t.to(dev) for t in host]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = bench.rescore_and_keep(*args, 0.2, 0.9)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cpu_out = bench.rescore_and_keep(*host, 0.2, 0.9)
    got = got.cpu()
    if not (torch.equal(got[:, 1], cpu_out[:, 1]) and torch.allclose(
            got[:, 0], cpu_out[:, 0], rtol=1e-6, atol=0)):
        raise AssertionError("full's OKS-NMS on the card keeps other "
                             "instances than on the CPU")
    log(f"bench full's rescoring + OKS-NMS at ({b // bench.PER_IMG}, "
        f"{bench.PER_IMG}, {k}, 3) on the card: no synchronizing call, "
        f"{int(got[:, 1].sum())} of {b} kept, keep sets equal the CPU's")
    return launches, warp


def bench_train_holds(torch, card, dev, step_ms):
    """The bench's ``train`` section at its shape, in this process: the
    shear warp of its first batch (``bench.train_inputs``' canvases, the
    draw of ``draw_augment`` seeded 0: (128, 640, 640, 3) uint8 -> (128,
    3, 256, 192)) bit-equal to its plain version, its time, its plain
    version's, its bound and ``F.grid_sample``'s time; then a trace of one
    of its train steps (cuDNN benchmark on, as the section's child runs),
    whose busy share says whether the step at 128 is host-bound. Returns
    the warp's numbers for the kernels line."""
    from rsgnet_tpu_torch import bench
    from rsgnet_tpu_torch.config.defaults import rsgnet_w32_256x192
    from rsgnet_tpu_torch.core.train import (create_train_state,
                                             make_train_step)
    from rsgnet_tpu_torch.data.augment import augment_geometry, draw_augment
    from rsgnet_tpu_torch.data.skeletons import get_spec
    from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp
    from rsgnet_tpu_torch.ops.shear_warp import (shear_prepare,
                                                 shear_warp_reference)
    from rsgnet_tpu_torch.tools._profiling import cuda_event_ms

    cfg = rsgnet_w32_256x192()
    spec = get_spec(cfg.DATASET.DATASET)
    b, out_size = bench.BATCH, tuple(cfg.MODEL.IMAGE_SIZE)
    imgs, joints, vis, centers, scales = bench.train_inputs(
        b, cfg.MODEL.NUM_JOINTS)
    host = {"joints": joints, "joints_vis": vis, "center": centers,
            "scale": scales}
    host = {kk: torch.from_numpy(v) for kk, v in host.items()}
    draws = draw_augment(torch.Generator().manual_seed(0), b)
    trans = augment_geometry(draws, host["joints"], host["joints_vis"],
                             host["center"], host["scale"], float(bench.SRC),
                             cfg, spec)[0].to(dev)
    canvases = torch.from_numpy(imgs[0]).to(dev)
    pos = shear_prepare(trans, bench.SRC, out_size)
    err, equal = shear_vs_plain(torch, shear_warp, canvases, pos)
    if not equal:
        raise AssertionError(f"shear warp kernel disagrees with its plain "
                             f"version at the bench's train shape: {err}")
    warp = {"shape": list(canvases.shape), "out_size": list(out_size),
            "max_abs_err": err,
            "ms": cuda_event_ms(lambda: shear_warp(canvases, pos)),
            "plain_ms": cuda_event_ms(lambda: shear_warp_reference(
                canvases, pos))}
    warp["bound_ms"], warp["bound_by"], nbytes, src_bytes = shear_bound_ms(
        torch, canvases, pos)
    warp["library_ms"] = grid_sample_ms(torch, canvases, trans, out_size)
    log(f"[{card}] shear_warp at the bench's train shape {tuple(canvases.shape)}"
        f" uint8 -> ({b}, 3, {out_size[1]}, {out_size[0]}) fp32: bit-equal "
        f"to its plain version; kernel {warp['ms']:.4f} ms, plain "
        f"{warp['plain_ms']:.4f} ms, bound {warp['bound_ms']:.4f} ms "
        f"({warp['bound_by']}: {nbytes / 1e6:.1f} MB, source footprint "
        f"{src_bytes / 1e6:.1f} MB), {100 * warp['bound_ms'] / warp['ms']:.1f}"
        f"% of its bound; F.grid_sample {warp['library_ms']:.4f} ms")

    state = create_train_state(cfg, bench._model(cfg), device=dev)
    step = make_train_step(cfg, spec)
    batch = {"image": canvases, **host}
    with torch.no_grad():
        x = torch.zeros(1, 3, out_size[1], out_size[0], device=dev)
        fwd = forward_flops(torch, state.model.eval(), x)
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        profile_device(torch, lambda: step(state, batch, draws), card,
                       3 * b * fwd, f"one step of the bench's train section "
                       f"at batch {b} (its pipelined step {step_ms:.2f} ms)")
    finally:
        torch.backends.cudnn.benchmark = saved
    del state, step, batch, canvases
    torch.cuda.empty_cache()
    return warp


def serving_phases(card):
    """Phases 29-30: ``profile_serving --config w32 --batches 1 8 32
    --e2e`` (every row finite, p50 <= p95) and ``profile_batcher --clients
    1,16,64 --seconds 3`` (goodput > 0 and fill >= 1 at each level, no
    expired request at 1 client), each a child process."""
    t0 = time.perf_counter()
    p, rows = run_module("rsgnet_tpu_torch.tools.profile_serving",
                         ["--config", "w32", "--batches", "1", "8", "32",
                          "--e2e"], 500)
    table = [r for r in rows if "batch" in r]
    for r in rows:
        log(f"profile_serving: {json.dumps(r)}")
    keys = ("rtt_p50_ms", "rtt_p95_ms", "pipelined_ms",
            "pipelined_images_per_sec", "latency_images_per_sec")
    if p.returncode != 0 or len(table) != 6 or not all(
            r.get("card") == card and np.isfinite([r[k] for k in keys]).all()
            and r["rtt_p50_ms"] <= r["rtt_p95_ms"] for r in table):
        raise AssertionError(f"profile_serving: rc {p.returncode}, rows "
                             f"{table}; stderr {p.stderr[-3000:]}")
    log(f"phase 29 (profile_serving): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    p, rows = run_module("rsgnet_tpu_torch.tools.profile_batcher",
                         ["--clients", "1,16,64", "--seconds", "2"], 500)
    for r in rows:
        log(f"profile_batcher: {json.dumps(r)}")
    if (p.returncode != 0 or [r["clients"] for r in rows] != [1, 16, 64]
            or not all(r.get("card") == card and r["goodput_rps"] > 0
                       and r["mean_fill"] >= 1 for r in rows)
            or rows[0]["expired"]):
        raise AssertionError(f"profile_batcher: rc {p.returncode}, rows "
                             f"{rows}; stderr {p.stderr[-3000:]}")
    log(f"phase 30 (profile_batcher): {time.perf_counter() - t0:.1f} s")


# -- phase 31: the path dissections ------------------------------------------

# tool -> its arguments in phase 31: the card's default config, cut to a
# small batch and few iterations (each tool's full run is its own command)
PROFILERS = {
    "profile_memory": ["--config", "w48", "w32", "--batch", "16"],
    "profile_roofline": ["--batch", "32", "--iters", "3"],
    "profile_config_sweep": ["--config", "w48", "--batches", "16",
                             "--iters", "2"],
    "profile_paths": ["--batch", "16", "--iters", "2"],
    "profile_train_dissect": ["--batch", "16", "--iters", "2"],
    "profile_bwd": ["--batch", "16", "--iters", "2"],
    "profile_update": ["--batch", "16", "--iters", "2"],
}
PROFILERS_BUDGET_S = 150


def expected_launches(tool, row):
    """(shear warp, DARK) launches a dissection row must count: DARK once
    per e2e call of the W48 DARK config, the shear warp once per train step
    and once per call of a row that augments or warps whole; 0 else; None
    for an out-of-memory row (a finding, not checked)."""
    name = row.get("row", "")
    if row.get("oom"):
        return None
    if row.get("kind") == "e2e" or (tool == "profile_memory"
                                    and row.get("kind") == "eval"):
        dark = row["calls"] if "DARK" in row["config"] else 0
        return 0, dark
    if row.get("kind") == "train":
        return row["steps"], 0
    if name.startswith(("augment_from_draws", "shear warp full")):
        return row["calls"], 0
    if name.startswith(("train step FULL", "FULL shear", "crowdpose train")):
        return row["steps"], 0
    return 0, 0


def dissection_holds(tool, rows, kind, total):
    """Phase 31's holds beyond the shared ones: memory rows measured (peak
    above weights + batch, at most the card's ``total``) or out of memory;
    roofline rates at most 105% of the spec sheet's peak."""
    for r in rows:
        if tool == "profile_memory" and not r.get("oom") and not (
                r["peak_bytes"] is not None and r["weights_bytes"]
                + r["batch_bytes"] < r["peak_bytes"] <= total):
            raise AssertionError(f"profile_memory: peak out of range "
                                 f"(card {total} B): {r}")
        if (tool == "profile_roofline" and "spec_share" in r
                and r["spec_share"] > 1.05):
            raise AssertionError(f"profile_roofline: {r['tflops']:.1f} "
                                 f"TFLOP/s is above 105% of the "
                                 f"spec-sheet peak: {r}")
    if tool == "profile_roofline" and not any("spec_share" in r
                                              for r in rows):
        log(f"profile_roofline: no spec-sheet peak known for {kind}")


def _numbers(row):
    return [v for k, v in row.items() if isinstance(v, (int, float))
            and not isinstance(v, bool)] + [
        v for v in row["kernel_launches"].values()]


def start_tools(tools):
    """(start time, {tool: child}): every tool of ``tools`` (name ->
    arguments) started now as ``python -m rsgnet_tpu_torch.tools.<tool>``."""
    return time.perf_counter(), {tool: subprocess.Popen(
        [sys.executable, "-m", f"rsgnet_tpu_torch.tools.{tool}", *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tool, args in tools.items()}


def stop_tools(started):
    """Kill every child of ``start_tools`` that is still running."""
    for p in started[1].values():
        if p.poll() is None:
            p.kill()
            p.wait()


def children_phase(card, kind, label, tools, started, expected, holds,
                   budget_s):
    """Wait for the children ``start_tools(tools)`` started, then hold each
    one's rows: exit 0, at least one row, every row naming the card and
    torch's device name, without a failure, its numbers finite, the
    (shear warp, DARK) launches ``expected(tool, row)`` gives (None:
    unchecked), and ``holds(tool, rows)``. Returns each kernel's launches
    per tool over the tools' rows."""
    t0, procs = started
    outs = {}
    try:
        for tool, p in procs.items():
            outs[tool] = p.communicate(timeout=max(
                10.0, 400.0 - (time.perf_counter() - t0)))
    finally:
        stop_tools(started)
    launches = {"shear_warp": {}, "dark_decode": {}}
    for tool, p in procs.items():
        stdout, stderr = outs[tool]
        rows = [json.loads(ln) for ln in stdout.splitlines()
                if ln.startswith("{")]
        for r in rows:
            log(f"{tool}: {json.dumps(r)}")
        bad = [r for r in rows if "failed" in r or r.get("card") != card
               or r.get("device") != kind
               or not np.isfinite(_numbers(r)).all()]
        if p.returncode != 0 or not rows or bad:
            raise AssertionError(f"{tool}: rc {p.returncode}, {len(rows)} "
                                 f"rows, bad rows {bad}; stderr "
                                 f"{stderr[-3000:]}")
        for r in rows:
            want = expected(tool, r)
            got = (r["kernel_launches"]["shear_warp"],
                   r["kernel_launches"]["dark_decode"])
            if want is not None and got != want:
                raise AssertionError(f"{tool}: row {r} launched (shear warp,"
                                     f" DARK) {got}, expected {want}")
        holds(tool, rows)
        for k in launches:
            launches[k][tool] = sum(r["kernel_launches"][k] for r in rows)
        log(f"[{card}] {tool} {' '.join(tools[tool])}: {len(rows)} rows,"
            f" launches shear_warp {launches['shear_warp'][tool]}, "
            f"dark_decode {launches['dark_decode'][tool]}")
    wall = time.perf_counter() - t0
    log(f"{label} ({len(tools)} children): {wall:.1f} s since they started "
        f"(budget {budget_s} s{'' if wall <= budget_s else ', OVER'})")
    return launches


def profilers_phase(torch, card, kind, started):
    """Phase 31: the seven path dissections, children started together at
    reduced sizes (``start_tools(PROFILERS)``), and their holds."""
    total = torch.cuda.get_device_properties(0).total_memory
    return children_phase(
        card, kind, "phase 31 (the path dissections)", PROFILERS, started,
        expected_launches,
        lambda tool, rows: dissection_holds(tool, rows, kind, total),
        PROFILERS_BUDGET_S)


# -- phase 32: the A/B scripts that pick the defaults -------------------------

# script -> its arguments in phase 32: the card's default configs, cut to a
# small batch, few iterations and rounds (each script's full run is its own
# command)
AB_SCRIPTS = {
    "profile_s2d": ["--batch", "16", "--iters", "2", "--rounds", "2"],
    "profile_fuse_merged": ["--batch", "16", "--iters", "2", "--rounds",
                            "2"],
    "profile_fold_bn": ["--batch", "16", "--iters", "3", "--rounds", "2"],
    "profile_eval_warp": ["--b", "16", "--iters", "2", "--rounds", "1"],
    "profile_shear": ["--batch", "16", "--iters", "2"],
    "profile_nms": ["--images", "200"],
    "profile_loader": ["--images", "40", "--instances", "120", "--batch",
                       "16", "--grain-workers", "0", "2"],
    "profile_shear_ab_seeds": ["--seeds", "2", "--steps", "20"],
}
AB_BUDGET_S = 150


def ab_expected_launches(tool, row):
    """(shear warp, DARK) launches an A/B row must count: the shear warp
    once per step of an S2D or FUSE_MERGED train row and of a shear-trained
    seed, and once per call or step of a row whose ``impl`` is the kernel;
    0 else. No A/B script decodes with DARK (W32 and res50 use the quarter
    offset)."""
    if row.get("arm") == "train":
        return row["steps"], 0
    if row.get("kind") == "seed":
        return row["shear_steps"], 0
    from rsgnet_tpu_torch.tools._profiling import SHEAR_KERNEL
    if row.get("impl") == SHEAR_KERNEL:
        return row["steps"] if "steps" in row else row["calls"], 0
    return 0, 0


def ab_holds(tool, rows):
    """Phase 32's holds beyond the shared ones: every NMS row's keep sets
    agree; every crop row's difference is measured."""
    if tool == "profile_nms" and not all(r.get("agree") is True
                                         for r in rows):
        raise AssertionError(f"profile_nms: keep sets differ: {rows}")
    crops = [r for r in rows if r.get("kind") == "crop"]
    if tool == "profile_eval_warp" and not (crops and all(
            np.isfinite(r["max_abs_crop_diff"]) for r in crops)):
        raise AssertionError(f"profile_eval_warp: crop rows {crops}")


def ab_phase(card, kind, started):
    """Phase 32: the eight A/B scripts, children started together at
    reduced sizes (``start_tools(AB_SCRIPTS)``), and their holds."""
    return children_phase(card, kind, "phase 32 (the A/B scripts)",
                          AB_SCRIPTS, started, ab_expected_launches,
                          ab_holds, AB_BUDGET_S)





# -- phase 33: data parallelism over NCCL, a card each ------------------------


def cli_rank(out_dir, module, argv):
    """``--cli-rank OUT_DIR MODULE ARGV``: ``python -m MODULE ARGV`` run in
    this process as ``runpy`` runs it, counting both kernels' launches and
    keeping the last gathered eval result ``core/validate.py::
    _evaluate_and_log`` received; saved to ``OUT_DIR/cli_<RANK>.pt`` (rank
    0 without a launcher). Phase 15 runs its train CLI so, and phase 33b
    each rank under ``python -m torch.distributed.run``."""
    import runpy
    import torch
    sys.path.insert(0, ROOT)
    from rsgnet_tpu_torch.core import validate as tval
    from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode
    from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp
    out, evaluate = {}, tval._evaluate_and_log

    def capture(dataset, preds, boxes, ids, *rest):
        name_value, ap = evaluate(dataset, preds, boxes, ids, *rest)
        out.update(preds=preds, boxes=boxes, ids=ids,
                   name_value=dict(name_value), ap=ap)
        return name_value, ap

    tval._evaluate_and_log = capture
    sys.argv = [module, *argv]
    t = time.perf_counter()
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    torch.cuda.synchronize()
    out.update(rank=int(os.environ.get("RANK", "0")),
               wall_s=time.perf_counter() - t,
               card=torch.cuda.current_device(),
               omp_threads=os.environ.get("OMP_NUM_THREADS"),
               launches={"shear_warp": shear_warp.launches,
                         "dark_decode": dark_decode.launches})
    torch.save(out, os.path.join(out_dir, f"cli_{out['rank']}.pt"))
    return 0


def torchrun(world, module, argv, out_dir, timeout):
    """``python -m torch.distributed.run --nproc_per_node=<world>
    chip_smoke.py --cli-rank OUT_DIR MODULE ARGV`` on a free localhost
    port: each rank runs ``python -m MODULE ARGV`` (``cli_rank``). A
    launcher that fails or outlives ``timeout`` fails the phase, and its
    whole process group (the ranks) is killed. Returns (each rank's
    result, the launcher's output, wall seconds)."""
    import signal
    import torch
    os.makedirs(out_dir, exist_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes=1",
           f"--nproc_per_node={world}", "--master_addr=127.0.0.1",
           f"--master_port={free_port()}", os.path.abspath(__file__),
           "--cli-rank", out_dir, module, *argv]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torch.distributed.run -m {module} exited "
                             f"{proc.returncode}:\n{text[-6000:]}")
    ranks = [torch.load(os.path.join(out_dir, f"cli_{r}.pt"),
                        weights_only=False) for r in range(world)]
    if [r["card"] for r in ranks] != list(range(world)):
        raise AssertionError(f"-m {module}: ranks on cards "
                             f"{[r['card'] for r in ranks]}")
    return ranks, text, wall


def nccl_cli_phase(torch, card, dev, root, world):
    """Phase 33b: the CLIs under ``python -m torch.distributed.run
    --nproc_per_node=<world>`` with their default backend (NCCL: every rank
    has a card). The test CLI on W48 @ 384x288 DARK (seeded init) over
    ``root``'s set, held by ``test_cli_holds``; the train CLI on W32 for
    one epoch: exit 0, each rank on its own card, the shear warp once per
    step on each rank and DARK never; then the train CLI in this process,
    one process, resumes rank 0's ``checkpoint.pt`` for a second epoch.
    Returns (DARK's launches per rank in the test CLI, the shear warp's in
    the train CLI)."""
    from rsgnet_tpu_torch import train as train_cli
    from rsgnet_tpu_torch.data import get_dataset
    from rsgnet_tpu_torch.config.defaults import load_config, opts_to_dict
    from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp
    from rsgnet_tpu_torch.utils.checkpoint import peek_checkpoint
    launcher = f"python -m torch.distributed.run --nproc_per_node={world}"
    timeout = ["--dist-timeout", str(NCCL_TIMEOUT_S)]
    work = os.path.join(root, "cli_test")
    opts = test_cli_opts(root, work)
    argv = ["--cfg", W48_YAML, "--workers", "4", *timeout, *opts]
    torch.cuda.empty_cache()
    ranks, _, wall = torchrun(world, "rsgnet_tpu_torch.test", argv, work,
                              NCCL_CLI_TIMEOUT_S)
    test_launches = test_cli_holds(torch, f"{launcher} -m "
                                   f"rsgnet_tpu_torch.test (NCCL)", ranks,
                                   wall, argv, opts)

    work = os.path.join(root, "cli_train")
    opts = ["DATASET.ROOT", root, "DATASET.TRAIN_SET", "val",
            "DATASET.TEST_SET", "val", "OUTPUT_DIR",
            os.path.join(work, "output"), "LOG_DIR",
            os.path.join(work, "log"), "PRINT_FREQ", "1000"]
    argv = ["--cfg", W32_YAML, "--workers", "4", *timeout, *opts]
    cfg = load_config(W32_YAML, overrides=opts_to_dict(opts))
    n = len(get_dataset(cfg, is_train=True))
    bs = cfg.TRAIN.BATCH_SIZE_PER_GPU
    steps = n // (bs * world)
    ranks, _, wall = torchrun(world, "rsgnet_tpu_torch.train",
                              ["--max-epochs", "1", *argv], work,
                              NCCL_CLI_TIMEOUT_S)
    ckpt = os.path.join(work, "output", "coco", "pose_rsgnet", "w32_256x192",
                        "checkpoint.pt")
    peek = peek_checkpoint(ckpt)
    train_launches = [r["launches"]["shear_warp"] for r in ranks]
    log(f"{launcher} -m rsgnet_tpu_torch.train (NCCL), W32, one epoch: exit "
        f"0 in {wall:.1f} s; each rank's CLI "
        + ", ".join(f"{r['wall_s']:.1f}" for r in ranks) + " s; launches "
        + ", ".join(f"rank {r['rank']} {r['launches']}" for r in ranks)
        + f" ({steps} steps); AP " + " / ".join(
            f"{r['ap']:.4f}" for r in ranks) + f"; rank 0's checkpoint "
        f"{peek}")
    if any(r["launches"] != {"shear_warp": steps, "dark_decode": 0}
           for r in ranks):
        raise AssertionError(f"train CLI launches "
                             f"{[r['launches'] for r in ranks]}, expected "
                             f"the shear warp once per step ({steps})")
    if peek["epoch"] != 0 or peek["batch_in_epoch"] != 0:   # epoch 0 done
        raise AssertionError(f"rank 0's checkpoint: {peek}")

    # the second epoch in one process, resumed from that checkpoint
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        shear_warp.launches = 0
        state, _ = train_cli.main(["--max-epochs", "2", *argv])
        torch.cuda.synchronize()
        one_launches = shear_warp.launches
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    log(f"python -m rsgnet_tpu_torch.train in one process on that run "
        f"directory, --max-epochs 2: resumed at epoch 1, {state.step} steps "
        f"in all ({steps} on {world} ranks + {n // bs} at batch {bs}), "
        f"shear_warp launches {one_launches}")
    if state.step != steps + n // bs or one_launches != n // bs:
        raise AssertionError(f"the one-process resume ran to step "
                             f"{state.step}, launches {one_launches}")
    return test_launches, train_launches


def nccl_phase(torch, card, dev):
    """Phase 33: data parallelism over NCCL with a card for each rank, on
    every card of the machine up to ``NCCL_MAX_WORLD``: 33a ``fit``
    (``dp_fit_phase``) and 33b the CLIs under ``torch.distributed.run``
    (``nccl_cli_phase``), over a synthetic set of its own. On a machine
    with one card it prints that it needs two and runs nothing (no gloo in
    NCCL's place). Returns None there, else the kernels' launches per rank:
    {"fit": the shear warp's, "test_cli": DARK's, "train_cli": the shear
    warp's}."""
    from rsgnet_tpu_torch.data.synthetic import write_synthetic_coco
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"phase 33 (data parallelism over NCCL, a card each) needs two "
            f"or more cards; this machine has {cards}: not run")
        return None
    world = min(cards, NCCL_MAX_WORLD)
    t0 = time.perf_counter()
    version = torch.cuda.nccl.version()
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60).stdout
    log(f"phase 33: backend nccl, NCCL "
        f"{'.'.join(map(str, version)) if isinstance(version, tuple) else version}"
        f", {world} ranks of {cards} cards, rank r on card r (LOCAL_RANK): "
        + ", ".join(f"rank {r} -> card {r} {torch.cuda.get_device_name(r)}"
                    for r in range(world))
        + "; link topology (nvidia-smi topo -m):\n" + topo.rstrip())
    root = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    try:
        write_synthetic_coco(root, n_images=NCCL_IMAGES)
        fit = dp_fit_phase(torch, card, dev, root, world=world,
                           backend="nccl", epochs=NCCL_EPOCHS)
        test_cli, train_cli = nccl_cli_phase(torch, card, dev, root, world)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"phase 33 (NCCL, {world} cards): {wall:.1f} s (budget "
        f"{NCCL_BUDGET_S} s{'' if wall <= NCCL_BUDGET_S else ', OVER'})")
    return {"fit": fit, "test_cli": test_cli, "train_cli": train_cli}


def nccl_main(torch):
    """``python3 chip_smoke.py --nccl``: phases 1-2, the shear-warp kernel
    against its plain version at the train shape, both kernels timed as
    phases 5 and 9 time them, then phase 33 alone; the result lines as a
    full run prints them, ``launches`` being phase 33's over its ranks
    (DARK's in the test CLI, the shear warp's in ``fit``)."""
    from rsgnet_tpu_torch.config.defaults import load_config
    from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode
    from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp
    from rsgnet_tpu_torch.ops.decode import dark_decode_reference
    from rsgnet_tpu_torch.ops.shear_warp import (shear_prepare,
                                                 shear_warp_reference)
    from rsgnet_tpu_torch.tools._profiling import cuda_event_ms
    card, kind, dev, hm64, err64 = card_and_dark_phases(torch)
    blur = load_config(W48_YAML).TEST.BLUR_KERNEL
    dark = (cuda_event_ms(lambda: dark_decode(hm64, blur)),
            cuda_event_ms(lambda: dark_decode_reference(hm64, blur)),
            *dark_bound_ms(64, 17, 96, 72, blur))
    wcfg = load_config(W32_YAML)
    out_size = tuple(wcfg.MODEL.IMAGE_SIZE)
    canvases = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, (32, CANVAS, CANVAS, 3)).astype(np.uint8)).to(dev)
    mats = shear_matrices(torch, 32, CANVAS, wcfg, seed=6).to(dev)
    pos = shear_prepare(mats[:32], CANVAS, out_size)
    warp_err, equal = shear_vs_plain(torch, shear_warp, canvases, pos)
    if not equal:
        raise AssertionError(f"shear warp kernel vs plain: {warp_err}")
    warp = (cuda_event_ms(lambda: shear_warp(canvases, pos)),
            cuda_event_ms(lambda: shear_warp_reference(canvases, pos)),
            *shear_bound_ms(torch, canvases, pos)[:2],
            grid_sample_ms(torch, canvases, mats[:32], out_size))
    log(f"[{card}] dark_decode (64, 17, 96, 72) blur {blur}: kernel "
        f"{dark[0]:.4f} ms, plain {dark[1]:.4f} ms, bound {dark[2]:.4f} ms; "
        f"shear_warp at (32, {CANVAS}, {CANVAS}, 3) -> {out_size}: bit-equal"
        f" to its plain version, kernel {warp[0]:.4f} ms, plain "
        f"{warp[1]:.4f} ms, bound {warp[2]:.4f} ms, F.grid_sample "
        f"{warp[4]:.4f} ms")
    del hm64, canvases, mats, pos
    torch.cuda.empty_cache()
    nccl = nccl_phase(torch, card, dev)
    log(f"chip_smoke --nccl: {time.perf_counter() - _T0:.1f} s")
    if nccl is None:           # no NCCL run: no result
        return 1
    none = [0] * len(nccl["fit"])
    kernels = [{
        "name": "dark_decode", "route": "cuda",
        "source": "rsgnet_tpu_torch/csrc/dark_decode.cu",
        "replaces": "rsgnet_tpu/ops/pallas/dark_decode.py:48",
        "launches": sum(nccl["test_cli"]),
        "max_abs_err": err64[11], "ms": dark[0], "plain_ms": dark[1],
        "bound_ms": dark[2], "bound_by": dark[3], "library_ms": None,
        "nccl_fit_launches_per_rank": none,
        "nccl_test_cli_launches_per_rank": nccl["test_cli"],
    }, {
        "name": "shear_warp", "route": "cuda",
        "source": "rsgnet_tpu_torch/csrc/shear_warp.cu",
        "replaces": "rsgnet_tpu/ops/pallas/shear_warp.py:88",
        "launches": sum(nccl["fit"]),
        "max_abs_err": warp_err, "ms": warp[0], "plain_ms": warp[1],
        "bound_ms": warp[2], "bound_by": warp[3], "library_ms": warp[4],
        "library_call": "F.grid_sample bilinear zeros (the gather warp)",
        "nccl_fit_launches_per_rank": nccl["fit"],
        "nccl_test_cli_launches_per_rank": none,
        "nccl_train_cli_launches_per_rank": nccl["train_cli"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def build_kernels(names):
    """Build every ``csrc/<name>.cu`` at once, one process (one ``nvcc``)
    each, then load them here from the build directory."""
    from rsgnet_tpu_torch.ops.cuda import build
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys; from rsgnet_tpu_torch.ops.cuda."
         "build import load_library; load_library(sys.argv[1])", name],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name in names]
    outs = [p.communicate()[0] for p in procs]
    failed = [f"{n}: rc {p.returncode}\n{o[-3000:]}"
              for n, p, o in zip(names, procs, outs) if p.returncode != 0]
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    for name in names:
        build.load_library(name)


def step_metrics():
    """(list, restore): every step's (step, loss, acc) of the ``fit`` calls
    made until ``restore()``, as its train loop reads them
    (``train_one_epoch``'s ``on_metrics``)."""
    from rsgnet_tpu_torch.core import function
    seen, inner = [], function.train_one_epoch

    def recorded(*args, **kw):
        return inner(*args, on_metrics=lambda s, loss, acc: seen.append(
            (s, loss, acc)), **kw)

    function.train_one_epoch = recorded
    return seen, lambda: setattr(function, "train_one_epoch", inner)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


# (C, H, W) of W48 @ 384x288's BatchNorms: the stem at 192x144, layer1,
# then the four branches down to 12x9
W48_BN_PLANES = [(64, 192, 144), (256, 96, 72), (48, 96, 72), (96, 48, 36),
                 (192, 24, 18), (384, 12, 9)]
W48_BATCHNORMS = 293     # eval BatchNorms of one W48 @ 384x288 forward


def epilogue_vs_plain(torch, y, stats, addend, relu):
    """The ConvBN epilogue kernel against its plain version: one launch,
    and |kernel - plain| within 8 fp32 ulps of the magnitudes of the
    terms, |y s|, |m s|, |b| and |addend| (s = w / sqrt(v + eps)): the
    kernel rounds (y - m), its product with w * rsqrtf(v + eps) (rsqrtf 2
    ulps), + b and + addend apart, cuDNN's inference BatchNorm in its own
    order. Returns the largest error as a share of its bound."""
    from rsgnet_tpu_torch.ops.cuda.convbn_epilogue import (
        convbn_epilogue, convbn_epilogue_reference)
    w, b, m, v = stats
    before = convbn_epilogue.launches
    got = convbn_epilogue(y, w, b, m, v, 1e-5, addend, relu)
    want = convbn_epilogue_reference(y, w, b, m, v, 1e-5, addend, relu)
    torch.cuda.synchronize()
    if convbn_epilogue.launches != before + 1:
        raise AssertionError("the epilogue did not count one launch")
    s = w * torch.rsqrt(v + 1e-5)
    mag = ((y.float() * s[:, None, None]).abs()
           + (m * s).abs()[:, None, None] + b.abs()[:, None, None])
    if addend is not None:
        mag = mag + addend.abs()
    # a NaN both give is no error; where every term is 0 (a zero y with
    # zero mean and bias) the bound is 0, and so must the error be
    err = torch.where(torch.isnan(got) & torch.isnan(want), 0.0,
                      (got - want).abs())
    bound = 8 * 2.0 ** -24 * mag
    ratio = float(torch.where(bound > 0, err / bound,
                              torch.where(err == 0, 0.0, torch.inf)).max())
    if not ratio <= 1.0:
        raise AssertionError(f"epilogue {tuple(y.shape)} {y.dtype}: "
                             f"|kernel - plain| {ratio:.2f} x its bound")
    return ratio


def epilogue_bound_ms(y, addend):
    """Least time of the epilogue on an H100: y read once, the addend
    read once, the fp32 output written once, at 3.35 TB/s."""
    nbytes = y.numel() * (y.element_size() + 4 + (4 if addend is not None
                                                  else 0))
    return nbytes / HBM_BYTES_PER_S * 1e3


def epilogue_widths(torch, fn):
    """The vector widths (elements a thread) of the epilogue kernels that
    ``fn`` launches, in order: the second template argument of
    ``convbn_epilogue_kernel`` in a trace's kernel names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted((e.time_range.start, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "convbn_epilogue_kernel" in e.name)
    return [int(re.search(r"convbn_epilogue_kernel<[^,]+, *(?:\(int\))?"
                          r"(\d+)", n).group(1)) for _, n in names]


def epilogue_on_a_forward(torch, model, fn):
    """Each eval BatchNorm that ``fn()`` runs in ``model``, held against
    the plain version on its own input (``epilogue_vs_plain``). Returns
    (BatchNorms held, the largest error as a share of its bound)."""
    from rsgnet_tpu_torch.models.hrnet import BatchNorm
    ratios = []

    def hold(bn, args, kwargs):
        ratios.append(epilogue_vs_plain(
            torch, args[0], (bn.weight, bn.bias, bn.running_mean,
                             bn.running_var),
            kwargs.get("addend"), kwargs.get("relu", False)))

    hooks = [m.register_forward_pre_hook(hold, with_kwargs=True)
             for m in model.modules() if isinstance(m, BatchNorm)]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return len(ratios), max(ratios, default=0.0)


def epilogue_launches_hold(label, got, forwards):
    """The ConvBN epilogue launched once for each eval BatchNorm of the
    ``forwards`` W48 forwards of a stretch of the main path."""
    want = W48_BATCHNORMS * forwards
    if got != want:
        raise AssertionError(f"{label}: {got} ConvBN epilogue launches, "
                             f"expected {want} ({W48_BATCHNORMS} a forward "
                             f"x {forwards} forwards)")


def epilogue_phase(torch, card, dev):
    """Phase 34: the ConvBN epilogue kernel against its plain version at
    W48's plane sizes, and its time at the largest beside its bound and
    the plain chain's. Returns {label: (kernel ms, plain ms, bound ms)}."""
    from rsgnet_tpu_torch.ops.cuda.build import library_path
    from rsgnet_tpu_torch.ops.cuda.convbn_epilogue import (
        convbn_epilogue, convbn_epilogue_reference)
    from rsgnet_tpu_torch.tools._profiling import cuda_event_ms
    ptxas = library_path("convbn_epilogue")
    ptxas = ptxas.with_name(ptxas.stem[3:] + ".ptxas.txt")
    lines = sorted({ln.split(":", 1)[-1].strip()
                    for ln in ptxas.read_text().splitlines()
                    if "registers" in ln or "spill" in ln})
    log(f"ptxas, convbn_epilogue's instantiations: {lines}")
    g = torch.Generator(device=dev).manual_seed(34)

    def stats(c):
        return (torch.randn(c, device=dev, generator=g),
                0.5 * torch.randn(c, device=dev, generator=g),
                0.5 * torch.randn(c, device=dev, generator=g),
                torch.rand(c, device=dev, generator=g) * 2.0 + 0.05)

    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for c, h, w in W48_BN_PLANES:
            y = torch.randn((8, c, h, w), device=dev, generator=g).to(dtype)
            r = torch.randn((8, c, h, w), device=dev, generator=g)
            st = stats(c)
            for addend, relu in ((None, False), (None, True), (r, True)):
                worst = max(worst, epilogue_vs_plain(torch, y, st, addend,
                                                     relu))
            (width,) = epilogue_widths(
                torch, lambda: convbn_epilogue(y, *st, 1e-5, r, True))
            log(f"epilogue vs plain (8, {c}, {h}, {w}) {dtype}: within "
                f"the bound alone, with ReLU, with residual and ReLU; "
                f"{width} elements a thread (the trace's kernel name)")
    for c, h, w in ((256, 32, 24), (256, 64, 48)):   # ViTPose's decoder
        y = torch.randn((8, c, h, w), device=dev, generator=g).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        worst = max(worst, epilogue_vs_plain(torch, y, stats(c), None, True))
        log(f"epilogue vs plain (8, {c}, {h}, {w}) bf16 channels-last with "
            f"ReLU: within the bound")
    log(f"epilogue vs plain: largest |kernel - plain| {worst:.3f} x its "
        f"bound (8 fp32 ulps of the terms)")
    times = {}
    for label, (c, h, w), with_addend in (
            ("stem, ReLU", (64, 192, 144), False),
            ("layer1 block tail, residual and ReLU", (256, 96, 72), True)):
        y = torch.randn((64, c, h, w), device=dev, generator=g).to(
            torch.bfloat16)
        r = (torch.randn((64, c, h, w), device=dev, generator=g)
             if with_addend else None)
        st = stats(c)
        held = epilogue_vs_plain(torch, y, st, r, True)
        log(f"epilogue vs plain (64, {c}, {h}, {w}) bf16, the timed "
            f"tensors: {held:.3f} x the bound")
        k_ms = cuda_event_ms(lambda: convbn_epilogue(y, *st, 1e-5, r, True))
        p_ms = cuda_event_ms(
            lambda: convbn_epilogue_reference(y, *st, 1e-5, r, True))
        bound = epilogue_bound_ms(y, r)
        times[label] = (k_ms, p_ms, bound)
        log(f"[{card}] convbn_epilogue {label} (64, {c}, {h}, {w}) bf16: "
            f"kernel {k_ms:.4f} ms, plain chain {p_ms:.4f} ms, bound "
            f"{bound:.4f} ms (bytes); {100 * bound / k_ms:.1f}% of the "
            f"bound, {p_ms / k_ms:.2f}x faster than the plain chain")
        del y, r
    torch.cuda.empty_cache()
    return times


def card_and_dark_phases(torch):
    """Phases 1-2: the card, the kernels built, and the DARK kernel held
    against its plain version. Returns (the ``nvidia-smi`` card line,
    torch's device name, the device, the serving-shape heatmaps, DARK's
    max |coord diff| on them by blur)."""
    from rsgnet_tpu_torch.ops.cuda import build
    from rsgnet_tpu_torch.ops.cuda.dark_decode import (BLOCK_THREADS,
                                                       dark_decode,
                                                       shared_bytes)
    from rsgnet_tpu_torch.ops.decode import dark_decode_reference
    from rsgnet_tpu_torch.data.synthetic import HARD_DARK, hard_dark_heatmaps

    # -- 1. the card ------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0: {kind}; count {torch.cuda.device_count()}")
    dev = torch.device("cuda")

    # -- 2. kernel vs plain version ----------------------------------------
    t0 = time.perf_counter()
    names = ["dark_decode", "shear_warp", "convbn_epilogue"]
    build_kernels(names)                           # one nvcc each, at once
    log(f"built {', '.join(n + '.cu' for n in names)} in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(build.library_path(n).name for n in names))
    ptxas = build.library_path("dark_decode").with_name(
        build.library_path("dark_decode").stem[3:] + ".ptxas.txt")
    entry, regs = None, None
    for line in ptxas.read_text().splitlines():
        if "entry function" in line:
            entry = line.split("'")[1]
        elif entry and "ILi11E" in entry and any(
                x in line for x in ("registers", "spill", "smem")):
            cols = 4 if "ILi11ELi4E" in entry else 1
            log(f"ptxas, blur 11, {cols} column(s) per thread: "
                f"{line.strip()}")
            if cols == 4 and "registers" in line:
                regs = int(line.split("Used ")[1].split(" registers")[0])
    # maps per SM on an H100: 64 K registers (256 per warp at a time), 228
    # KB of shared memory (1 KB reserved per block), 2,048 threads
    smem = shared_bytes(96, 72, 11)
    warps = BLOCK_THREADS // 32
    by_regs = 65536 // (-(-regs * 32 // 256) * 256) // warps
    by_smem = 228 * 1024 // (smem + 1024)
    log(f"shared memory per map at 96x72, blur 11: {smem} B; maps per SM "
        f"{min(by_regs, by_smem, 2048 // BLOCK_THREADS)} (by registers "
        f"{by_regs}, by shared memory {by_smem}; blocks of "
        f"{BLOCK_THREADS} threads)")
    hm64 = torch.from_numpy(synthetic_heatmaps(64, 17, 96, 72, 0)).to(dev)
    err64 = {}
    for blur in (11, 3):
        err64[blur] = kernel_vs_plain(torch, dark_decode,
                                      dark_decode_reference, hm64, blur)
        log(f"kernel vs plain (64, 17, 96, 72) blur {blur}: peaks equal, "
            f"maxvals bit-equal, max |coord diff| {err64[blur]:.3e}")
    # ViTPose-H's maps at 256x192 (the vitpose_h.infer_b64 cell's B1 shape)
    hm_vit = torch.from_numpy(synthetic_heatmaps(64, 17, 64, 48, 2)).to(dev)
    kernel_vs_plain(torch, dark_decode, dark_decode_reference, hm_vit, 11)
    log("kernel vs plain (64, 17, 64, 48) blur 11: peaks equal, maxvals "
        "and coords bit-equal")
    edge = np.zeros((3, 7, 96, 72), np.float32)     # N*K = 21
    edge[0, 1, 1, 1] = 1.0                           # border peak
    edge[1, 2] = -1.0                                # maxval <= 0
    edge[2, 3, 40, 30] = edge[2, 3, 50, 20] = 2.0    # tie
    edge_t = torch.from_numpy(edge).to(dev)
    c, v = dark_decode(edge_t, 11)
    c, v = c.cpu().numpy(), v.cpu().numpy()
    if not (c[0, 0].tolist() == [0.0, 0.0] and v[0, 0, 0] == 0.0
            and c[0, 1].tolist() == [1.0, 1.0]
            and c[1, 2].tolist() == [0.0, 0.0] and v[1, 2, 0] == -1.0
            and abs(c[2, 3, 0] - 30) < 1 and abs(c[2, 3, 1] - 40) < 1):
        raise AssertionError(f"edge cases decode wrong: {c[:, :4]}")
    kernel_vs_plain(torch, dark_decode, dark_decode_reference, edge_t, 11)
    log("edge cases (zero map, border peak, maxval <= 0, tie, N*K=21): ok")
    for name, blur in sorted(HARD_DARK.items()):
        hard = torch.from_numpy(hard_dark_heatmaps(name)).permute(
            0, 3, 1, 2).contiguous().to(dev)
        kernel_vs_plain(torch, dark_decode, dark_decode_reference, hard, blur)
        log(f"hard case {name} {tuple(hard.shape)} blur {blur}: peaks, "
            f"maxvals and coords bit-equal")
    shifted = torch.empty(hm64.numel() + 1, device=dev)[1:].view(hm64.shape)
    shifted.copy_(hm64)                  # 4-byte aligned: the scalar path
    odd = torch.from_numpy(synthetic_heatmaps(2, 3, 37, 29, 1)).to(dev)
    for label, x, blur in (("misaligned serving batch", shifted, 11),
                           ("odd width 37x29", odd, 7)):
        kernel_vs_plain(torch, dark_decode, dark_decode_reference, x, blur)
        log(f"{label} {tuple(x.shape)} blur {blur}: bit-equal")
    return card, kind, dev, hm64, err64


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not importable", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "rsgnet_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (no "
              "rsgnet_tpu_torch/ beside this script)", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--dp-worker"]:    # a rank of phases 19-20 and 33a
        return dp_worker(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--cli-rank"]:     # phase 15, a rank of phase 33b
        return cli_rank(sys.argv[2], sys.argv[3], sys.argv[4:])
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--nccl"]:         # phases 1-2, then phase 33
        return nccl_main(torch)
    from rsgnet_tpu_torch import serve
    from rsgnet_tpu_torch.config.defaults import tiny_rsgnet
    from rsgnet_tpu_torch.core.inference import (heatmaps_with_flip_test,
                                                 make_inference_fn)
    from rsgnet_tpu_torch.data.skeletons import get_spec
    from rsgnet_tpu_torch.models import get_pose_net, init_weights
    from rsgnet_tpu_torch.ops.cuda import build
    from rsgnet_tpu_torch.models.hrnet import BatchNorm
    from rsgnet_tpu_torch.ops.cuda.convbn_epilogue import convbn_epilogue
    from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode
    from rsgnet_tpu_torch.ops.decode import dark_decode_reference
    from rsgnet_tpu_torch.ops.warp import normalize_image
    from rsgnet_tpu_torch.serving.http_server import (predict_image_remote,
                                                      predict_remote)
    from rsgnet_tpu_torch.config.defaults import load_config
    from rsgnet_tpu_torch.core.function import train_one_epoch
    from rsgnet_tpu_torch.core.train import (create_train_state,
                                             make_train_step)
    from rsgnet_tpu_torch.data.augment import draw_augment
    from rsgnet_tpu_torch.data.synthetic import synthetic_train_batch
    from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp
    from rsgnet_tpu_torch.ops.shear_warp import (shear_prepare,
                                                 shear_warp_reference)
    from rsgnet_tpu_torch.data.synthetic import HARD_WARPS, hard_warp_matrix
    from rsgnet_tpu_torch.tools._profiling import cuda_event_ms

    card, kind, dev, hm64, err64 = card_and_dark_phases(torch)
    epilogue_times = epilogue_phase(torch, card, dev)

    # -- 3. small-input reference: card vs CPU, fp32 tiny model ------------
    tcfg = tiny_rsgnet()
    tcfg.TEST.DECODE = "dark"
    tcfg.TEST.BLUR_KERNEL = 5
    tiny = init_weights(get_pose_net(tcfg), seed=1)
    tiny_cpu = get_pose_net(tcfg)
    tiny_cpu.load_state_dict(tiny.state_dict())
    rng = np.random.RandomState(2)
    req = (rng.randint(0, 256, (4, 96, 64, 3)).astype(np.uint8),
           rng.uniform(50, 300, (4, 2)).astype(np.float32),
           rng.uniform(0.4, 1.5, (4, 2)).astype(np.float32))
    p_gpu, v_gpu = make_inference_fn(tcfg, tiny, True, device="cuda")(*req)
    p_cpu, v_cpu = make_inference_fn(tcfg, tiny_cpu, True, device="cpu")(*req)
    torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=0, atol=1e-2)
    torch.testing.assert_close(v_gpu.cpu(), v_cpu, rtol=0, atol=1e-4)
    log(f"tiny fp32 RSGNet, card vs CPU: max |pred diff| "
        f"{float((p_gpu.cpu() - p_cpu).abs().max()):.3e} px, max |maxval "
        f"diff| {float((v_gpu.cpu() - v_cpu).abs().max()):.3e}")

    # -- 4. serve RSGNet-W48 @ 384x288, DARK, over HTTP --------------------
    args = serve.parse_args(["--cfg", W48_YAML, "--port", "0", "--buckets",
                             BUCKETS, "--seed", "0", "--max-wait-ms", "5",
                             "--in-flight", "2"])
    t0 = time.perf_counter()
    cfg, model = serve.load_model(args)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model {cfg.MODEL.NAME} W{cfg.MODEL.EXTRA.STAGE2.NUM_CHANNELS[0]} "
        f"{cfg.MODEL.IMAGE_SIZE[1]}x{cfg.MODEL.IMAGE_SIZE[0]} DTYPE "
        f"{cfg.DTYPE} DECODE {cfg.TEST.DECODE} blur {cfg.TEST.BLUR_KERNEL}: "
        f"{n_params} params, seeded init in {time.perf_counter() - t0:.1f} s")
    if cfg.TEST.DECODE != "dark" or cfg.MODEL.NAME != "pose_rsgnet":
        raise AssertionError("the W48 YAML no longer selects DARK RSGNet")
    t0 = time.perf_counter()
    engine, batcher, server = serve.build_server(args, cfg, model)
    log(f"warmed buckets {engine.buckets} in {time.perf_counter() - t0:.1f}"
        f" s; min s/dispatch {engine.bucket_cost}")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    url = "http://%s:%d" % server.server_address
    h, w = cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0]
    k = cfg.MODEL.NUM_JOINTS
    rng = np.random.RandomState(3)
    crop_reqs = [(rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
                  rng.uniform(100, 500, (n, 2)).astype(np.float32),
                  rng.uniform(0.8, 2.5, (n, 2)).astype(np.float32))
                 for n in (1, 8, 3, 5, 2, 8, 4, 7)]
    frame = rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    frame_boxes = [np.array([[40, 30, 120, 300], [200, 50, 150, 380],
                             [400, 100, 90, 200]], np.float32),
                   np.array([[10, 10, 300, 400], [350, 60, 200, 390],
                             [500, 200, 100, 150], [60, 250, 80, 160],
                             [250, 20, 60, 120], [300, 300, 150, 170]],
                            np.float32)]
    results, latencies, errors = {}, {}, []

    def client(i, kind_, payload):
        t = time.perf_counter()
        try:
            if kind_ == "predict":
                results[i] = predict_remote(url, *payload, timeout=300)
            else:
                results[i] = predict_image_remote(url, image=frame,
                                                  boxes=payload, timeout=300)
        except BaseException as e:          # re-raised below, in main
            errors.append((i, e))
        latencies[i] = time.perf_counter() - t

    jobs = [("predict", r) for r in crop_reqs] + \
           [("predict_image", b) for b in frame_boxes]
    passes = 2 if cfg.TEST.FLIP_TEST else 1
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    if n_bn != W48_BATCHNORMS:
        raise AssertionError(f"W48 has {n_bn} BatchNorms")
    # main path starts here
    dark_decode.launches = shear_warp.launches = convbn_epilogue.launches = 0
    batches_before = engine.stats()["batches"]
    try:
        threads = [threading.Thread(target=client, args=(i, kd, pl))
                   for i, (kd, pl) in enumerate(jobs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        launches = dark_decode.launches          # main path ends here
        warp_on_serve = shear_warp.launches
        serve_bn = convbn_epilogue.launches
        batches = engine.stats()["batches"] - batches_before
        stats = batcher.stats()
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        th.join(60)
    if errors:
        raise RuntimeError(f"requests failed: {errors}") from errors[0][1]
    if any(t.is_alive() for t in threads) or len(results) != len(jobs):
        raise RuntimeError("not every request came back")
    for i, (kd, pl) in enumerate(jobs):
        n = pl[0].shape[0] if kd == "predict" else pl.shape[0]
        p, v = results[i]
        if p.shape != (n, k, 2) or v.shape != (n, k, 1):
            raise AssertionError(f"request {i}: shapes {p.shape} {v.shape}")
        if not (np.isfinite(p).all() and np.isfinite(v).all()):
            raise AssertionError(f"request {i}: non-finite output")
    lat_ms = sorted(1e3 * x for x in latencies.values())
    log(f"served {len(jobs)} concurrent requests "
        f"({sum(r[0].shape[0] for r in crop_reqs)} crops + "
        f"{sum(len(b) for b in frame_boxes)} boxes) in {batches} engine "
        f"batches {stats['engine']['bucket_calls']}; kernel launches "
        f"{launches}, ConvBN epilogue {serve_bn}; request latency ms: p50 "
        f"{np.percentile(lat_ms, 50):.1f}"
        f" max {lat_ms[-1]:.1f}; mean batch fill "
        f"{stats['mean_batch_fill']:.2f}")
    if launches < 1 or launches != batches or warp_on_serve != 0:
        raise AssertionError(f"kernel launches {launches} != engine batches "
                             f"{batches}, or the shear warp ran "
                             f"({warp_on_serve})")
    epilogue_launches_hold("serving", serve_bn, passes * batches)

    # kernel vs plain on one served batch's heatmaps (8 crops, bucket 8)
    perm = torch.as_tensor(get_spec(cfg.DATASET.DATASET).flip_perm,
                           device=dev)
    with torch.inference_mode():
        x = torch.from_numpy(crop_reqs[1][0]).to(dev).float()
        x = normalize_image(x).permute(0, 3, 1, 2).contiguous()
        hm = heatmaps_with_flip_test(model, x, cfg, perm).contiguous()
        served_err = kernel_vs_plain(torch, dark_decode,
                                     dark_decode_reference, hm,
                                     cfg.TEST.BLUR_KERNEL)
        per_image = forward_flops(torch, model, x[:1])
        bn_held, bn_worst = epilogue_on_a_forward(
            torch, model, lambda: heatmaps_with_flip_test(model, x, cfg,
                                                          perm))
    log(f"served batch heatmaps {tuple(hm.shape)}: kernel peaks and maxvals "
        f"equal the plain version's; max |coord diff| {served_err:.3e}")
    if bn_held != passes * W48_BATCHNORMS:
        raise AssertionError(f"held {bn_held} BatchNorms of the served batch")
    log(f"ConvBN epilogue vs plain on each of the served batch's "
        f"{bn_held} BatchNorms (bucket 8, flip-test), on its own input: "
        f"largest |kernel - plain| {bn_worst:.3f} x its bound")
    log(f"model forward: {per_image / 1e9:.2f} GFLOP per image (convs and "
        f"linears), {passes} passes per image")

    # -- 5. serving timings -----------------------------------------------
    timing = {}
    blur = cfg.TEST.BLUR_KERNEL
    one = torch.empty(1, device=dev)
    log(f"[{card}] cuda_event_ms floor (zero_ of one float): "
        f"{cuda_event_ms(one.zero_):.4f} ms")
    for n in (1, 8, 32, 64):
        hm_n = hm64[:n].contiguous()
        ms = cuda_event_ms(lambda: dark_decode(hm_n, blur))
        plain_ms = cuda_event_ms(lambda: dark_decode_reference(hm_n, blur))
        read_ms = cuda_event_ms(hm_n.amax)
        bound, by = dark_bound_ms(n, 17, 96, 72, blur)
        timing[n] = (ms, plain_ms, bound, by)
        log(f"[{card}] dark_decode bucket {n} ({n * 17} maps): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
            f"({by}); {100 * bound / ms:.1f}% of the bound; a plain read "
            f"of the same maps (amax) {read_ms:.4f} ms")
    serve_fn = engine._fn
    req32 = (np.random.RandomState(4).randint(0, 256, (32, h, w, 3))
             .astype(np.uint8), np.full((32, 2), 200.0, np.float32),
             np.full((32, 2), 1.5, np.float32))
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = serve_fn(*req32)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    assert out[0].shape == (32, k, 2)
    log(f"[{card}] inference call, bucket 32 (uint8 crops in, flip-test, "
        f"DARK, image coords out): median {1e3 * np.median(walls):.2f} ms, "
        f"min {1e3 * min(walls):.2f} ms = {32 / min(walls):.1f} images/s")
    log(f"[{card}] request latency over HTTP (phase 4): "
        + ", ".join(f"{x:.1f}" for x in lat_ms) + " ms")
    n_kernels = profile_device(torch, lambda: serve_fn(*req32), card,
                               32 * passes * per_image,
                               "one bucket-32 inference call")
    profile_device(torch, lambda: serve_fn(*(a[:1] for a in req32)), card,
                   passes * per_image, "one bucket-1 inference call")
    log(f"serving kernels per bucket-32 inference call: {n_kernels} "
        f"(before the train slice: {SERVE_KERNELS_BEFORE})")
    if n_kernels > SERVE_KERNELS_BEFORE:
        raise AssertionError(f"serving launches {n_kernels} kernels per "
                             f"bucket-32 call, more than "
                             f"{SERVE_KERNELS_BEFORE}")
    serve_launches = launches
    del engine, batcher, server, model, serve_fn
    torch.cuda.empty_cache()

    # -- 6. the shear-warp kernel vs its plain version ---------------------
    ptxas = build.library_path("shear_warp").with_name(
        build.library_path("shear_warp").stem[3:] + ".ptxas.txt")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "entry function" in line:        # the kernel named below
                log(f"ptxas: {line.split(chr(39))[1][:40]}...")
            elif any(w in line for w in ("registers", "spill", "smem")):
                log(f"ptxas:   {line.strip()}")
    wcfg = load_config(W32_YAML)
    out_size = tuple(wcfg.MODEL.IMAGE_SIZE)
    rng = np.random.RandomState(5)
    canvases = torch.from_numpy(rng.randint(0, 256, (32, CANVAS, CANVAS, 3))
                                .astype(np.uint8)).to(dev)
    mats = shear_matrices(torch, 32, CANVAS, wcfg, seed=6).to(dev)
    aug_pos = shear_prepare(mats[:32], CANVAS, out_size)
    fixed_pos = shear_prepare(mats[32:], CANVAS, out_size)
    if not (fixed_pos.swap.any() and not fixed_pos.swap.all()):
        raise AssertionError("the fixed matrices miss one of the frames")
    floats = torch.from_numpy(rng.uniform(-1, 2, (8, CANVAS, CANVAS, 3))
                              .astype(np.float32)).to(dev)
    odd = torch.from_numpy(rng.randint(0, 256, (9, 97, 97, 3))
                           .astype(np.uint8)).to(dev)
    ocfg = copy.deepcopy(wcfg)
    ocfg.MODEL.IMAGE_SIZE = (40, 56)
    odd_pos = shear_prepare(shear_matrices(torch, 1, 97, ocfg, 7).to(dev),
                            97, (40, 56))
    cases = [("train shape, augmentation matrices", canvases, aug_pos, 255.0),
             ("fixed rotations, flips, transposed frame", canvases[:8],
              fixed_pos, 255.0),
             ("float32 source of range 3", floats, fixed_pos, 3.0),
             ("odd size 97 -> 40x56", odd, odd_pos, 255.0)]
    for i, name in enumerate(sorted(HARD_WARPS)):
        pos_i = shear_prepare(torch.from_numpy(
            hard_warp_matrix(name, CANVAS, out_size)).to(dev), CANVAS,
            out_size)
        cases += [(f"hard matrix {name}", canvases[i:i + 1], pos_i, 255.0),
                  (f"hard matrix {name}", floats[i:i + 1], pos_i, 3.0)]
    warp_err = 0.0
    for label, images, pos, span in cases:
        err, equal = shear_vs_plain(torch, shear_warp, images, pos)
        err255 = err * 255.0 / span
        log(f"shear_warp kernel vs plain, {label} {tuple(images.shape)} "
            f"{str(images.dtype)[6:]}: max |diff| {err:.3e} ({err255:.3e} "
            f"on 0-255), bit-equal {equal}")
        if err255 > 1e-3 or not equal:
            raise AssertionError(f"shear warp kernel disagrees with its plain "
                                 f"version: {err255} on 0-255, bit-equal "
                                 f"{equal}")
        if label.startswith("train shape"):
            warp_err = err

    # -- 7. small-input reference: a tiny fp32 train step, card vs CPU -----
    tcfg = tiny_rsgnet()
    tcfg.TRAIN.OPTIMIZER = "sgd"
    spec = get_spec("coco")
    tiny = init_weights(get_pose_net(tcfg), seed=1)
    tb = synthetic_train_batch(4, 128, seed=2)
    tdraws = draw_augment(torch.Generator().manual_seed(3), 4)
    res = {}
    for d in (dev, torch.device("cpu")):
        st = create_train_state(tcfg, copy.deepcopy(tiny), device=d)
        batch = {kk: torch.from_numpy(v) for kk, v in tb.items()}
        batch["image"] = batch["image"].to(d)
        st, met = make_train_step(tcfg, spec)(st, batch, tdraws)
        res[d.type] = (float(met["loss"]),
                       {nm: (q.detach().cpu(), q.grad.cpu())
                        for nm, q in st.model.named_parameters()})
    torch.testing.assert_close(res["cuda"][0], res["cpu"][0], rtol=1e-4,
                               atol=0)
    rels, p_err = [], 0.0
    for nm, (p_cpu, g_cpu) in res["cpu"][1].items():
        p_gpu, g_gpu = res["cuda"][1][nm]
        scale = max(float(g_cpu.abs().max()), 1e-12)
        rels.append(float((g_gpu - g_cpu).abs().max()) / scale)
        if rels[-1] > 5e-2:
            raise AssertionError(f"tiny step grad {nm}: rel {rels[-1]}")
        torch.testing.assert_close(p_gpu, p_cpu, rtol=0,
                                   atol=1e-6 + tcfg.TRAIN.LR * 5e-2 * scale)
        p_err = max(p_err, float((p_gpu - p_cpu).abs().max()))
    if np.mean(rels) > 3e-3:
        raise AssertionError(f"tiny step grads: mean rel {np.mean(rels)}")
    log(f"tiny fp32 train step (SGD), card vs CPU: loss {res['cuda'][0]:.6f}"
        f" vs {res['cpu'][0]:.6f}; grads max rel {max(rels):.3e}, mean "
        f"{np.mean(rels):.3e}; updated params max |diff| {p_err:.3e}")

    # -- 8. train RSGNet-W32 @ 256x192, the train slice's main path --------
    t0 = time.perf_counter()
    wmodel = init_weights(get_pose_net(wcfg), seed=0)
    n_params = sum(q.numel() for q in wmodel.parameters())
    state = create_train_state(wcfg, wmodel, device="cuda")
    step_fn = make_train_step(wcfg, get_spec(wcfg.DATASET.DATASET))
    bs = wcfg.TRAIN.BATCH_SIZE_PER_GPU
    log(f"model {wcfg.MODEL.NAME} W{wcfg.MODEL.EXTRA.STAGE2.NUM_CHANNELS[0]} "
        f"{out_size[1]}x{out_size[0]} DTYPE {wcfg.DTYPE} optimizer "
        f"{wcfg.TRAIN.OPTIMIZER} lr {wcfg.TRAIN.LR} batch {bs} TRAIN.WARP "
        f"{wcfg.TRAIN.WARP}: {n_params} params, seeded init in "
        f"{time.perf_counter() - t0:.1f} s")
    if (wcfg.MODEL.NAME != "pose_rsgnet" or wcfg.DTYPE != "bfloat16"
            or wcfg.TRAIN.OPTIMIZER != "adam" or bs != 32):
        raise AssertionError("the W32 YAML no longer selects bf16 Adam "
                             "RSGNet at batch 32")
    raw = synthetic_train_batch(bs, CANVAS, seed=8)
    seen = []
    t0 = time.perf_counter()
    dark_decode.launches = shear_warp.launches = 0   # main path starts here
    state, mean_loss, done, _ = train_one_epoch(
        step_fn, state, [raw] * TRAIN_STEPS, seed=9,
        on_metrics=lambda st_, loss, acc: seen.append((loss, acc)))
    torch.cuda.synchronize()
    warp_launches = shear_warp.launches               # main path ends here
    dark_on_train = dark_decode.launches
    train_s = time.perf_counter() - t0
    losses = [x[0] for x in seen]
    log(f"trained {done} steps in {train_s:.1f} s (first step included): "
        f"loss " + ", ".join(f"{x:.5f}" for x in losses) + "; acc "
        + ", ".join(f"{x[1]:.3f}" for x in seen) + f"; shear_warp launches "
        f"{warp_launches}, dark_decode launches {dark_on_train}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if done != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"train steps {done}, losses {losses}")
    if not (losses[-1] < losses[0]
            and np.mean(losses[-3:]) < np.mean(losses[:3])):
        raise AssertionError(f"the loss on the repeated batch did not fall: "
                             f"{losses}")
    if warp_launches != TRAIN_STEPS or dark_on_train != 0:
        raise AssertionError(f"shear_warp launches {warp_launches} != "
                             f"{TRAIN_STEPS} steps, or dark_decode ran "
                             f"({dark_on_train})")

    # -- 9. timings of the train slice --------------------------------------
    warp_ms = cuda_event_ms(lambda: shear_warp(canvases, aug_pos))
    warp_plain_ms = cuda_event_ms(lambda: shear_warp_reference(canvases,
                                                                   aug_pos))
    warp_bound, warp_by, warp_bytes, src_bytes = shear_bound_ms(
        torch, canvases, aug_pos)
    gs_ms = grid_sample_ms(torch, canvases, mats[:32], out_size)
    log(f"[{card}] shear_warp at (32, {CANVAS}, {CANVAS}, 3) uint8 -> (32, "
        f"3, {out_size[1]}, {out_size[0]}) fp32: kernel {warp_ms:.4f} ms, "
        f"plain {warp_plain_ms:.4f} ms, bound {warp_bound:.4f} ms "
        f"({warp_by}: {warp_bytes / 1e6:.1f} MB = output "
        f"{(warp_bytes - src_bytes) / 1e6:.1f} MB + source footprint "
        f"{src_bytes / 1e6:.1f} MB of {canvases.numel() / 1e6:.1f} MB); "
        f"F.grid_sample (the gather warp, fp32 NCHW source; equals the "
        f"shear warp only at rot 0/+-90/flips) {gs_ms:.4f} ms")
    log(f"[{card}] shear_warp kernel: {100 * warp_bound / warp_ms:.1f}% of "
        f"its bound ({warp_ms / warp_bound:.2f}x the bound), "
        f"{warp_ms / gs_ms:.3f}x the time of F.grid_sample "
        f"({'faster' if warp_ms < gs_ms else 'slower'})")
    step_s = steady_step_s(torch, step_fn, state, raw, 6)
    log(f"[{card}] train step, batch {bs} (host batch in, pinned copy, "
        f"augmentation, forward, backward, Adam): {1e3 * step_s:.2f} ms = "
        f"{bs / step_s:.1f} images/s (mean of 6 steps)")
    draws = draw_augment(torch.Generator().manual_seed(12), bs)
    batch = {kk: torch.from_numpy(v) for kk, v in raw.items()}
    batch["image"] = batch["image"].to(dev)
    with torch.no_grad():
        x = torch.zeros(1, 3, out_size[1], out_size[0], device=dev)
        fwd = forward_flops(torch, state.model.eval(), x)
    profile_device(torch, lambda: step_fn(state, batch, draws), card,
                   3 * bs * fwd, f"one train step at batch {bs} (forward "
                   f"{fwd / 1e9:.2f} GFLOP per image; x3 for fwd+bwd)")

    # -- 10. eval RSGNet-W48 @ 384x288 with DARK, the eval slice's path --
    del state, step_fn, wmodel, batch
    torch.cuda.empty_cache()
    ecfg = load_config(W48_YAML)
    eroot = tempfile.mkdtemp(prefix="chip_smoke_coco_")
    try:
        eval_out = eval_phases(torch, ecfg, eroot, card, dev, per_image)
    finally:
        shutil.rmtree(eroot, ignore_errors=True)
    # DARK and the epilogue: the validate() run's counts
    eval_dark, eval_shear, eval_bn = eval_out

    # -- 13-14. training through fit and the train CLI; the eval CLI -------
    froot = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    try:
        best_pt, fit_steps = fit_phases(torch, card, dev, froot, step_s)
        test_cli_dark = test_cli_phase(torch, card, dev, froot, best_pt)
        torch.cuda.empty_cache()
        # -- 15. ResNet-152 @ 384x288 on phase 13's set, the slice's path --
        resnet = resnet_phases(torch, card, dev, froot)
        # -- 16-18. CrowdPose, MPII, the infer CLI ---------------------------
        crowdpose_phase(torch, card, os.path.join(froot, "crowdpose"))
        mpii_phase(torch, card, os.path.join(froot, "mpii"))
        infer_phase(card, froot, resnet["best_pt"])
        torch.cuda.empty_cache()
        # -- 19-20. two ranks on the card over gloo: fit, the test CLI -------
        dp_fit_launches = dp_fit_phase(torch, card, dev, froot)
        dp_test_launches = dp_test_cli_phase(torch, card, dev, froot)
        # -- 25-27. the process loader, the trace windows, the decoder -------
        t0 = time.perf_counter()
        grain_launches = grain_phase(torch, card, dev, froot)
        log(f"phases 25-27: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(froot, ignore_errors=True)
    # -- 21-23. TRAIN.REMAT, MODEL.FUSE_MERGED, MODEL.S2D_STEM ---------------
    remat_phase(torch, card, dev)
    fuse_phase(torch, card, dev)
    s2d_phase(torch, card, dev)
    # -- 24. serve W48 DARK from an exported artifact, the slice's path -----
    etmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    t0 = time.perf_counter()
    try:
        export = export_phase(torch, card, dev, etmp)
    finally:
        shutil.rmtree(etmp, ignore_errors=True)
    log(f"phase 24: {time.perf_counter() - t0:.1f} s")
    # -- 28-30. the bench and the serving profilers, each in a child ---------
    t0 = time.perf_counter()
    bench_launches, bench_warp = bench_phase(torch, card, kind, dev)
    log(f"phase 28 (bench): {time.perf_counter() - t0:.1f} s")
    serving_phases(card)
    # -- 31-32. the path dissections and the A/B scripts: fifteen children
    # started at once (held one phase after the other) --------------------
    started = (start_tools(PROFILERS), start_tools(AB_SCRIPTS))
    try:
        profilers_launches = profilers_phase(torch, card, kind, started[0])
        for k, per_tool in ab_phase(card, kind, started[1]).items():
            profilers_launches[k].update(per_tool)
    finally:
        for group in started:
            stop_tools(group)

    log(f"phases 1-32: {time.perf_counter() - _T0:.1f} s")
    # -- 33. data parallelism over NCCL, a card each (two cards or more) ----
    nccl = nccl_phase(torch, card, dev)
    none = [0] * len(nccl["fit"]) if nccl else None

    # -- 12. result lines ----------------------------------------------------
    ms, plain_ms, bound, by = timing[64]
    kernels = [{
        "name": "dark_decode",
        "route": "cuda",
        "source": "rsgnet_tpu_torch/csrc/dark_decode.cu",
        "replaces": "rsgnet_tpu/ops/pallas/dark_decode.py:48",
        "launches": serve_launches,
        "max_abs_err": err64[11],
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "bound_share": bound / ms,
        "library_ms": None,
        "eval_launches": eval_dark,
        "fit_launches": 0,
        "test_cli_launches": test_cli_dark,
        "resnet_fit_launches": 0,
        "dp_fit_launches_per_rank": [0] * DP_WORLD,
        "dp_test_cli_launches_per_rank": dp_test_launches,
        "nccl_fit_launches_per_rank": none,
        "nccl_test_cli_launches_per_rank": nccl and nccl["test_cli"],
        "export_launches": {"serve": export["serve"][0],
                            "e2e": export["e2e"][0]},
        "grain_fit_launches": grain_launches[1],
        "bench_train_launches": bench_launches["dark_decode"],
        "profilers_launches": profilers_launches["dark_decode"],
        "export_call_ms": export["call_ms"],
        "shape": [64, 17, 96, 72],
        "blur_kernel": blur,
        "bucket_ms": {str(b): timing[b][0] for b in sorted(timing)},
    }, {
        "name": "shear_warp",
        "route": "cuda",
        "source": "rsgnet_tpu_torch/csrc/shear_warp.cu",
        "replaces": "rsgnet_tpu/ops/pallas/shear_warp.py:88",
        "launches": warp_launches,
        "max_abs_err": warp_err,
        "ms": warp_ms,
        "plain_ms": warp_plain_ms,
        "bound_ms": warp_bound,
        "bound_by": warp_by,
        "library_ms": gs_ms,
        "library_call": "F.grid_sample bilinear zeros (the gather warp)",
        "eval_launches": eval_shear,
        "fit_launches": fit_steps,
        "test_cli_launches": 0,
        "resnet_fit_launches": resnet["fit_launches"],
        "dp_fit_launches_per_rank": dp_fit_launches,
        "dp_test_cli_launches_per_rank": [0] * DP_WORLD,
        "nccl_fit_launches_per_rank": nccl and nccl["fit"],
        "nccl_test_cli_launches_per_rank": none,
        "nccl_train_cli_launches_per_rank": nccl and nccl["train_cli"],
        "export_launches": {"serve": export["serve"][1],
                            "e2e": export["e2e"][1]},
        "grain_fit_launches": grain_launches[0],
        "bench_train_launches": bench_launches["shear_warp"],
        "profilers_launches": profilers_launches["shear_warp"],
        "shape": [32, CANVAS, CANVAS, 3],
        "out_size": list(out_size),
        "resnet": {"shape": [32, CANVAS, CANVAS, 3], "out_size": [288, 384],
                   **resnet["warp"]},
        "bench_train": bench_warp,
    }]
    stem_ms, stem_plain_ms, stem_bound = epilogue_times["stem, ReLU"]
    kernels.append({
        "name": "convbn_epilogue",
        "route": "cuda",
        "source": "rsgnet_tpu_torch/csrc/convbn_epilogue.cu",
        "replaces": None,
        "launches": serve_bn,
        "launches_per_forward": W48_BATCHNORMS,
        "eval_launches": eval_bn,
        "export_launches": {"serve": export["serve"][2],
                            "e2e": export["e2e"][2]},
        "ms": stem_ms,
        "plain_ms": stem_plain_ms,
        "bound_ms": stem_bound,
        "bound_by": "bytes",
        "shape": [64, 64, 192, 144],
        "timed": {k: {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2]}
                  for k, v in epilogue_times.items()},
    })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
