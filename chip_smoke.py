#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``multishiftseg_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
device and ``nvcc``; without a device, or without the package beside it, it
exits non-zero and prints no result. Phases, one JSON line each:

1. ``build``: compile every ``multishiftseg_torch/csrc/*.cu`` with nvcc for
   sm_90a, all sources at once, into the package's git-ignored ``build/``.
2. ``kernels``: each kernel entry point at the main-path shapes (Mask2Former R-50,
   1024x2048, batch 1) against its plain PyTorch version on the same inputs, with
   a stated tolerance; plus small inputs with a degenerate h == 1 level and with
   points outside the map. Median time of kernel and plain version, and the
   bound (the larger of bytes over 3.35 TB/s and f32 operations over
   67 TFLOP/s, counted from this run's inputs).
3. ``slice_parity``: the port's MaskFormer at full widths and a reduced image,
   in f32 with TF32 off, on the card (kernels) against the same weights on the
   CPU (plain versions).
4. ``serve``: ``build_m2f_request_forward`` on the full-width R-50 model in
   bf16 with 1024x2048 uint8 images made from a seed, 3 requests after warm-up
   in each setting of ``SERVE_SETTINGS`` (``bilinear``, ``nearest``, ``int8``,
   ``nearest_top6``, ``nearest_top6c``, ``shared``, a bilinear / nearest_top6c
   hybrid, ``nearest`` with ``score_lowres`` and with ``score_topq=32``), with
   the kernel launch counts of those requests (the setting's deformable
   entries, 6 a request, 3 + 3 for the hybrid, 6 quantize launches more for
   int8; one anomaly tail, on 32 queries for topq and at the identity resize
   for lowres; one semantic tail; nothing else), one profiled request and the
   OOD metrics of a synthetic label map (random weights: their values mean
   nothing).
5. ``train_parity``, once per seed of ``TRAIN_PARITY_SEEDS``: one stage-2 step
   of ``TrainM2FOOD`` (exps/m2f.yaml) at full widths on 2 pairs of 256x256
   crops, f32 with TF32 off, on the card (kernels) and on the CPU (plain
   versions) from the same weights, batch and CPU-made draws: the pixel
   decoder's outputs, the attention masks, the assignment, loss components,
   gradients per parameter group (both f32 steps against a float64 step on the
   CPU) and updated parameters.
6. ``train``: the stage-2 step at exps/m2f.yaml's settings (8 pairs of 700x700
   crops padded to 704, bf16 autocast, f32 master weights; the deformable
   encoder rematerialised, as in every training step): 2 warm-up and 3
   timed steps, with the launch counts of the timed steps, the losses, the
   gradient norm, peak memory and one profiled step.

7. ``deeplab_parity``: the port's DeepLab v3+ WRN-38 at full widths and a
   256x512 image, in f32 with TF32 off, on the card (kernels) against the same
   weights on the CPU (plain versions): trunk output, score and logits.
8. ``deeplab_serve``: ``build_deeplab_forward`` at 1024x2048, batch 1, bf16
   autocast over f32 weights, 3 requests after 2 warm-up, with their launch
   counts (3 dilated convs a request, no other kernel) and one profiled request.
9. ``deeplab_train_parity``, once per seed of ``DL_TRAIN_PARITY_SEEDS``: one
   stage-0 and then one stage-1 step of ``TrainDeepLabOOD`` (exps/deeplab.yaml)
   at full widths on 2 pairs of 200x200 crops, f32 with TF32 off, card against
   CPU from the same weights, batch and CPU-made draws (RCL noise and dropout
   masks): losses, running statistics, updates, the frozen parameters, and the
   card's trainable gradients against a float64 CPU step (in stage 1 one that
   follows the card's ReLU branches), with the ReLU and pixel-selection flips
   between the f32 and float64 steps counted.
10. ``deeplab_train``: stage 0 and then stage 1 at exps/deeplab.yaml's settings
   (8 pairs of 700x700 crops, bf16 autocast, f32 master weights), each with 2
   warm-up and 3 timed steps, their launch counts and one profiled step.
11. ``stage1_parity``: one M2F stage-1 step (RCL on the anomaly score, Adam
   over ``class_embed2``) at full widths on 2 pairs of 256x256, f32 with TF32
   off, card against CPU from the same weights, batch and CPU-made RCL noise,
   the CPU attending with the card's attention masks: losses, the gradient
   against a float64 CPU step, the Adam update, every other parameter unchanged.
12. ``stage1_train``: stage 1 at exps/m2f.yaml's settings (8 pairs of 700x700
   padded to 704, bf16): 2 warm-up and 3 timed steps, launch counts, peak
   memory, one profiled step; then ``set_stage(1)`` and one stage-2 step.
13. ``validate``: ``TrainM2FOOD.valid`` and ``TrainDeepLabOOD.valid`` over 10
   in-memory images (6 at 720x1280, 4 at 1024x2048: two buckets), labels
   0/1/255: seconds per image, and the binned metrics against the exact ones
   on the same maps, within 2/8192.
14. ``evaluate``: the eval CLI (``test_runner.main``) for ``--model m2f`` and
   ``--model deeplab`` on a temporary RoadAnomaly21-layout folder (4 jpg
   images of 720x1280 with their label pngs) named in a temporary YAML, with
   a detectron2-style checkpoint of the seeded model and ``--save_outputs``;
   then the CLI with ``--sample_mode nearest_top6c --score_topq 32``, and
   ``multishiftseg_torch.tools.validate_release.qualify_sampling_modes`` over
   its six settings on the same folder against the ``bilinear`` run, writing
   the artifact, after which the gate must refuse exactly the settings
   recorded unqualified; and ``OODEvaluator`` on the m2f run: seconds per
   image and the route of its exact metrics (the native one must run: the
   folder holds over 2,000,000 labelled pixels), then ``eval_ood_measure``
   on the evaluator's own scores and labels by that route and with
   ``use_native=False``: seconds each.
15. ``train_loop``: both trainers' ``train()``, the epoch loop a user runs
   (``python -m multishiftseg_torch.train.cli``), from their recipes' yaml with
   only the dataset roots, ``n_epochs = 2`` and ``warmup_epoch = 1`` overridden
   (full widths, batch 8, crop 700, bf16, 4 loader workers), on a synthetic
   tree made from ``SEED`` (16 Cityscapes frames of 1024x2048 with one
   generated variant each, a 4-image COCO bank, 4 RoadAnomaly21 images of
   720x1280): one epoch in each stage, two steps and a validation each, the
   checkpoints; then a resume from ``last`` with ``n_epochs = 3`` whose epoch
   runs in stage 1 with the saved optimizer state and best AUPRC. Per epoch:
   steps, stage, seconds, images/s, the median step, the loader's wait a
   step; peak memory, the decoder, the files, and the launches, which must
   include every training kernel of the trainer and the binned metrics.
16. ``instance_parity``: one ``TrainM2FInstance`` step of
   exps/m2f_instance.yaml (the vanilla decoder, 48 target slots, deep
   supervision over 9 layers) at full widths on 2 unpadded 200x200 crops, f32
   with TF32 off, card against CPU and a float64 CPU step from the same
   weights, batch and CPU-made draws, the CPU steps attending with the card's
   attention masks and matching with its assignments (each within 1e-5 of the
   CPU's own optimum on the CPU's costs): losses, the AdamW update, the
   gradients against a float64 step on the card's ReLU branches (each
   replayed unit's input within rounding of 0), the launches (6 + 6
   deformable, 10 assignments, 20 label points); then
   ``instance_inference`` / ``panoptic_inference`` on the card against the
   CPU on the same logits (the model's at 256x512, and confident synthetic
   ones at 512x1024).
17. ``instance_train``: the three vanilla recipes,
   exps/m2f_{instance,panoptic,semantic}.yaml, at their own widths (batch 8,
   unpadded crops 700x700 / 700x700 / 512x1024, 48 / 48 / 20 slots, bf16)
   through ``train()`` on a generated Cityscapes tree of 24 train and 2 val
   frames of 1024x2048 (instanceIds, panoptic pngs and json, labelTrainIds),
   one epoch of 3 steps, the instance recipe then through a resume from
   ``last``; then ``evaluate(max_images=2)`` at 1024x2048 for each (AP, +PQ,
   or mIoU; random weights: the values mean nothing). Per recipe: epoch
   seconds, images/s, the median step, the loader's wait, peak memory, the
   launches of train and of evaluate.
18. ``alt_parity``: the alternates in f32 (TF32 off), card against CPU from
   the same seeded weights on a 256x512 image: Swin-L and R-101 MaskFormer at
   full widths (MSDeformAttn + GMA, the CPU attending with the card's masks),
   the FPN pixel decoder (under the GMA decoder) and the transformer-encoder
   one (under the MaskFormer-v1 predictor) at full widths over R-50 with 3
   decoder and 2 encoder layers, and DeepV3Plus on R-101 and SEResNeXt-101.
19. ``alt_serve``: 1024x2048 requests, batch 1, bf16: ``build_m2f_request_forward``
   on the Swin-L and the R-101 MaskFormer, and DeepV3Plus on SEResNeXt-101
   (its ASPP's dilated convs at 2048 channels): latency, launches, peak
   memory, one profiled request, and in Swin-L's the device time of the
   kernels its window attentions launch and its share of the busy time.
20. ``alt_train``: exps/m2f_swin_large.yaml's stage-2 step (exps/m2f.yaml's
   8 pairs of crops, the backbone trained, drop path; it fits 80 GB with the
   encoder's remat), exps/m2f_instance_swin_large.yaml's step (8 unpadded 700x700 crops, 48
   slots) and exps/m2f_semantic_r101.yaml's (8 crops of 512x1024, 20 slots),
   bf16: step ms, launches, peak memory, a profiled step; where 80 GB does not
   hold a vanilla recipe's batch, the largest batch that does, the cut listed.
21. ``dp_train``: the data-parallel path (``multishiftseg_torch/core/mesh.py``).
   (a) A world of 1 over NCCL: exps/deeplab.yaml's stage-2 step,
   exps/m2f.yaml's R-50 stage-2 step and exps/m2f_instance.yaml's step at
   full widths and the recipes' batches through DDP, whose reductions a
   world of 1 keeps on their single-process routes (``F.batch_norm``, the
   one-launch bottom-k), each held to the single-process step from the same
   weights, batch and draws in f32 (gradients too) and in bf16 (the losses),
   with both bf16 steps' times and the launches of 3 timed DP steps (paths
   ``dp_train_<recipe>``); the DeepLab DP step with its BatchNorms on
   the single-process route and forced onto the global one, each timed and
   profiled;
   and the global bottom-k's kernel row (``bottom_k_sum_global``: its route
   at world 1 against its plain version over 8 x 700 x 700 values, timed as
   the single-process row). (b) Two ranks on the one card over gloo
   (``torch.multiprocessing``; NCCL refuses two ranks on one device): each
   recipe's f32 step of its parity batch (2 pairs or 2 images at 200² /
   256²) split in two through the global reductions (BatchNorm, RCL's
   bottom-k and pairs, the criterion's normalisers), against the
   single-process step of the same global batch, both ranks ending with the
   same parameters, rank 0's launches the path ``dp_train_two_ranks`` (the
   global bottom-k's row counts them); and in each rank the global
   bottom-k's kernels against their plain version, at the main-path size,
   with ties and with select_num 0.
22. ``deploy``: the serving artifact (``multishiftseg_torch/deploy.py``) of M2F
   R-50 (Mask2Anomaly heads, exps/m2f.yaml) and DeepLab v3+ WRN-38
   (exps/deeplab.yaml) at 1024x2048, batch 1, random weights from the
   recipes' seeds, exported through the CLI (``python -m
   multishiftseg_torch.deploy``'s ``main``) for the card: the export's seconds,
   the ``.pt2`` (no weight in it) and ``.npz`` sizes, the ``mss::`` ops the
   program calls; each artifact served from a fresh process that imports the
   serving module and neither ``models/`` nor ``train/`` (3 requests after 2
   warm-ups, their launches: 6 bilinear deformable forwards, one anomaly and
   one semantic tail a M2F request, 3 dilated convs a DeepLab one; the
   program alone on a batch on the card), the last request's outputs against
   the eager forward (``build_*_forward``) on the artifact's weights within
   1e-2 of each output's scale (worst differences printed); then in one
   process the loaded program and the eager forward in turns, each profiled.
   The served requests' launches are the paths ``deploy_m2f`` and
   ``deploy_deeplab``.
23. ``pipeline``: the R-50 stage-2 step with ``pipeline_parallel = 2`` (GPipe
   over the deformable encoder, ``core/pipeline.py``; the stages on the first
   two cards, or both on the one) against the sequential step from the same
   weights, batch and draws: in f32 (TF32 off) at 2 pairs of 256x256, and in
   bf16 at exps/m2f.yaml's 8 pairs of 704x704, timed (3 steps after 2
   warm-ups each, peak memory), the pipelined steps' launches the path
   ``pipeline``; losses, gradients and the updates held with the tolerances
   printed.
24. ``tensor_parallel``: DeepLab WRN-38's stage-2 step (exps/deeplab.yaml, 8
   pairs of 700²) and M2F R-50's (exps/m2f.yaml, 8 pairs of 704²) with
   ``model_parallel = 2`` (``core/tensor_parallel.py``; both shards on the
   one card, ``min_size`` 1024) against the unsharded step from the same
   weights, batch and draws in f32 with TF32 off (loss and components within
   1e-4, gradients within 1e-2 in L2, the worst tensor reported), both bf16
   steps timed (3 after a warm-up, peak memory), the bytes of parameters and
   optimizer state a shard against the unsharded run's; the sharded steps'
   launches the paths ``tp_train_deeplab`` and ``tp_train_m2f``.
25. ``spatial``: both eval forwards (``build_*_forward`` with
   ``spatial_devices``; ``core/spatial.py``) at 1024x2048, batch 1, in 2 and
   4 row slabs, every slab on the one card, against the unsplit forward in
   f32 with TF32 off (DeepLab's score and logits; M2F's anomaly and ``sem``
   with the unsplit forward's decoder masks replayed; each within
   ``SPATIAL_RTOL`` of its scale), bf16 requests timed in turns with the
   unsplit one, one N = 2 request's launches the paths ``spatial_deeplab``
   and ``spatial_m2f``, and the halo rows the dilated conv throws away.
26. ``cgaug_parity``: CG-Aug's towers (``multishiftseg_torch/cgaug``) on the
   card against the CPU from the same seeded weights, f32 with TF32 off,
   each within its ``CGAUG_LIMITS`` of its scale (a control with TF32 on
   reported beside them): CLIP-L's text tower on two
   prompts, SD1.5's UNet with ControlNet-v15 at full widths for 2 guided
   DDIM steps on a 128x256 hint and the VAE decode, SAM at ViT-H's widths
   and depth on a 256 px input (embedding, mask logits, IoU, the masks where
   clear of 0), and the detector's anomaly map at 256x512 with the card's
   attention masks replayed.
27. ``cgaug``: the reference generation path (``MultiShiftGenerator`` over
   ``SDControlNetGenerator``, ``SAMSegmenter`` and ``make_m2f_detector``) at
   full widths from seeded weights, a synthetic vocab and a seeded anomaly
   source, on a seeded 512x1024 Cityscapes colour label, 50 guided DDIM
   steps, the gates set so every attempt runs all three backends: 1 warm-up
   and 2 timed calls in f32 (their launches the path ``cgaug``: 6 bilinear
   deformable forwards, one anomaly and one semantic tail a call), and 1
   timed call with the SD towers and SAM in bf16 (no warm-up: the time
   limit): seconds an image, each stage's device time, the gate values, peak
   memory, the stages' CUDA-event spans over the wall time (an upper bound
   of the busy share).

``slice_parity``, ``train_parity`` and ``instance_parity`` run the CPU's
decoder on the card's attention masks, and hold every bit that differs to a
logit within rounding of 0.

The ``kernels`` phase also holds the training slice's kernels at its shapes
(16 images at 704x704): the deformable-attention backward and the bilinear
forward (a row of its own beside the eval shapes'), the batched
assignment (and scipy's optimum on the valid rows) and the label points (the
rows count Swin-L's stage-2 step and ``dp_train``'s M2F step too); and
DeepLab's: the ASPP's dilated conv at the eval shapes (its three rates timed
together, beside cuDNN's dilated ``conv2d`` in benchmark mode, channels-last
and NCHW), at DeepV3Plus's eval shapes (2048 input channels, a row of its
own counting the ``alt_serve`` DeepV3Plus request's launches, beside cuDNN's
in the faster layout) and at the training shapes (a row of its own, beside
cuDNN's), its
weight gradient at the training shapes (beside cuDNN's), each with its
achieved TFLOP/s (the build line carries their registers and spills), and
the pixel selection, forward and backward, over 8 x 700 x 700 values, their
bounds at the bf16 tensor-core peak (989 TFLOP/s) where the tensor cores do
the work (the DeepLab profiles give the dilated conv's device time); stage
1's and validation's: the two forward score tails at
stage 1's shapes (the anomaly score, and the K class channels alone), the
anomaly tail's backward there (d probs alone, and with d masks) and with
forced ties, and
the binned metrics' masked range and 8192-bin histogram at 720x1280 and
1024x2048 (bit-for-bit equal to the plain versions); the vanilla recipes',
at the instance and panoptic recipes' shapes (8 unpadded 700x700 crops, 48
slots) and at the semantic recipe's (8 of 512x1024, 20 slots): the bilinear
deformable forward and backward, the label points over 8 segment id maps
with -1 pixels, the assignment of 8 problems of T slots x 100 queries with
padding rows (duplicate classes at 48 slots), and the semantic evaluation's
K-class score tail at 1024x2048; and the eval fast
paths' at the main-path shapes: the int8 table's quantize (bit for bit) and
forward, ``nearest_top6``, ``nearest_top6c`` and ``shared`` (the centroid modes
held off their rounding boundaries, flips counted), with f32 edge cases
(degenerate levels with 30 channels and points outside the map, all-equal
weights, T = J against ``nearest``). A kernel's ``launches``
are those of the main paths: ``serve``, ``deeplab_serve``, ``validate``,
``evaluate`` and ``deploy``'s served requests for the eval kernels, the timed
steps of ``train``, ``deeplab_train``, ``stage1_train`` and ``pipeline`` and
the epochs of ``train_loop`` for the training kernels, and ``instance_train``'s ``train()`` and ``evaluate()``
calls for the vanilla recipes', counted per recipe (the dilated conv's, the
bilinear deformable forward's and backward's, the anomaly tail's, the
classes-only tail's, the label points' and the assignment's rows split them:
eval paths, training steps, each row of the vanilla recipes the recipes at
its shapes; ``tensor_parallel``'s sharded steps count as training paths,
``cgaug``'s timed calls count in the rows at the detector's shapes
(``*_cgaug_shapes``: one f32 512x1024 image),
``spatial``'s N = 2 requests count in the rows at a slab's shapes:
``mask_scores_anomaly_slab`` and ``mask_scores_semantic_slab``, the tails'
row window over rows 512-1024,
``ms_deform_attn_bilinear_slab``, a slab's 21504 queries over the whole
table, and ``dilated_conv3x3_slab``, the ASPP on a slab of the stride-8
map with its halo rows, beside cuDNN's), each path run
with the counts set to 0 just before it and read just after.

Every row's ``ms`` times single synchronised calls (the wrapper's host time
before its launch included). The rows of the score tails' forward and of every
deformable forward at the eval shapes (``bilinear``, ``nearest``, the int8
quantize and forward, ``nearest_top6``, ``nearest_top6c``, ``shared``), the
bilinear forward at the training shapes, the label points, the pixel
selection (``bottom_k_sum``), the assignment and the two binned-metric
kernels give it as the median of 4 block medians of 25 such calls, with the
lowest and highest block median as
``ms_spread``, and add ``device_ms`` and ``device_ms_spread``, the same over
calls issued back to back (each call's device time; see ``spread_ms``), and
``host_ms``, the wrapper's host time a call. The rows of the forward kernel
(``bilinear``, ``nearest``, int8) add ``staged_levels``, the levels it staged
in shared memory. The assignment's and the selection's rows add
``device_kernels``, the device kernels one call runs (the launch calls of a
profile, ``launch_calls``); the
assignment's ``max_steps``, the most Dijkstra steps of any problem (from the
plain version), and ``device_ns_per_step``, its device time over them; the
selection's ``staged_fraction``, the share of keys its kernel keeps in shared
memory, and as ``library_ms`` one ``torch.topk`` of the k smallest keys and
their sum.

Then the ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` gives them, and as the last line ``{"ok": true, "device": ...}``
when every check passed. Any failed check exits 1 without that line.

``--phases kernels,serve`` runs the build and the named phases only, and
``--root DIR`` runs the package of another checkout under this harness: an
A/B of two trees on one card is ``python3 chip_smoke.py --root A --phases
kernels,serve`` for A, B, B, A in one call.
"""

import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

H, W = 1024, 2048
# main-path pyramid of the deformable encoder (strides 32, 16, 8 of 1024x2048)
LEVELS = [(H // 32, W // 32), (H // 16, W // 16), (H // 8, W // 8)]
N_HEADS, HEAD_DIM, N_POINTS = 8, 32, 4
QUERIES, CLASSES = 100, 19
# the stage-2 step (exps/m2f.yaml): 8 pairs of 700x700 crops padded to 704x704
TRAIN_PAIRS, CROP, TRAIN_HW = 8, (700, 700), (704, 704)
TRAIN_LEVELS = [(22, 22), (44, 44), (88, 88)]
# the top-T kernel's selection widths, for its tests: J = 12 points a head
# (two heads a warp) and J = 32 (one head a warp); (levels, points a level)
WARP_WIDTHS = {12: ([(6, 4), (3, 2), (2, 5)], 4), 32: ([(6, 4), (3, 2), (2, 5), (4, 4)], 8)}
TRAIN_POINTS = 12544
SEED = 0
# train_parity's weight and batch seeds: the gradient limit rests on several
# (six until the deploy and pipeline phases joined the run: three keep it
# inside the time limit)
TRAIN_PARITY_SEEDS = tuple(SEED + 10 * k for k in range(1, 4))
# A mask logit sums mask_dim (256) f32 products of inputs that carry every
# card-vs-CPU difference upstream; the logits agree "within rounding" where
# their difference is at most LOGIT_RTOL of the absolute scale
# sum_c |embed_c| |feature_c|, about 7x the worst-case rounding error of one
# 256-term f32 sum (256 x 2^-24 = 1.5e-5 of that scale)
LOGIT_RTOL = 1e-4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM data sheet, f32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 on the tensor cores
# DeepLab v3+ WRN-38: the ASPP's dilated convs over the output-stride-8 map
# (4096 -> 256 channels); eval at 1024x2048 (a 128x256 map), training at
# exps/deeplab.yaml (8 pairs of 700x700 crops: 88x88 maps, 16 images)
DL_RATES, DL_CIN, DL_COUT = (12, 24, 36), 4096, 256
DL_EVAL_MAP, DL_TRAIN_MAP = (H // 8, W // 8), (88, 88)
DL_TRAIN_PAIRS, DL_CROP = 8, (700, 700)
# DeepV3Plus (SEResNeXt / ResNet trunks): the same ASPP over 2048 channels
DV3_CIN = 2048
# deeplab_train_parity's seeds: each costs seven full-width steps on the CPU
# (a second seed, SEED + 37, ran until the deploy and pipeline phases joined)
DL_TRAIN_PARITY_SEEDS = (SEED + 27,)
# M2F stage 1 (exps/m2f.yaml): the anomaly tail's backward at the stage-1 shapes,
# stride-4 masks of the 704x704 padded crops
S1_MASK_HW = (TRAIN_HW[0] // 4, TRAIN_HW[1] // 4)
# the vanilla recipes (exps/m2f_{instance,panoptic,semantic}.yaml): batch 8 of
# unpadded 700x700 crops, 48 target slots (instance and panoptic), 8 thing classes
INST_BATCH, INST_SLOTS, INST_CLASSES = 8, 48, 8
# their step's shapes: the crop, the target slots and the training paths
# that run them (the R-50 recipes' and the Swin-L / R-101 alternates'); the
# semantic recipe's crops are 512x1024 with 20 slots
INST_SHAPES = {"instance": (CROP, INST_SLOTS, ("instance_train_instance", "instance_train_panoptic",
                                               "alt_train_m2f_instance_swin_large",
                                               "dp_train_instance")),
               "semantic": ((512, 1024), 20, ("instance_train_semantic",
                                              "alt_train_m2f_semantic_r101"))}


def pyramid(crop):
    """The deformable encoder's levels (strides 32, 16, 8) of an unpadded crop:
    R-50's stride-2 stages round up."""
    return [(-(-crop[0] // s), -(-crop[1] // s)) for s in (32, 16, 8)]
# the binned validation metrics: 8192 bins; SMIYC RoadAnomaly21's validation
# images are 720x1280, Cityscapes-sized ones 1024x2048
NUM_BINS = 8192
VAL_HW = ((720, 1280), (1024, 2048))


_STARTED = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's carries the seconds since the script started."""
    if "phase" in obj:
        obj = {**obj, "at_seconds": time.perf_counter() - _STARTED}
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired, IndexError) as e:
        return f"nvidia-smi unavailable: {e}"


# cycles the card sleeps before a block of back-to-back calls: longer than
# the host takes to queue them (25 calls of at most 0.15 ms of host time)
QUEUE_AHEAD_CYCLES = 20_000_000


def median_ms(torch, fn, reps):
    """Median device time of ``fn`` over ``reps`` calls, one event pair each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def spread_ms(torch, fn, back_to_back=False, blocks=4, reps=25):
    """(median, [lowest, highest]) of ``blocks`` block medians of ``reps``
    calls of ``fn`` each: the spread tells a small change from noise within
    one run. By default each call is timed as ``median_ms`` times it: alone
    and synchronised, the wrapper's host time before its launch included.
    ``back_to_back``: a block queues its calls behind a sleep kernel, with an
    event between consecutive ones and no host sync, so the card runs them in
    a row whatever the host's pace and each interval is one call's device
    time."""
    fn()
    torch.cuda.synchronize()
    meds = []
    for _ in range(blocks):
        if not back_to_back:
            meds.append(median_ms(torch, fn, reps))
            continue
        events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
        events[0].record()
        for i in range(reps):
            fn()
            events[i + 1].record()
        events[-1].synchronize()
        meds.append(statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:])))
    meds.sort()
    return statistics.median(meds), [meds[0], meds[-1]]


def host_ms(torch, fn, reps=25):
    """Median host time of one call of ``fn`` (the wrapper's work up to its
    launch) over ``reps`` calls issued back to back: the card runs behind
    them and no call waits for it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


# host-side CUDA runtime calls that put work on the device, as the profiler
# names them (libraries that launch with cuLaunchKernel are not counted)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cudaMemsetAsync",
                "cudaMemcpyAsync")


def launch_calls(prof):
    """The runtime calls in a profile that launch a kernel, a fill or a copy:
    recorded on the host's clock, so none falls out of the window, as device
    events were seen to (a cooperative kernel's most of all)."""
    return sum(1 for e in prof.events() if e.name.startswith(LAUNCH_CALLS))


def device_kernels(torch, fn, calls=10, pause_s=0.25):
    """Device kernels (and copies or fills) a call of ``fn`` runs: the launch
    calls of ``calls`` warm calls in one profile, over ``calls``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pause_s)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(pause_s)
    return launch_calls(prof) / calls


def time_redesigned(torch, row, fn):
    """A redesigned kernel's timings: ``ms`` over single synchronised calls,
    as in every row, and ``device_ms`` over calls back to back, each with its
    spread; and ``host_ms``, the wrapper's host time a call."""
    row["ms"], row["ms_spread"] = spread_ms(torch, fn)
    row["device_ms"], row["device_ms_spread"] = spread_ms(torch, fn, back_to_back=True)
    row["host_ms"] = host_ms(torch, fn)


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """The least time for ``nbytes`` at HBM rate and ``ops`` at ``ops_per_s``
    (default f32 outside the tensor cores), ms, and which of the two binds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def msda_inputs(torch, levels, lq, dtype, device, seed, d=HEAD_DIM, avoid_ties=True,
                batch=1):
    """value, sampling locations and attention weights for ``levels``; locations
    in [-0.1, 1.1] of each map, so some points fall outside it."""
    g = np.random.RandomState(seed)
    s = sum(h * w for h, w in levels)
    value = torch.from_numpy(g.randn(batch, s, N_HEADS, d).astype(np.float32))
    loc = g.rand(batch, lq, N_HEADS, len(levels), N_POINTS, 2).astype(np.float32) * 1.2 - 0.1
    if avoid_ties:
        # nudge points 1e-3 px off the integer pixel positions, where the
        # bilinear backward's location slope is one-sided and the two versions'
        # rounding may pick other sides (the nearest mode's half-pixel ties need
        # no nudge: kernel and plain version round x * W - 0.5 op by op)
        size = np.array([[w, h] for h, w in levels], np.float32)[None, None, None, :, None, :]
        px = loc * size - 0.5
        frac = px - np.floor(px)
        near = np.minimum(frac, 1 - frac) < 1e-3
        loc = np.where(near, (px + 2e-3 + 0.5) / size, loc).astype(np.float32)
    logits = torch.from_numpy(g.randn(batch, lq, N_HEADS, len(levels) * N_POINTS).astype(
        np.float32))
    attn = torch.softmax(logits, -1).view(batch, lq, N_HEADS, len(levels), N_POINTS)
    return (value.to(device, dtype), torch.from_numpy(loc).to(device),
            attn.to(device, dtype))


def msda_ops(torch, loc, levels, mode, backward=False):
    """f32 operations these inputs need: per channel, 2 per in-bounds corner
    (bilinear) and 2 per in-bounds point (weight x value, accumulate). For the
    backward 4 per channel and in-bounds corner: one multiply-add of the dot
    product <g, corner value>, from which d attn and d loc follow per corner,
    and one multiply and one add into d value."""
    size = torch.tensor([[w, h] for h, w in levels], dtype=torch.float32, device=loc.device)
    px = loc * size[None, None, None, :, None, :] - 0.5
    x, y = px[..., 0], px[..., 1]
    wl, hl = size[None, None, None, :, None, 0], size[None, None, None, :, None, 1]
    if mode == "nearest":
        points = ((x > -0.5) & (x < wl - 0.5) & (y > -0.5) & (y < hl - 0.5)).sum()
        return int(points) * 2 * HEAD_DIM
    x0, y0 = torch.floor(x), torch.floor(y)
    corners = 0
    for dx in (0, 1):
        for dy in (0, 1):
            corners += int(((x0 + dx >= 0) & (x0 + dx < wl) & (y0 + dy >= 0)
                            & (y0 + dy < hl)).sum())
    points = int(((x > -1) & (x < wl) & (y > -1) & (y < hl)).sum())
    if backward:
        return 4 * corners * HEAD_DIM
    return (2 * corners + 2 * points) * HEAD_DIM


def label_sector_bytes(torch, labels, coords, maps):
    """Bytes of the 32-byte label-map sectors that hold the in-map corners of
    these points, each sector counted once. labels [B, H, W]; coords [R, P, 2];
    maps [R], the label map of each coordinate row."""
    _, h, w = labels.shape
    x0 = torch.floor(coords[..., 0] * w - 0.5).long()
    y0 = torch.floor(coords[..., 1] * h - 0.5).long()
    per_sector = 32 // labels.element_size()
    sectors = []
    for dx in (0, 1):
        for dy in (0, 1):
            ix, iy = x0 + dx, y0 + dy
            valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            flat = (maps[:, None] * h + iy) * w + ix
            sectors.append(flat[valid] // per_sector)
    return int(torch.unique(torch.cat(sectors)).numel()) * 32


def phase_build():
    from multishiftseg_torch import _build

    t0 = time.perf_counter()
    report = _build.build()
    return {"phase": "build", "ok": True, "seconds": time.perf_counter() - t0,
            "sources": {k: {"seconds": v["seconds"],
                            "ptxas": v["ptxas"] if k == "dilated_conv" else v["ptxas"][:6]}
                        for k, v in report.items()},
            "nvidia_smi": nvidia_smi()}


def phase_kernels(torch):
    from multishiftseg_torch.ops import ms_deform_attn as msda
    from multishiftseg_torch.ops import scores

    dev = torch.device("cuda")
    rows, checks = {}, []

    def check(name, got, want, atol, rtol):
        """Pass where |got - want| <= atol + rtol * |want| everywhere; the
        relative error reported is the largest one over the reference's scale."""
        err = (got.float() - want.float()).abs()
        ok = bool((err <= atol + rtol * want.float().abs()).all())
        scale = float(want.float().abs().max())
        checks.append({"check": name, "max_abs_err": float(err.max()),
                       "max_rel_err": float(err.max()) / max(scale, 1e-30),
                       "atol": atol, "rtol": rtol, "ok": ok})
        return float(err.max())

    # deformable attention at the main-path shapes, bf16 as served. Tolerance:
    # both sides sum in f32 and round once to bf16, so they differ by at most
    # one bf16 step (2^-8 relative) plus f32 sum-order noise.
    lq = sum(h * w for h, w in LEVELS)
    value, loc, attn = msda_inputs(torch, LEVELS, lq, torch.bfloat16, dev, SEED)
    for mode, line in (("bilinear", 93), ("nearest", 236)):
        run = lambda: msda.ms_deform_attn_core(value, LEVELS, loc, attn, mode)
        plain = lambda: msda.ms_deform_attn_core_plain(value, LEVELS, loc, attn, mode)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        err = check(f"ms_deform_attn_{mode}_main_shapes", out, ref, 1e-3, 1e-2)
        b_ms, b_by = bound(nbytes(value, loc, attn, out), msda_ops(torch, loc, LEVELS, mode))
        rows[f"ms_deform_attn_{mode}"] = {
            "name": f"ms_deform_attn_{mode}", "route": "cuda",
            "source": "multishiftseg_torch/csrc/ms_deform_attn.cu",
            "replaces": f"multishiftseg_tpu/ops/ms_deform_attn.py:{line}",
            # the eval paths; the training steps' launches are the
            # training-shape row's
            "paths": ("serve", "validate", "evaluate", "instance_eval", "alt_serve_swin_large",
                      "alt_serve_resnet101", "deploy_m2f"), "max_abs_err": err,
            "plain_ms": median_ms(torch, plain, 10), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}
        row = rows[f"ms_deform_attn_{mode}"]
        time_redesigned(torch, row, run)
        row["staged_levels"] = msda.forward_staged_levels(value, LEVELS, mode == "nearest")
        # f32 edge cases: a degenerate h == 1 / w == 1 pyramid (a 32-px side)
        # with points outside the map, and 30 channels a head (no 16-byte
        # channel groups: the kernel's one-channel path); f32 sums in another order
        edge = [(1, 5), (4, 1), (3, 3)]
        v32, l32, a32 = msda_inputs(torch, edge, 64, torch.float32, dev, SEED + 1, d=30)
        check(f"ms_deform_attn_{mode}_degenerate_levels",
              msda.ms_deform_attn_core(v32, edge, l32, a32, mode),
              msda.ms_deform_attn_core_plain(v32, edge, l32, a32, mode), 1e-5, 1e-5)
        outside = (l32 < 0) | (l32 > 1)
        checks[-1]["points_outside_map"] = int(outside.any(-1).sum())
    # nearest on exact pixel boundaries (x = j / W_l, y = j / H_l), main-path
    # shapes: the last bit of x * W - 0.5 picks the pixel, so kernel and plain
    # version must round alike. Integer values and weights of 1/16 keep every
    # sum exact in any order: bit for bit
    gb = np.random.RandomState(SEED + 3)
    vb = gb.randint(-8, 9, (1, lq, N_HEADS, HEAD_DIM)).astype(np.float32)
    lb = np.empty((1, lq, N_HEADS, len(LEVELS), N_POINTS, 2), np.float32)
    for lid, (h, w) in enumerate(LEVELS):
        for axis, size in ((0, w), (1, h)):
            j = gb.randint(0, size + 1, lb.shape[:3] + (N_POINTS,)).astype(np.float32)
            lb[:, :, :, lid, :, axis] = j / np.float32(size)
    vb, lb = torch.from_numpy(vb).to(dev, torch.bfloat16), torch.from_numpy(lb).to(dev)
    ab = torch.full(lb.shape[:-1], 1 / 16, dtype=torch.bfloat16, device=dev)
    out = msda.ms_deform_attn_core(vb, LEVELS, lb, ab, "nearest")
    ref = msda.ms_deform_attn_core_plain(vb, LEVELS, lb, ab, "nearest")
    torch.cuda.synchronize()
    check("ms_deform_attn_nearest_pixel_boundaries", out, ref, 0.0, 0.0)
    del vb, lb, ab, out, ref

    # score tail at the main-path shapes: f32 stride-4 masks to 1024x2048; the
    # sums over 100 queries differ only in order (f32)
    g = np.random.RandomState(SEED + 2)
    masks = torch.from_numpy(
        3 * g.randn(1, QUERIES, H // 4, W // 4).astype(np.float32)).to(dev)
    cls = g.randn(1, QUERIES, CLASSES + 1).astype(np.float32)
    cls[0, :5, 3] = 8.0  # five confident queries keep their extra channel
    cls = torch.from_numpy(cls).to(dev)
    for head, line in (("anomaly", "scores.py:39"), ("semantic", "scores.py:25")):
        if head == "anomaly":
            run = lambda: scores.anomaly_score_upsampled(cls, masks, (H, W))
            plain = lambda: scores.anomaly_score_upsampled_plain(cls, masks, (H, W))
        else:
            run = lambda: scores.semantic_inference_upsampled(cls, masks, (H, W), CLASSES)
            plain = lambda: scores.semantic_inference_upsampled_plain(cls, masks, (H, W),
                                                                      CLASSES)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        err = check(f"mask_scores_{head}_main_shapes", out, ref, 1e-5, 1e-5)
        del ref
        per_q = 11 + 2 * CLASSES  # bilinear taps 7, sigmoid 4, contraction 2K
        ops = H * W * (QUERIES * per_q + (CLASSES + 1 if head == "anomaly" else QUERIES))
        in_bytes = nbytes(masks) + QUERIES * CLASSES * 4 + (QUERIES * 4 if head == "semantic" else 0)
        b_ms, b_by = bound(in_bytes + nbytes(out), ops)
        rows[f"mask_scores_{head}"] = {
            "name": f"mask_scores_{head}", "route": "cuda",
            "source": "multishiftseg_torch/csrc/mask_scores.cu",
            "replaces": f"multishiftseg_tpu/ops/{line}",
            "max_abs_err": err, "plain_ms": median_ms(torch, plain, 5), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}
        time_redesigned(torch, rows[f"mask_scores_{head}"], run)
        # the eval paths at 1024x2048; stage 1's, a slab's and CG-Aug's
        # launches are their own rows'
        rows[f"mask_scores_{head}"]["paths"] = ("serve", "validate", "evaluate",
                                                "alt_serve_swin_large", "alt_serve_resnet101",
                                                "deploy_m2f")
        del out
    approx_kernel_rows(torch, dev, rows, check, checks)
    train_kernel_rows(torch, dev, rows, check, checks)
    deeplab_kernel_rows(torch, dev, rows, check, checks)
    stage1_kernel_rows(torch, dev, rows, check, checks)
    instance_kernel_rows(torch, dev, rows, check, checks)
    ood_hist_rows(torch, dev, rows, checks)
    spatial_kernel_rows(torch, dev, rows, check, checks)
    cgaug_kernel_rows(torch, dev, rows, check, checks)
    ok = all(c["ok"] for c in checks)
    return rows, {"phase": "kernels", "ok": ok, "checks": checks}


def cgaug_kernel_rows(torch, dev, rows, check, checks):
    """The kernels of CG-Aug's detector (``cgaug``) at its shapes: one f32
    512x1024 image, so the deformable encoder's pyramid of 16x32, 32x64 and
    64x128 (10752 queries) and 100 stride-4 masks of 128x256 scored at
    512x1024, both tails. Each counts only the ``cgaug`` path's launches."""
    from multishiftseg_torch.ops import ms_deform_attn as msda
    from multishiftseg_torch.ops import scores

    ch, cw = CGAUG_HW
    levels = [(ch // 32, cw // 32), (ch // 16, cw // 16), (ch // 8, cw // 8)]
    lq = sum(h * w for h, w in levels)
    value, loc, attn = msda_inputs(torch, levels, lq, torch.float32, dev, SEED + 160)
    run = lambda: msda.ms_deform_attn_core(value, levels, loc, attn, "bilinear")
    plain = lambda: msda.ms_deform_attn_core_plain(value, levels, loc, attn, "bilinear")
    out, ref = run(), plain()
    torch.cuda.synchronize()
    # f32 on both sides: the sums differ only in order
    err = check("ms_deform_attn_bilinear_cgaug_shapes", out, ref, 1e-5, 1e-5)
    b_ms, b_by = bound(nbytes(value, loc, attn, out), msda_ops(torch, loc, levels, "bilinear"))
    row = rows["ms_deform_attn_bilinear_cgaug_shapes"] = {
        "name": "ms_deform_attn_bilinear_cgaug_shapes", "route": "cuda",
        "source": "multishiftseg_torch/csrc/ms_deform_attn.cu",
        "replaces": "multishiftseg_tpu/ops/ms_deform_attn.py:93",
        "counter": "ms_deform_attn_bilinear", "paths": ("cgaug",), "max_abs_err": err,
        "plain_ms": median_ms(torch, plain, 10), "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}
    time_redesigned(torch, row, run)
    del value, loc, attn, out, ref

    g = np.random.RandomState(SEED + 161)
    masks = torch.from_numpy(3 * g.randn(1, QUERIES, ch // 4, cw // 4).astype(np.float32)).to(dev)
    cls = g.randn(1, QUERIES, CLASSES + 1).astype(np.float32)
    cls[0, :5, 3] = 8.0
    cls = torch.from_numpy(cls).to(dev)
    for head, line in (("anomaly", "scores.py:39"), ("semantic", "scores.py:25")):
        if head == "anomaly":
            run = lambda: scores.anomaly_score_upsampled(cls, masks, CGAUG_HW)
            plain = lambda: scores.anomaly_score_upsampled_plain(cls, masks, CGAUG_HW)
        else:
            run = lambda: scores.semantic_inference_upsampled(cls, masks, CGAUG_HW, CLASSES)
            plain = lambda: scores.semantic_inference_upsampled_plain(cls, masks, CGAUG_HW,
                                                                      CLASSES)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        err = check(f"mask_scores_{head}_cgaug_shapes", out, ref, 1e-5, 1e-5)
        del ref
        ops = ch * cw * (QUERIES * (11 + 2 * CLASSES)
                         + (CLASSES + 1 if head == "anomaly" else QUERIES))
        in_bytes = nbytes(masks) + QUERIES * CLASSES * 4 + (QUERIES * 4 if head == "semantic" else 0)
        b_ms, b_by = bound(in_bytes + nbytes(out), ops)
        row = rows[f"mask_scores_{head}_cgaug_shapes"] = {
            "name": f"mask_scores_{head}_cgaug_shapes", "route": "cuda",
            "source": "multishiftseg_torch/csrc/mask_scores.cu",
            "replaces": f"multishiftseg_tpu/ops/{line}",
            "counter": f"mask_scores_{head}", "paths": ("cgaug",), "max_abs_err": err,
            "plain_ms": median_ms(torch, plain, 5), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}
        time_redesigned(torch, row, run)
        del out


def spatial_kernel_rows(torch, dev, rows, check, checks):
    """The kernels of the row-partitioned eval (``spatial``) at a slab's shapes,
    2 slabs of a 1024x2048 image: the anomaly and semantic tails' row window
    (rows 512 to 1024, the lower slab), the bilinear deformable forward on a slab's queries
    (half the pyramid's tokens) against the whole gathered table, and the
    ASPP's dilated conv on a slab of the stride-8 map with its halo rows (64 +
    2 rate rows, whose outer 2 rate rows are thrown away). Each counts only
    the spatial paths' launches."""
    import torch.nn.functional as F

    from multishiftseg_torch.ops import dilated_conv as dconv
    from multishiftseg_torch.ops import ms_deform_attn as msda
    from multishiftseg_torch.ops import scores
    from multishiftseg_torch.ops.resize import source_rows

    window = (H // 2, H // 2)
    g = np.random.RandomState(SEED + 141)
    masks = torch.from_numpy(3 * g.randn(1, QUERIES, H // 4, W // 4).astype(np.float32)).to(dev)
    cls = torch.from_numpy(g.randn(1, QUERIES, CLASSES + 1).astype(np.float32)).to(dev)
    probs = torch.softmax(cls, -1)[..., :-1].contiguous()
    run = lambda: scores.anomaly_score_upsampled(cls, masks, (H, W), rows=window)
    plain = lambda: scores._tail_plain(masks, probs, None, [H, W], 0, *window)
    out, ref = run(), plain()
    torch.cuda.synchronize()
    err = check("mask_scores_anomaly_slab_rows", out, ref, 1e-5, 1e-5)
    i0, i1, _ = source_rows(H // 4, H, window)
    src_rows = int(i1.max()) - int(i0.min()) + 1
    ops = window[1] * W * (QUERIES * (11 + 2 * CLASSES) + CLASSES + 1)
    b_ms, b_by = bound(QUERIES * src_rows * (W // 4) * 4 + nbytes(probs, out), ops)
    row = rows["mask_scores_anomaly_slab"] = {
        "name": "mask_scores_anomaly_slab", "route": "cuda",
        "source": "multishiftseg_torch/csrc/mask_scores.cu",
        "replaces": "multishiftseg_tpu/ops/scores.py:39",
        "counter": "mask_scores_anomaly", "paths": ("spatial_m2f",), "max_abs_err": err,
        "plain_ms": median_ms(torch, plain, 5), "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}
    time_redesigned(torch, row, run)
    del out, ref
    keep = scores.keep_weights(cls, CLASSES).contiguous()
    run = lambda: scores.semantic_inference_upsampled(cls, masks, (H, W), CLASSES, rows=window)
    plain = lambda: scores._tail_plain(masks, probs, keep, [H, W], scores._SEMANTIC, *window)
    out, ref = run(), plain()
    torch.cuda.synchronize()
    err = check("mask_scores_semantic_slab_rows", out, ref, 1e-5, 1e-5)
    ops = window[1] * W * QUERIES * (11 + 2 * CLASSES + 1)
    b_ms, b_by = bound(QUERIES * src_rows * (W // 4) * 4 + nbytes(probs, keep, out), ops)
    row = rows["mask_scores_semantic_slab"] = {
        "name": "mask_scores_semantic_slab", "route": "cuda",
        "source": "multishiftseg_torch/csrc/mask_scores.cu",
        "replaces": "multishiftseg_tpu/ops/scores.py:25",
        "counter": "mask_scores_semantic", "paths": ("spatial_m2f",), "max_abs_err": err,
        "plain_ms": median_ms(torch, plain, 5), "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}
    time_redesigned(torch, row, run)
    del masks, out, ref

    lq = sum(h * w for h, w in LEVELS) // 2
    value, loc, attn = msda_inputs(torch, LEVELS, lq, torch.bfloat16, dev, SEED + 142)
    run = lambda: msda.ms_deform_attn_core(value, LEVELS, loc, attn, "bilinear")
    plain = lambda: msda.ms_deform_attn_core_plain(value, LEVELS, loc, attn, "bilinear")
    out, ref = run(), plain()
    torch.cuda.synchronize()
    err = check("ms_deform_attn_bilinear_slab_queries", out, ref, 1e-3, 1e-2)
    b_ms, b_by = bound(nbytes(value, loc, attn, out), msda_ops(torch, loc, LEVELS, "bilinear"))
    row = rows["ms_deform_attn_bilinear_slab"] = {
        "name": "ms_deform_attn_bilinear_slab", "route": "cuda",
        "source": "multishiftseg_torch/csrc/ms_deform_attn.cu",
        "replaces": "multishiftseg_tpu/ops/ms_deform_attn.py:93",
        "counter": "ms_deform_attn_bilinear", "paths": ("spatial_m2f",), "max_abs_err": err,
        "plain_ms": median_ms(torch, plain, 10), "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}
    time_redesigned(torch, row, run)
    del value, loc, attn, out, ref

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions sum in f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED + 143)
    slab, wmap = DL_EVAL_MAP[0] // 2, DL_EVAL_MAP[1]
    xs = [torch.randn((1, slab + 2 * r, wmap, DL_CIN), generator=gen, device=dev)
          .to(torch.bfloat16) for r in DL_RATES]
    ks = [torch.randn((3, 3, DL_CIN, DL_COUT), generator=gen, device=dev) / 96 for _ in DL_RATES]
    with torch.no_grad():
        run = lambda: [dconv.dilated_conv3x3(x, k, r) for x, k, r in zip(xs, ks, DL_RATES)]
        plain = lambda: [dconv.dilated_conv3x3_plain(x, k, r) for x, k, r in zip(xs, ks, DL_RATES)]
        outs, refs = run(), plain()
        torch.cuda.synchronize()
        err = max(check(f"dilated_conv3x3_rate{r}_slab", o, ref,
                        1e-3 * float(ref.float().abs().max()), 2 ** -7)
                  for r, o, ref in zip(DL_RATES, outs, refs))
        del refs
        times = (median_ms(torch, run, 10), median_ms(torch, plain, 2))
        xc = [x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last) for x in xs]
        wc = [k.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last) for k in ks]
        torch.backends.cudnn.benchmark = True
        lib = lambda: [F.conv2d(x, w, padding=r, dilation=r) for x, w, r in zip(xc, wc, DL_RATES)]
        lib()
        lib_ms = median_ms(torch, lib, 2)
        torch.backends.cudnn.benchmark = False
    taps = sum(in_map_taps(1, (slab + 2 * r, wmap), r) for r in DL_RATES)
    flop = 2 * taps * DL_CIN * DL_COUT
    b_ms, b_by = bound(nbytes(*xs, *outs) + sum(k.numel() * 2 for k in ks), flop,
                       BF16_TC_OPS_PER_S)
    rows["dilated_conv3x3_slab"] = {
        "name": "dilated_conv3x3_slab", "route": "cuda",
        "source": "multishiftseg_torch/csrc/dilated_conv.cu",
        "replaces": "multishiftseg_tpu/ops/dilated_conv.py:19",
        "counter": "dilated_conv3x3", "paths": ("spatial_deeplab",), "max_abs_err": err,
        "ms": times[0], "plain_ms": times[1], "bound_ms": b_ms, "bound_by": b_by,
        # cuDNN's dilated conv2d on the same haloed slabs, bf16 channels-last
        "library_ms": lib_ms}
    kept = sum(slab * wmap for _ in DL_RATES)
    checks.append({"check": "dilated_conv3x3_slab_work", "rows_computed":
                   [slab + 2 * r for r in DL_RATES], "rows_kept": slab,
                   "discarded_share": 1 - kept / sum((slab + 2 * r) * wmap for r in DL_RATES),
                   "tflop": flop / 1e12, "ok": True})
    del xs, xc, wc, outs


def near_rounding_boundary(torch, loc, attn, levels, mode, margin=1e-4):
    """[N, Lq, M] bool: outputs whose centroid (float64) lies within ``margin``
    px of a nearest-pixel boundary (c * W an integer), where f32 sums in
    another order may round to the neighbouring pixel: ``nearest_top{T}c``'s
    tail centroid of each (head, level), ``shared``'s point of each (level,
    point) for every head; none in the other modes. A centroid without mass
    is exactly 0 (or 0.5) in every version and is not counted. The CPU tests
    hold the port's centroid modes off the same outputs."""
    loc, a = loc.double(), attn.double()
    size = torch.tensor([[w, h] for h, w in levels], dtype=torch.float64, device=loc.device)
    n, lq, m, L, p = a.shape
    if mode != "shared" and not mode.endswith("c"):
        return torch.zeros((n, lq, m), dtype=torch.bool, device=loc.device)
    if mode == "shared":
        asum = a.sum(2)
        c = (loc * a[..., None]).sum(2) / asum.clamp_min(1e-12)[..., None]
        px = c * size[None, None, :, None, :]
        near = ((px - px.round()).abs() < margin).any(-1) & (asum > 1e-12)
        return near.reshape(n, lq, -1).any(-1)[:, :, None].expand(n, lq, m)
    top = int(mode[len("nearest_top"):-1])
    x = loc * size[None, None, None, :, None, :] - 0.5
    inb = ((x > -0.5) & (x < size[None, None, None, :, None, :] - 0.5)).all(-1)
    w = torch.where(inb, a, 0.0).reshape(n, lq, m, L * p)
    order = torch.sort(w, dim=-1, descending=True, stable=True).indices[..., :top]
    tail = w.scatter(-1, order, 0.0).reshape(n, lq, m, L, p)
    mass = tail.sum(-1)
    c = (tail[..., None] * loc).sum(-2) / mass.clamp_min(1e-12)[..., None]
    px = c * size[None, None, None, :, :]
    return (((px - px.round()).abs() < margin).any(-1) & (mass > 1e-12)).any(-1)


def check_off_boundaries(torch, checks, name, got, want, loc, attn, levels, mode, atol, rtol):
    """``check`` for a centroid mode: every output within atol + rtol |want|,
    except outputs whose centroid lies within 1e-4 px of a rounding boundary
    (:func:`near_rounding_boundary`); those off tolerance are counted (flips)."""
    n, lq, m = attn.shape[:3]
    err = (got.float() - want.float()).abs().view(n, lq, m, -1)
    bad = (err > atol + rtol * want.float().abs().view(n, lq, m, -1)).any(-1)
    near = near_rounding_boundary(torch, loc, attn.float(), levels, mode)
    held = err[~near]
    max_err = float(held.max()) if held.numel() else 0.0
    flips = int((bad & near).sum())
    checks.append({"check": name, "max_abs_err": max_err, "atol": atol, "rtol": rtol,
                   "outputs_near_boundary": int(near.sum()), "flipped_outputs": flips,
                   "ok": not bool((bad & ~near).any()) and flips <= max(2, bad.numel() // 10000)})
    return max_err


def msda_approx_ops(torch, loc, attn, levels, mode):
    """f32 operations these inputs need: 2 per channel and gathered in-map row
    (weight x value, accumulate); the top-T selection's J^2 comparisons a head
    and the tail centroids' 6 a point (centroid mode); the shared points' 6 a
    head and point."""
    n, lq, m, L, p = attn.shape
    size = torch.tensor([[w, h] for h, w in levels], dtype=torch.float32, device=loc.device)
    x = loc * size[None, None, None, :, None, :] - 0.5
    inb = ((x > -0.5) & (x < size[None, None, None, :, None, :] - 0.5)).all(-1)
    heads, J = n * lq * m, L * p
    if mode == "shared":
        return n * lq * J * m * 6 + int(inb.sum()) * 2 * HEAD_DIM
    top = int(mode[len("nearest_top"):].rstrip("c"))
    kept = int(inb.reshape(heads, J).sum(-1).clamp(max=top).sum())
    ops = heads * J * J + kept * 2 * HEAD_DIM
    if mode.endswith("c"):
        ops += heads * (J - top) * 6 + heads * L * 2 * HEAD_DIM
    return ops


def approx_kernel_rows(torch, dev, rows, check, checks):
    """The int8 table and the approximate deformable modes at the main-path
    shapes (1024x2048, batch 1, bf16): the quantize against its plain version
    bit for bit; the int8 forward, ``nearest_top6``, ``nearest_top6c`` and
    ``shared`` within one bf16 step plus f32 order noise, as the exact rows
    (the centroid modes off their rounding boundaries, flips counted); and f32
    edge cases: degenerate h == 1 / w == 1 levels with 30 channels a head and
    points outside the map, T = J against ``nearest``, all-equal weights."""
    from multishiftseg_torch.ops import ms_deform_attn as msda

    lq = sum(h * w for h, w in LEVELS)
    value, loc, attn = msda_inputs(torch, LEVELS, lq, torch.bfloat16, dev, SEED + 70,
                                   avoid_ties=False)
    src = "multishiftseg_torch/csrc/ms_deform_attn.cu"
    approx_src = "multishiftseg_torch/csrc/ms_deform_attn_approx.cu"
    replaces = "multishiftseg_tpu/ops/ms_deform_attn.py:"

    run_q = lambda: msda.quantize_value_table(value)
    plain_q = lambda: msda.quantize_value_table_plain(value)
    (q, scale), (qp, sp) = run_q(), plain_q()
    torch.cuda.synchronize()
    same = bool(torch.equal(q, qp)) and bool(torch.equal(scale.view(torch.int32),
                                                         sp.view(torch.int32)))
    checks.append({"check": "ms_deform_attn_quantize_main_shapes_bit_for_bit", "equal": same,
                   "max_abs_err": float((q.int() - qp.int()).abs().max()), "ok": same})
    # per element: abs and max, then divide, round, clamp
    b_ms, b_by = bound(nbytes(value, q, scale), 5 * value.numel())
    rows["ms_deform_attn_quantize"] = {
        "name": "ms_deform_attn_quantize", "route": "cuda", "source": src,
        "replaces": replaces + "130", "counter": "ms_deform_attn_quantize",
        "max_abs_err": float((q.int() - qp.int()).abs().max()),
        "plain_ms": median_ms(torch, plain_q, 10), "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}
    time_redesigned(torch, rows["ms_deform_attn_quantize"], run_q)
    del qp, sp

    run_i = lambda: msda._ms_deform_attn_int8_cuda(q, scale, LEVELS, loc, attn)
    plain_i = lambda: msda._bilinear_int8_plain(q, scale, LEVELS, loc, attn).to(attn.dtype)
    out = run_i()
    torch.cuda.synchronize()
    err = check("ms_deform_attn_int8_main_shapes", out, plain_i(), 1e-3, 1e-2)
    # the bilinear forward's operations and one scale multiply per corner and channel
    size = torch.tensor([[w, h] for h, w in LEVELS], dtype=torch.float32, device=dev)
    px = loc * size[None, None, None, :, None, :] - 0.5
    points = int(((px[..., 0] > -1) & (px[..., 0] < size[:, 0, None])
                  & (px[..., 1] > -1) & (px[..., 1] < size[:, 1, None])).sum())
    ops = msda_ops(torch, loc, LEVELS, "bilinear") + 4 * points * HEAD_DIM
    b_ms, b_by = bound(nbytes(q, scale, loc, attn, out), ops)
    rows["ms_deform_attn_int8"] = {
        "name": "ms_deform_attn_int8", "route": "cuda", "source": src,
        "replaces": replaces + "221", "counter": "ms_deform_attn_int8",
        "max_abs_err": err, "plain_ms": median_ms(torch, plain_i, 10), "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None}
    time_redesigned(torch, rows["ms_deform_attn_int8"], run_i)
    rows["ms_deform_attn_int8"]["staged_levels"] = msda.forward_staged_levels(q, LEVELS)
    del q, scale, out

    for mode, line, counter in (("nearest_top6", 304, "ms_deform_attn_nearest_top"),
                                ("nearest_top6c", 375, "ms_deform_attn_nearest_topc"),
                                ("shared", 481, "ms_deform_attn_shared")):
        run = lambda: msda.ms_deform_attn_core(value, LEVELS, loc, attn, mode)
        plain = lambda: msda.ms_deform_attn_core_plain(value, LEVELS, loc, attn, mode)
        out = run()
        torch.cuda.synchronize()
        # both sides sum in f32 and round once to bf16: one bf16 step plus
        # f32 order noise, as the exact rows
        err = check_off_boundaries(torch, checks, f"ms_deform_attn_{mode}_main_shapes", out,
                                   plain(), loc, attn, LEVELS, mode, 1e-3, 1e-2)
        b_ms, b_by = bound(nbytes(value, loc, attn, out),
                           msda_approx_ops(torch, loc, attn, LEVELS, mode))
        rows[f"ms_deform_attn_{mode}"] = {
            "name": f"ms_deform_attn_{mode}", "route": "cuda", "source": approx_src,
            "replaces": replaces + str(line), "counter": counter, "max_abs_err": err,
            "plain_ms": median_ms(torch, plain, 10), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}
        time_redesigned(torch, rows[f"ms_deform_attn_{mode}"], run)
        del out
    del value, loc, attn

    # f32 edge cases, f32 sums in another order (1e-5): a degenerate pyramid
    # (a 32-px side) with 30 channels a head (the one-channel path) and points
    # outside the map, in every mode; all-equal weights (the tie rule alone);
    # T = J against nearest
    edge = [(1, 5), (4, 1), (3, 3)]
    v32, l32, a32 = msda_inputs(torch, edge, 64, torch.float32, dev, SEED + 71, d=30,
                                avoid_ties=False)
    equal = torch.full_like(a32, 1.0 / a32[0, 0, 0].numel())
    outside = int(((l32 < 0) | (l32 > 1)).any(-1).sum())
    for mode in ("nearest_top6", "nearest_top6c", "shared"):
        for tag, a in (("degenerate_levels", a32), ("equal_weights", equal)):
            check_off_boundaries(torch, checks, f"ms_deform_attn_{mode}_{tag}",
                                 msda.ms_deform_attn_core(v32, edge, l32, a, mode),
                                 msda.ms_deform_attn_core_plain(v32, edge, l32, a, mode),
                                 l32, a, edge, mode, 1e-5, 1e-5)
            checks[-1]["points_outside_map"] = outside
    check("ms_deform_attn_int8_degenerate_levels",
          msda.ms_deform_attn_core(v32, edge, l32, a32, quantize_table=True),
          msda.ms_deform_attn_core_plain(v32, edge, l32, a32, quantize_table=True), 1e-5, 1e-5)
    near = msda.ms_deform_attn_core(v32, edge, l32, a32, "nearest")
    for mode in ("nearest_top12", "nearest_top12c"):
        check(f"ms_deform_attn_{mode}_all_points_is_nearest",
              msda.ms_deform_attn_core(v32, edge, l32, a32, mode), near, 1e-5, 1e-5)
    q32, s32 = msda.quantize_value_table(v32)
    qp32, sp32 = msda.quantize_value_table_plain(v32)
    same = bool(torch.equal(q32, qp32)) and bool(torch.equal(s32, sp32))
    checks.append({"check": "ms_deform_attn_quantize_degenerate_levels_bit_for_bit",
                   "equal": same, "ok": same})


def msda_train_rows(torch, dev, rows, check, levels, b, seed, shapes, paths):
    """The bilinear deformable forward and backward of a training step over
    ``b`` images with the pyramid ``levels``, bf16 as trained, against their
    plain versions: rows ``ms_deform_attn_bilinear_backward`` and
    ``ms_deform_attn_bilinear_train_shapes`` (``shapes`` empty), or
    ``ms_deform_attn_bilinear_backward_{shapes}_shapes`` and
    ``ms_deform_attn_bilinear_{shapes}_shapes``, which count the launches of
    ``paths``."""
    from multishiftseg_torch.ops import ms_deform_attn as msda

    # deformable backward. Tolerance: d value sums in f32 by atomics in
    # run-to-run order and both sides round once to bf16 (one bf16 step,
    # 2^-8 relative); d loc and d attn reduce 32 channels in f32
    lq = sum(h * w for h, w in levels)
    value, loc, attn = msda_inputs(torch, levels, lq, torch.bfloat16, dev, seed, batch=b)
    g = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        b, lq, N_HEADS * HEAD_DIM).astype(np.float32)).to(dev, torch.bfloat16)
    run = lambda: msda.ms_deform_attn_backward(value, levels, loc, attn, g)
    plain = lambda: msda.ms_deform_attn_backward_plain(value, levels, loc, attn, g)
    got, want = run(), plain()
    torch.cuda.synchronize()
    errs = [check(f"ms_deform_attn_bilinear_backward_{n}_{shapes or 'main'}_shapes", x, y,
                  1e-2 * float(y.float().abs().max()), 1e-2)
            for n, x, y in zip(("dvalue", "dloc", "dattn"), got, want)]
    del got, want
    ops = msda_ops(torch, loc, levels, "bilinear", backward=True)
    out_bytes = nbytes(value) + nbytes(loc) + nbytes(attn)  # d value, d loc, d attn
    b_ms, b_by = bound(nbytes(value, loc, attn, g) + out_bytes, ops)
    name = "ms_deform_attn_bilinear_backward" + (f"_{shapes}_shapes" if shapes else "")
    rows[name] = {
        "name": name, "route": "cuda", "source": "multishiftseg_torch/csrc/ms_deform_attn.cu",
        "replaces": "multishiftseg_tpu/ops/ms_deform_attn.py:587",
        "counter": "ms_deform_attn_bilinear_backward", "paths": paths,
        "max_abs_err": max(errs), "ms": median_ms(torch, run, 10),
        "plain_ms": median_ms(torch, plain, 3), "bound_ms": b_ms, "bound_by": b_by,
        # no single PyTorch call computes this function (grid_sample's backward
        # works per level on another layout and leaves the sum over points)
        "library_ms": None}
    # the bilinear forward at the same shapes, 6 launches in every M2F step;
    # tolerance as at the eval shapes (one bf16 step plus f32 order noise)
    run = lambda: msda.ms_deform_attn_core(value, levels, loc, attn, "bilinear")
    plain = lambda: msda.ms_deform_attn_core_plain(value, levels, loc, attn, "bilinear")
    name = f"ms_deform_attn_bilinear_{shapes or 'train'}_shapes"
    with torch.no_grad():
        out = run()
        err = check(name, out, plain(), 1e-3, 1e-2)
        b_ms, b_by = bound(nbytes(value, loc, attn, out),
                           msda_ops(torch, loc, levels, "bilinear"))
        rows[name] = {
            "name": name, "route": "cuda", "source": "multishiftseg_torch/csrc/ms_deform_attn.cu",
            "replaces": "multishiftseg_tpu/ops/ms_deform_attn.py:93",
            "counter": "ms_deform_attn_bilinear", "paths": paths,
            "max_abs_err": err, "plain_ms": median_ms(torch, plain, 5), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "staged_levels": msda.staged_levels(levels, HEAD_DIM, value.dtype)}
        time_redesigned(torch, rows[name], run)
    del value, loc, attn, g, out


# the paths that run the stage-2 shapes (16 images of 704x704); the pipelined
# step ("pipeline") runs the deformable kernels on its microbatches (rows
# ``*_pipeline_shapes``) and the other kernels on the full batch
TRAIN_PATHS = ("train", "stage1_train", "train_loop", "dp_train_m2f",
               "alt_train_m2f_swin_large_stage2", "tp_train_m2f")
PIPELINE_PATHS = ("pipeline",)
# the served programs' requests (the deploy phase)
DEPLOY_PATHS = ("deploy_m2f", "deploy_deeplab")


def train_kernel_rows(torch, dev, rows, check, checks):
    """The training slice's kernels at the stage-2 shapes (8 pairs of 700x700
    crops padded to 704x704): the deformable forward and backward over the
    16 images (``TRAIN_PATHS``) and over one GPipe microbatch of them
    (``PIPELINE_PATHS``, ``pipeline_parallel = 2``), the assignment and the
    label points over the 16 (both)."""
    from multishiftseg_torch.core.pipeline import auto_microbatches
    from multishiftseg_torch.losses import criterion, matcher

    pairs, paths = TRAIN_PAIRS, TRAIN_PATHS + PIPELINE_PATHS
    b = 2 * pairs
    msda_train_rows(torch, dev, rows, check, TRAIN_LEVELS, b, SEED + 7, "", TRAIN_PATHS)
    msda_train_rows(torch, dev, rows, check, TRAIN_LEVELS, b // auto_microbatches(b, 2),
                    SEED + 7, "pipeline", PIPELINE_PATHS)

    # batched assignment: 16 problems of 19 targets x 100 queries, about half
    # the rows at BIG (classes absent from the image); exact equality
    rs = np.random.RandomState(SEED + 9)
    cost_np = rs.rand(b, CLASSES, QUERIES).astype(np.float32)
    cost_np[rs.rand(b, CLASSES) > 0.5] = matcher.BIG
    cost_np[:, 0] = rs.rand(b, QUERIES)  # every image has a valid row
    cost = torch.from_numpy(cost_np).to(dev)
    run = lambda: matcher.linear_sum_assignment(cost)
    steps = []
    want = matcher.linear_sum_assignment_plain(cost, steps)
    got = run()
    torch.cuda.synchronize()
    same = bool(torch.equal(got.cpu(), want.cpu()))
    from scipy.optimize import linear_sum_assignment as scipy_lsa

    optimal = True
    for i in range(b):
        valid = np.nonzero(cost_np[i, :, 0] < matcher.BIG)[0]
        r, c = scipy_lsa(cost_np[i][valid])
        ours = cost_np[i][valid, got[i].cpu().numpy()[valid]].sum()
        optimal &= bool(abs(ours - cost_np[i][valid][r, c].sum()) <= 1e-5 * abs(ours))
    checks.append({"check": "linear_sum_assignment_main_shapes",
                   "equal_to_plain": same, "scipy_optimal_on_valid_rows": optimal,
                   "ok": same and optimal})
    # each Dijkstra step reduces over every column: about 5 f32 operations each
    b_ms, b_by = bound(nbytes(cost, got), sum(steps) * QUERIES * 5)
    name = "linear_sum_assignment"
    row = rows[name] = {
        "name": name, "route": "cuda",
        "source": "multishiftseg_torch/csrc/assignment.cu",
        "replaces": "multishiftseg_tpu/losses/matcher.py:28",
        # the OOD trainers' steps at these shapes; the vanilla recipes' are
        # their own rows'
        "counter": "linear_sum_assignment", "paths": paths,
        "max_abs_err": 0.0 if same else float("nan"), "ms": median_ms(torch, run, 20),
        "plain_ms": median_ms(torch, lambda: matcher.linear_sum_assignment_plain(cost), 3),
        "bound_ms": b_ms, "bound_by": b_by,
        # PyTorch has no assignment solver
        "library_ms": None}
    time_redesigned(torch, row, run)
    # a latency yardstick beside the byte bound: the search is a chain of
    # dependent argmins, the longest problem's steps
    row["device_kernels"] = device_kernels(torch, run)
    row["max_steps"] = max(steps)
    row["device_ns_per_step"] = row["device_ms"] * 1e6 / max(steps)

    # label points on the label maps at 704x704: every class at the matcher's
    # points, and one class per row at the augmented half's clean candidates
    labels_np = rs.randint(0, CLASSES + 3, (b, *TRAIN_HW)).astype(np.int32)
    labels_np[:, :, CROP[1]:] = 255
    labels = torch.from_numpy(labels_np).to(dev)
    coords = torch.from_numpy(rs.rand(b, TRAIN_POINTS, 2).astype(np.float32)).to(dev)
    run = lambda: criterion.sample_target_points(labels, coords, CLASSES)
    plain = lambda: criterion.sample_target_points_plain(labels, coords, CLASSES)
    out = run()
    # at most four corner weights summed in f32, in another order
    err = check("label_points_classes_main_shapes", out, plain(), 1e-6, 0.0)
    n_rows = pairs * CLASSES
    rcoords = torch.from_numpy(rs.rand(n_rows, int(TRAIN_POINTS * 1.25), 2).astype(
        np.float32)).to(dev)
    ids = torch.arange(CLASSES, device=dev).repeat(pairs)
    err = max(err, check("label_points_rows_main_shapes",
                         criterion.sample_class_points(labels, rcoords, ids, CLASSES, pairs),
                         criterion.sample_class_points_plain(labels, rcoords, ids, CLASSES,
                                                             pairs), 1e-6, 0.0))
    # bytes: the label sectors the corners touch, the coordinates, the samples;
    # operations: 4 compares and 4 adds per point and class
    label_bytes = label_sector_bytes(torch, labels, coords, torch.arange(b, device=dev))
    b_ms, b_by = bound(label_bytes + nbytes(coords, out), b * TRAIN_POINTS * CLASSES * 8)
    name = "label_points"
    rows[name] = {
        "name": name, "route": "cuda",
        "source": "multishiftseg_torch/csrc/label_points.cu",
        "replaces": "multishiftseg_tpu/losses/criterion.py:66",
        "counter": "label_points", "paths": paths,
        "max_abs_err": err, "ms": median_ms(torch, run, 20),
        "plain_ms": median_ms(torch, plain, 5), "bound_ms": b_ms, "bound_by": b_by,
        # the one-call equivalent, grid_sample of [B, K, H, W] one-hot masks,
        # takes other inputs (the masks, not the label map)
        "library_ms": None}
    time_redesigned(torch, rows[name], run)


def in_map_taps(n, hw, rate):
    """Pixel-taps of a dilated 3x3 conv over n maps of ``hw`` whose shifted
    source lies in the map: the work the function needs."""
    from multishiftseg_torch.ops.dilated_conv import tap_windows

    return n * sum((sy.stop - sy.start) * (sx.stop - sx.start)
                   for _, _, sy, sx, _, _ in tap_windows(*hw, rate))


def deeplab_kernel_rows(torch, dev, rows, check, checks):
    """DeepLab's kernels at its main-path shapes: the ASPP's dilated conv at the
    eval shapes (its three rates timed together), its weight gradient and
    forward at the training shapes, and the pixel selection over 8 x 700 x 700
    CE values;
    then small and odd shapes. The conv bounds count in-map taps only, at the
    bf16 tensor-core peak."""
    import torch.nn.functional as F

    from multishiftseg_torch.losses import rcl
    from multishiftseg_torch.ops import dilated_conv as dconv

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions sum in f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    # forward, eval shapes, bf16 as served; the f32 master weights, which the
    # wrapper casts. Tolerance: both sides sum the same products in f32 and
    # round once to bf16, one bf16 step (2^-8) apart, plus f32 order noise
    x = torch.randn((1, *DL_EVAL_MAP, DL_CIN), generator=gen, device=dev).to(torch.bfloat16)
    ks = [torch.randn((3, 3, DL_CIN, DL_COUT), generator=gen, device=dev) / 96 for _ in DL_RATES]
    with torch.no_grad():
        run = lambda: [dconv.dilated_conv3x3(x, k, r) for k, r in zip(ks, DL_RATES)]
        plain = lambda: [dconv.dilated_conv3x3_plain(x, k, r) for k, r in zip(ks, DL_RATES)]
        outs, refs = run(), plain()
        torch.cuda.synchronize()
        err = max(check(f"dilated_conv3x3_rate{r}_eval_shapes", o, ref,
                        1e-3 * float(ref.float().abs().max()), 2 ** -7)
                  for r, o, ref in zip(DL_RATES, outs, refs))
        del refs
        times = (median_ms(torch, run, 10), median_ms(torch, plain, 2))
        # the library: cuDNN's dilated conv2d in bf16, in benchmark mode (its
        # first call per rate tries every algorithm), channels-last as served
        # and NCHW-contiguous; the faster layout is the row's yardstick
        cudnn = {}
        torch.backends.cudnn.benchmark = True
        for layout, fmt in (("channels_last", torch.channels_last),
                            ("nchw", torch.contiguous_format)):
            xc = x.permute(0, 3, 1, 2).contiguous(memory_format=fmt)
            wc = [k.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=fmt)
                  for k in ks]
            lib = lambda: [F.conv2d(xc, w, padding=r, dilation=r) for w, r in zip(wc, DL_RATES)]
            t0 = time.perf_counter()
            lib()
            torch.cuda.synchronize()
            cudnn[layout] = {
                "first_call_s": time.perf_counter() - t0, "ms": median_ms(torch, lib, 2),
                "backend": str(torch._C._select_conv_backend(
                    xc, wc[0], None, [1, 1], [12, 12], [12, 12], False, [0, 0], 1))}
        torch.backends.cudnn.benchmark = False
        del xc, wc
    best = min(cudnn, key=lambda k: cudnn[k]["ms"])
    taps = sum(in_map_taps(1, DL_EVAL_MAP, r) for r in DL_RATES)
    flop = 2 * taps * DL_CIN * DL_COUT
    b_ms, b_by = bound(nbytes(x, *outs) + sum(k.numel() * 2 for k in ks), flop,
                       BF16_TC_OPS_PER_S)
    rows["dilated_conv3x3"] = {
        "name": "dilated_conv3x3", "route": "cuda",
        "source": "multishiftseg_torch/csrc/dilated_conv.cu",
        "replaces": "multishiftseg_tpu/ops/dilated_conv.py:19",
        "paths": ("deeplab_serve", "validate", "evaluate", "deploy_deeplab"),
        "max_abs_err": err, "ms": times[0], "plain_ms": times[1], "bound_ms": b_ms,
        "bound_by": b_by,
        # cuDNN's dilated conv2d, bf16, the faster layout: the same function
        "library_ms": cudnn[best]["ms"]}
    checks.append({"check": "dilated_conv3x3_eval_work", "in_map_pixel_taps": taps,
                   "tflop": flop / 1e12, "kernel_tflop_per_s": flop / times[0] / 1e9,
                   "library_tflop_per_s": flop / cudnn[best]["ms"] / 1e9,
                   "peak": "bf16 tensor cores, 989 TFLOP/s", "library": cudnn,
                   "library_layout": best, "ok": True})
    del x, outs

    # forward at DeepV3Plus's eval shapes (the ASPP over an SEResNeXt-101 or
    # R-101 layer4 / res5 at output stride 8: 2048 -> 256 channels at 128x256),
    # bf16 as served; the same tolerance; cuDNN in the faster layout above
    xd = torch.randn((1, *DL_EVAL_MAP, DV3_CIN), generator=gen, device=dev).to(torch.bfloat16)
    kd = [torch.randn((3, 3, DV3_CIN, DL_COUT), generator=gen, device=dev) / 64
          for _ in DL_RATES]
    with torch.no_grad():
        run = lambda: [dconv.dilated_conv3x3(xd, k, r) for k, r in zip(kd, DL_RATES)]
        plain = lambda: [dconv.dilated_conv3x3_plain(xd, k, r) for k, r in zip(kd, DL_RATES)]
        outs, refs = run(), plain()
        torch.cuda.synchronize()
        err = max(check(f"dilated_conv3x3_rate{r}_deepv3_shapes", o, ref,
                        1e-3 * float(ref.float().abs().max()), 2 ** -7)
                  for r, o, ref in zip(DL_RATES, outs, refs))
        del refs
        times = (median_ms(torch, run, 10), median_ms(torch, plain, 2))
        fmt = torch.channels_last if best == "channels_last" else torch.contiguous_format
        xc = xd.permute(0, 3, 1, 2).contiguous(memory_format=fmt)
        wc = [k.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=fmt)
              for k in kd]
        torch.backends.cudnn.benchmark = True
        lib = lambda: [F.conv2d(xc, w, padding=r, dilation=r) for w, r in zip(wc, DL_RATES)]
        lib()
        lib_ms = median_ms(torch, lib, 2)
        torch.backends.cudnn.benchmark = False
        del xc, wc
    taps = sum(in_map_taps(1, DL_EVAL_MAP, r) for r in DL_RATES)
    flop = 2 * taps * DV3_CIN * DL_COUT
    b_ms, b_by = bound(nbytes(xd, *outs) + sum(k.numel() * 2 for k in kd), flop,
                       BF16_TC_OPS_PER_S)
    rows["dilated_conv3x3_deepv3"] = {
        "name": "dilated_conv3x3_deepv3", "route": "cuda",
        "source": "multishiftseg_torch/csrc/dilated_conv.cu",
        "replaces": "multishiftseg_tpu/ops/dilated_conv.py:19",
        "counter": "dilated_conv3x3", "paths": ("alt_serve_deepv3",),
        "max_abs_err": err, "ms": times[0], "plain_ms": times[1], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms}
    checks.append({"check": "dilated_conv3x3_deepv3_work", "cin": DV3_CIN,
                   "tflop": flop / 1e12, "kernel_tflop_per_s": flop / times[0] / 1e9,
                   "library_tflop_per_s": flop / lib_ms / 1e9, "library_layout": best,
                   "ok": True})
    del xd, kd, outs

    # weight gradient, training shapes (16 x 88 x 88), bf16 inputs, f32 result
    # by atomics; tolerance: the same exact products summed in f32 in another order
    b = 2 * DL_TRAIN_PAIRS
    xt = torch.randn((b, *DL_TRAIN_MAP, DL_CIN), generator=gen, device=dev).to(torch.bfloat16)
    gt = (torch.randn((b, *DL_TRAIN_MAP, DL_COUT), generator=gen, device=dev) / 64).to(
        torch.bfloat16)
    run = lambda: [dconv.dilated_conv3x3_wgrad(xt, gt, r) for r in DL_RATES]
    plain = lambda: [dconv.dilated_conv3x3_wgrad_plain(xt, gt, r) for r in DL_RATES]
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = max(check(f"dilated_conv3x3_wgrad_rate{r}_train_shapes", a, c,
                    1e-4 * float(c.abs().max()), 0.0) for r, a, c in zip(DL_RATES, got, want))
    del got, want
    xc, gc = xt.permute(0, 3, 1, 2), gt.permute(0, 3, 1, 2)
    library = lambda: [torch.nn.grad.conv2d_weight(xc, (DL_COUT, DL_CIN, 3, 3), gc, padding=r,
                                                   dilation=r) for r in DL_RATES]
    torch.backends.cudnn.benchmark = True  # the library at its best
    times = (median_ms(torch, run, 5), median_ms(torch, plain, 1), median_ms(torch, library, 3))
    torch.backends.cudnn.benchmark = False
    taps = sum(in_map_taps(b, DL_TRAIN_MAP, r) for r in DL_RATES)
    flop = 2 * taps * DL_CIN * DL_COUT
    b_ms, b_by = bound(nbytes(xt, gt) + len(DL_RATES) * 9 * DL_COUT * DL_CIN * 4, flop,
                       BF16_TC_OPS_PER_S)
    rows["dilated_conv3x3_wgrad"] = {
        "name": "dilated_conv3x3_wgrad", "route": "cuda",
        "source": "multishiftseg_torch/csrc/dilated_conv.cu",
        "replaces": "multishiftseg_tpu/ops/dilated_conv.py:19",
        "max_abs_err": err, "ms": times[0], "plain_ms": times[1], "bound_ms": b_ms,
        "bound_by": b_by,
        # cuDNN's weight gradient of the dilated conv2d, bf16 channels-last
        "library_ms": times[2]}
    checks.append({"check": "dilated_conv3x3_wgrad_train_work", "in_map_pixel_taps": taps,
                   "tflop": flop / 1e12, "kernel_tflop_per_s": flop / times[0] / 1e9,
                   "library_tflop_per_s": flop / times[2] / 1e9, "ok": True})
    del xc, gc
    # the forward at the training shapes, 3 launches a step (the tiles' 16
    # columns do not divide the 88-wide map); the eval check's tolerance, and
    # timed beside cuDNN's conv2d there (channels-last, benchmark mode)
    errs = []
    with torch.no_grad():
        for k, r in zip(ks, DL_RATES):
            out, ref = dconv.dilated_conv3x3(xt, k, r), dconv.dilated_conv3x3_plain(xt, k, r)
            torch.cuda.synchronize()
            errs.append(check(f"dilated_conv3x3_rate{r}_train_shapes", out, ref,
                              1e-3 * float(ref.float().abs().max()), 2 ** -7))
            del out, ref
        run = lambda: [dconv.dilated_conv3x3(xt, k, r) for k, r in zip(ks, DL_RATES)]
        plain = lambda: [dconv.dilated_conv3x3_plain(xt, k, r) for k, r in zip(ks, DL_RATES)]
        xc = xt.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        wc = [k.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
              for k in ks]
        library = lambda: [F.conv2d(xc, w, padding=r, dilation=r) for w, r in zip(wc, DL_RATES)]
        torch.backends.cudnn.benchmark = True
        times = (median_ms(torch, run, 5), median_ms(torch, plain, 1), median_ms(torch, library, 3))
        torch.backends.cudnn.benchmark = False
    taps = sum(in_map_taps(b, DL_TRAIN_MAP, r) for r in DL_RATES)
    flop = 2 * taps * DL_CIN * DL_COUT
    out_bytes = b * DL_TRAIN_MAP[0] * DL_TRAIN_MAP[1] * DL_COUT * 2
    b_ms, b_by = bound(nbytes(xt) + len(DL_RATES) * (out_bytes + 9 * DL_COUT * DL_CIN * 2),
                       flop, BF16_TC_OPS_PER_S)
    rows["dilated_conv3x3_train"] = {
        "name": "dilated_conv3x3_train", "route": "cuda",
        "source": "multishiftseg_torch/csrc/dilated_conv.cu",
        "replaces": "multishiftseg_tpu/ops/dilated_conv.py:19",
        "counter": "dilated_conv3x3", "paths": ("deeplab_train", "train_loop",
                                                "dp_train_deeplab", "tp_train_deeplab"),
        "max_abs_err": max(errs), "ms": times[0], "plain_ms": times[1], "bound_ms": b_ms,
        "bound_by": b_by,
        # cuDNN's dilated conv2d, bf16 channels-last: the same function
        "library_ms": times[2]}
    checks.append({"check": "dilated_conv3x3_train_work", "in_map_pixel_taps": taps,
                   "tflop": flop / 1e12, "kernel_tflop_per_s": flop / times[0] / 1e9,
                   "library_tflop_per_s": flop / times[2] / 1e9, "ok": True})
    del xt, gt, ks, xc, wc

    # pixel selection over the augmented half's CE values (8 x 700 x 700),
    # a fifth of them invalid (+inf keys); the threshold must equal the k-th
    # smallest key pattern, the sum agree within f32 rounding
    n = DL_TRAIN_PAIRS * DL_CROP[0] * DL_CROP[1]
    vals = -torch.rand(n, generator=gen, device=dev).log() * 2
    valid = torch.rand(n, generator=gen, device=dev) > 0.2
    keyed = torch.where(valid, vals, torch.full_like(vals, float("inf")))
    sn = (0.8 * valid.sum()).to(torch.int32)
    run = lambda: rcl._bottom_k_sum(vals, keyed, sn)
    plain = lambda: rcl.bottom_k_sum_plain(vals, keyed, sn)
    got, want = run(), plain()
    _, threshold, _ = rcl.bottom_k_sum_cuda(vals, keyed, sn)
    kth = torch.sort(keyed.view(torch.int32).long() & 0xFFFFFFFF).values[int(sn) - 1]
    torch.cuda.synchronize()
    err = check("bottom_k_sum_main_shapes", got, want, 0.0, 1e-6)
    same_t = (int(threshold) & 0xFFFFFFFF) == int(kth)
    checks[-1].update(threshold_equal_kth_key=same_t, ok=checks[-1]["ok"] and same_t)
    # its backward, which every training step launches: the weights exactly
    grads = []
    for fn in (rcl._bottom_k_sum, rcl.bottom_k_sum_plain):
        v = vals.clone().requires_grad_()
        fn(v, keyed, sn).backward()
        grads.append(v.grad)
    torch.cuda.synchronize()
    check("bottom_k_sum_main_shapes_grad", grads[0], grads[1], 0.0, 0.0)
    checks[-1]["elements"] = n
    del grads
    b_ms, b_by = bound(nbytes(vals, keyed, sn, got), 2 * n)  # a compare and an add each
    k_host = int(sn)
    row = rows["bottom_k_sum"] = {
        "name": "bottom_k_sum", "route": "cuda", "source": "multishiftseg_torch/csrc/bottom_k.cu",
        "replaces": "multishiftseg_tpu/losses/rcl.py:65",
        "max_abs_err": err, "ms": median_ms(torch, run, 20), "plain_ms": median_ms(torch, plain, 5),
        "bound_ms": b_ms, "bound_by": b_by,
        # the k smallest by torch.topk (k read to the host first): the same
        # forward value, since the threshold's ties are equal values where the
        # key is finite, but not the kernel's gradient weights (topk picks
        # some of the ties whole)
        "library_ms": median_ms(
            torch, lambda: torch.topk(keyed, k_host, largest=False).values.sum(), 20)}
    time_redesigned(torch, row, run)
    with torch.no_grad():
        row["device_kernels"] = device_kernels(torch, run)
    row["staged_fraction"] = rcl.staged_fraction(n, dev)

    # small and odd shapes: taps wholly outside the map, channels off the
    # tiles, f32 and bf16, the gradients through the autograd Function
    for dtype in (torch.float32, torch.bfloat16):
        for n_, h_, w_, cin, cout, r in ((1, 5, 7, 16, 8, 12), (2, 13, 29, 20, 5, 24),
                                         (3, 20, 20, 8, 16, 36)):
            xs = torch.randn((n_, h_, w_, cin), generator=gen, device=dev).to(dtype)
            kk = torch.randn((3, 3, cin, cout), generator=gen, device=dev) / 8
            gs = torch.randn((n_, h_, w_, cout), generator=gen, device=dev).to(dtype)
            res = []
            for fn in (dconv.dilated_conv3x3, dconv.dilated_conv3x3_plain):
                xi, ki = xs.clone().requires_grad_(), kk.clone().requires_grad_()
                o = fn(xi, ki, r)
                o.backward(gs)
                res.append((o.detach(), xi.grad, ki.grad))
            torch.cuda.synchronize()
            for part, a, c in zip(("out", "dx", "dw"), *res):
                ref = float(c.float().abs().max())
                # f32: order only; bf16: one rounding of an f32 sum apart
                atol, rtol = (1e-5 * ref, 0.0) if dtype == torch.float32 else (1e-4 * ref, 2 ** -7)
                check(f"dilated_conv3x3_{str(dtype)[6:]}_{n_}x{h_}x{w_}x{cin}to{cout}_rate{r}_{part}",
                      a, c, atol, rtol)
    for case in ("ties", "select_num_0"):
        q = torch.floor(torch.rand(5003, generator=gen, device=dev) * 40) / 16
        ok_ = torch.rand(5003, generator=gen, device=dev) > 0.25
        kq = torch.where(ok_, q, torch.full_like(q, float("inf")))
        sq = (0.8 * ok_.sum()).to(torch.int32) if case == "ties" else torch.zeros(
            (), dtype=torch.int32, device=dev)
        res = []
        for fn in (rcl._bottom_k_sum, rcl.bottom_k_sum_plain):
            v = q.clone().requires_grad_()
            out = fn(v, kq, sq)
            out.backward()
            res.append((out.detach(), v.grad))
        torch.cuda.synchronize()
        check(f"bottom_k_sum_{case}_sum", res[0][0], res[1][0], 1e-6, 1e-6)
        check(f"bottom_k_sum_{case}_grad", res[0][1], res[1][1], 0.0, 0.0)


def check_per_entry(checks, name, got, want, scale, rel):
    """Pass where |got - want| <= rel * scale entry by entry (``scale``: the
    entry's sum of absolute terms); report the largest ratio."""
    err = (got - want).abs()
    ok = bool((err <= rel * scale + 1e-30).all())
    checks.append({"check": name, "max_abs_err": float(err.max()),
                   "max_err_over_abs_terms": float((err / scale.clamp_min(1e-30)).max()),
                   "rel_of_abs_terms": rel, "ok": ok})
    return float(err.max())


def tail_backward_inputs(torch, dev, seed, n, hw, out_hw, crop=None, tie=False):
    """Mask logits [n, 100, *hw], class probabilities [n, 100, 19] and a
    gradient [n, *out_hw] of the anomaly score (zero outside ``crop``). Where
    the top two class sums lie within 1e-4 of each other, f32 sum order
    decides which class takes the gradient, so it is zeroed there (counted);
    ``tie`` makes classes 0 and 1 equal and leading instead."""
    from multishiftseg_torch.ops import scores

    g = np.random.RandomState(seed)
    logits = g.randn(n, QUERIES, CLASSES + 1).astype(np.float32)
    if tie:
        logits[..., 1] = logits[..., 0] = 3.0 + g.rand(n, QUERIES).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(logits).to(dev), -1)[..., :-1].contiguous()
    masks = torch.from_numpy(3 * g.randn(n, QUERIES, *hw).astype(np.float32)).to(dev)
    grad = torch.from_numpy(g.randn(n, *out_hw).astype(np.float32)).to(dev)
    if crop is not None:
        grad[:, crop[0]:] = 0
        grad[:, :, crop[1]:] = 0
    zeroed = 0
    if not tie:
        with torch.no_grad():
            up = torch.sigmoid(scores.resize_bilinear_nchw(masks, out_hw))
            top2 = torch.einsum("bqk,bqhw->bhwk", probs, up).topk(2, dim=-1).values
            del up
            near = (top2[..., 0] - top2[..., 1]) <= 1e-4
            zeroed = int((near & (grad != 0)).sum())
            grad[near] = 0
            del top2, near
    return masks, probs, grad, zeroed


def stage1_kernel_rows(torch, dev, rows, check, checks):
    """Stage 1's score-tail kernels at its shapes (16 images, 176x176 masks to
    704x704). The two forward tails of every step, the anomaly score and the K
    class channels alone (the classes-only mode), against their plain versions
    (f32 sums in another order: 1e-5). The anomaly tail's backward (the gradient
    inside the 700x700 crop), d probs alone (the main path) and with d masks,
    against autograd of the plain version: each entry within 1e-5 of its sum of
    absolute terms (the same backward of |g|); and a small case with forced ties."""
    from multishiftseg_torch.ops import scores

    b = 2 * TRAIN_PAIRS
    g = np.random.RandomState(SEED + 33)
    fmasks = torch.from_numpy(3 * g.randn(b, QUERIES, *S1_MASK_HW).astype(np.float32)).to(dev)
    cls = torch.from_numpy(g.randn(b, QUERIES, CLASSES + 1).astype(np.float32)).to(dev)
    # per output pixel and query: bilinear taps 7, sigmoid 4, the K sums 2K
    ops = b * TRAIN_HW[0] * TRAIN_HW[1] * QUERIES * (11 + 2 * CLASSES)
    run_a = lambda: scores.anomaly_score_upsampled(cls, fmasks, TRAIN_HW)
    plain_a = lambda: scores.anomaly_score_upsampled_plain(cls, fmasks, TRAIN_HW)
    with torch.no_grad():
        out = run_a()
        err = check("mask_scores_anomaly_stage1_shapes", out, plain_a(), 1e-5, 1e-5)
        # and the max over K of each pixel
        b_ms, b_by = bound(nbytes(fmasks) + b * QUERIES * CLASSES * 4 + nbytes(out),
                           ops + b * TRAIN_HW[0] * TRAIN_HW[1] * (CLASSES + 1))
        rows["mask_scores_anomaly_stage1_shapes"] = {
            "name": "mask_scores_anomaly_stage1_shapes", "route": "cuda",
            "source": "multishiftseg_torch/csrc/mask_scores.cu",
            "replaces": "multishiftseg_tpu/ops/scores.py:39",
            "counter": "mask_scores_anomaly", "paths": ("stage1_train", "train_loop"),
            "max_abs_err": err, "plain_ms": median_ms(torch, plain_a, 3), "bound_ms": b_ms,
            "bound_by": b_by,
            # no single PyTorch call computes the fused tail (the plain version
            # is an interpolate, a sigmoid, an einsum and an amax)
            "library_ms": None}
        time_redesigned(torch, rows["mask_scores_anomaly_stage1_shapes"], run_a)
        del out
    run_c = lambda: scores.semantic_inference_upsampled(cls, fmasks, TRAIN_HW, CLASSES,
                                                        _classes_only=True)
    plain_c = lambda: scores.semantic_inference_upsampled_plain(cls, fmasks, TRAIN_HW, CLASSES,
                                                                _classes_only=True)
    out = run_c()
    err = check("mask_scores_semantic_classes_stage1_shapes", out, plain_c(), 1e-5, 1e-5)
    checks[-1]["shape"] = list(out.shape)
    b_ms, b_by = bound(nbytes(fmasks) + b * QUERIES * CLASSES * 4 + nbytes(out), ops)
    rows["mask_scores_semantic_classes"] = {
        "name": "mask_scores_semantic_classes", "route": "cuda",
        "source": "multishiftseg_torch/csrc/mask_scores.cu",
        "replaces": "multishiftseg_tpu/ops/scores.py:25",
        # stage 1's steps; the vanilla semantic evaluation's are their own row's
        "paths": ("stage1_train", "train_loop"), "max_abs_err": err, "plain_ms": median_ms(torch, plain_c, 3), "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None}
    time_redesigned(torch, rows["mask_scores_semantic_classes"], run_c)
    del fmasks, cls, out
    masks, probs, grad, zeroed = tail_backward_inputs(torch, dev, SEED + 30, b, S1_MASK_HW,
                                                      TRAIN_HW, crop=CROP)
    run = lambda: scores.mask_scores_backward(masks, probs, grad, TRAIN_HW)
    run_m = lambda: scores.mask_scores_backward(masks, probs, grad, TRAIN_HW, dmask=True)
    plain = lambda: scores.mask_scores_backward_plain(masks, probs, grad, TRAIN_HW)
    dp, _ = run()
    again, _ = run()
    dp2, dm = run_m()
    want_p, want_m = scores.mask_scores_backward_plain(masks, probs, grad, TRAIN_HW, dmask=True)
    abs_p, abs_m = scores.mask_scores_backward_plain(masks, probs, grad.abs(), TRAIN_HW,
                                                     dmask=True)
    torch.cuda.synchronize()
    err = check_per_entry(checks, "mask_scores_backward_dprobs_stage1_shapes", dp, want_p,
                          abs_p.abs(), 1e-5)
    same = bool(torch.equal(dp, dp2)) and bool(torch.equal(dp, again))
    checks[-1].update(pixels_zeroed_near_ties=zeroed, same_as_with_dmask=bool(torch.equal(dp, dp2)),
                      two_runs_bit_for_bit=bool(torch.equal(dp, again)),
                      ok=checks[-1]["ok"] and same)
    check_per_entry(checks, "mask_scores_backward_dmask_stage1_shapes", dm, want_m, abs_m.abs(),
                    1e-5)
    del want_p, want_m, abs_p, abs_m, dm, dp2, again
    times = {"ms": median_ms(torch, run, 10), "dmask_ms": median_ms(torch, run_m, 5),
             "plain_ms": median_ms(torch, plain, 3)}
    checks.append({"check": "mask_scores_backward_stage1_times", **times, "ok": True})
    # operations the pixels with a gradient need: the forward's per query
    # (bilinear 7, sigmoid 4, the K sums 2K), the max over K, and a multiply
    # and an add into d probs per query and tied class
    pixels = int((grad != 0).sum())
    per_px = QUERIES * (11 + 2 * CLASSES) + CLASSES + 2 * QUERIES
    b_ms, b_by = bound(nbytes(masks, probs, grad) + nbytes(dp), pixels * per_px)
    rows["mask_scores_backward"] = {
        "name": "mask_scores_backward", "route": "cuda",
        "source": "multishiftseg_torch/csrc/mask_scores.cu",
        "replaces": "multishiftseg_tpu/ops/scores.py:39",
        "max_abs_err": err, "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by,
        # no single PyTorch call computes this gradient
        "library_ms": None}
    del masks, probs, grad, dp
    # forced ties, small: the tied classes share the gradient evenly
    masks, probs, grad, _ = tail_backward_inputs(torch, dev, SEED + 32, 2, (16, 20), (64, 80),
                                                 tie=True)
    dp, dm = scores.mask_scores_backward(masks, probs, grad, (64, 80), dmask=True)
    want_p, want_m = scores.mask_scores_backward_plain(masks, probs, grad, (64, 80), dmask=True)
    abs_p, abs_m = scores.mask_scores_backward_plain(masks, probs, grad.abs(), (64, 80),
                                                     dmask=True)
    torch.cuda.synchronize()
    check_per_entry(checks, "mask_scores_backward_forced_ties_dprobs", dp, want_p, abs_p.abs(), 1e-5)
    even = bool(torch.equal(dp[..., 0], dp[..., 1])) and float(dp[..., 0].abs().max()) > 0
    checks[-1].update(tied_classes_equal=even, ok=checks[-1]["ok"] and even)
    check_per_entry(checks, "mask_scores_backward_forced_ties_dmask", dm, want_m, abs_m.abs(), 1e-5)


def instance_kernel_rows(torch, dev, rows, check, checks):
    """The vanilla recipes' kernels at their own shapes (:data:`INST_SHAPES`):
    per pair of recipes that share them, the bilinear deformable forward and
    backward over 8 unpadded crops (:func:`msda_train_rows`); the label points
    over 8 segment id maps of the crop with -1 (ignore) pixels and T slots;
    the assignment of 8 problems of T slots x 100 queries, costs from
    ``compute_match_cost`` with -1 padding slots (rows at BIG) and, for the
    instance and panoptic recipes, duplicate classes. Then the semantic
    evaluation's K-class score tail (100 queries of 256x512 masks to
    1024x2048). Against the plain versions: label points within 1e-6 (four
    corner weights summed in f32), the assignment exactly, the score tail
    within 1e-5 (f32 sums in another order). Each row counts the launches of
    the training paths at its shapes, the alternates' included."""
    from multishiftseg_torch.losses import criterion, matcher
    from multishiftseg_torch.ops import scores

    for shapes, (crop, t, paths) in INST_SHAPES.items():
        b = INST_BATCH
        msda_train_rows(torch, dev, rows, check, pyramid(crop), b, SEED + 82, shapes, paths)
        rs = np.random.RandomState(SEED + 80)
        blocks = (b, -(-crop[0] // 16), -(-crop[1] // 16))
        ids_np = np.repeat(np.repeat(rs.randint(-1, t, blocks), 16, 1), 16, 2)[
            :, :crop[0], :crop[1]]
        ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
        coords = torch.from_numpy(rs.rand(b, TRAIN_POINTS, 2).astype(np.float32)).to(dev)
        run = lambda: criterion.sample_target_points(ids, coords, t)
        plain = lambda: criterion.sample_target_points_plain(ids, coords, t)
        out = run()
        err = check(f"label_points_classes_{shapes}_shapes", out, plain(), 1e-6, 0.0)
        rcoords = torch.from_numpy(rs.rand(b * t, TRAIN_POINTS, 2).astype(np.float32)).to(dev)
        slots = torch.arange(t, device=dev).repeat(b)
        err = max(err, check(f"label_points_rows_{shapes}_shapes",
                             criterion.sample_class_points(ids, rcoords, slots, t),
                             criterion.sample_class_points_plain(ids, rcoords, slots, t),
                             1e-6, 0.0))
        label_bytes = label_sector_bytes(torch, ids, coords, torch.arange(b, device=dev))
        b_ms, b_by = bound(label_bytes + nbytes(coords, out), b * TRAIN_POINTS * t * 8)
        name = f"label_points_{shapes}_shapes"
        rows[name] = {
            "name": name, "route": "cuda", "source": "multishiftseg_torch/csrc/label_points.cu",
            "replaces": "multishiftseg_tpu/losses/criterion.py:66",
            "counter": "label_points", "paths": paths,
            "max_abs_err": err, "plain_ms": median_ms(torch, plain, 5), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}
        time_redesigned(torch, rows[name], run)
        del ids, coords, rcoords, out

        k = INST_CLASSES if shapes == "instance" else CLASSES
        if shapes == "instance":
            classes = torch.from_numpy(rs.randint(0, k, (b, t)))
            classes[:, 1] = classes[:, 0]  # duplicate classes
            for i in range(b):
                classes[i, 10 + 4 * i:] = -1  # 10..38 valid slots
        else:  # one segment a class present: 12..19 valid slots, distinct
            classes = torch.full((b, t), -1, dtype=torch.int64)
            for i in range(b):
                n = 12 + i
                classes[i, :n] = torch.from_numpy(rs.permutation(k)[:n])
        p_match = 512
        cost_cpu = matcher.compute_match_cost(
            torch.from_numpy(rs.randn(b, QUERIES, k + 1).astype(np.float32)),
            torch.from_numpy(3 * rs.randn(b, QUERIES, p_match).astype(np.float32)),
            torch.from_numpy((rs.rand(b, t, p_match) > 0.7).astype(np.float32)), classes >= 0,
            2.0, 5.0, 5.0, tgt_classes=classes).transpose(1, 2).contiguous()
        cost = cost_cpu.to(dev)
        run = lambda: matcher.linear_sum_assignment(cost)
        steps = []
        want = matcher.linear_sum_assignment_plain(cost, steps)
        got = run()
        torch.cuda.synchronize()
        same = bool(torch.equal(got.cpu(), want.cpu()))
        from scipy.optimize import linear_sum_assignment as scipy_lsa

        optimal, cost_np = True, cost_cpu.numpy()
        for i in range(b):
            valid = np.nonzero(classes[i].numpy() >= 0)[0]
            r, c = scipy_lsa(cost_np[i][valid])
            ours = cost_np[i][valid, got[i].cpu().numpy()[valid]].sum()
            optimal &= bool(abs(ours - cost_np[i][valid][r, c].sum()) <= 1e-5 * abs(ours))
        checks.append({"check": f"linear_sum_assignment_{shapes}_shapes",
                       "equal_to_plain": same, "scipy_optimal_on_valid_rows": optimal,
                       "shared_bytes": matcher.assignment_shared_bytes(t, QUERIES),
                       "ok": same and optimal})
        b_ms, b_by = bound(nbytes(cost, got), sum(steps) * QUERIES * 5)
        name = f"linear_sum_assignment_{shapes}_shapes"
        row = rows[name] = {
            "name": name, "route": "cuda", "source": "multishiftseg_torch/csrc/assignment.cu",
            "replaces": "multishiftseg_tpu/losses/matcher.py:28",
            "counter": "linear_sum_assignment", "paths": paths,
            "max_abs_err": 0.0 if same else float("nan"),
            "plain_ms": median_ms(torch, lambda: matcher.linear_sum_assignment_plain(cost), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        time_redesigned(torch, row, run)
        row["max_steps"] = max(steps)
        row["device_ns_per_step"] = row["device_ms"] * 1e6 / max(steps)
        del cost

    g = np.random.RandomState(SEED + 81)
    masks = torch.from_numpy(3 * g.randn(1, QUERIES, H // 4, W // 4).astype(np.float32)).to(dev)
    cls = torch.from_numpy(g.randn(1, QUERIES, CLASSES + 1).astype(np.float32)).to(dev)
    run = lambda: scores.semantic_inference_upsampled(cls, masks, (H, W), CLASSES,
                                                      _classes_only=True)
    plain = lambda: scores.semantic_inference_upsampled_plain(cls, masks, (H, W), CLASSES,
                                                              _classes_only=True)
    with torch.no_grad():
        out = run()
        err = check("mask_scores_semantic_classes_eval_shapes", out, plain(), 1e-5, 1e-5)
        ops = H * W * QUERIES * (11 + 2 * CLASSES)
        b_ms, b_by = bound(nbytes(masks) + QUERIES * CLASSES * 4 + nbytes(out), ops)
        rows["mask_scores_semantic_classes_eval_shapes"] = {
            "name": "mask_scores_semantic_classes_eval_shapes", "route": "cuda",
            "source": "multishiftseg_torch/csrc/mask_scores.cu",
            "replaces": "multishiftseg_tpu/ops/scores.py:25",
            "counter": "mask_scores_semantic_classes", "paths": ("instance_eval",),
            "max_abs_err": err, "plain_ms": median_ms(torch, plain, 3), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}
        time_redesigned(torch, rows["mask_scores_semantic_classes_eval_shapes"], run)
    del masks, cls, out


def ood_hist_rows(torch, dev, rows, checks):
    """The binned metrics' kernel (``csrc/ood_hist.cu``) through its three
    entries at 720x1280 (the rows' times) and 1024x2048, with void pixels: the
    masked range, the 8192-bin label-split histogram over a given range, and
    both in one launch (the validation meter's), each equal to its plain
    version bit for bit; then ``BinnedOODMeter.update`` on a 720x1280 crop of
    a 768x1280 map with numpy labels, as validation calls it: wall ms, device
    kernels and host syncs a map."""
    from multishiftseg_torch.evals import ood_metrics as om

    rs = np.random.RandomState(SEED + 31)
    entries = ("minmax", "hist", "range_hist")
    times = {}
    for hw in VAL_HW:
        n = hw[0] * hw[1]
        # scores shaped like an anomaly map: most low, the OOD ones higher
        lab = torch.from_numpy(rs.choice([0, 1, 255], size=n, p=[0.75, 0.1, 0.15]).astype(
            np.int32)).to(dev)
        s = torch.from_numpy(rs.beta(2, 5, n).astype(np.float32)).to(dev) + 0.3 * (lab == 1)
        lo, hi = om.masked_min_max(s, lab)
        lo_p, hi_p = om.masked_min_max_plain(s, lab)
        got = om.label_histograms(s, lab, lo, hi, NUM_BINS)
        want = om.label_histograms_plain(s, lab, lo_p, hi_p, NUM_BINS)
        torch.cuda.synchronize()
        same_range = float(lo) == float(lo_p) and float(hi) == float(hi_p)
        same_hist = all(bool(torch.equal(a, c)) for a, c in zip(got, want))
        one = om.range_histograms(s, lab, NUM_BINS)
        torch.cuda.synchronize()
        one_equal = (float(one[0]) == float(lo_p) and float(one[1]) == float(hi_p)
                     and all(bool(torch.equal(a, c)) for a, c in zip(one[2:], want)))
        check = {"check": f"ood_hist_{hw[0]}x{hw[1]}", "range_equal": same_range,
                 "histograms_equal": same_hist, "one_launch_equal": one_equal, "pixels": n,
                 "counted": int(got[0].sum() + got[1].sum()),
                 "ok": same_range and same_hist and one_equal}
        checks.append(check)

        def library():
            # the same bin arithmetic (elementwise passes), then one bincount
            valid = (lab == 0) | (lab == 1)
            x = ((s - lo) / torch.clamp(hi - lo, min=1e-12) * NUM_BINS).clamp(0, NUM_BINS)
            bins = x.to(torch.int32).clamp(max=NUM_BINS - 1).long() + NUM_BINS * (lab == 0)
            return torch.bincount(torch.where(valid, bins, 2 * NUM_BINS), minlength=2 * NUM_BINS + 1)

        runs = {"minmax": (lambda: om.masked_min_max(s, lab),
                           lambda: om.masked_min_max_plain(s, lab)),
                "hist": (lambda: om.label_histograms(s, lab, lo, hi, NUM_BINS),
                         lambda: om.label_histograms_plain(s, lab, lo, hi, NUM_BINS)),
                "range_hist": (lambda: om.range_histograms(s, lab, NUM_BINS),
                               lambda: om.range_histograms_plain(s, lab, NUM_BINS))}
        t = times[hw] = {"valid": int(((lab == 0) | (lab == 1)).sum()), "bytes": nbytes(s, lab),
                         "library_ms": median_ms(torch, library, 20)}
        for e in entries:
            run, plain = runs[e]
            t[e] = {"plain_ms": median_ms(torch, plain, 20), "device_kernels":
                    device_kernels(torch, run)}
            time_redesigned(torch, t[e], run)
        check.update({f"{e}_{k}": v for e in entries for k, v in t[e].items()})
        check["library_ms"] = t["library_ms"]
        # what back-to-back timing reads for a one-element kernel: the floor
        # of any one-kernel row's device_ms
        one = torch.zeros(1, device=dev)
        check["one_kernel_floor_ms"] = spread_ms(torch, lambda: one.add_(1), back_to_back=True)[0]
    t = times[VAL_HW[0]]
    # bytes: each score and label read once, the results written once;
    # operations: a compare and a min and max per valid pixel, six for a bin
    bounds = {"minmax": bound(t["bytes"] + 8, 3 * t["valid"]),
              "hist": bound(t["bytes"] + 2 * NUM_BINS * 4, 6 * t["valid"]),
              "range_hist": bound(t["bytes"] + 8 + 2 * NUM_BINS * 4, 9 * t["valid"])}
    names = {"minmax": "ood_hist_minmax", "hist": "ood_hist", "range_hist": "ood_range_hist"}
    lines = {"minmax": "197", "hist": "186", "range_hist": "235"}
    for e in entries:
        rows[names[e]] = {
            "name": names[e], "route": "cuda",
            "source": "multishiftseg_torch/csrc/ood_hist.cu",
            "replaces": f"multishiftseg_tpu/evals/ood_metrics.py:{lines[e]}", "max_abs_err": 0.0,
            "plain_ms": t[e]["plain_ms"], "bound_ms": bounds[e][0], "bound_by": bounds[e][1],
            # no single PyTorch call takes the min and max over a label mask;
            # for the histogram: torch.bincount over bin + 8192 x label, after
            # the same elementwise bin arithmetic (timed with it)
            "library_ms": t["library_ms"] if e == "hist" else None,
            **{k: t[e][k] for k in ("ms", "ms_spread", "device_ms", "device_ms_spread",
                                    "host_ms", "device_kernels")}}
    # the validation meter runs the one-launch entry alone; the other two
    # are binned_ood_metrics' and callers' entries, off the main paths
    rows["ood_hist_minmax"]["paths"] = rows["ood_hist"]["paths"] = ()
    check = {"check": "binned_meter_update_720x1280_crop"}
    check.update(meter_update_stats(torch, dev, om))
    # one kernel and one host sync a map; three runtime calls: the label
    # upload, the kernel, the copy of its buffer back
    check["ok"] = (check["kernels_an_update"] == 1 and check["host_syncs_an_update"] == 1
                   and check["launch_calls_an_update"] == 3)
    checks.append(check)


# the runtime calls by which a read of a tensor waits for the device (not the
# cudaDeviceSynchronize of torch.cuda.synchronize and of the profiler's stop)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize")


def host_syncs(prof):
    """The runtime calls in a profile by which the host waited for a stream."""
    return sum(1 for e in prof.events() if e.name.startswith(SYNC_CALLS))


def meter_update_stats(torch, dev, om, calls=10, reps=25):
    """``BinnedOODMeter.update`` on a 720x1280 crop of a 768x1280 map with
    numpy labels, as validation calls it: the median wall ms of ``reps``
    updates (each ends in its copy to the host; also with the labels already
    on the card), and the device launches, kernels and host syncs an update
    from a profile of ``calls``."""
    from torch.profiler import ProfilerActivity, profile

    rs = np.random.RandomState(SEED + 32)
    full = torch.from_numpy(rs.beta(2, 5, (768, 1280)).astype(np.float32)).to(dev)
    lab = rs.choice([0, 1, 255], size=VAL_HW[0], p=[0.75, 0.1, 0.15]).astype(np.int32)
    meter = om.BinnedOODMeter(NUM_BINS)
    crop = full[:VAL_HW[0][0], :VAL_HW[0][1]]

    def wall(labels):
        meter.update(crop, labels)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            meter.update(crop, labels)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), [min(times), max(times)]

    out = {}
    out["update_wall_ms"], out["update_wall_ms_range"] = wall(lab)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            meter.update(crop, lab)
        torch.cuda.synchronize()
    out["launch_calls_an_update"] = launch_calls(prof) / calls
    out["kernels_an_update"] = sum(1 for e in prof.events()
                                   if e.name.startswith(LAUNCH_CALLS[:2])) / calls
    out["host_syncs_an_update"] = host_syncs(prof) / calls
    out["update_wall_ms_labels_on_card"] = wall(torch.from_numpy(lab).to(dev))[0]
    return out


def seeded_deeplab(torch, seed):
    """Port DeepWV3Plus (WRN-38, full widths) with seeded weights: the modules'
    own init from ``seed``, and numpy-seeded running statistics (mean 0.1 x
    noise, variance 1 + 0.1 x |noise|), so that no eval BatchNorm is the identity."""
    from multishiftseg_torch.models.deeplab import DeepWV3Plus

    torch.manual_seed(seed)
    model = DeepWV3Plus()
    g = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in sorted(model.named_buffers()):
            noise = torch.from_numpy((0.1 * g.randn(*t.shape)).astype(np.float32))
            t.add_(noise.abs() if name.endswith("running_var") else noise)
    return model.eval()


def seeded_model(torch, seed, **cfg):
    """Port MaskFormer with seeded weights: the modules' own init, then numpy
    noise on every entry (0.01; 0.1 on the deformable offset/weight heads, which
    init to zero)."""
    from multishiftseg_torch.models.maskformer import MaskFormer

    torch.manual_seed(seed)
    return seeded(torch, MaskFormer(**cfg), seed)


def seeded(torch, model, seed):
    """``model`` with numpy noise from ``seed`` on every state entry, as
    :func:`seeded_model`; in eval mode."""
    g = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in sorted(model.state_dict().items()):
            scale = 0.1 if ("sampling_offsets" in name or "attention_weights" in name) \
                and name.endswith("weight") else 0.01
            t.add_(torch.from_numpy((scale * g.randn(*t.shape)).astype(np.float32)))
    return model.eval()


def attention_mask_hooks(predictor, masks, replay=None):
    """Forward pre-hooks on the decoder's cross-attention layers: each appends
    the attention masks its layer receives to ``masks`` (on the CPU): (fg, bg)
    for the GMA decoder's layers, (fg,) for the vanilla decoder's, which take
    one mask. Given ``replay``, another run's ``masks``, the layer then attends
    with that run's masks instead of its own. Returns the hook handles."""
    from multishiftseg_torch.models.transformer_decoder import GlobalCrossAttentionLayer

    def hook(module, args, i):
        n = 2 if isinstance(module, GlobalCrossAttentionLayer) else 1
        masks.append(tuple(m.cpu() for m in args[2:2 + n]))
        if replay is None:
            return None
        mine = tuple(m.to(args[2].device) for m in replay[i])
        return (*args[:2], *mine, *args[2 + n:])

    return [layer.register_forward_pre_hook(lambda m, a, i=i: hook(m, a, i))
            for i, layer in enumerate(predictor.transformer_cross_attention_layers)]


def mask_logit_layers(torch, card, cpu, sizes):
    """The decoder's attention masks and the logits behind them, layer by layer,
    card against CPU.

    The decoder thresholds mask logits at 0 as hard booleans (GMA: fg and bg;
    vanilla: fg alone), so a logit within rounding of 0 may fall on the other
    side on the card. The CPU run attends
    with the card's masks (:func:`attention_mask_hooks`), so every layer stays
    comparable; this holds each bit that differs to a logit within rounding
    of 0. ``card`` and ``cpu`` hold the ``embeds`` of every mask prediction
    ([N, Q, C] f32 on the CPU), the ``mask_features`` [N, C, H, W] they multiply
    and the ``masks`` each run computed; layer i's logits are resized to
    ``sizes[i % 3]``, as the decoder does. Per layer: the bits that differ, the
    largest CPU |logit| at one, the largest logit difference, and that difference
    over the absolute scale sum_c |embed_c| |feature_c|. The layer is within
    rounding when the difference, and the CPU |logit| at each differing bit, are
    at most LOGIT_RTOL of that scale.
    """
    from multishiftseg_torch.ops.resize import resize_bilinear_nchw

    def logits(e, m, size):
        return resize_bilinear_nchw(torch.einsum("nqc,nchw->nqhw", e, m), size)

    layers = []
    for i, (g_masks, c_masks) in enumerate(zip(card["masks"], cpu["masks"])):
        size = sizes[i % 3]
        lg = logits(card["embeds"][i], card["mask_features"], size)
        lc = logits(cpu["embeds"][i], cpu["mask_features"], size)
        scale = logits(cpu["embeds"][i].abs(), cpu["mask_features"].abs(), size)
        tol = LOGIT_RTOL * scale
        err = (lg - lc).abs()
        flip = torch.stack([g != c for g, c in zip(g_masks, c_masks)]).any(0)[:, 0].reshape(
            lc.shape)
        layers.append({"flips": int(flip.sum()),
                       "max_abs_logit_at_flip": float(lc[flip].abs().max()) if flip.any() else None,
                       "max_logit_diff": float(err.max()),
                       "max_diff_over_scale": float((err / scale.clamp_min(1e-30)).max()),
                       "within_rounding": bool((err <= tol).all()
                                               and (lc[flip].abs() <= tol[flip]).all())})
    return layers


def maskformer_parity(torch, model, images):
    """``model`` (f32, on the CPU) on the card and on the CPU in f32 with TF32
    off, the CPU attending with the card's attention masks where the decoder
    masks its attention: the pixel decoder's outputs (backbone, deformable
    encoder and FPN: conv algorithms and sums in another order, within 1e-3 of
    scale), the masks' deciding logits (:func:`mask_logit_layers`), every
    prediction within 1e-3 of scale, and for the GMA decoder the eval tail:
    the card's score kernels on the CPU run's predictions within 1e-5 of the
    CPU's tail, and each side's own within 1e-3."""
    from multishiftseg_torch.models.maskformer import inference, preprocess

    gpu_model = copy.deepcopy(model).cuda()
    hw = images.shape[1:3]
    masked = hasattr(model.sem_seg_head.predictor, "transformer_cross_attention_layers")

    def run(m, dev, replay=None):
        rec = {"embeds": [], "masks": []}
        pred = m.sem_seg_head.predictor

        def pd_hook(mod, i, o):
            rec["mask_features"] = o[0].float().cpu()
            rec["ms"] = [t.float().cpu() for t in o[2]]

        hooks = [pred.mask_embed.register_forward_hook(
                     lambda mod, i, o: rec["embeds"].append(o.float().cpu())),
                 m.sem_seg_head.pixel_decoder.register_forward_hook(pd_hook)]
        if masked:
            hooks += attention_mask_hooks(pred, rec["masks"], replay)
        with torch.no_grad():
            out = m(preprocess(torch.from_numpy(images).to(dev)))
            if "pred_logits_ood" in out:
                rec["sem"], rec["anomaly"] = (t.float().cpu() for t in inference(out, hw))
        for h in hooks:
            h.remove()
        rec["out"] = {k: v.float().cpu() for k, v in out.items() if k != "aux_outputs"}
        rec["aux"] = [{k: v.float().cpu() for k, v in a.items()} for a in out["aux_outputs"]]
        return rec

    g = run(gpu_model, "cuda")
    c = run(model, "cpu", replay=g["masks"] if masked else None)
    del gpu_model
    torch.cuda.empty_cache()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))

    res = {"pixel_decoder_rel_err": max([rel(g["mask_features"], c["mask_features"])]
                                        + [rel(a, b) for a, b in zip(g["ms"], c["ms"])]),
           "pred_rel_err": max(rel(g["out"][k], c["out"][k]) for k in c["out"]),
           "aux_rel_err": max([rel(a[k], b[k]) for a, b in zip(g["aux"], c["aux"]) for k in b]
                              or [0.0])}
    checks = {"pixel_decoder_rel_err<=1e-3": res["pixel_decoder_rel_err"] <= 1e-3,
              "predictions_rel_err<=1e-3": max(res["pred_rel_err"], res["aux_rel_err"]) <= 1e-3}
    if masked:
        # a bit may differ only at a logit within rounding of 0, and the CPU
        # then attends with the card's bit
        layers = mask_logit_layers(torch, g, c, [tuple(t.shape[-2:]) for t in c["ms"]])
        res["attention_masks"] = layers
        res["max_diff_over_scale"] = max(x["max_diff_over_scale"] for x in layers)
        checks["mask_logits_within_rounding"] = all(x["within_rounding"] for x in layers)
    if "anomaly" in c:
        with torch.no_grad():
            sem_k, an_k = inference({k: v.cuda() for k, v in c["out"].items()}, hw)
        res["tail_max_abs_err"] = max(float((sem_k.cpu() - c["sem"]).abs().max()),
                                      float((an_k.cpu() - c["anomaly"]).abs().max()))
        res["anomaly_max_abs_err"] = float((g["anomaly"] - c["anomaly"]).abs().max())
        res["sem_max_abs_err"] = float((g["sem"] - c["sem"]).abs().max())
        checks["tail_max_abs_err<=1e-5"] = res["tail_max_abs_err"] <= 1e-5
        checks["tail<=1e-3"] = max(res["anomaly_max_abs_err"], res["sem_max_abs_err"]) <= 1e-3
    res["checks"] = checks
    res["ok"] = bool(all(checks.values()))
    return res


def phase_slice_parity(torch, hw=(256, 512)):
    """Full-width MaskFormer (R-50, GMA) in f32: card with kernels vs CPU with
    plain versions (:func:`maskformer_parity`)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images = np.random.RandomState(SEED + 4).randint(0, 256, (1, *hw, 3)).astype(np.uint8)
    res = {"phase": "slice_parity", "image_hw": list(hw), "widths": "full",
           "dtype": "float32", "tf32": False}
    res.update(maskformer_parity(torch, seeded_model(torch, SEED + 3), images))
    return res


def profile_request(torch, fwd, image, focus=None, ranges=()):
    """``fwd(image)`` (a request, or a training step) once under torch.profiler:
    device time by kernel name (top 12), the device's busy share of the wall
    time, the device events and the launch calls (see ``launch_calls``) and,
    with ``focus`` (a string or several), the device time of the kernels whose
    name holds each string and its share of the busy time; for each name in
    ``ranges`` (``record_function`` ranges, e.g. :func:`module_ranges`), the
    ranges, the device time of the kernels launched inside them (the gaps
    between those kernels not counted) and its share of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd(image)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        # device kernels only: record_function ranges (the optimizer's step,
        # for one) also appear on the device timeline, spanning kernels and gaps
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (end - start) / 1e3, n + 1)
    busy, last = 0.0, None
    for start, end in sorted(spans):  # union of device intervals, us
        if last is None or start > last:
            busy += end - start
            last = end
        elif end > last:
            busy += end - last
            last = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    res = {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
           "device_busy_share": busy / 1e3 / wall_ms if wall_ms else None,
           "device_events": len(spans), "launch_calls": launch_calls(prof),
           "device_kernel_ms_total": sum(v[0] for v in by_name.values()),
           "top_kernels": [{"name": k[:90], "ms": v[0], "count": v[1]} for k, v in top]}
    for name in (focus,) if isinstance(focus, str) else focus or ():
        ms = sum(v[0] for k, v in by_name.items() if name in k)
        res[f"{name}_ms"] = ms
        res[f"{name}_share_of_busy"] = ms * 1e3 / busy if busy else None
    for name in ranges:
        # the host-side range: its kernels are those its ops (and their
        # children) launched; the device-side copy of the range spans gaps
        spans = [e for e in prof.events() if e.name == name and e.device_type == DeviceType.CPU]
        ms = sum(e.device_time_total for e in spans) / 1e3
        res[f"{name}_ranges"] = len(spans)
        res[f"{name}_device_ms"] = ms
        res[f"{name}_share_of_busy"] = ms * 1e3 / busy if busy else None
    return res


@contextlib.contextmanager
def module_ranges(model, cls, name):
    """Every forward of ``model``'s ``cls`` modules inside a profiler range
    ``name`` (forward hooks, removed on exit)."""
    from torch.profiler import record_function

    open_ranges = []

    def enter(module, args):
        r = record_function(name)
        r.__enter__()
        open_ranges.append(r)

    def leave(module, args, out):
        open_ranges.pop().__exit__(None, None, None)

    handles = [h for m in model.modules() if isinstance(m, cls)
               for h in (m.register_forward_pre_hook(enter), m.register_forward_hook(leave))]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


# device time by kernel name: in the M2F request's profile the forward score
# tails and every deformable-attention kernel (the setting's forward, the int8
# quantize); in the M2F steps' the score tails, the deformable forward, the
# deformable backward (stage 2) and the anomaly tail's d-probs backward (stage 1)
FWD_FOCUS = ("mask_scores_fwd_kernel", "msda")
STEP_FOCUS = ("msda_backward_kernel", "mask_scores_bwd_dp_kernel", "mask_scores_fwd_kernel",
              "msda_fwd_kernel")


# the serve phase's settings: (sample_mode, score_lowres, score_topq), and the
# deformable launches each request makes (6 encoder layers; the hybrid 3 + 3)
HYBRID = "bilinear,bilinear,bilinear,nearest_top6c,nearest_top6c,nearest_top6c"
SERVE_SETTINGS = {
    "bilinear": (("bilinear", False, 0), {"ms_deform_attn_bilinear": 6}),
    "nearest": (("nearest", False, 0), {"ms_deform_attn_nearest": 6}),
    "int8": (("int8", False, 0), {"ms_deform_attn_quantize": 6, "ms_deform_attn_int8": 6}),
    "nearest_top6": (("nearest_top6", False, 0), {"ms_deform_attn_nearest_top": 6}),
    "nearest_top6c": (("nearest_top6c", False, 0), {"ms_deform_attn_nearest_topc": 6}),
    "shared": (("shared", False, 0), {"ms_deform_attn_shared": 6}),
    "hybrid": ((HYBRID, False, 0), {"ms_deform_attn_bilinear": 3,
                                    "ms_deform_attn_nearest_topc": 3}),
    "nearest+lowres": (("nearest", True, 0), {"ms_deform_attn_nearest": 6}),
    "nearest+topq32": (("nearest", False, 32), {"ms_deform_attn_nearest": 6}),
}


@contextlib.contextmanager
def tail_launch_shapes(scores):
    """Record (Q, h, w, H, W) of every anomaly-tail launch of ``scores``."""
    seen, orig = [], scores._mask_scores_cuda

    def recording(masks, probs, keep, out_hw, mode, *window):
        if mode == scores._ANOMALY:
            seen.append((*masks.shape[1:], *out_hw))
        return orig(masks, probs, keep, out_hw, mode, *window)

    scores._mask_scores_cuda = recording
    try:
        yield seen
    finally:
        scores._mask_scores_cuda = orig


SERVE_WARMUP = 2  # requests before the timed ones


def serve_requests(torch, fwd, images, warmup=SERVE_WARMUP):
    """``fwd`` (-> a tuple of outputs) over ``images`` after ``warmup`` of
    them: latencies (ms, each synchronised), the launch counts of the timed
    requests, their outputs' finiteness, the last one's shapes, peak memory.
    Returns (result, counts, the last request's outputs)."""
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts

    for im in images[:warmup]:
        fwd(im)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    latencies, finite = [], True
    for im in images:
        t0 = time.perf_counter()
        outs = fwd(im)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        finite &= all(bool(torch.isfinite(o).all()) for o in outs)
    counts = launch_counts()
    return {"latency_ms": latencies, "images_per_s": len(images) / (sum(latencies) / 1e3),
            "finite": finite, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": {k: v for k, v in counts.items() if v},
            "shapes": [list(o.shape) for o in outs]}, counts, outs


def phase_serve(torch, requests=3):
    """``build_m2f_request_forward`` in every setting of ``SERVE_SETTINGS``:
    launch counts per request (the setting's deformable entries, one anomaly
    and one semantic tail, nothing else; the anomaly tail at the identity
    resize for ``score_lowres`` and on 32 queries for ``score_topq``), finite
    outputs of the input's shape, latency, and one profiled request."""
    from multishiftseg_torch.evals.ood_metrics import eval_ood_measure
    from multishiftseg_torch.ops import scores
    from multishiftseg_torch.train.test_runner import build_m2f_request_forward

    model = seeded_model(torch, SEED + 5).to(torch.bfloat16)
    h, w = H, W
    g = np.random.RandomState(SEED + 6)
    images = [g.randint(0, 256, (1, h, w, 3)).astype(np.uint8) for _ in range(requests)]
    label = np.zeros((h, w), np.int64)
    side = h // 4
    y0, x0 = g.randint(0, h - side), g.randint(0, w - side)
    label[y0:y0 + side, x0:x0 + side] = 1  # a seeded anomaly square
    res = {"phase": "serve", "model": "MaskFormer R-50 MSDeformAttn+GMA, full widths",
           "dtype": "bfloat16", "image_hw": [h, w], "batch": 1, "modes": {}}
    totals = {}
    ok = True
    n_queries = model.sem_seg_head.predictor.num_queries
    for name, ((mode, lowres, topq), deform) in SERVE_SETTINGS.items():
        fwd = build_m2f_request_forward(model, sample_mode=mode,
                                        score_lowres=lowres, score_topq=topq)
        with tail_launch_shapes(scores) as tails:
            r, counts, (anomaly, sem) = serve_requests(torch, fwd, images)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        shapes_ok = (tuple(anomaly.shape) == (1, h, w)
                     and tuple(sem.shape) == (1, CLASSES + n_queries, h, w))
        want = {k: 0 for k in counts}
        want.update({k: v * requests for k, v in deform.items()})
        want.update(mask_scores_anomaly=requests, mask_scores_semantic=requests)
        # the anomaly tail (warm-up requests included): on Q queries
        # (score_topq's), from the stride-4 masks of the /32-padded input, to
        # the padded input or (score_lowres) to the masks' own size
        mask_hw = (-(-h // 32) * 8, -(-w // 32) * 8)
        out_hw = mask_hw if lowres else (-(-h // 32) * 32, -(-w // 32) * 32)
        tails_ok = len(tails) == SERVE_WARMUP + requests and all(
            t == (topq or n_queries, *mask_hw, *out_hw) for t in tails)
        counts_ok = counts == want and tails_ok
        metrics = eval_ood_measure(anomaly[0].float().cpu().numpy(), label)
        mode_ok = r["finite"] and shapes_ok and counts_ok and metrics is not None
        ok &= mode_ok
        res["modes"][name] = {
            "sample_mode": mode, "score_lowres": lowres, "score_topq": topq, **r,
            "launches_per_image_ok": counts_ok,
            "anomaly_tail_launches_q_h_w_H_W": [list(t) for t in tails[:1]],
            "shapes_ok": shapes_ok, "auroc_auprc_fpr95_random_weights": metrics, "ok": mode_ok,
            "profiled_request": profile_request(torch, fwd, images[0], focus=FWD_FOCUS)}
    res["ok"] = ok
    return res, totals


def train_config(pairs, crop, bf16):
    from multishiftseg_torch.core.config import load_config

    cfg = load_config(str(Path(__file__).resolve().parent / "exps" / "m2f.yaml"))
    cfg.train.train_batch = pairs
    cfg.data.crop_size = tuple(crop)
    cfg.train.bf16 = bf16
    return cfg


def tree_to(tree, dev):
    """A nest of dicts and lists of tensors, moved to ``dev``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return None if tree is None else tree.to(dev)


def recorded_step(torch, tr, step, card=None):
    """``step()``, one training step of the M2F trainer ``tr`` that returns
    (loss, components, gradient norm, assignments), with recorders: the mask
    embeds, the pixel decoder's outputs, the attention masks (the layers
    attend with those of ``card``, the card run's record, when given) and the
    launch counts. Returns the record, with the losses, the gradient norm,
    the assignments and every parameter's gradient and value (f32, CPU)."""
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts

    rec = {"embeds": [], "masks": []}

    def record_pixel_decoder(m, i, o):
        rec["mask_features"] = o[0].detach().float().cpu()
        rec["ms"] = [t.detach().float().cpu() for t in o[2]]

    head = tr.model.sem_seg_head
    hooks = [head.predictor.mask_embed.register_forward_hook(
                 lambda m, i, o: rec["embeds"].append(o.detach().float().cpu())),
             head.pixel_decoder.register_forward_hook(record_pixel_decoder)]
    hooks += attention_mask_hooks(head.predictor, rec["masks"],
                                  card["masks"] if card is not None else None)
    reset_launch_counts()
    try:
        loss, losses, gnorm, assign = step()
        if tr.device.type == "cuda":
            torch.cuda.synchronize()
        rec["launches"] = launch_counts()
    finally:
        for h in hooks:
            h.remove()
    rec.update(loss=float(loss), losses={k: float(v) for k, v in losses.items()},
               gnorm=float(gnorm), assign=[a.cpu() for a in assign],
               grads={n: p.grad.detach().float().cpu() for n, p in tr.model.named_parameters()},
               params={n: p.detach().float().cpu() for n, p in tr.model.named_parameters()})
    return rec


def compare_steps(torch, runs, optimizer, m2f, res):
    """What both M2F step parities hold: ``runs`` are the records
    (:func:`recorded_step`) of the card's f32 step, the CPU's and the CPU's
    float64 step from the same weights, batch and draws, and optionally
    (``cpu_f64_card_branches``) a float64 step on the card's ReLU branches,
    which the card's gradients are then held against; ``optimizer`` gives
    the parameter groups; ``m2f`` the config's learning rate and clip. Adds
    the readings to ``res`` and returns the checks."""
    g, c, f = runs["card"], runs["cpu"], runs["cpu_f64"]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))

    # the pixel decoder's outputs, in the training forward: f32 on both sides,
    # conv algorithms and sums in another order (as slice_parity)
    res["pixel_decoder_rel_err"] = max([rel(g["mask_features"], c["mask_features"])]
                                       + [rel(a, b) for a, b in zip(g["ms"], c["ms"])])
    layers = mask_logit_layers(torch, g, c, [tuple(t.shape[-2:]) for t in c["ms"]])
    res["attention_masks"] = layers
    res["loss_rel_err"] = {k: abs(g["losses"][k] - v) / max(abs(v), 1e-12)
                           for k, v in c["losses"].items()}

    # per parameter group (backbone / rest, decay or not), the worst tensor by
    # the largest error of its gradient over its largest entry
    def grad_errs(a, b):
        out = {}
        for grp in optimizer.param_groups:
            key = f"lr_x{grp['lr_mult']:g}_{'decay' if grp['decay'] else 'no_decay'}"
            errs = {n: float((a["grads"][n] - b["grads"][n]).abs().max())
                    / max(float(b["grads"][n].abs().max()), 1e-30) for n in grp["names"]}
            worst = max(errs, key=errs.get)
            out[key] = {"err": errs[worst], "tensor": worst}
        return out

    res["grad_rel_err_by_group"] = grad_errs(g, c)
    vs_f64 = {"card": grad_errs(g, f), "cpu": grad_errs(c, f)}
    res["grad_rel_err_vs_f64_by_group"] = vs_f64
    twin = runs.get("cpu_f64_card_branches")
    if twin is not None:
        vs_twin = grad_errs(g, twin)
        res["grad_rel_err_vs_f64_on_card_branches_by_group"] = vs_twin
    # the card's gradients reach every module upstream of the deformable core
    upstream = ("value_proj", "sampling_offsets", "attention_weights", "input_proj", "backbone")
    res["upstream_grads_nonzero"] = {
        t: all(float(v.abs().max()) > 0 for n, v in g["grads"].items() if t in n)
        for t in upstream}
    # the first AdamW step is about lr * sign(g): compare where the clipped
    # gradient is far above eps and clear of sign noise
    lr = m2f.base_lr
    clip = min(1.0, m2f.clip_gradients_value / c["gnorm"])
    upd = 0.0
    for n, gc in c["grads"].items():
        sel = ((gc * clip).abs() > 1e-6) & (gc.abs() > 1e-2 * gc.abs().max())
        if sel.any():
            upd = max(upd, float((g["params"][n][sel] - c["params"][n][sel]).abs().max()))
    res["param_update_max_abs_err"] = upd
    res["param_update_atol"] = 1e-2 * lr
    # the same arithmetic on both sides; losses: f32 sums in another order.
    # Gradients: a ReLU input within f32 rounding of 0 takes either side and
    # moves the whole gradient path below it, on the card as on the CPU (up to
    # 1.3e-2 of a backbone tensor's scale between them; readings in PERF.md).
    # So each f32 step is held against the float64 step: in every group the
    # card's error may be at most 4x the CPU's, plus 1e-3 of scale; or, given
    # a float64 twin on the card's ReLU branches, the card's error against it
    # at most 1e-3 of scale (as deeplab_train_parity's stage 1)
    if twin is None:
        grad_check = ("grad_err_vs_f64<=4x_cpu+1e-3", all(
            v["err"] <= 4 * vs_f64["cpu"][k]["err"] + 1e-3 for k, v in vs_f64["card"].items()))
    else:
        grad_check = ("grad_err_vs_f64_on_card_branches<=1e-3",
                      all(v["err"] <= 1e-3 for v in vs_twin.values()))
    return {
        "pixel_decoder_rel_err<=1e-3": res["pixel_decoder_rel_err"] <= 1e-3,
        "mask_logits_within_rounding": all(x["within_rounding"] for x in layers),
        "loss_rel_err<=1e-3": max(res["loss_rel_err"].values()) <= 1e-3,
        grad_check[0]: grad_check[1],
        "param_update_err<=1e-2*lr": upd <= 1e-2 * lr,
        "finite": all(np.isfinite(v) for v in list(g["losses"].values()) + [g["gnorm"]]),
        "upstream_grads_nonzero": all(res["upstream_grads_nonzero"].values())}


def phase_train_parity(torch, seed, pairs=2, crop=(256, 256), card="cuda"):
    """One stage-2 step at full widths in f32 (TF32 off): the card with kernels
    against the CPU with plain versions, same weights, batch and CPU-made draws,
    all made from ``seed``; and the CPU's step in float64, which the gradients
    of both f32 steps are held against. (``card="cpu"`` rehearses the phase's
    control flow without a card.)"""
    from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD, synthetic_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_config(pairs, crop, bf16=False)
    base = seeded_model(torch, seed)
    batch = synthetic_batch(pairs, crop, CLASSES, seed + 1)
    trainers = {"card": TrainM2FOOD(cfg, model=copy.deepcopy(base), device=card),
                "cpu": TrainM2FOOD(cfg, model=copy.deepcopy(base), device="cpu"),
                "cpu_f64": TrainM2FOOD(cfg, model=copy.deepcopy(base), device="cpu")}
    for tr in trainers.values():
        tr.set_stage(1)
    trainers["cpu_f64"].model.double()  # in place: the optimizer keeps the same parameters
    draws = trainers["cpu"].draws(2 * pairs, tuple(crop))  # CPU-made, used by both
    runs = {}
    for side, tr in trainers.items():
        # the card runs first; the CPU steps then attend with the card's masks
        runs[side] = recorded_step(
            torch, tr, lambda tr=tr: tr.stage2_step(*batch, draws=tree_to(draws, tr.device)),
            runs.get("card"))
    g, c = runs["card"], runs["cpu"]
    res = {"phase": "train_parity", "seed": seed, "pairs": pairs, "crop": list(crop),
           "widths": "full", "dtype": "float32", "tf32": False, "launches": g["launches"],
           "losses_card": g["losses"], "losses_cpu": c["losses"],
           "grad_norm_card": g["gnorm"], "grad_norm_cpu": c["gnorm"]}
    checks = compare_steps(torch, runs, trainers["cpu"].optimizer, cfg.model.m2f, res)
    res["assignment_equal"] = all(torch.equal(a, b) for a, b in zip(g["assign"], c["assign"]))
    counts = g["launches"]
    res["checks"] = {
        **checks, "assignment_equal": res["assignment_equal"],
        "launches_ok": (counts["ms_deform_attn_bilinear"] == 6
                        and counts["ms_deform_attn_bilinear_backward"] == 6
                        and counts["linear_sum_assignment"] >= 1 and counts["label_points"] >= 4)}
    res["ok"] = bool(all(res["checks"].values()))
    return res


def timed_steps(torch, step, warmup=1, timed=2):
    """``step()`` (-> loss, components, gradient norm, assignments) ``warmup``
    times, then ``timed`` times, each synchronised: step ms, each timed step's
    loss, gradient norm and components, whether all are finite, peak memory,
    the launches a step and one profiled step. Returns (result, the launch
    counts of the timed steps)."""
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, steps = [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        loss, losses, gnorm, _ = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        steps.append({"loss": float(loss), "grad_norm": float(gnorm),
                      "losses": {k: float(v) for k, v in losses.items()}})
    counts = launch_counts()
    finite = all(np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"])
                 and all(np.isfinite(v) for v in x["losses"].values()) for x in steps)
    return {"step_ms": times, "steps": steps, "finite": bool(finite),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches_per_step": {k: v / timed for k, v in counts.items() if v},
            "profiled_step": profile_request(torch, lambda _: step(), None,
                                             focus=STEP_FOCUS)}, counts


def phase_train(torch, pairs=TRAIN_PAIRS, warmup=2, timed=3):
    """The stage-2 step at exps/m2f.yaml's settings in bf16 on the card."""
    from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD, synthetic_batch

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"phase": "train", "model": "MaskFormer R-50 MSDeformAttn+GMA, full widths",
           "config": "exps/m2f.yaml", "dtype": "bfloat16 autocast, f32 master weights"}
    trainer = TrainM2FOOD(train_config(pairs, CROP, bf16=True),
                          model=seeded_model(torch, SEED + 12).train(), device="cuda")
    trainer.set_stage(1)
    batch = [torch.from_numpy(x).cuda() for x in synthetic_batch(pairs, CROP, CLASSES, SEED + 13)]
    r, counts = timed_steps(torch, lambda: trainer.stage2_step(*batch), warmup, timed)
    res.update(pairs=pairs, images_per_step=2 * pairs, crop=list(CROP), padded=list(TRAIN_HW),
               images_per_s=2 * pairs * timed / (sum(r["step_ms"]) / 1e3), launches=counts, **r)
    launches_ok = (counts["ms_deform_attn_bilinear"] == 6 * timed
                   and counts["ms_deform_attn_bilinear_backward"] == 6 * timed
                   and counts["linear_sum_assignment"] >= timed
                   and counts["label_points"] >= 4 * timed
                   and counts["ms_deform_attn_nearest"] == 0
                   and counts["mask_scores_anomaly"] + counts["mask_scores_semantic"]
                   + counts["mask_scores_semantic_classes"] == 0)
    res["checks"] = {"finite": r["finite"], "launches_ok": launches_ok}
    res["ok"] = bool(all(res["checks"].values()))
    return res, counts


def phase_deeplab_parity(torch, hw=(256, 512), card="cuda"):
    """Full-width WRN-38 DeepLab in f32 (TF32 off): the card (kernels) against
    the CPU (plain versions) from the same weights: trunk output, score, logits.
    (``card="cpu"`` rehearses the phase's control flow without a card.)"""
    from multishiftseg_torch.train.test_runner import build_deeplab_forward

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_model = seeded_deeplab(torch, SEED + 21)
    gpu_model = copy.deepcopy(cpu_model)
    image = np.random.RandomState(SEED + 22).randn(1, *hw, 3).astype(np.float32)
    res = {"phase": "deeplab_parity", "model": "DeepLab v3+ WRN-38, full widths",
           "image_hw": list(hw), "dtype": "float32", "tf32": False}
    runs = {}
    for side, model, dev in (("card", gpu_model, card), ("cpu", cpu_model, "cpu")):
        trunk = []
        last = list(model.mod7.children())[-1]  # the trunk's last block
        hook = last.register_forward_hook(lambda m, i, o, t=trunk: t.append(o.float().cpu()))
        score, logit = build_deeplab_forward(deeplab_config(1, hw, bf16=False), model=model,
                                             device=dev)(image)
        hook.remove()
        runs[side] = {"trunk": trunk[0], "score": score.cpu(), "logit": logit.cpu()}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))

    g, c = runs["card"], runs["cpu"]
    for k in ("trunk", "score", "logit"):
        res[f"{k}_rel_err"] = rel(g[k], c[k])
    res["score_abs_max"] = float(c["score"].abs().max())
    res["logit_abs_max"] = float(c["logit"].abs().max())
    # f32 on both sides; conv algorithms and sums in another order over 38
    # layers (the M2F slice's pixel decoder held 1e-3)
    res["checks"] = {f"{k}_rel_err<=1e-4": res[f"{k}_rel_err"] <= 1e-4
                     for k in ("trunk", "score", "logit")}
    res["checks"]["shapes"] = (tuple(g["score"].shape) == (1, *hw)
                               and tuple(g["logit"].shape) == (1, CLASSES, *hw))
    res["ok"] = bool(all(res["checks"].values()))
    return res


def phase_deeplab_serve(torch, requests=3):
    """``build_deeplab_forward`` at 1024x2048, batch 1, bf16 autocast over the
    f32 weights: 3 requests after 2 warm-up, with their launch counts."""
    from multishiftseg_torch.evals.ood_metrics import eval_ood_measure
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.train.test_runner import build_deeplab_forward

    torch.backends.cudnn.allow_tf32 = True
    fwd = build_deeplab_forward(deeplab_config(1, DL_CROP, bf16=True),
                                model=seeded_deeplab(torch, SEED + 23), device="cuda")
    g = np.random.RandomState(SEED + 24)
    images = [g.randn(1, H, W, 3).astype(np.float32) for _ in range(requests)]
    label = np.zeros((H, W), np.int64)
    label[H // 3:H // 2, W // 3:W // 2] = 1  # an anomaly rectangle
    for im in images[:2]:
        fwd(im)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    latencies, outs = [], []
    for im in images:
        t0 = time.perf_counter()
        score, logit = fwd(im)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        outs.append((score, logit))
    counts = launch_counts()
    score, logit = outs[-1]
    finite = all(bool(torch.isfinite(a).all() and torch.isfinite(b).all()) for a, b in outs)
    shapes_ok = tuple(score.shape) == (1, H, W) and tuple(logit.shape) == (1, CLASSES, H, W)
    counts_ok = (counts["dilated_conv3x3"] == 3 * requests
                 and all(v == 0 for k, v in counts.items() if k != "dilated_conv3x3"))
    metrics = eval_ood_measure(score[0].float().cpu().numpy(), label)
    res = {"phase": "deeplab_serve", "model": "DeepLab v3+ WRN-38, full widths",
           "dtype": "bfloat16 autocast, f32 weights", "image_hw": [H, W], "batch": 1,
           "latency_ms": latencies, "images_per_s": requests / (sum(latencies) / 1e3),
           "launches": counts, "launches_per_image_ok": counts_ok, "finite": finite,
           "shapes_ok": shapes_ok, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "auroc_auprc_fpr95_random_weights": metrics,
           "profiled_request": profile_request(torch, fwd, images[0], focus="dconv")}
    res["ok"] = bool(finite and shapes_ok and counts_ok and metrics is not None)
    return res, counts


def deeplab_config(pairs, crop, bf16):
    from multishiftseg_torch.core.config import load_config

    cfg = load_config(str(Path(__file__).resolve().parent / "exps" / "deeplab.yaml"))
    cfg.train.train_batch = pairs
    cfg.data.crop_size = tuple(crop)
    cfg.train.bf16 = bf16
    return cfg


def relu_sign_flips(a, b):
    """ReLU units whose input lies on other sides of 0 in two runs (records of
    ``relu_sign_hooks``): the frozen trunk's, which move values by rounding
    only, and the head's, on the gradient path, by module."""
    per = {n: int((a[n] != b[n]).sum()) for n in a}
    head = {n: v for n, v in per.items() if v and not n.startswith("mod")}
    return {"trunk": sum(v for n, v in per.items() if n.startswith("mod")),
            "head": sum(head.values()), "head_modules": head}


def selected_pixels(torch, logit, tgt_aug, params):
    """The augmented half's pixel selection as ``rel_contrastive_loss`` makes
    it (keys below and at the k-th smallest) from a step's logits [2B, C, H, W]."""
    from multishiftseg_torch.losses import rcl

    t = torch.as_tensor(tgt_aug).long()
    valid = t < params.in_id
    ce = rcl._pixel_ce(logit[logit.shape[0] // 2:].permute(0, 2, 3, 1),
                       torch.where(valid, t, torch.full_like(t, params.void_id)), valid)
    keys = torch.where(valid, ce, torch.full_like(ce, float("inf"))).reshape(-1)
    bits = keys.view(torch.int32).long() & 0xFFFFFFFF
    k = int((params.selection_ratio * valid.sum()).to(torch.int32))
    return bits <= torch.sort(bits).values[k - 1]


def phase_deeplab_train_parity(torch, seed, pairs=2, crop=(200, 200), card="cuda"):
    """One stage-0 and then one stage-1 step of ``TrainDeepLabOOD`` at full
    widths in f32 (TF32 off): the card (kernels) against the CPU (plain
    versions), same weights, batch and CPU-made draws; and the CPU's step in
    float64. Stage 0's gradient (``ood_head``) crosses no ReLU and is held
    against float64 directly. Stage 1's crosses the head's ReLUs, where an
    input within f32 rounding of 0 moves a whole gradient path: the phase
    counts those flips (and the pixel selection's) between the steps, and
    holds the card's gradients against a float64 step on the card's ReLU
    branches (``relu_sign_hooks``), each replayed unit's input within
    LOGIT_RTOL of its call's largest |input|. ``card="cpu"`` rehearses the
    control flow."""
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.train.deeplab_trainer import TrainDeepLabOOD, synthetic_batch
    from multishiftseg_torch.utils import relu_sign_hooks

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = deeplab_config(pairs, crop, bf16=False)
    base = seeded_deeplab(torch, seed)
    batch = synthetic_batch(pairs, crop, CLASSES, seed + 1)
    trainers = {"card": TrainDeepLabOOD(cfg, model=copy.deepcopy(base), device=card),
                "cpu": TrainDeepLabOOD(cfg, model=copy.deepcopy(base), device="cpu"),
                "cpu_f64": TrainDeepLabOOD(cfg, model=copy.deepcopy(base), device="cpu")}
    trainers["cpu_f64"].model.double()  # in place: the optimizer keeps the same parameters
    res = {"phase": "deeplab_train_parity", "seed": seed, "pairs": pairs, "crop": list(crop),
           "widths": "full", "dtype": "float32", "tf32": False, "stages": []}
    ok = True
    for stage in (0, 1):
        draws = trainers["cpu"].draws(2 * pairs, tuple(crop))  # CPU-made, used by all
        steps = list(trainers.items())
        if stage == 1:
            # the float64 step again from the same state, on the card's branches
            twin = TrainDeepLabOOD(cfg, model=copy.deepcopy(base), device="cpu")
            twin.model.double()
            twin.model.load_state_dict(trainers["cpu_f64"].model.state_dict())
            steps.append(("cpu_f64_card_branches", twin))
        runs, signs, replayed = {}, {}, {}
        for side, tr in steps:
            tr.set_stage(stage)
            dev = tr.device
            # copies: .double() of a float64 tensor is the tensor itself
            snap = lambda t: t.detach().to("cpu", torch.float64, copy=True)
            before = {n: snap(p) for n, p in tr.model.named_parameters()}
            signs[side], out = {}, {}
            hooks = relu_sign_hooks(tr.model, signs[side], replay=signs["card"] if (
                side == "cpu_f64_card_branches") else None, flips=replayed)
            hooks.append(tr.model.register_forward_hook(
                lambda m, a, o, out=out: out.update(logit=o[1].detach().float().cpu())))
            reset_launch_counts()
            loss, aux = tr.step(*batch, draws={"rcl_noise": draws["rcl_noise"].to(dev),
                                               "dropout": {k: v.to(dev) for k, v in
                                                           draws["dropout"].items()}})
            if dev.type == "cuda":
                torch.cuda.synchronize()
            for h in hooks:
                h.remove()
            runs[side] = {
                "launches": launch_counts(), "loss": float(loss),
                "aux": {k: float(v) for k, v in aux.items()},
                "grads": {n: snap(p.grad) for n, p in tr.model.named_parameters()
                          if p.grad is not None},
                "params": {n: snap(p) for n, p in tr.model.named_parameters()},
                "stats": {n: snap(b) for n, b in tr.model.named_buffers()},
                "selected": selected_pixels(torch, out["logit"], batch[3], tr.rcl_params)}
            runs[side]["delta"] = {n: runs[side]["params"][n] - before[n] for n in before}
        g, c, f = runs["card"], runs["cpu"], runs["cpu_f64"]
        ref = runs["cpu_f64_card_branches"] if stage == 1 else f

        def rel_errs(run, want):
            """Per trainable tensor, the error against ``want`` over its scale."""
            return {n: float((run["grads"][n] - w).abs().max()) / (float(w.abs().max()) + 1e-30)
                    for n, w in want["grads"].items()}

        vs_f64, vs_f64_cpu, vs_ref = rel_errs(g, f), rel_errs(c, f), rel_errs(g, ref)
        worst, worst_ref = max(vs_f64, key=vs_f64.get), max(vs_ref, key=vs_ref.get)
        stat_err = max(float((g["stats"][n] - v).abs().max() / v.abs().max().clamp_min(1e-12))
                       for n, v in c["stats"].items())
        # this step's update against the float64 step's on the same branches
        # (Adam's first step is about lr * sign(g)), where the gradient is far
        # above eps and clear of sign noise: an earlier step's sign noise, and
        # the card's and the CPU's other ReLU branches, stay out of it
        lr = cfg.train.lr if stage == 0 else cfg.train.lr_update
        upd = 0.0
        for name, gr in ref["grads"].items():
            # the gradient Adam sees, the L2 term added
            gr = gr + cfg.train.weight_decay * (ref["params"][name] - ref["delta"][name])
            sel = (gr.abs() > 1e-6) & (gr.abs() > 1e-2 * gr.abs().max())
            if sel.any():
                upd = max(upd, float((g["delta"][name][sel] - ref["delta"][name][sel]).abs().max()))
        upd_atol = 1e-2 * lr + 2.0 ** -21 * max(float(v.abs().max()) for v in c["params"].values())
        frozen_same = all(torch.equal(g["params"][n], c["params"][n]) and torch.equal(
            c["params"][n], base.state_dict()[n].double()) for n in c["params"] if n not in c["grads"])
        counts = g["launches"]
        pairs_ = (("card", "cpu_f64"), ("cpu", "cpu_f64"), ("card", "cpu"))
        st = {"stage": stage, "loss_card": g["loss"], "loss_cpu": c["loss"],
              "loss_f64": f["loss"], "aux_card": g["aux"], "aux_cpu": c["aux"],
              "trainable_tensors": len(vs_f64),
              "grad_err_vs_f64_worst": {"tensor": worst, "card": vs_f64[worst],
                                        "cpu": vs_f64_cpu[worst]},
              "relu_units": sum(int(m.numel()) for m in signs["card"].values()),
              "relu_sign_flips": {f"{a}_vs_{b}": relu_sign_flips(signs[a], signs[b])
                                  for a, b in pairs_},
              "selected_pixels": int(g["selected"].sum()),
              "selection_flips": {f"{a}_vs_{b}": int((runs[a]["selected"] != runs[b]["selected"]
                                                      ).sum()) for a, b in pairs_},
              "running_stat_rel_err": stat_err, "param_update_max_abs_err": upd,
              "param_update_atol": upd_atol, "launches": counts}
        if stage == 1:
            st["grad_err_vs_f64_on_card_branches_worst"] = {
                "tensor": worst_ref, "card": vs_ref[worst_ref]}
            # the twin's replayed units: each call's largest |input| at a flip
            # over that call's largest |input|
            st["relu_replayed_flips"] = {
                "units": sum(v["units"] for v in replayed.values()), "calls": len(replayed),
                "max_abs_over_scale": max((v["max_abs_over_scale"] for v in replayed.values()),
                                          default=0.0)}
        st["checks"] = {
            "loss_rel_err<=1e-5": all(abs(g["aux"][k] - v) <= 1e-5 * max(abs(v), 1e-6)
                                      for k, v in c["aux"].items())
            and abs(g["loss"] - c["loss"]) <= 1e-5 * abs(c["loss"]),
            # stage 0: against the float64 step; stage 1: against the float64
            # step on the card's ReLU branches
            "grad_err_vs_f64<=1e-3": all(e <= 1e-3 for e in vs_ref.values()),
            # every replayed branch within rounding of 0
            "relu_replayed_flips_within_rounding": stage == 0 or (
                st["relu_replayed_flips"]["max_abs_over_scale"] <= LOGIT_RTOL),
            "running_stats_rel_err<=1e-4": stat_err <= 1e-4,
            "param_update_err<=1e-2*lr+4ulp": upd <= upd_atol,
            "frozen_unchanged": frozen_same,
            "launches_ok": (card == "cpu" or (
                counts["dilated_conv3x3"] == 3 and counts["bottom_k_sum"] == 1
                and counts["dilated_conv3x3_wgrad"] == (3 if stage == 1 else 0))),
            "finite": bool(np.isfinite(g["loss"]))}
        st["ok"] = bool(all(st["checks"].values()))
        ok &= st["ok"]
        res["stages"].append(st)
    res["ok"] = bool(ok)
    return res


def phase_deeplab_train(torch, pairs=DL_TRAIN_PAIRS, warmup=2, timed=3):
    """Stage 0 and then stage 1 at exps/deeplab.yaml's settings (8 pairs of
    700x700 crops, bf16 autocast, f32 master weights) on the card: each with
    warm-up and timed steps, their launch counts and one profiled step."""
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.train.deeplab_trainer import TrainDeepLabOOD, synthetic_batch

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"phase": "deeplab_train", "model": "DeepLab v3+ WRN-38, full widths",
           "config": "exps/deeplab.yaml", "dtype": "bfloat16 autocast, f32 master weights",
           "pairs": pairs, "images_per_step": 2 * pairs, "crop": list(DL_CROP), "stages": []}
    trainer = TrainDeepLabOOD(deeplab_config(pairs, DL_CROP, bf16=True),
                              model=seeded_deeplab(torch, SEED + 25), device="cuda")
    batch = [torch.from_numpy(x).cuda() for x in synthetic_batch(pairs, DL_CROP, CLASSES,
                                                                 SEED + 26)]
    totals, ok = {}, True
    for stage in (0, 1):
        trainer.set_stage(stage)
        losses = [float(trainer.step(*batch)[0]) for _ in range(warmup)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times, steps = [], []
        for _ in range(timed):
            t0 = time.perf_counter()
            loss, aux = trainer.step(*batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            steps.append({"loss": float(loss), **{k: float(v) for k, v in aux.items()}})
        counts = launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        per_step = {k: v / timed for k, v in counts.items()}
        losses += [x["loss"] for x in steps]
        finite = all(np.isfinite(v) for x in steps for v in x.values())
        launches_ok = (per_step["dilated_conv3x3"] == 3 and per_step["bottom_k_sum"] == 1
                       and per_step["dilated_conv3x3_wgrad"] == (3 if stage == 1 else 0)
                       and all(v == 0 for k, v in counts.items() if k not in (
                           "dilated_conv3x3", "dilated_conv3x3_wgrad", "bottom_k_sum")))
        st = {"stage": stage, "trainable": list(
                  (trainer.cfg.model.trainable_params_name,
                   trainer.cfg.model.trainable_params_name_update)[stage]),
              "lr": trainer.optimizer.param_groups[0]["lr"], "step_ms": times,
              "images_per_s": 2 * pairs * timed / (sum(times) / 1e3),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "steps": steps,
              "losses_all_steps": losses, "losses_falling": losses[-1] < losses[0],
              "launches": counts, "launches_per_step": per_step,
              "profiled_step": profile_request(torch, lambda _: trainer.step(*batch), None,
                                               focus="dconv")}
        st["checks"] = {"finite": finite, "launches_ok": launches_ok}
        st["ok"] = bool(all(st["checks"].values()))
        ok &= st["ok"]
        res["stages"].append(st)
    res["ok"] = bool(ok)
    return res, totals


def phase_stage1_parity(torch, seed=SEED + 40, pairs=2, crop=(256, 256), card="cuda"):
    """One stage-1 step (``set_stage(0)``: RCL on the anomaly score, Adam over
    ``class_embed2``) at full widths in f32 (TF32 off): the card (kernels)
    against the CPU (plain versions), same weights, batch and CPU-made RCL
    noise, and the CPU's step in float64, which the card's gradient is held
    against. The CPU runs attend with the card's attention masks
    (``attention_mask_hooks``), whose flipped bits are counted. ``card="cpu"``
    rehearses the control flow."""
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD, synthetic_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_config(pairs, crop, bf16=False)
    base = seeded_model(torch, seed)
    batch = synthetic_batch(pairs, crop, CLASSES, seed + 1)
    trainers = {"card": TrainM2FOOD(cfg, model=copy.deepcopy(base), device=card),
                "cpu": TrainM2FOOD(cfg, model=copy.deepcopy(base), device="cpu"),
                "cpu_f64": TrainM2FOOD(cfg, model=copy.deepcopy(base), device="cpu")}
    trainers["cpu_f64"].model.double()  # in place: the optimizer keeps the same parameters
    noise = trainers["cpu"].draws(2 * pairs, tuple(crop))["rcl_noise"]  # CPU-made, used by all
    head = "sem_seg_head.predictor.class_embed2."
    snap = lambda t: t.detach().to("cpu", torch.float64, copy=True)
    runs = {}
    for side, tr in trainers.items():
        masks = []
        hooks = attention_mask_hooks(tr.model.sem_seg_head.predictor, masks,
                                     runs["card"]["masks"] if side != "card" else None)
        before = {n: snap(p) for n, p in tr.model.named_parameters()}
        reset_launch_counts()
        try:
            loss, aux = tr.stage1_step(*batch, draws={"rcl_noise": noise.to(tr.device)})
            if tr.device.type == "cuda":
                torch.cuda.synchronize()
        finally:
            for h in hooks:
                h.remove()
        runs[side] = {
            "launches": launch_counts(), "masks": masks, "loss": float(loss),
            "aux": {k: float(v) for k, v in aux.items()},
            "grads": {n: snap(p.grad) for n, p in tr.model.named_parameters()
                      if p.grad is not None},
            "delta": {n: snap(p) - before[n] for n, p in tr.model.named_parameters()},
            "params": before}
    g, c, f = runs["card"], runs["cpu"], runs["cpu_f64"]
    flips = sum(int((a[0] != b[0]).sum() + (a[1] != b[1]).sum())
                for a, b in zip(g["masks"], runs["cpu"]["masks"]))
    grad_err = {n: float((g["grads"][n] - w).abs().max()) / float(w.abs().max())
                for n, w in f["grads"].items()}
    # Adam's first step is about lr * sign(g + wd * p): where that is far above
    # eps and clear of sign noise, the card's update meets the float64 step's
    lr, wd = cfg.train.lr, cfg.train.weight_decay
    upd = 0.0
    for n, gr in f["grads"].items():
        gr = gr + wd * f["params"][n]
        sel = (gr.abs() > 1e-6) & (gr.abs() > 1e-2 * gr.abs().max())
        upd = max(upd, float((g["delta"][n][sel] - f["delta"][n][sel]).abs().max()))
    frozen_same = all(float(v.abs().max()) == 0 for run in runs.values()
                      for n, v in run["delta"].items() if not n.startswith(head))
    counts = g["launches"]
    res = {"phase": "stage1_parity", "seed": seed, "pairs": pairs, "crop": list(crop),
           "widths": "full", "dtype": "float32", "tf32": False, "loss_card": g["loss"],
           "loss_cpu": c["loss"], "loss_f64": f["loss"], "aux_card": g["aux"], "aux_cpu": c["aux"],
           "attention_mask_bits_flipped": flips, "trainable": sorted(f["grads"]),
           "grad_err_vs_f64": grad_err,
           "grad_err_vs_f64_cpu_f32": {n: float((c["grads"][n] - w).abs().max())
                                       / float(w.abs().max()) for n, w in f["grads"].items()},
           "param_update_max_abs_err": upd, "param_update_atol": 1e-2 * lr, "launches": counts}
    res["checks"] = {
        "loss_rel_err<=1e-5": all(abs(g["aux"][k] - v) <= 1e-5 * max(abs(v), 1e-6)
                                  for k, v in c["aux"].items())
        and abs(g["loss"] - c["loss"]) <= 1e-5 * abs(c["loss"]),
        "only_class_embed2_trains": sorted(f["grads"]) == [head + "bias", head + "weight"],
        "grad_err_vs_f64<=1e-3": all(e <= 1e-3 for e in grad_err.values()),
        "param_update_err<=1e-2*lr": upd <= 1e-2 * lr,
        "others_unchanged": frozen_same,
        "launches_ok": card == "cpu" or (
            counts["mask_scores_backward"] == 1 and counts["mask_scores_anomaly"] == 1
            and counts["mask_scores_semantic_classes"] == 1
            and counts["mask_scores_semantic"] == 0 and counts["ms_deform_attn_bilinear"] == 6
            and counts["ms_deform_attn_bilinear_backward"] == 0),
        "finite": bool(np.isfinite(g["loss"]))}
    res["ok"] = bool(all(res["checks"].values()))
    return res


def phase_stage1_train(torch, pairs=TRAIN_PAIRS, warmup=2, timed=3):
    """Stage 1 at exps/m2f.yaml's settings (8 pairs of 700x700 crops padded to
    704, bf16 autocast, f32 master weights): 2 warm-up and 3 timed steps with
    their launch counts, peak memory and one profiled step; then
    ``set_stage(1)`` and one stage-2 step."""
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD, synthetic_batch

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"phase": "stage1_train", "model": "MaskFormer R-50 MSDeformAttn+GMA, full widths",
           "config": "exps/m2f.yaml", "dtype": "bfloat16 autocast, f32 master weights",
           "pairs": pairs, "images_per_step": 2 * pairs, "crop": list(CROP),
           "padded": list(TRAIN_HW)}
    trainer = TrainM2FOOD(train_config(pairs, CROP, bf16=True),
                          model=seeded_model(torch, SEED + 41), device="cuda")
    batch = [torch.from_numpy(x).cuda() for x in synthetic_batch(pairs, CROP, CLASSES, SEED + 42)]
    frozen = "sem_seg_head.predictor.class_embed.weight"
    params = dict(trainer.model.named_parameters())
    start = {n: params[n].detach().clone() for n in (frozen, "sem_seg_head.predictor.class_embed2.weight")}
    losses = [float(trainer.stage1_step(*batch)[0]) for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, steps = [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        loss, aux = trainer.stage1_step(*batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        steps.append({"loss": float(loss), **{k: float(v) for k, v in aux.items()}})
    counts = launch_counts()
    per_step = {k: v / timed for k, v in counts.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    profiled = profile_request(torch, lambda _: trainer.stage1_step(*batch), None,
                               focus=STEP_FOCUS)
    moved = {n: float((params[n].detach() - v).abs().max()) for n, v in start.items()}
    trainer.set_stage(1)
    reset_launch_counts()
    t0 = time.perf_counter()
    loss2, losses2, gnorm, _ = trainer.stage2_step(*batch)
    torch.cuda.synchronize()
    switch = {"stage2_step_ms": (time.perf_counter() - t0) * 1e3, "loss": float(loss2),
              "grad_norm": float(gnorm), "losses": {k: float(v) for k, v in losses2.items()},
              "launches": launch_counts(),
              "trainable_tensors": sum(p.requires_grad for p in trainer.model.parameters())}
    launches_ok = (per_step["mask_scores_backward"] == 1 and per_step["mask_scores_anomaly"] == 1
                   and per_step["mask_scores_semantic_classes"] == 1
                   and per_step["ms_deform_attn_bilinear"] == 6
                   and all(v == 0 for k, v in counts.items() if k not in (
                       "mask_scores_backward", "mask_scores_anomaly",
                       "mask_scores_semantic_classes", "ms_deform_attn_bilinear")))
    finite = all(np.isfinite(v) for x in steps for v in x.values())
    res.update(step_ms=times, images_per_s=2 * pairs * timed / (sum(times) / 1e3),
               peak_mem_gib=peak, steps=steps, losses_warmup=losses, launches=counts,
               launches_per_step=per_step, param_change_over_5_steps=moved,
               profiled_step=profiled, after_set_stage_1=switch)
    res["checks"] = {
        "finite": finite, "launches_ok": launches_ok,
        "only_class_embed2_moved": moved[frozen] == 0 and moved[
            "sem_seg_head.predictor.class_embed2.weight"] > 0,
        "stage2_step_after_switch": bool(np.isfinite(switch["loss"]) and np.isfinite(
            switch["grad_norm"]) and switch["launches"]["ms_deform_attn_bilinear_backward"] == 6)}
    res["ok"] = bool(all(res["checks"].values()))
    return res, counts


def synthetic_val_set(sizes, seed):
    """An in-memory validation set: normalised f32 images and label maps (an
    anomaly rectangle of 1, the rest 0, a tenth of the pixels void 255)."""
    g = np.random.RandomState(seed)
    items = []
    for i, (h, w) in enumerate(sizes):
        lab = np.zeros((h, w), np.int32)
        y0, x0 = g.randint(0, h // 2), g.randint(0, w // 2)
        lab[y0:y0 + h // 4, x0:x0 + w // 4] = 1
        lab[g.rand(h, w) < 0.1] = 255
        items.append((g.randn(h, w, 3).astype(np.float32), lab, f"val{i}"))

    class InMemory:
        def __len__(self):
            return len(items)

        def __getitem__(self, i):
            return items[i]

    return InMemory()


def phase_validate(torch, device="cuda", sizes=(VAL_HW[0],) * 6 + (VAL_HW[1],) * 4,
                   m2f=None, deeplab=None):
    """``TrainM2FOOD.valid`` and ``TrainDeepLabOOD.valid`` (bf16 autocast, full
    widths) over 10 in-memory images in two shape buckets. A first, untimed
    pass warms up each bucket and records the maps the meter sees (at its
    ``update``); a second pass with the plain meter is timed, and its launches
    are the path's. Both passes' binned metrics lie within 2 / 8192 of the
    exact ones on the recorded maps. ``device="cpu"`` with small models
    rehearses the control flow."""
    from multishiftseg_torch.evals.ood_metrics import BinnedOODMeter, eval_ood_measure
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.train import validation
    from multishiftseg_torch.train.deeplab_trainer import TrainDeepLabOOD
    from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD

    torch.backends.cudnn.allow_tf32 = True
    ds = synthetic_val_set(sizes, SEED + 50)
    seen = []

    class RecordingMeter(BinnedOODMeter):
        def update(self, scores, labels):
            seen.append((scores.float().cpu().numpy().reshape(-1), np.asarray(labels).reshape(-1)))
            super().update(scores, labels)

    res = {"phase": "validate", "images": [list(hw) for hw in sizes], "bins": NUM_BINS,
           "models": {}}
    totals, ok = {}, True
    trainers = {
        "m2f": lambda: TrainM2FOOD(train_config(1, CROP, bf16=device != "cpu"),
                                   model=m2f or seeded_model(torch, SEED + 51), device=device),
        "deeplab": lambda: TrainDeepLabOOD(deeplab_config(1, DL_CROP, bf16=device != "cpu"),
                                           model=deeplab or seeded_deeplab(torch, SEED + 52),
                                           device=device)}
    sync = (lambda: None) if device == "cpu" else torch.cuda.synchronize
    keys = ("AUROC", "AUPRC", "FPR_TPR95")
    for name, make in trainers.items():
        tr = make()
        seen.clear()
        validation.BinnedOODMeter = RecordingMeter
        try:
            t0 = time.perf_counter()
            recorded = tr.valid(ds)  # untimed: warm-up of both buckets, maps recorded
            sync()
            cold = time.perf_counter() - t0
        finally:
            validation.BinnedOODMeter = BinnedOODMeter
        reset_launch_counts()
        t0 = time.perf_counter()
        metrics = tr.valid(ds)
        sync()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        exact = dict(zip(keys, eval_ood_measure(np.concatenate([s for s, _ in seen]),
                                                np.concatenate([lb for _, lb in seen]))))
        diff = {k: abs(metrics[k] - exact[k]) for k in keys}
        diff_recorded = {k: abs(recorded[k] - exact[k]) for k in keys}
        m = {"binned": metrics, "binned_recorded_pass": recorded, "exact": exact,
             "abs_diff": diff, "abs_diff_recorded_pass": diff_recorded, "seconds": seconds,
             "seconds_per_image": seconds / len(sizes),
             "first_pass_seconds_with_recording": cold, "maps": len(seen), "launches": counts}
        m["checks"] = {
            "within_2_bins": all(v <= 2 / NUM_BINS for v in list(diff.values())
                                 + list(diff_recorded.values())),
            "finite": all(np.isfinite(v) for v in metrics.values()),
            "every_map_metered": len(seen) == len(sizes),
            # one launch of the range and histogram entry a map, no other entry
            "launches_ok": device == "cpu" or (counts.get("ood_range_hist", 0) == len(sizes)
                                               and counts["ood_hist"] == 0
                                               and counts["ood_hist_minmax"] == 0)}
        m["ok"] = bool(all(m["checks"].values()))
        ok &= m["ok"]
        res["models"][name] = m
        del tr
    res["ok"] = bool(ok)
    return res, totals


def phase_evaluate(torch, device="cuda", hw=VAL_HW[0], n_images=4, m2f=None, deeplab=None,
                   extra_yaml=None):
    """The eval CLI (``test_runner.main``), ``--model m2f`` and ``--model
    deeplab``, on a temporary SMIYC RoadAnomaly21 folder (jpg images and
    ``_labels_semantic.png`` labels, 4 images of 720x1280) named in a
    temporary YAML, with ``--weight_path`` a detectron2-style ``{"model": sd}``
    file of the seeded port model and ``--save_outputs``: finite metrics and
    artifacts of the images' shape; then :func:`evaluate_approximate` on the
    m2f run. ``device="cpu"`` with small models (and their widths in
    ``extra_yaml``) rehearses the control flow."""
    import os
    import tempfile

    import yaml
    from PIL import Image

    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.train import test_runner

    res = {"phase": "evaluate", "images": n_images, "image_hw": list(hw), "models": {}}
    totals, ok, runs = {}, True, {}
    g = np.random.RandomState(SEED + 60)
    here = Path(__file__).resolve().parent
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "dataset_AnomalyTrack"
        (root / "images").mkdir(parents=True)
        (root / "labels_masks").mkdir()
        for i in range(n_images):
            Image.fromarray(g.randint(0, 256, (*hw, 3)).astype(np.uint8)).save(
                root / "images" / f"val{i}.jpg", quality=90)
            lab = np.zeros(hw, np.uint8)
            lab[hw[0] // 3:hw[0] // 2, hw[1] // 4:hw[1] // 2] = 1
            lab[g.rand(*hw) < 0.1] = 255
            Image.fromarray(lab).save(root / "labels_masks" / f"val{i}_labels_semantic.png")
        models = {"m2f": (m2f or (lambda: seeded_model(torch, SEED + 61)), "m2f.yaml"),
                  "deeplab": (deeplab or (lambda: seeded_deeplab(torch, SEED + 62)), "deeplab.yaml")}
        for name, (make, base) in models.items():
            cfg_path = Path(tmp) / f"{name}.yaml"
            y = {"base": str(here / "exps" / base), "data": {"anomaly_track_root": str(root)},
                 **((extra_yaml or {}).get(name, {}))}
            cfg_path.write_text(yaml.safe_dump(y))
            weights = Path(tmp) / f"{name}.pth"
            torch.save({"model": make().state_dict()}, weights)
            out = Path(tmp) / f"out_{name}"
            argv = ["--model", name, "--cfg", str(cfg_path), "--weight_path", str(weights),
                    "--test_dataset", "RoadAnomaly21", "--save_outputs", str(out),
                    "--device", device]
            os.chdir(tmp)  # the config loader writes ckpts/<id> under the working directory
            try:
                reset_launch_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(sys.stderr):  # the CLI prints its results
                    results = test_runner.main(argv)
                seconds = time.perf_counter() - t0
                counts = launch_counts()
            finally:
                os.chdir(cwd)
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            metrics = results.get("RoadAnomaly21", {})
            arts = sorted((out / "RoadAnomaly21").glob("*_anomaly.npy"))
            colors = sorted((out / "RoadAnomaly21").glob("*_pred_color.png"))
            shapes_ok = (len(arts) == n_images == len(colors)
                         and all(np.load(a).shape == tuple(hw) for a in arts)
                         and all(Image.open(c).size == (hw[1], hw[0]) for c in colors))
            m = {"metrics": metrics, "seconds_with_model_load": seconds,
                 "seconds_per_image_with_model_load": seconds / n_images, "launches": counts,
                 "artifacts": len(arts) + len(colors)}
            m["checks"] = {"metrics_finite": len(metrics) == 3 and all(
                np.isfinite(v) for v in metrics.values()), "artifacts_shape": shapes_ok}
            m["ok"] = bool(all(m["checks"].values()))
            ok &= m["ok"]
            res["models"][name] = m
            runs[name] = (cfg_path, weights, metrics)
        cfg_path, weights, metrics = runs["m2f"]
        res["metrics_routes"] = evaluate_routes(torch, device, tmp, root, cfg_path, weights,
                                                metrics, n_images)
        ok &= res["metrics_routes"]["ok"]
        approx, counts = evaluate_approximate(torch, device, tmp, root, cfg_path, weights, metrics)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        res["approximate"] = approx
        ok &= approx["ok"]
    res["ok"] = bool(ok)
    return res, totals


def evaluate_routes(torch, device, tmp, root, cfg_path, weights, cli_metrics, n_images):
    """``OODEvaluator`` on the m2f run's folder, weights and forward (built
    once, warmed by a first pass): seconds per image (forward included), the
    route its exact metrics took (native: the folder holds over 2,000,000
    labelled pixels), its metrics equal to the CLI's within 1e-6. Then
    ``eval_ood_measure`` on the scores and labels the evaluator passed it, by
    the default route and with ``use_native=False``: seconds each (median of
    3), the two results within 1e-6, and the evaluator's seconds per image
    had it taken numpy (its time with the native call's swapped for numpy's)."""
    import os

    from multishiftseg_torch.core.config import load_config
    from multishiftseg_torch.evals import ood_metrics
    from multishiftseg_torch.train import test_runner

    cwd = os.getcwd()
    os.chdir(tmp)
    passed, real = [], test_runner.eval_ood_measure
    test_runner.eval_ood_measure = lambda s, g, **kw: passed.append((s, g)) or real(s, g, **kw)
    try:
        cfg = load_config(str(cfg_path), "routes")
        fwd = test_runner.build_m2f_forward(cfg, str(weights), device=device)
        for _ in range(2):  # a warm-up pass, then the timed one
            ev = test_runner.OODEvaluator(cfg, fwd, {"RoadAnomaly21": str(root)})
            t0 = time.perf_counter()
            metrics = ev.test("RoadAnomaly21")
            seconds = time.perf_counter() - t0
    finally:
        test_runner.eval_ood_measure = real
        os.chdir(cwd)
    scores, labels = passed[-1]
    out = {"route": ev.metric_routes["RoadAnomaly21"], "seconds_per_image": seconds / n_images,
           "labelled_pixels": int(np.count_nonzero(labels <= 1)),
           "metrics_equal_cli": all(abs(metrics[k] - v) <= 1e-6
                                    for k, v in cli_metrics.items())}
    results, metric_s = {}, {}
    for label, kw in (("default", {}), ("numpy", {"use_native": False})):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            results[label] = ood_metrics.eval_ood_measure(scores, labels, **kw)
            times.append(time.perf_counter() - t0)
        metric_s[label] = statistics.median(times)
    out["metrics_seconds"] = metric_s
    out["seconds_per_image_had_it_taken_numpy"] = (
        seconds - metric_s["default"] + metric_s["numpy"]) / n_images
    out["routes_agree"] = bool(np.allclose(results["default"], results["numpy"], rtol=0,
                                           atol=1e-6))
    out["ok"] = bool(out["route"] == "native" and out["metrics_equal_cli"]
                     and out["routes_agree"])
    return out


def evaluate_approximate(torch, device, tmp, root, cfg_path, weights, bilinear):
    """The eval CLI in an approximate setting (``--sample_mode nearest_top6c
    --score_topq 32``), then ``multishiftseg_torch.tools.validate_release``'s
    ``qualify_sampling_modes`` over its ``QUAL_MODES`` on the same folder and
    weights against the ``bilinear`` CLI run's metrics (``bilinear``), the
    artifact written next to the weights; the gate then refuses exactly the
    settings recorded unqualified. Random weights: the verdicts mean nothing,
    the path is what is checked. Launch counts of the CLI run and of the
    qualification, each path run with the counts set to 0 just before it."""
    import os

    from multishiftseg_torch.core.config import load_config
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.tools import validate_release as vr
    from multishiftseg_torch.train import test_runner

    totals, res = {}, {}
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        argv = ["--model", "m2f", "--cfg", str(cfg_path), "--weight_path", str(weights),
                "--test_dataset", "RoadAnomaly21", "--device", device,
                "--sample_mode", "nearest_top6c", "--score_topq", "32"]
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            metrics = test_runner.main(argv).get("RoadAnomaly21", {})
        cli = {"argv_flags": argv[-4:], "metrics": metrics,
               "seconds_with_model_load": time.perf_counter() - t0, "launches": launch_counts()}
        cli["ok"] = len(metrics) == 3 and all(np.isfinite(v) for v in metrics.values())
        res["cli"] = cli

        cfg = load_config(str(cfg_path))
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            record = vr.qualify_sampling_modes(
                cfg, str(weights), "RoadAnomaly21", str(root),
                {k: 100.0 * v for k, v in bilinear.items()}, 0.5, device=device)
        qual = {"seconds": time.perf_counter() - t0, "launches": launch_counts(),
                "record": record}
        path = vr.write_qualification(str(weights), record)
        # the gate as build_m2f_forward runs it first; a refused setting must
        # also stop build_m2f_forward before it builds anything
        gate = {}
        for mode, rec in record["modes"].items():
            base, _, suffix = mode.partition("+")
            opts = dict(sample_mode=base, score_lowres=suffix == "lowres",
                        score_topq=int(suffix[4:]) if suffix.startswith("topq") else 0)
            try:
                test_runner.check_sampling_qualification(
                    str(weights), test_runner.qualification_key(**opts))
                gate[mode] = "allowed"
            except RuntimeError as e:
                if "REFUSED" not in str(e):
                    raise
                try:
                    test_runner.build_m2f_forward(cfg, str(weights), device=device, **opts)
                    gate[mode] = "refused by the gate, built by build_m2f_forward"
                except RuntimeError as e2:
                    gate[mode] = "refused" if "REFUSED" in str(e2) else repr(e2)
        qual["gate"] = gate
        qual["artifact_written"] = path.exists()
        qual["ok"] = path.exists() and set(record["modes"]) == set(vr.QUAL_MODES) and all(
            gate[m] == ("allowed" if r["qualified"] else "refused")
            for m, r in record["modes"].items())
        res["qualification"] = qual
    finally:
        os.chdir(cwd)
    for part in (cli, qual):
        for k, v in part["launches"].items():
            totals[k] = totals.get(k, 0) + v
        part["launches"] = {k: v for k, v in part["launches"].items() if v}
    res["ok"] = bool(cli["ok"] and qual["ok"])
    return res, totals


# the kernels each trainer's epoch loop must launch (steps and validation)
LOOP_KERNELS = {
    "m2f": ("ms_deform_attn_bilinear", "ms_deform_attn_bilinear_backward", "label_points",
            "linear_sum_assignment", "mask_scores_anomaly", "mask_scores_backward",
            "mask_scores_semantic_classes", "ood_range_hist"),
    "deeplab": ("dilated_conv3x3", "dilated_conv3x3_wgrad", "bottom_k_sum", "ood_range_hist")}


def same_optimizer_state(torch, a, b):
    """Two optimizer ``state_dict``s hold the same groups and equal tensors."""
    if a["param_groups"] != b["param_groups"] or set(a["state"]) != set(b["state"]):
        return False
    return all(torch.equal(torch.as_tensor(v).cpu(), torch.as_tensor(b["state"][k][key]).cpu())
               for k, st in a["state"].items() for key, v in st.items())


TRAIN_LOOP_FRAMES = 16


def phase_train_loop(torch):
    """Both trainers' ``train()`` (the epoch loop: DiverseCityscapes, the
    recipe's augmentations, the Loader's pinned side-stream copies, the steps,
    a validation and the checkpoints every epoch) on a synthetic tree made
    from ``SEED`` (``tools.synthetic_tree``: 16 Cityscapes frames of H x W
    with labelTrainIds, one generated variant each with a label-254 region, a
    4-image COCO bank, a 4-image RoadAnomaly21 folder of ``VAL_HW[0]``). The
    recipe's yaml with only the roots, ``n_epochs = 2`` and ``warmup_epoch =
    1`` overridden (batch 8, crop 700, bf16 and 4 workers stay): two steps an
    epoch, one epoch in each stage, two validations; then a resume from
    ``last`` with ``n_epochs = 3`` whose epoch runs stage 1 with the saved
    optimizer state and best AUPRC. Per epoch: steps, stage, seconds,
    images/s, the median step on the card, the loader's wait a step; peak
    memory, the decoder, the files written and the launches of every run."""
    import os
    import tempfile

    from multishiftseg_torch.core.config import load_config
    from multishiftseg_torch.data import native_io
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.tools.synthetic_tree import write_training_tree
    from multishiftseg_torch.train.checkpoint import CheckpointManager
    from multishiftseg_torch.train.deeplab_trainer import TrainDeepLabOOD
    from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    # no earlier phase was cut to make room: the script ends within half its limit
    res = {"phase": "train_loop", "card": nvidia_smi(), "frames": TRAIN_LOOP_FRAMES,
           "frame_hw": [H, W], "val_hw": list(VAL_HW[0]), "earlier_phases_cut": [],
           "trainers": {}}
    totals, ok = {}, True
    trainers = {"m2f": TrainM2FOOD, "deeplab": TrainDeepLabOOD}
    here = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        roots = write_training_tree(Path(tmp) / "data", SEED + 70, frames=TRAIN_LOOP_FRAMES,
                                    hw=(H, W), val_hw=VAL_HW[0])
        res["tree_seconds"] = time.perf_counter() - t0
        for name, cls in trainers.items():
            def config(n_epochs):
                cfg = load_config(str(here / "exps" / f"{name}.yaml"))
                for k, v in roots.items():
                    setattr(cfg.data, k, v)
                cfg.train.n_epochs, cfg.train.warmup_epoch = n_epochs, 1
                cfg.model_dir = str(Path(tmp) / f"ckpts_{name}")
                return cfg

            def run(tr, **kw):
                reset_launch_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                best = tr.train(**kw)
                seconds = time.perf_counter() - t0
                counts = launch_counts()
                for k, v in counts.items():
                    totals[k] = totals.get(k, 0) + v
                epochs = [{**{k: h[k] for k in ("epoch", "stage", "steps", "seconds",
                                                "img_per_s", "step_ms_median", "loss",
                                                "valid_seconds", "metrics", "saved",
                                                "optimizer")},
                           "loader_wait_s_per_step": h["loader_wait_s"] / h["steps"]}
                          for h in tr.history]
                return {"seconds_with_datasets": seconds, "best": best, "epochs": epochs,
                        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "launches": {k: v for k, v in counts.items() if v}}

            cfg = config(2)
            t0 = time.perf_counter()
            tr = cls(cfg)
            build_s = time.perf_counter() - t0
            first = run(tr)
            del tr
            ckpt = CheckpointManager(cfg.model_dir)
            files = sorted(os.listdir(cfg.model_dir))
            saved = ckpt.restore("last", "cpu")
            # the resume: the optimizer and best AUPRC as restored, then its epoch
            tr = cls(config(3))
            start, stage = ckpt.resume(tr, "last", 0, 1)
            resumed_opt = same_optimizer_state(torch, tr.optimizer.state_dict(),
                                               saved["optimizer"])
            resumed_best = tr.best["AUPRC"] == saved["best_auprc"]
            second = run(tr, resume="last")
            del tr
            torch.cuda.empty_cache()
            m = {"model_build_seconds": build_s, "train": first,
                 "resume": {"start_epoch": start, "stage": stage, **second},
                 "files": files, "decoder": native_io.decoder()}
            stages = [e["stage"] for e in first["epochs"]]
            launched = {k: first["launches"].get(k, 0) + second["launches"].get(k, 0)
                        for k in LOOP_KERNELS[name]}
            m["kernels_launched"] = launched
            m["checks"] = {
                "two_stages": stages == [0, 1],
                "two_steps_an_epoch": [e["steps"] for e in first["epochs"]] == [2, 2],
                "validated_every_epoch": all(
                    e["metrics"] and all(np.isfinite(v) for v in e["metrics"].values())
                    for e in first["epochs"] + second["epochs"]),
                "finite_losses": all(np.isfinite(e["loss"])
                                     for e in first["epochs"] + second["epochs"]),
                "checkpoints": {"last.pt", "AUPRC_best.pt", "scalars.csv"} <= set(files)
                and saved["epoch"] == 1 and saved["stage"] == 1,
                "resume_into_stage_1": (start, stage) == (2, 1) and [
                    (e["epoch"], e["stage"]) for e in second["epochs"]] == [(2, 1)],
                "resume_optimizer_state": resumed_opt,
                "resume_best_auprc": resumed_best,
                "kernels_launched": all(v > 0 for v in launched.values())}
            m["ok"] = bool(all(m["checks"].values()))
            ok &= m["ok"]
            res["trainers"][name] = m
            emit({"train_loop": name, "card": res["card"], "epochs": [
                {k: e[k] for k in ("epoch", "stage", "steps", "seconds", "img_per_s",
                                   "step_ms_median", "loader_wait_s_per_step")}
                for e in first["epochs"] + second["epochs"]],
                "peak_mem_gib": max(first["peak_mem_gib"], second["peak_mem_gib"]),
                "decoder": m["decoder"], "files": files, "ok": m["ok"]})
    res["ok"] = bool(ok)
    return res, totals


def instance_config(recipe, batch, crop, bf16):
    """exps/m2f_<recipe>.yaml with the batch, crop and precision given."""
    from multishiftseg_torch.core.config import load_config

    cfg = load_config(str(Path(__file__).resolve().parent / "exps" / f"m2f_{recipe}.yaml"))
    cfg.train.train_batch = batch
    cfg.data.crop_size = tuple(crop)
    cfg.train.bf16 = bf16
    return cfg


def instance_batch(batch, crop, slots, seed):
    """A seeded batch of the instance recipe: normalised f32 images [B, H, W, 3],
    segment id maps [B, H, W] (-1 ignore) and classes [B, T] (the 8 thing
    classes, duplicates, -1 padding) from ``tools.synthetic_tree``'s frames
    through the port's mappers, clipped to the T largest segments."""
    from multishiftseg_torch.data.mappers import instance_to_targets, remap_classes
    from multishiftseg_torch.tools.synthetic_tree import segments_frame
    from multishiftseg_torch.train.instance_trainer import THING_RAW_IDS, clip_targets

    g = np.random.default_rng(seed)
    class_map = {c: i for i, c in enumerate(THING_RAW_IDS)}
    ids, classes = [], []
    for _ in range(batch):
        tgt = remap_classes(instance_to_targets(segments_frame(g, crop, 30)[1]), class_map)
        tgt = clip_targets(tgt, slots).padded(slots)
        ids.append(tgt.id_map)
        classes.append(tgt.classes)
    img = g.standard_normal((batch, *crop, 3), dtype=np.float32)
    return img, np.stack(ids).astype(np.int32), np.stack(classes).astype(np.int32)


def confident_logits(torch, seed, q, k, hw):
    """Class logits [Q, K+1] with most queries confident, and mask logits
    [Q, H, W] positive on a rectangle a query (overlapping others): inputs on
    which the panoptic thresholds keep and merge segments."""
    g = np.random.RandomState(seed)
    cls = g.randn(q, k + 1).astype(np.float32)
    cls[np.arange(q), g.randint(0, k, q)] += np.where(g.rand(q) < 0.7, 6.0, 0.0)
    masks = g.randn(q, *hw).astype(np.float32) - 6.0
    h, w = hw
    for i in range(q):
        y0, x0 = g.randint(0, h - h // 8), g.randint(0, w - w // 8)
        masks[i, y0:y0 + g.randint(h // 16, h // 3), x0:x0 + g.randint(w // 16, w // 3)] += 12.0
    return torch.from_numpy(cls), torch.from_numpy(masks)


def postprocess_parity(torch, logits, masks, thing_ids):
    """``instance_inference`` (over ``thing_ids``, or every class when None)
    and ``panoptic_inference`` on the card against the CPU on the same
    logits: the same detections (classes and masks equal, scores within 1e-5
    relative, in score order) and the same panoptic map and segments."""
    from multishiftseg_torch.models.inference_extras import (instance_inference,
                                                             panoptic_inference)

    out = {}
    for name, fn in (("instance", lambda c, m: instance_inference(c, m, thing_ids=thing_ids)),
                     ("panoptic", lambda c, m: panoptic_inference(c, m))):
        card = fn(logits.cuda(), masks.cuda())
        cpu = fn(logits.cpu(), masks.cpu())
        if name == "panoptic":
            out[name] = {"segments": len(cpu[1]), "equal": bool(
                np.array_equal(card[0], cpu[0]) and card[1] == cpu[1])}
            continue
        order = [np.lexsort((d["pred_classes"], -d["scores"].astype(np.float64)))
                 for d in (card, cpu)]
        a, b = ({k: v[o] for k, v in d.items()} for d, o in zip((card, cpu), order))
        out[name] = {"detections": int(len(b["scores"])), "equal": bool(
            np.array_equal(a["pred_classes"], b["pred_classes"])
            and np.array_equal(a["pred_masks"], b["pred_masks"])
            and np.allclose(a["scores"], b["scores"], rtol=1e-5, atol=1e-7))}
    return out


def criterion_replay(torch, replay, log):
    """Route the instance criterion's two data-dependent decisions through a
    recorder: the matches (``criterion.match``) and the uncertain points of
    the mask losses (``criterion.uncertain_point_coords``, a top-k over
    |logit|). Each call appends its own result (on the CPU) to
    ``log["assign"]`` or ``log["coords"]``; given ``replay``, another run's
    ``log``, it returns that run's result instead, in call order, and logs in
    ``log["assign_gaps"]`` whether its own assignment equals it and how far
    the replayed one's total cost over the valid slots lies above its own on
    its own costs (both optimal within rounding when small), and in
    ``log["point_gaps"]`` the rows whose selection differs and how far the
    replayed points' uncertainty falls below its own k-th largest, over the
    largest |logit| (both selections agree within rounding when small).
    Returns a function that restores both."""
    from multishiftseg_torch.losses import criterion, matcher
    from multishiftseg_torch.ops.sampling import point_sample_nchw

    orig_match, orig_points = criterion.match, criterion.uncertain_point_coords

    def match(pred_logits, out_pts, tgt_pts, valid, **kw):
        own = orig_match(pred_logits, out_pts, tgt_pts, valid, **kw)
        log["assign"].append(own.cpu())
        if replay is None:
            return own
        other = replay["assign"][len(log["assign"]) - 1].to(own.device)
        w = {k: kw[k] for k in ("cost_class_w", "cost_mask_w", "cost_dice_w")}
        cost = matcher.compute_match_cost(pred_logits, out_pts, tgt_pts, valid,
                                          tgt_classes=kw["tgt_classes"], **w).transpose(1, 2)

        def total(a):
            return (cost.gather(2, a[..., None])[..., 0].double() * valid).sum(1)

        mine = total(own)
        log["assign_gaps"].append({"equal": bool(torch.equal(own, other)), "rel_cost_gap": float(
            ((total(other) - mine) / mine.abs().clamp_min(1e-12)).max())})
        return other

    def uncertain_point_coords(pred_masks, coords, rand, cfg):
        own = orig_points(pred_masks, coords, rand, cfg)
        log["coords"].append(own.cpu())
        if replay is None:
            return own
        other = replay["coords"][len(log["coords"]) - 1].to(own.device)
        k = int(cfg.importance_sample_ratio * cfg.num_points)
        with torch.no_grad():
            unc = -point_sample_nchw(pred_masks[:, None], coords)[:, 0].abs()
            kth = unc.topk(k, dim=-1).values[:, -1:]
            replayed = -point_sample_nchw(pred_masks[:, None], other[:, :k])[:, 0].abs()
            gap = (kth - replayed).clamp_min(0).max()
        log["point_gaps"].append({
            "rows_differ": int((own != other).flatten(1).any(1).sum()),
            "rel_gap": float(gap / unc.abs().max().clamp_min(1e-30))})
        return other

    criterion.match, criterion.uncertain_point_coords = match, uncertain_point_coords

    def restore():
        criterion.match, criterion.uncertain_point_coords = orig_match, orig_points

    return restore


def phase_instance_parity(torch, seed=SEED + 90, batch=2, crop=(200, 200), card="cuda"):
    """One ``TrainM2FInstance`` step of the instance recipe at full widths on
    2 unpadded 200x200 crops (pyramid 7 / 13 / 25, masks 50x50) with 48 slots,
    f32 with TF32 off: the card (kernels) against the CPU (plain versions) and
    a float64 CPU step, same weights, batch and CPU-made draws, the CPU steps
    attending with the card's attention masks and taking the card's matches
    and uncertain points (:func:`criterion_replay`: the random-weight queries
    are alike, so 48-slot problems meet near-ties, and the top-k of |logit|
    meets near-equal logits, that rounding decides; each replayed assignment
    must cost within 1e-5 of the CPU's own optimum on the CPU's costs, and
    each replayed point lie within LOGIT_RTOL of the largest |logit| of the
    CPU's own selection threshold). The f32 and float64 CPU steps take their
    own ReLU branches; an input within f32 rounding of 0 moves the whole
    gradient path below it (the first card runs held the card's gradients up
    to 10x further from the float64 step than the CPU's), so, as in
    ``deeplab_train_parity``, the card's gradients are held against a float64
    twin that follows the card's ReLU branches (``utils.relu_sign_hooks``),
    and every unit whose sign the twin replays against its own must have an
    input within LOGIT_RTOL of its call's largest |input|. Held otherwise as
    ``train_parity`` holds the
    stage-2 step. Then the
    stage-2 step. Then the
    eval forward of one 256x512 image on the card and ``instance_inference`` /
    ``panoptic_inference`` on its logits, and on confident synthetic logits at
    512x1024, card against CPU. (``card="cpu"`` rehearses the step's control
    flow without a card.)"""
    from multishiftseg_torch.models.inference_extras import CITYSCAPES_THING_IDS
    from multishiftseg_torch.ops.resize import resize_bilinear_nchw
    from multishiftseg_torch.train.instance_trainer import TrainM2FInstance
    from multishiftseg_torch.utils import relu_sign_hooks

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = instance_config("instance", batch, crop, bf16=False)
    base = seeded_model(torch, seed, num_classes=INST_CLASSES, predictor="vanilla")
    img, ids, classes = instance_batch(batch, crop, INST_SLOTS, seed + 1)
    twin = "cpu_f64_card_branches"
    trainers = {side: TrainM2FInstance(cfg, model=copy.deepcopy(base), dataset_name="unused",
                                       device=dev)
                for side, dev in (("card", card), ("cpu", "cpu"), ("cpu_f64", "cpu"),
                                  (twin, "cpu"))}
    for side in ("cpu_f64", twin):
        trainers[side].model.double()  # in place: the optimizer keeps the same parameters
    draws = trainers["cpu"].draws(batch, INST_SLOTS)  # CPU-made, used by all four
    runs, matches, relus = {}, {}, {}
    for side, tr in trainers.items():
        card_run = runs.get("card")
        matches[side] = {"assign": [], "coords": [], "assign_gaps": [], "point_gaps": []}
        relus[side] = {"signs": {}, "flips": {}}

        def step(tr=tr, side=side):
            restore = criterion_replay(torch, matches["card"] if side != "card" else None,
                                       matches[side])
            hooks = relu_sign_hooks(tr.model, relus[side]["signs"], replay=(
                relus["card"]["signs"] if side == twin else None), flips=relus[side]["flips"])
            try:
                return tr.step(img, ids, classes, draws=tree_to(draws, tr.device))
            finally:
                restore()
                for h in hooks:
                    h.remove()

        runs[side] = recorded_step(torch, tr, step, card_run)
    g, c = runs["card"], runs["cpu"]
    n_out = len(g["assign"])  # the final output and the 9 auxiliary ones
    res = {"phase": "instance_parity", "seed": seed, "batch": batch, "crop": list(crop),
           "slots": INST_SLOTS, "valid_slots": [int((x >= 0).sum()) for x in classes],
           "levels": [list(t.shape[-2:]) for t in c["ms"]], "widths": "full",
           "dtype": "float32", "tf32": False, "launches": g["launches"],
           "loss_card": g["loss"], "loss_cpu": c["loss"], "grad_norm_card": g["gnorm"],
           "grad_norm_cpu": c["gnorm"]}
    checks = compare_steps(torch, runs, trainers["cpu"].optimizer, cfg.model.m2f, res)
    replayed = ("cpu", "cpu_f64", twin)
    res["assignment_replay"] = {side: matches[side]["assign_gaps"] for side in replayed}
    res["point_replay"] = {side: matches[side]["point_gaps"] for side in replayed}
    card_signs = relus["card"]["signs"]
    res["relu_calls"] = {side: len(v["signs"]) for side, v in relus.items()}
    res["relu_units"] = sum(int(v.numel()) for v in card_signs.values())
    # units on other sides of 0 than on the card, each CPU step on its own
    # branches; the twin's, with each call's largest |input| at a flip over
    # that call's largest |input|
    res["relu_sign_flips_vs_card"] = {side: sum(int((v != card_signs[k]).sum()) for k, v in
                                                relus[side]["signs"].items())
                                      for side in ("cpu", "cpu_f64")}
    flips = relus[twin]["flips"]
    res["relu_replayed_flips"] = {
        "units": sum(f["units"] for f in flips.values()), "calls": len(flips),
        "max_abs_over_scale": max((f["max_abs_over_scale"] for f in flips.values()),
                                  default=0.0)}
    res["checks"] = {
        "relu_calls_equal": all(set(v["signs"]) == set(card_signs) for v in relus.values()),
        "relu_replayed_flips_within_rounding": (
            res["relu_replayed_flips"]["max_abs_over_scale"] <= LOGIT_RTOL),
        **checks,
        "assignments_within_rounding": all(
            len(gaps) == n_out and all(x["equal"] or x["rel_cost_gap"] <= 1e-5 for x in gaps)
            for gaps in res["assignment_replay"].values()),
        "points_within_rounding": all(
            len(gaps) == n_out and all(x["rel_gap"] <= LOGIT_RTOL for x in gaps)
            for gaps in res["point_replay"].values())}
    counts = g["launches"]
    if card == "cuda":
        # one match and two label-point launches (targets, mask rows) an output
        res["checks"]["launches_ok"] = (
            counts["ms_deform_attn_bilinear"] == 6
            and counts["ms_deform_attn_bilinear_backward"] == 6
            and counts["linear_sum_assignment"] == n_out and counts["label_points"] == 2 * n_out)
        model = trainers["card"].model
        x = torch.from_numpy(np.random.RandomState(seed + 2).randn(1, 256, 512, 3).astype(
            np.float32)).cuda()
        model.eval()
        with torch.no_grad():
            out = model(x)
            masks = resize_bilinear_nchw(out["pred_masks"].float(), (256, 512))[0]
        # the instance task scores every class; the panoptic one its things
        res["postprocess_model_logits"] = postprocess_parity(
            torch, out["pred_logits"][0].float().cpu(), masks.cpu(), None)
        res["postprocess_confident_logits"] = postprocess_parity(
            torch, *confident_logits(torch, seed + 3, QUERIES, CLASSES, (512, 1024)),
            CITYSCAPES_THING_IDS)
        res["checks"]["postprocess_equal"] = all(
            v["equal"] for k in ("postprocess_model_logits", "postprocess_confident_logits")
            for v in res[k].values())
        res["checks"]["panoptic_segments_kept"] = (
            res["postprocess_confident_logits"]["panoptic"]["segments"] > 0)
    res["ok"] = bool(all(res["checks"].values()))
    return res


# the kernels the vanilla recipes' steps and evaluations must launch
INSTANCE_TRAIN_KERNELS = ("ms_deform_attn_bilinear", "ms_deform_attn_bilinear_backward",
                          "label_points", "linear_sum_assignment")
INSTANCE_RECIPES = ("instance", "panoptic", "semantic")
INSTANCE_FRAMES = {"train": 24, "val": 2}


def phase_instance_train(torch):
    """The three vanilla recipes, exps/m2f_{instance,panoptic,semantic}.yaml, at
    their own widths (R-50, 100 queries, 9 layers, 12544 points, batch 8,
    unpadded crops of 700x700 / 700x700 / 512x1024, 48 / 48 / 20 slots, bf16,
    deep supervision, 4 loader workers) through ``train()`` on a generated
    Cityscapes tree of 1024x2048 frames (``write_segments_tree``: 24 train and
    2 val frames, 40 things each), only the root and ``n_epochs`` overridden:
    one epoch of three steps (the median step is a warm one); the instance
    recipe then resumes from ``last`` for a second epoch with the saved
    optimizer state. Then ``evaluate(max_images=2)``
    at 1024x2048 for each. Per recipe: epoch seconds, images/s, the median step
    on the card, the loader's wait a step, peak memory, the launches of train
    and of evaluate, and the metrics (random weights: the values mean nothing)."""
    import tempfile

    from multishiftseg_torch.data.registry import DatasetCatalog
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.tools.synthetic_tree import write_segments_tree
    from multishiftseg_torch.train.checkpoint import CheckpointManager
    from multishiftseg_torch.train.instance_trainer import TrainM2FInstance

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    here = Path(__file__).resolve().parent
    res = {"phase": "instance_train", "card": nvidia_smi(), "frames": INSTANCE_FRAMES,
           "frame_hw": [H, W], "recipes": {}}
    totals = {"instance_eval": {}}
    ok = True

    def add(into, counts):
        for k, v in counts.items():
            into[k] = into.get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = write_segments_tree(Path(tmp) / "data", SEED + 91, frames=INSTANCE_FRAMES,
                                   hw=(H, W), things=40)["cityscapes_root"]
        res["tree_seconds"] = time.perf_counter() - t0
        for recipe in INSTANCE_RECIPES:
            def config(n_epochs):
                from multishiftseg_torch.core.config import load_config

                cfg = load_config(str(here / "exps" / f"m2f_{recipe}.yaml"))
                cfg.data.cityscapes_root = root
                cfg.train.n_epochs = n_epochs
                cfg.model_dir = str(Path(tmp) / f"ckpts_{recipe}")
                return cfg

            def measured(fn, into):
                reset_launch_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                counts = launch_counts()
                add(into, counts)
                return out, {"seconds": time.perf_counter() - t0,
                             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                             "launches": {k: v for k, v in counts.items() if v}}

            def epochs(tr):
                return [{**{k: h[k] for k in ("epoch", "steps", "seconds", "img_per_s",
                                                "step_ms_median", "loss")},
                         "loader_wait_s_per_step": h["loader_wait_s"] / h["steps"]}
                        for h in tr.history]

            t0 = time.perf_counter()
            tr = TrainM2FInstance(config(1))
            m = {"model_build_seconds": time.perf_counter() - t0,
                 "crop": list(tr.cfg.data.crop_size), "slots": tr.cfg.model.m2f.max_instances,
                 "classes": tr.cfg.model.m2f.num_classes}
            train_counts = totals[f"instance_train_{recipe}"] = {}
            first, m["train"] = measured(tr.train, train_counts)
            m["train"]["epochs"] = epochs(tr)
            checks = {"finite_loss": bool(np.isfinite(first["loss"])),
                      "three_steps": [e["steps"] for e in m["train"]["epochs"]] == [3]}
            if recipe == "instance":  # the resume: a new trainer from `last`
                del tr
                saved = CheckpointManager(config(2).model_dir).restore("last")
                tr = TrainM2FInstance(config(2))
                second, m["resume"] = measured(lambda: tr.train(resume="last"),
                                               train_counts)
                m["resume"]["epochs"] = epochs(tr)
                resumed = CheckpointManager(tr.cfg.model_dir).restore("last")
                checks["resume"] = (saved["epoch"] == 0 and saved["step"] == 3
                                    and [e["epoch"] for e in m["resume"]["epochs"]] == [1]
                                    and resumed["step"] == 6 and all(
                                        int(st["step"]) == 6
                                        for st in resumed["optimizer"]["state"].values())
                                    and bool(np.isfinite(second["loss"])))
            metrics, m["evaluate"] = measured(lambda: tr.evaluate(max_images=2),
                                              totals["instance_eval"])
            m["metrics"] = metrics
            launched = m["train"]["launches"]
            eval_l = m["evaluate"]["launches"]
            checks["train_kernels_launched"] = all(launched.get(k, 0) > 0
                                                   for k in INSTANCE_TRAIN_KERNELS)
            checks["eval_launches"] = (
                eval_l.get("ms_deform_attn_bilinear", 0) == 12
                and eval_l.get("mask_scores_semantic_classes", 0) == (
                    2 if recipe == "semantic" else 0))
            checks["metrics"] = metrics is not None and all(
                np.isnan(v) or 0.0 <= v <= 1.0 for k, v in metrics.items()
                if k in ("AP", "AP50", "AP75", "PQ", "SQ", "RQ", "mIoU", "pixel_acc"))
            m["checks"] = checks
            m["ok"] = bool(all(checks.values()))
            ok &= m["ok"]
            res["recipes"][recipe] = m
            emit({"instance_train": recipe, "card": res["card"],
                  "epochs": m["train"]["epochs"] + m.get("resume", {}).get("epochs", []),
                  "peak_mem_gib": max(m["train"]["peak_mem_gib"],
                                      m.get("resume", {}).get("peak_mem_gib", 0.0)),
                  "launches_train": launched, "launches_evaluate": eval_l,
                  "evaluate_seconds": m["evaluate"]["seconds"],
                  "metrics": {k: v for k, v in metrics.items() if k != "AP_per_class"},
                  "ok": m["ok"]})
            del tr
            torch.cuda.empty_cache()
    for name in DatasetCatalog.list():
        DatasetCatalog.remove(name)
    res["ok"] = bool(ok)
    return res, totals


# ---------------------------------------------------------------------------
# the alternate backbones and heads: Swin-L and R-101 MaskFormer, the FPN and
# transformer-encoder pixel decoders, the MaskFormer-v1 predictor, DeepV3Plus


ALT_SWIN = "swin_large"  # exps/m2f_swin_large.yaml's backbone
# the alternates' main paths, each run with the launch counts set to 0 before it
ALT_PATHS = ("alt_serve_swin_large", "alt_serve_resnet101", "alt_serve_deepv3",
             "alt_train_m2f_swin_large_stage2", "alt_train_m2f_instance_swin_large",
             "alt_train_m2f_semantic_r101")
DV3_TRUNKS = ("resnet-101", "seresnext-101")


def seeded_deepv3(torch, trunk, seed):
    """Port DeepV3Plus at full widths with seeded weights: the modules' own init,
    each residual branch's last BatchNorm scale at 0.2 (a random 100-layer trunk
    at unit scales amplifies rounding from layer to layer), and running
    statistics as :func:`seeded_deeplab`'s."""
    from multishiftseg_torch.models.deepv3_generic import DeepV3Plus

    torch.manual_seed(seed)
    model = DeepV3Plus(trunk=trunk)
    g = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in sorted(model.state_dict().items()):
            if name.endswith(("conv3.norm.weight", "bn3.weight")):
                t.mul_(0.2)
            elif name.endswith(("running_mean", "running_var")):
                noise = torch.from_numpy((0.1 * g.randn(*t.shape)).astype(np.float32))
                t.add_(noise.abs() if name.endswith("running_var") else noise)
    return model.eval()


def phase_alt_parity(torch, hw=(256, 512)):
    """The alternates in f32 (TF32 off), card (kernels) against CPU (plain
    versions) from the same weights: Swin-L and R-101 MaskFormer at full
    widths (GMA, MSDeformAttn); the three new heads at full widths and a small
    depth over R-50 (the FPN pixel decoder under the GMA decoder; the
    transformer-encoder pixel decoder under the MaskFormer-v1 predictor);
    DeepV3Plus on R-101 and SEResNeXt-101 (logits)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images = np.random.RandomState(SEED + 61).randint(0, 256, (1, *hw, 3)).astype(np.uint8)
    res = {"phase": "alt_parity", "image_hw": list(hw), "dtype": "float32", "tf32": False,
           "models": {}}
    small = dict(dec_layers=3, transformer_enc_layers=2)
    for seed, (name, cfg) in enumerate((
            ("swin_large_msdeformattn_gma", dict(backbone=ALT_SWIN)),
            ("resnet101_msdeformattn_gma", dict(backbone="resnet101")),
            ("resnet50_fpn_gma_3_layers", dict(small, pixel_decoder="fpn")),
            ("resnet50_transformer_encoder_standard_3_layers",
             dict(small, pixel_decoder="transformer_encoder", predictor="standard")))):
        res["models"][name] = maskformer_parity(
            torch, seeded_model(torch, SEED + 62 + seed, **cfg), images)
    from multishiftseg_torch.models.maskformer import preprocess

    x = preprocess(torch.from_numpy(images)).permute(0, 3, 1, 2)
    for seed, trunk in enumerate(DV3_TRUNKS):
        model = seeded_deepv3(torch, trunk, SEED + 70 + seed)
        with torch.no_grad():
            want = model(x)
            got = copy.deepcopy(model).cuda()(x.cuda()).cpu()
        torch.cuda.empty_cache()
        err = float((got - want).abs().max() / want.abs().max())
        res["models"][f"deepv3plus_{trunk}"] = {"logits_rel_err": err,
                                                "ok": bool(err <= 1e-3 and got.shape == want.shape)}
    res["ok"] = all(m["ok"] for m in res["models"].values())
    return res


def phase_alt_serve(torch, requests=3):
    """One request path per alternate at 1024x2048, batch 1, bf16:
    ``build_m2f_request_forward`` (``bilinear``) on the Swin-L and the R-101
    MaskFormer (GMA, full widths; bf16 weights, as ``serve``), and DeepV3Plus on
    SEResNeXt-101 (bf16 autocast over f32 weights), each 3 requests after 2
    warm-up: latency, launches (6 deformable forwards, one anomaly and one
    semantic tail a MaskFormer request; 3 dilated convs a DeepV3Plus one, and
    nothing else), peak memory, one profiled request (device busy share, top
    kernels); for Swin-L the profiled request also holds each window attention
    in a range, and gives the device time of the kernels they launch and its
    share of the request's busy time."""
    from multishiftseg_torch.models.maskformer import preprocess
    from multishiftseg_torch.models.swin import WindowAttention
    from multishiftseg_torch.train.test_runner import build_m2f_request_forward

    torch.backends.cudnn.allow_tf32 = True
    g = np.random.RandomState(SEED + 63)
    images = [g.randint(0, 256, (1, H, W, 3)).astype(np.uint8) for _ in range(requests)]
    res = {"phase": "alt_serve", "image_hw": [H, W], "batch": 1, "models": {}}
    counts_by_path, ok = {}, True
    for name, backbone in (("swin_large", ALT_SWIN), ("resnet101", "resnet101")):
        model = seeded_model(torch, SEED + 64, backbone=backbone).to(torch.bfloat16)
        fwd = build_m2f_request_forward(model)
        r, counts, _ = serve_requests(torch, fwd, images)
        want = {"ms_deform_attn_bilinear": 6 * requests, "mask_scores_anomaly": requests,
                "mask_scores_semantic": requests}
        r["launches_per_image_ok"] = {k: v for k, v in counts.items() if v} == want
        with module_ranges(model, WindowAttention, "window_attention"):
            r["profiled_request"] = profile_request(torch, fwd, images[0], focus=FWD_FOCUS,
                                                    ranges=("window_attention",))
        r["model"] = f"MaskFormer {backbone} MSDeformAttn+GMA, full widths"
        r["dtype"] = "bfloat16 weights"
        r["ok"] = bool(r["finite"] and r["launches_per_image_ok"]
                       and r["shapes"] == [[1, H, W], [1, CLASSES + QUERIES, H, W]])
        ok &= r["ok"]
        res["models"][name] = r
        counts_by_path[f"alt_serve_{name}"] = counts
        del model, fwd
        torch.cuda.empty_cache()
    model = seeded_deepv3(torch, DV3_TRUNKS[1], SEED + 65).cuda()

    @torch.inference_mode()
    def dv3(im):
        x = preprocess(torch.from_numpy(im).cuda()).permute(0, 3, 1, 2)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            return (model(x),)

    r, counts, _ = serve_requests(torch, dv3, images)
    r["launches_per_image_ok"] = {k: v for k, v in counts.items() if v} == {
        "dilated_conv3x3": 3 * requests}
    r["profiled_request"] = profile_request(torch, dv3, images[0], focus="dconv")
    r.update(model=f"DeepV3Plus {DV3_TRUNKS[1]}, full widths",
             dtype="bfloat16 autocast, f32 weights")
    r["ok"] = bool(r["finite"] and r["launches_per_image_ok"]
                   and r["shapes"] == [[1, CLASSES, H, W]])
    ok &= r["ok"]
    res["models"]["deepv3plus_seresnext101"] = r
    counts_by_path["alt_serve_deepv3"] = counts
    res["ok"] = bool(ok)
    return res, counts_by_path


def largest_batch_that_fits(torch, make, sizes):
    """``make(b)`` -> (result, counts) at the first of ``sizes`` (descending)
    that does not run out of device memory; the sizes that did are listed."""
    oom = []
    for b in sizes:
        try:
            r, counts = make(b)
            r["batch_cut_from"] = oom
            return r, counts
        except torch.cuda.OutOfMemoryError:
            oom.append(b)
            torch.cuda.empty_cache()
    return {"ok": False, "out_of_memory_at": oom}, {}


def phase_alt_train(torch):
    """The alternates' training steps at full widths on the card (bf16
    autocast, f32 master weights), 1 warm-up and 2 timed steps each:
    exps/m2f_swin_large.yaml's stage-2 step (exps/m2f.yaml's 8 pairs of
    700x700 crops padded to 704, every parameter trained, the backbone too,
    with drop path; the phase fails if it does not fit, the batch the
    stage-2 kernels' rows hold); exps/m2f_instance_swin_large.yaml's step (8
    unpadded 700x700 crops, 48 slots, drop path); exps/m2f_semantic_r101.yaml's
    step (8 crops of 512x1024, 20 slots). Where 80 GB does not hold the
    recipe's batch, the largest batch that does, with the cut listed."""
    from multishiftseg_torch.models.maskformer import maskformer_from_config
    from multishiftseg_torch.train.instance_trainer import TrainM2FInstance
    from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD, synthetic_batch

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"phase": "alt_train", "dtype": "bfloat16 autocast, f32 master weights",
           "recipes": {}}
    counts_by_path = {}

    def stage2(pairs):
        cfg = instance_config("swin_large", pairs, CROP, bf16=True)
        tr = TrainM2FOOD(cfg, model=seeded(torch, maskformer_from_config(cfg.model.m2f),
                                           SEED + 66).train(), device="cuda")
        tr.set_stage(1)
        batch = [torch.from_numpy(x).cuda() for x in synthetic_batch(pairs, CROP, CLASSES,
                                                                     SEED + 67)]
        try:
            r, counts = timed_steps(torch, lambda: tr.stage2_step(*batch))
        finally:
            del tr, batch
        r.update(images_per_step=2 * pairs, crop=list(CROP), padded=list(TRAIN_HW))
        return r, counts

    def vanilla(recipe, crop, slots, seed):
        def make(batch):
            cfg = instance_config(recipe, batch, crop, bf16=True)
            tr = TrainM2FInstance(cfg, model=seeded(torch, maskformer_from_config(
                cfg.model.m2f), seed).train(), dataset_name="unused", device="cuda")
            data = instance_batch(batch, crop, slots, seed + 1)
            try:
                r, counts = timed_steps(torch, lambda: tr.step(*data))
            finally:
                del tr
            r.update(images_per_step=batch, crop=list(crop), slots=slots)
            return r, counts
        return make

    for name, make, sizes in (
            ("m2f_swin_large_stage2", stage2, (TRAIN_PAIRS,)),
            ("m2f_instance_swin_large", vanilla("instance_swin_large", CROP, INST_SLOTS,
                                                SEED + 68), (INST_BATCH, 6, 4, 2)),
            ("m2f_semantic_r101", vanilla("semantic_r101", (512, 1024), 20, SEED + 71),
             (INST_BATCH, 6, 4, 2))):
        r, counts = largest_batch_that_fits(torch, make, sizes)
        torch.cuda.empty_cache()
        r["training_kernels_ok"] = all(counts.get(k, 0) > 0 for k in (
            "ms_deform_attn_bilinear", "ms_deform_attn_bilinear_backward",
            "linear_sum_assignment", "label_points"))
        r["ok"] = bool(r.get("finite") and r["training_kernels_ok"])
        res["recipes"][name] = r
        counts_by_path[f"alt_train_{name}"] = counts
    res["ok"] = all(r["ok"] for r in res["recipes"].values())
    return res, counts_by_path


# ---------------------------------------------------------------------------
# dp_train: the data-parallel path (multishiftseg_torch/core/mesh.py)

DP_RECIPES = ("deeplab", "m2f", "instance")
# the global bottom-k's inputs: the augmented half's CE values of
# exps/deeplab.yaml's step (8 x 700 x 700), split over the ranks
DP_BOTTOM_K_N = DL_TRAIN_PAIRS * DL_CROP[0] * DL_CROP[1]


def dp_setup(torch, name, full, dtype=None, bf16=None, tp=1):
    """One of dp_train's recipes at full widths on the card from seeded weights:
    (trainer, ``step()`` -> (loss, components)), the step on this process's
    rows of the recipe's global batch (its Loader shard) with the global
    draws of the trainer's generator. ``full``: the recipe's batch and crops in
    bf16 autocast (DeepLab's stage 2, M2F R-50's stage 2, the instance step;
    ``bf16=False`` in f32); else the parity batch (2 pairs, 2 images) and
    crops in ``dtype``. Inside a process group the trainer wraps the model in
    DDP. ``tp > 1``: ``train.model_parallel = tp`` with every shard on
    ``cuda:0`` (the ``tensor_parallel`` phase)."""
    from multishiftseg_torch.core.mesh import local_batch_slice
    from multishiftseg_torch.models.maskformer import maskformer_from_config
    from multishiftseg_torch.train.deeplab_trainer import TrainDeepLabOOD
    from multishiftseg_torch.train.instance_trainer import TrainM2FInstance
    from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD, synthetic_batch

    bf16 = full if bf16 is None else bf16
    shards = [torch.device("cuda", 0)] * tp if tp > 1 else None

    def rows(arrays, n):
        return [torch.from_numpy(np.ascontiguousarray(a[local_batch_slice(n)])).cuda()
                for a in arrays]

    if name == "deeplab":
        pairs, crop = (DL_TRAIN_PAIRS, DL_CROP) if full else (2, (200, 200))
        cfg = deeplab_config(pairs, crop, bf16=bf16)
        cfg.train.model_parallel = tp
        tr = TrainDeepLabOOD(cfg, model=seeded_deeplab(torch, SEED + 111), device="cuda",
                             tp_devices=shards)
        data = rows(synthetic_batch(pairs, crop, CLASSES, SEED + 112), pairs)
        stage, step = 1, lambda: tr.step(*data)
    elif name == "m2f":
        pairs, crop = (TRAIN_PAIRS, CROP) if full else (2, (256, 256))
        cfg = train_config(pairs, crop, bf16=bf16)
        cfg.train.model_parallel = tp
        tr = TrainM2FOOD(cfg, model=seeded_model(torch, SEED + 113).train(), device="cuda",
                         tp_devices=shards)
        data = rows(synthetic_batch(pairs, crop, CLASSES, SEED + 114), pairs)
        stage, step = 1, lambda: tr.stage2_step(*data)[:2]
    else:
        b, crop = (INST_BATCH, CROP) if full else (2, (200, 200))
        cfg = instance_config("instance", b, crop, bf16=bf16)
        torch.manual_seed(SEED + 115)  # the modules' own init, then the noise
        tr = TrainM2FInstance(cfg, model=seeded(torch, maskformer_from_config(cfg.model.m2f),
                                                SEED + 115).train(),
                              dataset_name="unused", device="cuda")
        data = rows(instance_batch(b, crop, INST_SLOTS, SEED + 116), b)
        stage, step = 0, lambda: tr.step(*data)[:2]
    if dtype is not None:
        tr.model.to(dtype)  # in place, before the stage's optimizer and DDP wrap
    tr.set_stage(stage)
    return tr, step


def dp_record(tr, out, grads=True):
    """(loss, components) of a step and, with ``grads``, its gradients (CPU)."""
    loss, parts = out
    rec = {"loss": float(loss), "parts": {k: float(v) for k, v in parts.items()}}
    if grads:
        rec["grads"] = {n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()
                        if p.grad is not None}
    return rec


def dp_compare(single, dp, loss_rtol, grad_rtol):
    """The data-parallel step against the single-process one: the loss and
    components within ``loss_rtol``, and all gradients together within
    ``grad_rtol`` in L2 (a tensor whose entries cancel, as a BatchNorm bias's
    sum, or one below a ReLU input within rounding of 0, moves alone by more;
    the worst tensor, against its own scale, is reported)."""
    worst = max((abs(dp["parts"][k] - v) / max(abs(v), 1e-12)
                 for k, v in single["parts"].items()), default=0.0)
    loss_err = abs(dp["loss"] - single["loss"]) / max(abs(single["loss"]), 1e-12)
    same_set = set(dp["grads"]) == set(single["grads"])
    num = den = tensor_err = 0.0
    worst_name = None
    for n, g in single["grads"].items():
        d = (dp["grads"][n].double() - g.double()) if n in dp["grads"] else g.double()
        num += float(d.pow(2).sum())
        den += float(g.double().pow(2).sum())
        e = float(d.abs().max()) / max(float(g.abs().max()), 1e-30)
        if e > tensor_err:
            tensor_err, worst_name = e, n
    grad_l2 = (num / max(den, 1e-300)) ** 0.5
    return {"loss_rel_err": loss_err, "parts_rel_err": worst, "grad_rel_l2": grad_l2,
            "worst_tensor_rel_err": tensor_err, "worst_tensor": worst_name,
            "same_trainable_set": same_set,
            "ok": bool(same_set and loss_err <= loss_rtol and worst <= loss_rtol
                       and grad_l2 <= grad_rtol)}


def dp_step_times(torch, step, warmup=1, timed=3):
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def dp_bottom_k_inputs(torch, n, seed):
    """The global bottom-k's global inputs, made alike on every rank: CE-like
    values, a fifth invalid (+inf keys), and select_num 0.8 of the valid."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    vals = -torch.rand(n, generator=gen, device="cuda").log() * 2
    valid = torch.rand(n, generator=gen, device="cuda") > 0.2
    keyed = torch.where(valid, vals, torch.full_like(vals, float("inf")))
    return vals, keyed, (0.8 * valid.sum()).to(torch.int32)


def dp_bottom_k_check(torch, seed=SEED + 117):
    """The global bottom-k's kernels against its plain version on this rank's
    share of the global inputs (main-path size, then ties and select_num 0 at
    5003 elements): the sum within f32 rounding, the threshold the k-th
    smallest key of all ranks', the gradient weights exactly."""
    from multishiftseg_torch.core.mesh import local_batch_slice
    from multishiftseg_torch.losses import rcl

    out = {}
    cases = [("main_shapes", *dp_bottom_k_inputs(torch, DP_BOTTOM_K_N, seed))]
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    q = torch.floor(torch.rand(5004, generator=gen, device="cuda") * 40) / 16
    ok_ = torch.rand(5004, generator=gen, device="cuda") > 0.25
    kq = torch.where(ok_, q, torch.full_like(q, float("inf")))
    cases += [("ties", q, kq, (0.8 * ok_.sum()).to(torch.int32)),
              ("select_num_0", q, kq, torch.zeros((), dtype=torch.int32, device="cuda"))]
    for case, vals, keyed, sn in cases:
        part = local_batch_slice(vals.numel())
        res = []
        for fn in (rcl.bottom_k_sum_global, rcl.bottom_k_sum_global_plain):
            v = vals[part].clone().requires_grad_()
            s = (rcl._GlobalBottomKSum.apply if fn is rcl.bottom_k_sum_global else fn)(
                v, keyed[part].contiguous(), sn)
            s.backward()
            res.append((float(s), v.grad))
        _, threshold, _ = rcl.bottom_k_sum_global_cuda(vals[part], keyed[part].contiguous(), sn)
        bits = keyed.view(torch.int32).long() & 0xFFFFFFFF
        kth = int(torch.sort(bits).values[int(sn) - 1]) if int(sn) > 0 else 0
        err = abs(res[0][0] - res[1][0])
        out[case] = {"sum": res[0][0], "plain_sum": res[1][0], "max_abs_err": err,
                     "threshold_equal_kth_key": (int(threshold) & 0xFFFFFFFF) == kth,
                     "grad_equal": bool(torch.equal(res[0][1], res[1][1])),
                     "ok": bool(err <= 1e-6 * max(abs(res[1][0]), 1.0)
                                and torch.equal(res[0][1], res[1][1])
                                and (int(threshold) & 0xFFFFFFFF) == kth)}
    return out


def dp_rank_param_diff(torch, model):
    """The largest difference between this rank's parameters and rank 0's."""
    import torch.distributed as dist

    diff = 0.0
    for p in model.parameters():
        t = p.detach().clone()
        dist.broadcast(t, 0)
        diff = max(diff, float((t - p.detach()).abs().max()))
    return diff


def dp_rank(rank, root, port, out_dir):
    """One of dp_train's two gloo ranks on the one card (``cuda:0``): the global
    bottom-k check, then each recipe's f32 step on its rows of the global
    batch with its launches (the counts set to 0 just before); rank 0 keeps
    the gradients."""
    sys.path.insert(0, root)
    import torch

    from multishiftseg_torch.core.mesh import initialize_distributed, shutdown_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(backend="gloo", init_method=f"tcp://localhost:{port}",
                           world_size=2, rank=rank, local_rank=0)
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts

    try:
        out = {"bottom_k": dp_bottom_k_check(torch), "recipes": {}}
        for name in DP_RECIPES:
            tr, step = dp_setup(torch, name, False)
            reset_launch_counts()
            rec = dp_record(tr, step(), grads=rank == 0)
            rec["launches"] = launch_counts()
            rec["rank_param_diff"] = dp_rank_param_diff(torch, tr.model)
            out["recipes"][name] = rec
            del tr, step
            torch.cuda.empty_cache()
        torch.save(out, str(Path(out_dir) / f"rank{rank}.pt"))
    finally:
        shutdown_distributed()


def dp_kernel_row(torch):
    """The global bottom-k's row of the kernels line, inside the world-1 NCCL
    group: its kernels against its plain version at the main-path size (every
    all-reduce a single rank's), timed as the single-process row. Its
    launches are those of the two-rank DeepLab steps (a world of 1 takes the
    single-process route)."""
    from multishiftseg_torch.losses import rcl

    vals, keyed, sn = dp_bottom_k_inputs(torch, DP_BOTTOM_K_N, SEED + 118)
    run = lambda: rcl.bottom_k_sum_global(vals, keyed, sn)
    plain = lambda: rcl.bottom_k_sum_global_plain(vals, keyed, sn)
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs())
    b_ms, b_by = bound(nbytes(vals, keyed, sn, got), 2 * DP_BOTTOM_K_N)
    k_host = int(sn)
    row = {"name": "bottom_k_sum_global", "route": "cuda",
           "source": "multishiftseg_torch/csrc/bottom_k.cu",
           "replaces": "multishiftseg_tpu/losses/rcl.py:65",
           "counter": "bottom_k_sum_global", "paths": ("dp_train_two_ranks",),
           "max_abs_err": err, "ms": median_ms(torch, run, 20),
           "plain_ms": median_ms(torch, plain, 5), "bound_ms": b_ms, "bound_by": b_by,
           # as the single-process row's: torch.topk of the k smallest, summed
           "library_ms": median_ms(
               torch, lambda: torch.topk(keyed, k_host, largest=False).values.sum(), 20)}
    time_redesigned(torch, row, run)
    with torch.no_grad():
        row["device_kernels"] = device_kernels(torch, run)
    return row, err <= 1e-6 * max(float(want.abs()), 1.0)


def dp_batch_norm_routes(torch, step):
    """The world-1 DP DeepLab step on its BatchNorms' two routes: the
    single-process one (``F.batch_norm``), which a world of 1 takes, and the
    global one of a larger world
    (``models.layers._GlobalBatchNorm``: the fused statistics, one all-gather
    and one all-reduce a BatchNorm, here a single rank's), forced by patching
    ``models.layers.spans_ranks``. Each: 3 timed steps and one profiled step
    (device busy ms, the device ms of the kernels named ``batch_norm``
    (torch's native ones, which both routes run on channels-last bf16), ``bn_``
    (cuDNN's) and ``nccl``)."""
    from multishiftseg_torch.models import layers

    real = getattr(layers, "spans_ranks", None)
    out = {}
    for label, forced in (("single", False), ("global", True)):
        if forced:
            layers.spans_ranks = lambda: True
        try:
            times = dp_step_times(torch, step)
            prof = profile_request(torch, lambda _: step(), None,
                                   focus=("batch_norm", "bn_", "nccl"))
        finally:
            if real is None:
                layers.__dict__.pop("spans_ranks", None)
            else:
                layers.spans_ranks = real
        out[label] = {"step_ms": times, **{k: prof[k] for k in (
            "wall_ms", "device_busy_ms", "device_busy_share", "device_events", "launch_calls",
            "batch_norm_ms", "bn__ms", "nccl_ms", "top_kernels")}}
    out["global_over_single"] = (statistics.median(out["global"]["step_ms"])
                                 / statistics.median(out["single"]["step_ms"]))
    return out


def phase_dp_train(torch):
    """The data-parallel path. (a) A world of 1 over NCCL (``core.mesh``): at
    full widths and the recipes' batches in bf16, DeepLab's stage-2 step, the
    M2F R-50 stage-2 step and the instance step through DDP (a world of 1
    takes the single-process reductions: ``F.batch_norm``, the one-launch
    bottom-k, which must run), each held to the single-process step from the
    same weights, batch and draws: in f32 with TF32 off (loss and components
    within 1e-4, all gradients within 1e-2 in L2, as in (b)), and in bf16 as
    the recipes train (loss and components within 2e-3), with both bf16
    steps' times; DeepLab's DP step with its BatchNorms on that route and
    forced onto the global one (:func:`dp_batch_norm_routes`); and the global
    bottom-k's kernel row. (b) Two ranks on the one card over gloo (NCCL
    refuses two ranks on one device): each recipe's f32 step (TF32 off) of
    its parity batch split in two against the single-process step of the
    same global batch: loss and components within 1e-4, all gradients within
    1e-2 in L2 (f32 rounding takes other ReLU branches at a few units, which
    moves single tensors: DeepLab's ASPP by 1.5e-2 of scale, 1.4e-3 in L2;
    the worst tensor is reported), both ranks ending with the
    same parameters, rank 0's DeepLab step launching the global bottom-k
    (path ``dp_train_two_ranks``); and in each rank the global bottom-k's
    kernels against their plain version. The kernels take f32 and bf16 only,
    so there is no
    float64 step on the card; the CPU tests hold the two-rank float64 steps
    to the single-process ones."""
    import tempfile

    import torch.multiprocessing as mp

    from multishiftseg_torch.core.mesh import initialize_distributed, shutdown_distributed
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"phase": "dp_train", "world_1": {}, "two_ranks": {}}
    counts_by_path = {}
    def f32_step(name):  # the recipe's step in f32, TF32 off
        torch.backends.cudnn.allow_tf32 = False
        tr, step = dp_setup(torch, name, True, bf16=False)
        rec = dp_record(tr, step())
        torch.backends.cudnn.allow_tf32 = True
        return rec

    single, single_f32 = {}, {}
    for name in DP_RECIPES:
        tr, step = dp_setup(torch, name, True)
        single[name] = dp_record(tr, step(), grads=False)
        single[name]["step_ms"] = dp_step_times(torch, step)
        del tr, step
        single_f32[name] = f32_step(name)
        torch.cuda.empty_cache()
    initialize_distributed(backend="nccl", init_method=f"tcp://localhost:{free_port()}",
                           world_size=1, rank=0)
    try:
        for name in DP_RECIPES:
            cmp = dp_compare(single_f32[name], f32_step(name), 1e-4, 1e-2)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tr, step = dp_setup(torch, name, True)
            dp = dp_record(tr, step(), grads=False)
            bf16 = dp_compare({**single[name], "grads": {}}, {**dp, "grads": {}}, 2e-3, 0.0)
            step()
            torch.cuda.synchronize()
            reset_launch_counts()
            dp["step_ms"] = dp_step_times(torch, step, warmup=0)
            counts_by_path[f"dp_train_{name}"] = launch_counts()
            res["world_1"][name] = {
                "f32": cmp, "bf16_loss_rel_err": bf16["loss_rel_err"],
                "bf16_parts_rel_err": bf16["parts_rel_err"], "ok": cmp["ok"] and bf16["ok"],
                "single_step_ms": single[name]["step_ms"], "dp_step_ms": dp["step_ms"],
                "dp_over_single": statistics.median(dp["step_ms"])
                / statistics.median(single[name]["step_ms"]),
                "dp_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "wrapped_in_ddp": type(tr.train_model).__name__ == "DistributedDataParallel",
                "launches": {k: v for k, v in counts_by_path[f"dp_train_{name}"].items() if v}}
            if name == "deeplab":
                res["world_1"]["deeplab_batch_norm_routes"] = dp_batch_norm_routes(torch, step)
            del tr, step
            torch.cuda.empty_cache()
        row, row_ok = dp_kernel_row(torch)
    finally:
        shutdown_distributed()
    res["kernel_row"] = row
    # a world of 1 takes the single-process bottom-k, one a step
    res["world_1"]["single_route_bottom_k"] = counts_by_path["dp_train_deeplab"].get(
        "bottom_k_sum", 0) == 3 and counts_by_path["dp_train_deeplab"].get(
        "bottom_k_sum_global", 0) == 0

    # (b) the single-process steps of the parity batches, then two ranks
    torch.backends.cudnn.allow_tf32 = False
    ranks = []
    try:
        ref = {}
        for name in DP_RECIPES:
            tr, step = dp_setup(torch, name, False)
            ref[name] = dp_record(tr, step())
            del tr, step
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(dp_rank, args=(str(Path(sys.path[0]).resolve()), free_port(), tmp),
                     nprocs=2, join=True)
            ranks = [torch.load(str(Path(tmp) / f"rank{r}.pt"), weights_only=False)
                     for r in range(2)]
        res["two_ranks"]["seconds"] = time.perf_counter() - t0
        for name, want in ref.items():
            got = ranks[0]["recipes"][name]
            cmp = dp_compare(want, got, 1e-4, 1e-2)
            cmp["rank_param_diff"] = max(r["recipes"][name]["rank_param_diff"] for r in ranks)
            cmp["ok"] = bool(cmp["ok"] and cmp["rank_param_diff"] == 0.0)
            res["two_ranks"][name] = cmp
        res["two_ranks"]["bottom_k"] = {f"rank{i}": r["bottom_k"] for i, r in enumerate(ranks)}
        # rank 0's steps, each with the counts set to 0 just before it
        two = {}
        for name in DP_RECIPES:
            for k, v in ranks[0]["recipes"][name]["launches"].items():
                two[k] = two.get(k, 0) + v
        counts_by_path["dp_train_two_ranks"] = two
        res["two_ranks"]["launches"] = {k: v for k, v in two.items() if v}
        deeplab = ranks[0]["recipes"]["deeplab"]["launches"]
        res["two_ranks"]["global_bottom_k_launched"] = (
            deeplab.get("bottom_k_sum_global", 0) == 1 and deeplab.get("bottom_k_sum", 0) == 0)
    except Exception as e:  # (a) stands reported; the phase fails
        res["two_ranks"]["error"] = f"{type(e).__name__}: {e}"[-2000:]
    res["checks"] = {
        "world_1_steps_match": all(res["world_1"][n]["ok"] for n in DP_RECIPES),
        "world_1_ddp": all(res["world_1"][n]["wrapped_in_ddp"] for n in DP_RECIPES),
        "world_1_single_route_bottom_k": res["world_1"]["single_route_bottom_k"],
        "two_rank_global_bottom_k_launched": bool(ranks) and res["two_ranks"][
            "global_bottom_k_launched"],
        "kernel_row_matches_plain": row_ok,
        "two_rank_steps_match": bool(ranks) and all(res["two_ranks"][n]["ok"]
                                                    for n in DP_RECIPES),
        "two_rank_bottom_k_matches_plain": bool(ranks) and all(
            c["ok"] for r in ranks for c in r["bottom_k"].values())}
    res["ok"] = bool(all(res["checks"].values()))
    return res, counts_by_path


# ---------------------------------------------------------------------------
# the serving artifact and GPipe

DEPLOY_REQUESTS = 3
# a fresh process that imports the serving module and nothing else of the
# port: serves the artifact's requests, then reports and saves what it got
SERVE_SCRIPT = r"""
import json, sys, time
import numpy as np
import torch
root, prefix, seed, requests, warmup = sys.argv[1:6]
sys.path.insert(0, root)
from multishiftseg_torch.deploy import ServingModel
t0 = time.perf_counter()
model = ServingModel(prefix)
load_s = time.perf_counter() - t0
n, h, w, _ = model.input_shape
images = np.random.RandomState(int(seed)).rand(int(warmup) + int(requests), 1, h, w, 3)
images = images.astype(np.float32)
for im in images[:int(warmup)]:
    model(im)
torch.cuda.synchronize()
from multishiftseg_torch.ops import reset_launch_counts, launch_counts
reset_launch_counts()
lat = []
for im in images[int(warmup):]:
    t0 = time.perf_counter()
    out = model(im)  # returns numpy: the copy back synchronises
    lat.append((time.perf_counter() - t0) * 1e3)
counts = launch_counts()
# the program alone on a device-resident batch (no host copies), synchronised
buf = torch.from_numpy(images[-1]).to(model.device)
prog = []
with torch.inference_mode():
    for _ in range(int(requests)):
        t0 = time.perf_counter()
        model._module(model.weights, buf)
        torch.cuda.synchronize()
        prog.append((time.perf_counter() - t0) * 1e3)
np.savez(prefix + "_served.npz", first=out[0], second=out[1])
banned = sorted(m for m in sys.modules if m.startswith(("multishiftseg_torch.models",
                "multishiftseg_torch.train", "multishiftseg_torch.core.config", "jax",
                "multishiftseg_tpu")))
print(json.dumps({"load_s": load_s, "latency_ms": lat, "program_ms": prog,
                  "launches": counts,
                  "banned_modules": banned, "device": str(model.device),
                  "input_shape": list(model.input_shape)}))
"""


def deploy_family(torch, family, tmp, cfg_path, expected):
    """Export one family with the CLI (``python -m multishiftseg_torch.deploy``'s
    ``main``, random weights from the recipe's seed, 1024x2048, batch 1, for
    the card); serve it from a fresh process (:data:`SERVE_SCRIPT`); serve
    the same images through the eager forward (``build_*_forward``) on the
    artifact's own weights, and compare the last request's outputs. Returns
    (result, the served requests' launch counts)."""
    import subprocess

    from multishiftseg_torch import deploy
    from multishiftseg_torch.core.config import load_config
    from multishiftseg_torch.train.test_runner import build_deeplab_forward, build_m2f_forward

    prefix = str(tmp / family)
    cwd = os.getcwd()
    os.chdir(tmp)  # the config loader writes ckpts/ and outputs/ under the working directory
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        deploy.main(["--model", family, "--cfg", cfg_path, "--height", str(H), "--width",
                     str(W), "--batch", "1", "--device", "cuda", "--out", prefix])
        export_s = time.perf_counter() - t0
        cfg = load_config(cfg_path, "deploy_eager")
    finally:
        os.chdir(cwd)
    # the artifact loaded once in this process (a load takes 10-20 s): its
    # program inspected here, then timed against the eager forward
    loaded = deploy.ServingModel(prefix)
    ep = loaded.exported
    program_weights = len(ep.state_dict)
    nodes = [n for gm in ep.graph_module.modules() if isinstance(gm, torch.fx.GraphModule)
             for n in gm.graph.nodes if n.op == "call_function"]
    calls = sorted({str(n.target) for n in nodes if str(n.target).startswith("mss.")})
    # the forward's bf16 autocast region, kept in the program as a
    # wrap_with_autocast call (device, dtype, enabled, ...)
    autocast = [list(map(str, n.args[:3])) for n in nodes
                if str(n.target) == "wrap_with_autocast"]
    del ep, nodes
    seed = SEED + (61 if family == "m2f" else 62)
    root = str(Path(multishiftseg_root()).resolve())
    proc = subprocess.run([sys.executable, "-c", SERVE_SCRIPT, root, prefix, str(seed),
                           str(DEPLOY_REQUESTS), str(SERVE_WARMUP)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        return {"family": family, "ok": False, "error": proc.stderr[-3000:]}, {}
    served = json.loads(proc.stdout.strip().splitlines()[-1])

    # the eager forward on the artifact's weights and the same images
    weights = deploy.load_pytree_npz(prefix + ".npz")
    mean = torch.tensor(cfg.data.mean, dtype=torch.float32, device="cuda")
    std = torch.tensor(cfg.data.std, dtype=torch.float32, device="cuda")
    if family == "m2f":
        from multishiftseg_torch.models.maskformer import maskformer_from_config

        model = maskformer_from_config(cfg.model.m2f)
        model.load_state_dict(weights)
        fwd = build_m2f_forward(cfg, model=model, device="cuda")
    else:
        from multishiftseg_torch.models.deeplab import DeepWV3Plus

        model = DeepWV3Plus(num_classes=cfg.data.class_num)
        model.load_state_dict(weights)
        fwd = build_deeplab_forward(cfg, model=model, device="cuda")
    images = np.random.RandomState(seed).rand(SERVE_WARMUP + DEPLOY_REQUESTS, 1, H, W, 3)
    images = images.astype(np.float32)
    eager = lambda x: fwd((x - mean) / std)  # x: [0, 1] images on the card
    for im in images[:SERVE_WARMUP]:
        eager(torch.from_numpy(im).cuda())
    torch.cuda.synchronize()
    lat = []
    for im in images[SERVE_WARMUP:]:
        x = torch.from_numpy(im).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eager(x)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    # M2F: (anomaly, sem); DeepLab: (score, logit NCHW), as the artifact's outputs
    want = [o.float().cpu().numpy() for o in out]
    ab = program_against_eager(torch, loaded, eager, torch.from_numpy(images[-1]).cuda())
    with np.load(prefix + "_served.npz") as z:
        got = [z["first"], z["second"]]
    errs = [float(np.abs(g - w).max()) for g, w in zip(got, want)]
    scales = [float(np.abs(w).max()) for w in want]
    # the same kernels on the same weights and inputs. M2F: bit for bit (1e-6
    # of each output's scale). DeepLab: cuDNN picks other algorithms for the
    # bf16 convolutions on the eager model's channels-last weights than on the
    # program's contiguous ones: 4.0e-3 of scale measured (H100, 700 W), 5e-3
    tol = {"m2f": 1e-6, "deeplab": 5e-3}[family]
    counts = served["launches"]
    want_counts = {k: v * DEPLOY_REQUESTS for k, v in expected.items()}
    counts_ok = all(counts.get(k, 0) == v for k, v in want_counts.items()) and all(
        v == 0 for k, v in counts.items() if k not in want_counts)
    checks = {"program_holds_no_weights": program_weights == 0,
              "program_autocasts_bf16": ["cuda", "torch.bfloat16", "True"] in autocast,
              "serving_process_imports_no_models_or_train": not served["banned_modules"],
              "launches_ok": counts_ok,
              "matches_eager": all(e <= tol * max(sc, 1.0) for e, sc in zip(errs, scales)),
              "finite": bool(all(np.isfinite(g).all() for g in got))}
    res = {"family": family, "config": cfg_path.split("/")[-1], "image_hw": [H, W],
           "batch": 1, "export_s": export_s, "pt2_bytes": os.path.getsize(prefix + ".pt2"),
           "npz_bytes": os.path.getsize(prefix + ".npz"), "ops_in_program": calls,
           "autocast_regions": autocast,
           # a served request: numpy in, the padded copy to the card, the
           # program, both outputs back to numpy; the program alone on a
           # batch already on the card; the eager forward on a batch on the
           # card, outputs left there
           "served_latency_ms": served["latency_ms"], "program_ms": served["program_ms"],
           "eager_latency_ms": lat, "in_process_ab": ab,
           "served_load_s": served["load_s"], "served_launches": counts,
           "max_abs_err": errs, "output_scale": scales, "tolerance_of_scale": tol,
           "checks": checks, "ok": bool(all(checks.values()))}
    return res, counts


def program_against_eager(torch, served, eager, image, rounds=3):
    """The loaded program (on a batch already on the card) and the eager
    forward in one process, in turns (program, eager, eager, program) for
    ``rounds`` rounds, each call synchronised, and one profile of each."""
    prog = lambda im: served._module(served.weights, im)
    times = {"program_ms": [], "eager_ms": []}
    with torch.inference_mode():
        for f in (prog, eager):
            f(image)
        for _ in range(rounds):
            for name, f in (("program_ms", prog), ("eager_ms", eager), ("eager_ms", eager),
                            ("program_ms", prog)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                f(image)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
        for name, f in (("program", prog), ("eager", eager)):
            times[f"{name}_profile"] = profile_request(torch, f, image, focus=FWD_FOCUS)
    return times


def multishiftseg_root():
    import multishiftseg_torch

    return Path(multishiftseg_torch.__file__).resolve().parent.parent


def phase_deploy(torch):
    """``deploy``: the serving artifact of M2F R-50 (Mask2Anomaly heads,
    exps/m2f.yaml) and DeepLab v3+ WRN-38 (exps/deeplab.yaml) at 1024x2048."""
    import tempfile

    root = Path(__file__).resolve().parent / "exps"
    res = {"phase": "deploy", "families": {}}
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for family, expected in (
                ("m2f", {"ms_deform_attn_bilinear": 6, "mask_scores_anomaly": 1,
                         "mask_scores_semantic": 1}),
                ("deeplab", {"dilated_conv3x3": 3})):
            r, c = deploy_family(torch, family, Path(tmp), str(root / f"{family}.yaml"),
                                 expected)
            res["families"][family] = r
            counts[f"deploy_{family}"] = c
            torch.cuda.empty_cache()
    res["ok"] = all(r["ok"] for r in res["families"].values())
    return res, counts


def pipeline_steps(torch, pairs, crop, bf16, seed, timed=0, warmup=0):
    """The stage-2 step of the same model, batch and draws, sequential and with
    ``pipeline_parallel = 2`` (the stages on the first two cards, or twice
    on the one): each run's loss, components, gradient norm, gradients and
    updated parameters (f32, CPU); with ``timed``, step times (after
    ``warmup``), peak memory and the pipelined steps' launch counts."""
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD, synthetic_batch

    devices = ([torch.device("cuda", i) for i in range(2)] if torch.cuda.device_count() > 1
               else [torch.device("cuda", 0)] * 2)
    batch = [torch.from_numpy(x).cuda() for x in synthetic_batch(pairs, crop, CLASSES, seed)]
    runs, draws = {}, None
    for pipe in (1, 2):
        cfg = train_config(pairs, crop, bf16)
        cfg.train.pipeline_parallel = pipe
        tr = TrainM2FOOD(cfg, model=seeded_model(torch, seed).train(), device="cuda",
                         pipeline_devices=devices if pipe > 1 else None)
        tr.set_stage(1)
        if draws is None:
            draws = tr.draws(2 * pairs, tuple(TRAIN_HW if crop == CROP else crop))
        state = {k: v.clone() for k, v in tr.model.state_dict().items()}
        opt = {k: v for k, v in tr.optimizer.state_dict().items()}
        r = {}
        if timed:
            for _ in range(warmup):
                tr.stage2_step(*batch, draws=draws)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            times = []
            for _ in range(timed):
                t0 = time.perf_counter()
                tr.stage2_step(*batch, draws=draws)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            r.update(step_ms=times, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                     launches=launch_counts())
            with torch.no_grad():  # back to the start for the compared step
                tr.model.load_state_dict(state)
            tr.optimizer.load_state_dict(opt)
        loss, losses, gnorm, _ = tr.stage2_step(*batch, draws=draws)
        torch.cuda.synchronize()
        r.update(loss=float(loss), losses={k: float(v) for k, v in losses.items()},
                 gnorm=float(gnorm),
                 grads={n: p.grad.detach().float().cpu() for n, p in tr.model.named_parameters()
                        if p.grad is not None},
                 params={n: p.detach().float().cpu() for n, p in tr.model.named_parameters()},
                 n_micro=tr.model.sem_seg_head.pixel_decoder.pipeline[1] if pipe > 1 else 1)
        runs[pipe] = r
        del tr, state, opt
        torch.cuda.empty_cache()
    return runs, devices


def compare_pipelined(runs, lr, loss_rtol, grad_tol, param_tol):
    """Pipelined (2) against sequential (1): the losses' relative error, the
    largest gradient error over the largest gradient, the largest update error
    on the entries whose gradient exceeds 1e-2 of its tensor's largest (there
    AdamW's first step does not divide a rounding difference by a tiny
    gradient), in units of the learning rate."""
    a, b = runs[1], runs[2]
    rel = lambda x, y: abs(x - y) / max(abs(x), 1e-12)
    loss_err = max([rel(a["loss"], b["loss"])]
                   + [rel(a["losses"][k], b["losses"][k]) for k in a["losses"]])
    scale = max(float(g.abs().max()) for g in a["grads"].values())
    grad_err = max(float((a["grads"][n] - b["grads"][n]).abs().max())
                   for n in a["grads"]) / scale
    param_err = 0.0
    for n, g in a["grads"].items():
        sel = g.abs() > 1e-2 * g.abs().max()
        if sel.any():
            param_err = max(param_err, float((a["params"][n] - b["params"][n])[sel].abs().max()))
    out = {"loss_rel_err": loss_err, "grad_err_of_scale": grad_err,
           "update_err_in_lr": param_err / lr, "loss": [a["loss"], b["loss"]],
           "grad_norm": [a["gnorm"], b["gnorm"]], "n_micro": b["n_micro"],
           "tolerance": {"loss_rel": loss_rtol, "grad_of_scale": grad_tol,
                         "update_in_lr": param_tol}}
    out["ok"] = bool(loss_err <= loss_rtol and grad_err <= grad_tol
                     and param_err / lr <= param_tol and set(a["grads"]) == set(b["grads"]))
    return out


def phase_pipeline(torch):
    """``pipeline``: the M2F R-50 stage-2 step with ``pipeline_parallel = 2``
    (GPipe over the deformable encoder, ``core/pipeline.py``) against the
    sequential step: (a) f32 with TF32 off, 2 pairs of 256x256, the check of
    the schedule; (b) exps/m2f.yaml's 8 pairs of 704x704 in bf16, timed, the
    pipelined steps' launches the path ``pipeline``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"phase": "pipeline", "model": "MaskFormer R-50 MSDeformAttn+GMA, full widths",
           "config": "exps/m2f.yaml", "pipeline_parallel": 2}
    lr = train_config(1, CROP, False).model.m2f.base_lr
    runs, devices = pipeline_steps(torch, 2, (256, 256), False, SEED + 71)
    # f32: the microbatches change the grouping of the encoder's sums, and the
    # deformable backward sums d value by atomics: 1e-4 relative on the
    # losses and of the largest gradient, 1e-2 of the learning rate on the
    # updates of entries with a gradient above 1e-2 of their tensor's largest
    res["f32_2x256"] = compare_pipelined(runs, lr, 1e-4, 1e-4, 1e-2)
    torch.backends.cudnn.allow_tf32 = True
    runs, devices = pipeline_steps(torch, TRAIN_PAIRS, CROP, True, SEED + 72, timed=3,
                                   warmup=2)
    # bf16: the encoder's products at other batch sizes round otherwise in
    # bf16; a sanity bound (2e-2 on the losses, 5e-2 of the largest gradient,
    # 0.5 learning rate on the selected updates)
    cmp = compare_pipelined(runs, lr, 2e-2, 5e-2, 0.5)
    counts = runs[2]["launches"]
    n_micro = runs[2]["n_micro"]
    launches_ok = (counts["ms_deform_attn_bilinear"] == 6 * n_micro * 3
                   and counts["ms_deform_attn_bilinear_backward"] == 6 * n_micro * 3
                   and counts["linear_sum_assignment"] >= 3 and counts["label_points"] >= 12)
    cmp.update(sequential_step_ms=runs[1]["step_ms"], pipelined_step_ms=runs[2]["step_ms"],
               sequential_peak_mem_gib=runs[1]["peak_mem_gib"],
               pipelined_peak_mem_gib=runs[2]["peak_mem_gib"],
               pipelined_launches={k: v for k, v in counts.items() if v},
               launches_ok=launches_ok)
    res["bf16_8x704"] = cmp
    res.update(devices=[str(d) for d in devices], device_count=len(set(devices)))
    res["ok"] = bool(res["f32_2x256"]["ok"] and cmp["ok"] and launches_ok)
    return res, {"pipeline": counts}


# tensor_parallel: the trainers' model_parallel (core/tensor_parallel.py)
TP_DEGREE = 2
TP_RECIPES = ("deeplab", "m2f")


def phase_tensor_parallel(torch):
    """``tensor_parallel``: DeepLab WRN-38's stage-2 step (exps/deeplab.yaml, 8
    pairs of 700x700) and M2F R-50's (exps/m2f.yaml, 8 pairs of 704x704) with
    ``model_parallel = 2``, both shards on ``cuda:0``, ``min_size`` 1024,
    against the unsharded step from the same weights, batch and draws: in f32
    with TF32 off (loss and components within 1e-4, all gradients within 1e-2
    in L2, the worst tensor reported, as ``dp_train``), then both bf16 steps
    timed (3 after a warm-up), the sharded steps' launches the paths
    ``tp_train_<recipe>``; the bytes of parameters and optimizer state by
    shard against the unsharded run's. With both shards on one card nothing
    overlaps: the sharded step's time is the column-parallel layout's cost."""
    from multishiftseg_torch.core import tensor_parallel as tp
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts

    res = {"phase": "tensor_parallel", "model_parallel": TP_DEGREE,
           "devices": ["cuda:0"] * TP_DEGREE, "min_size": 1024}
    counts_by_path, ok = {}, True
    for name in TP_RECIPES:
        out = {"config": f"exps/{'deeplab' if name == 'deeplab' else 'm2f'}.yaml"}
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        recs = {}
        for mp in (1, TP_DEGREE):
            tr, step = dp_setup(torch, name, full=True, bf16=False, tp=mp)
            loss, parts = step()
            recs[mp] = {"loss": float(loss), "parts": {k: float(v) for k, v in parts.items()},
                        "grads": tp.unsharded_grads(tr.model)}
            out[f"state_bytes_by_shard_mp{mp}"] = tp.state_bytes(tr.model, tr.optimizer)
            if mp > 1:
                out["sharded_modules"] = sum(isinstance(m, tp.ChannelShards)
                                             for m in tr.model.modules())
            del tr, step, loss, parts
            torch.cuda.empty_cache()
        out["f32"] = dp_compare(recs[1], recs[TP_DEGREE], 1e-4, 1e-2)
        del recs
        torch.backends.cudnn.allow_tf32 = True
        for mp in (1, TP_DEGREE):
            tr, step = dp_setup(torch, name, full=True, tp=mp)
            step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            times = dp_step_times(torch, step, warmup=0, timed=3)
            counts = launch_counts()
            out[f"bf16_step_ms_mp{mp}"] = times
            out[f"bf16_peak_mem_gib_mp{mp}"] = torch.cuda.max_memory_allocated() / 2 ** 30
            if mp > 1:
                counts_by_path[f"tp_train_{name}"] = counts
                out["launches"] = {k: v for k, v in counts.items() if v}
            del tr, step
            torch.cuda.empty_cache()
        c = counts_by_path[f"tp_train_{name}"]
        out["launches_ok"] = (
            c["dilated_conv3x3"] == 9 and c["dilated_conv3x3_wgrad"] == 9
            and c["bottom_k_sum"] == 3 if name == "deeplab" else
            c["ms_deform_attn_bilinear"] == 18 and c["ms_deform_attn_bilinear_backward"] == 18
            and c["linear_sum_assignment"] >= 3 and c["label_points"] >= 12)
        ok = ok and out["f32"]["ok"] and out["launches_ok"]
        res[name] = out
    torch.backends.cuda.matmul.allow_tf32 = False
    res["ok"] = bool(ok)
    return res, counts_by_path


# spatial: the evaluator's --spatial N, every slab on cuda:0 (core/spatial.py)
SPATIAL_SLABS = (2, 4)
SPATIAL_ROUNDS = 3
SPATIAL_RTOL = 1e-3  # of each output's scale, f32 with TF32 off


def phase_spatial(torch):
    """``spatial``: both eval forwards (``build_deeplab_forward`` and
    ``build_m2f_forward`` with ``spatial_devices = N``) at 1024x2048, batch 1,
    N = 2 and 4 with every slab on ``cuda:0``, against the unsplit forward on
    the same image: in f32 with TF32 off, DeepLab's score and logits, and
    M2F's anomaly score and ``sem`` with the unsplit forward's attention masks
    replayed (``attention_mask_hooks``; the decoder's masks are hard
    thresholds), each within ``SPATIAL_RTOL`` of the output's scale; then bf16
    requests timed in turns with the unsplit forward (``SPATIAL_ROUNDS``
    rounds after a warm-up), one more N = 2 request's launches the path
    ``spatial_<family>``, and DeepLab's halo rows that the dilated conv
    computes and throws away."""
    from multishiftseg_torch.core import spatial
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.train.test_runner import build_deeplab_forward, build_m2f_forward

    dev = torch.device("cuda", 0)
    image = torch.from_numpy(np.random.RandomState(SEED + 131).randn(1, H, W, 3)
                             .astype(np.float32))
    res = {"phase": "spatial", "hw": [H, W], "batch": 1, "slab_devices": str(dev),
           "slabs": list(SPATIAL_SLABS), "rtol": SPATIAL_RTOL}
    counts_by_path, ok = {}, True
    for family in ("deeplab", "m2f"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if family == "deeplab":
            model = seeded_deeplab(torch, SEED + 132)

            def make(n, bf16):
                return build_deeplab_forward(
                    deeplab_config(1, DL_CROP, bf16), model=model, device="cuda",
                    spatial_devices=n, slab_devices=[dev] * n if n else None)
        else:
            model = seeded_model(torch, SEED + 133)

            def make(n, bf16):
                return build_m2f_forward(
                    train_config(1, CROP, bf16), model=model, device="cuda",
                    spatial_devices=n, slab_devices=[dev] * n if n else None,
                    enforce_qualification=False)
        out = {}
        masks = []
        hooks = (attention_mask_hooks(model.sem_seg_head.predictor, masks)
                 if family == "m2f" else [])
        want = make(0, False)(image)
        for h in hooks:
            h.remove()
        names = ("score", "logit") if family == "deeplab" else ("anomaly", "sem")
        for n in SPATIAL_SLABS:
            hooks = (attention_mask_hooks(model.sem_seg_head.predictor, [], replay=masks)
                     if family == "m2f" else [])
            got = make(n, False)(image)
            for h in hooks:
                h.remove()
            errs = {}
            for key, g_, w_ in zip(names, got, want):
                scale = float(w_.abs().max())
                errs[key] = float((g_ - w_).abs().max()) / max(scale, 1e-30)
            out[f"f32_rel_err_n{n}"] = errs
            ok = ok and all(e <= SPATIAL_RTOL and np.isfinite(e) for e in errs.values()) \
                and all(g_.shape == w_.shape for g_, w_ in zip(got, want))
            del got
        del want
        torch.backends.cudnn.allow_tf32 = True
        fwds = {n: make(n, True) for n in (0,) + SPATIAL_SLABS}
        times = {n: [] for n in fwds}
        for fwd in fwds.values():
            fwd(image)
        torch.cuda.synchronize()
        for _ in range(SPATIAL_ROUNDS):
            for n, fwd in fwds.items():
                t0 = time.perf_counter()
                fwd(image)
                torch.cuda.synchronize()
                times[n].append((time.perf_counter() - t0) * 1e3)
        out["bf16_request_ms"] = {("unsplit" if n == 0 else f"n{n}"): t
                                  for n, t in times.items()}
        reset_launch_counts()
        fwds[SPATIAL_SLABS[0]](image)
        torch.cuda.synchronize()
        counts = launch_counts()
        counts_by_path[f"spatial_{family}"] = counts
        out["launches_n2"] = {k: v for k, v in counts.items() if v}
        if family == "deeplab":
            out["launches_ok"] = counts["dilated_conv3x3"] == 3 * SPATIAL_SLABS[0]
            out["dilated_conv_rows"] = {
                f"n{n}": dict(zip(("discarded", "kept"), spatial.discarded_rows(model, H, n)))
                for n in SPATIAL_SLABS}
        else:
            out["launches_ok"] = (counts["ms_deform_attn_bilinear"] == 6 * SPATIAL_SLABS[0]
                                  and counts["mask_scores_anomaly"] == SPATIAL_SLABS[0]
                                  and counts["mask_scores_semantic"] == SPATIAL_SLABS[0])
        ok = ok and out["launches_ok"]
        res[family] = out
        del fwds, model
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    res["ok"] = bool(ok)
    return res, counts_by_path


# CG-Aug's reference generation path (multishiftseg_torch/cgaug): the timed
# phase runs 512x1024 labels (64x128 latents, 8192 tokens at the UNet's first
# level: f32 logits of 2 x 8 x 8192^2 x 4 B = 4.3 GB; a 1024x2048 label would
# need 68.7 GB), with GenerationConfig's 200-500 px paste range scaled to it
CGAUG_HW = (512, 1024)
CGAUG_PASTE = (100, 250)
CGAUG_STEPS = 50
# the parity phase's cuts: a 128x256 hint (16x32 latents) for 2 guided steps,
# SAM at ViT-H's widths and depth on a 256 px input, the detector at 256x512
CGAUG_PARITY_HINT = (128, 256)
CGAUG_PARITY_STEPS = 2
CGAUG_PARITY_SAM = 256
CGAUG_PARITY_HW = (256, 512)
# each output's largest difference over its scale, card against CPU in f32
# with TF32 off: readings of 6.4e-7 (CLIP) to 3.1e-6 (SAM, the decode, the
# detector) and 1.5e-5 (the latents after 2 guided steps) on an H100; the
# limits stand a few times above them and below what TF32 on the card gives
# (the phase's control: 3.5e-4 for CLIP, 1.1e-3 to 6.2e-3 for the others)
CGAUG_LIMITS = {"clip_text": 2e-5, "ddim_latents": 1e-4, "vae_decode": 2e-5,
                "sam_embedding": 2e-5, "sam_mask_logits": 2e-5, "sam_iou": 2e-5,
                "sam_low_res_logits": 2e-5, "detector_anomaly": 2e-5}
CGAUG_PROMPTS = ("An image sampled from various stereo video sequences taken by dash cam.",
                 "longbody, lowres, bad anatomy, worst quality, low quality")


def write_synthetic_vocab(root):
    """CLIP's byte-level vocabulary with a few merges (ids below 520): the
    real vocab.json / merges.txt are not in the repository."""
    from multishiftseg_torch.cgaug.clip_text import bytes_to_unicode

    chars = sorted(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": len(chars) + i for i, c in enumerate(chars)})
    for tok in ("ll", "he", "llo</w>", "hello</w>", "<|startoftext|>", "<|endoftext|>"):
        vocab[tok] = len(vocab)
    Path(root, "vocab.json").write_text(json.dumps(vocab))
    Path(root, "merges.txt").write_text("#version: 0.2\nl l\nh e\nll o</w>\nhe llo</w>\n")


def city_colour_label(seed, hw):
    """A seeded Cityscapes colour label: sky, buildings and vegetation over a
    road with sidewalks, cars on it."""
    g = np.random.RandomState(seed)
    h, w = hw
    lbl = np.empty((h, w, 3), np.uint8)
    lbl[:] = (70, 130, 180)                                   # sky
    lbl[h * 2 // 10:h // 2] = (70, 70, 70)                    # building
    lbl[h * 3 // 10:h // 2, : w // 5] = (107, 142, 35)        # vegetation
    lbl[h // 2:] = (128, 64, 128)                             # road
    lbl[h // 2:, : w // 8] = lbl[h // 2:, -w // 8:] = (244, 35, 232)  # sidewalk
    for _ in range(3):                                        # cars
        y, x = g.randint(h // 2, h - h // 8), g.randint(w // 8, w - w // 4)
        lbl[y:y + h // 16, x:x + w // 12] = (0, 0, 142)
    return lbl


class SeededAnomalySource:
    """Seeded objects in place of the ADE20K index the repository does not
    hold: an ellipse of 40-160 px with a notch, and an OOD class name."""

    def sample(self, rng):
        from multishiftseg_torch.cgaug.ade20k_source import DEFAULT_OOD_CLASSES

        h, w = (int(v) for v in rng.integers(40, 160, 2))
        yy, xx = np.mgrid[:h, :w]
        mask = ((2 * yy / h - 1) ** 2 + (2 * xx / w - 1) ** 2 <= 1).astype(np.uint8)
        mask[: h // 3, w // 3: 2 * w // 3] = 0
        return mask, DEFAULT_OOD_CLASSES[int(rng.integers(len(DEFAULT_OOD_CLASSES)))]


def seeded_on(torch, make, seed, device, scale=0.01):
    """``make()`` built on ``device`` under ``torch.manual_seed(seed)`` (the
    modules' own init), then ``scale`` normal noise on every state entry from a
    generator on the device, so no table or zero-initialised layer is
    constant; in eval mode."""
    torch.manual_seed(seed)
    with torch.device(device):
        module = make()
    g = torch.Generator(device).manual_seed(seed)
    with torch.no_grad():
        for t in module.state_dict().values():
            t.add_(scale * torch.randn(t.shape, generator=g, device=t.device, dtype=t.dtype))
    return module.eval()


def cpu_twin(torch, make, module):
    """``make()`` on the CPU holding ``module``'s state."""
    with torch.device("meta"):
        twin = make()
    twin = twin.to_empty(device="cpu")
    twin.load_state_dict(module.state_dict())
    return twin.eval()


def rel_to_scale(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@contextlib.contextmanager
def tf32_matmuls(torch, on):
    """TF32 for cuBLAS's and cuDNN's f32 work ``on`` or off, restored after."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def phase_cgaug_parity(torch, card="cuda"):
    """``cgaug_parity``: CG-Aug's towers on the card against the CPU from the
    same seeded weights, in f32 with TF32 off, each output within its
    ``CGAUG_LIMITS`` of its scale: CLIP-L's text tower on two prompts; SD1.5's
    UNet with ControlNet-v15 at full widths for 2 guided DDIM steps from one
    x_T on a 128x256 hint (the CPU's text contexts on both), then the VAE
    decode of the CPU's latents; SAM at ViT-H's widths and depth on a 256 px
    input (a 256x512 image, downsampled) with a box: the embedding, the
    low-res and full-size mask logits and the IoU, the masks equal where the
    CPU's logit is clear of 0; the detector (``make_m2f_detector`` over the
    default M2F R-50 + GMA) at 256x512, the CPU attending with the card's
    masks (``attention_mask_hooks``). A control reruns the card's side with
    TF32 on (the detector attending with the f32 run's masks) and reports
    its differences beside the limits, which it should exceed."""
    from multishiftseg_torch.cgaug import clip_text, sd_pipeline
    from multishiftseg_torch.cgaug.generate import make_m2f_detector
    from multishiftseg_torch.cgaug.label_ops import cityscapes_to_ade20k
    from multishiftseg_torch.cgaug.sam import SAM, SamPredictor, SAMConfig
    from multishiftseg_torch.core.config import load_config
    from multishiftseg_torch.models.maskformer import maskformer_from_config
    import tempfile

    res = {"phase": "cgaug_parity", "dtype": "float32", "tf32": False, "limits": CGAUG_LIMITS,
           "hint_hw": list(CGAUG_PARITY_HINT), "ddim_steps": CGAUG_PARITY_STEPS,
           "sam_img_size": CGAUG_PARITY_SAM, "detector_hw": list(CGAUG_PARITY_HW)}
    errs, control, seconds = {}, {}, {}
    t0 = time.perf_counter()
    g = np.random.RandomState(SEED + 140)
    ldm = seeded_on(torch, sd_pipeline.ControlLDM, SEED + 141, card)
    cpu_ldm = cpu_twin(torch, sd_pipeline.ControlLDM, ldm)
    sampler = sd_pipeline.SamplerConfig(steps=CGAUG_PARITY_STEPS)
    pipe, cpu_pipe = (sd_pipeline.ControlNetPipeline(ldm, sampler),
                      sd_pipeline.ControlNetPipeline(cpu_ldm, sampler))
    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_vocab(tmp)
        tokens = clip_text.load_tokenizer(tmp)(list(CGAUG_PROMPTS))
    label, _ = cityscapes_to_ade20k(city_colour_label(SEED + 142, CGAUG_PARITY_HINT))
    hint = torch.from_numpy(label).permute(2, 0, 1)[None].float() / 255.0
    h8, w8 = CGAUG_PARITY_HINT[0] // 8, CGAUG_PARITY_HINT[1] // 8
    x_T = torch.from_numpy(g.randn(1, 4, h8, w8).astype(np.float32))

    def sd(p, ctx_cpu=None, lat_cpu=None):
        """(text contexts, latents after the guided steps, decoded image) on
        ``p``'s device; given the CPU's, the steps from its contexts and the
        decode of its latents."""
        dev = p.device
        ctx = p.encode_text(tokens)
        c = ctx if ctx_cpu is None else ctx_cpu.to(dev)
        lat = p.sample(x_T.to(dev), hint.to(dev), c[:1], c[1:])
        return ctx, lat, p.decode((lat if lat_cpu is None else lat_cpu).to(dev))

    want = sd(cpu_pipe)
    names = ("clip_text", "ddim_latents", "vae_decode")
    finite = [bool(torch.isfinite(t).all()) for t in want]
    for on, into in ((False, errs), (True, control)):
        with tf32_matmuls(torch, on):
            got = sd(pipe, want[0], want[1])
        finite += [bool(torch.isfinite(t).all()) for t in got]
        into.update({k: rel_to_scale(a, b) for k, a, b in zip(names, got, want)})
    del pipe, cpu_pipe, ldm, cpu_ldm, got, want
    torch.cuda.empty_cache()
    seconds["sd"] = time.perf_counter() - t0

    sam_cfg = SAMConfig(img_size=CGAUG_PARITY_SAM)
    make_sam = lambda: SAM(sam_cfg)  # noqa: E731
    sam_card = seeded_on(torch, make_sam, SEED + 143, card)
    pred, cpu_pred = SamPredictor(sam_card), SamPredictor(cpu_twin(torch, make_sam, sam_card))
    image = g.randint(0, 256, (CGAUG_PARITY_SAM, 2 * CGAUG_PARITY_SAM, 3)).astype(np.uint8)
    box = np.array([100, 40, 380, 200])

    def sam(p):
        p.set_image(image)
        return (p._embed, *p.mask_logits(box))

    names = ("sam_embedding", "sam_mask_logits", "sam_iou", "sam_low_res_logits")
    want = sam(cpu_pred)
    for on, into in ((False, errs), (True, control)):
        with tf32_matmuls(torch, on):
            got = sam(pred)
        into.update({k: rel_to_scale(a, b) for k, a, b in zip(names, got, want)})
        if not on:
            full_card, full_cpu = got[1].cpu(), want[1]
    clear = full_cpu.abs() > CGAUG_LIMITS["sam_mask_logits"] * full_cpu.abs().max()
    res["sam_mask_clear_share"] = float(clear.float().mean())
    res["sam_masks_equal_where_clear"] = bool(
        torch.equal((full_card > 0)[clear], (full_cpu > 0)[clear]))
    del pred, cpu_pred, sam_card, got, want
    torch.cuda.empty_cache()
    seconds["sam"] = time.perf_counter() - t0 - seconds["sd"]

    make_m2f = lambda: maskformer_from_config(load_config(None).model.m2f)  # noqa: E731
    torch.manual_seed(SEED + 144)
    m2f = seeded(torch, make_m2f(), SEED + 144)
    cpu_m2f = copy.deepcopy(m2f)
    photo = g.randint(0, 256, (*CGAUG_PARITY_HW, 3)).astype(np.uint8)

    def anomaly(model, device, masks, replay=None):
        hooks = attention_mask_hooks(model.sem_seg_head.predictor, masks, replay=replay)
        try:
            return torch.from_numpy(make_m2f_detector(model, device=device).anomaly_score(photo))
        finally:
            for h in hooks:
                h.remove()

    masks = []
    with tf32_matmuls(torch, False):
        got = anomaly(m2f, card, masks)
    want = anomaly(cpu_m2f, "cpu", [], replay=masks)
    errs["detector_anomaly"] = rel_to_scale(got, want)
    with tf32_matmuls(torch, True):
        control["detector_anomaly"] = rel_to_scale(anomaly(m2f, card, [], replay=masks), want)
    res["detector_shape_ok"] = tuple(got.shape) == tuple(want.shape) == CGAUG_PARITY_HW
    del m2f, cpu_m2f
    torch.cuda.empty_cache()
    seconds["detector"] = time.perf_counter() - t0 - seconds["sd"] - seconds["sam"]

    res["finite"] = all(finite)
    res["rel_err"], res["tf32_control_rel_err"], res["seconds"] = errs, control, seconds
    res["tf32_control_above_limit"] = {k: control[k] > CGAUG_LIMITS[k] for k in control}
    res["ok"] = bool(res["finite"] and res["sam_masks_equal_where_clear"]
                     and res["detector_shape_ok"]
                     and all(np.isfinite(e) and e <= CGAUG_LIMITS[k] for k, e in errs.items()))
    return res


class StageTimes:
    """CUDA events around named methods of the backends (instance attributes
    that wrap them): ``read()`` synchronises and returns each name's times."""

    def __init__(self, torch):
        self.torch, self.pending = torch, []

    def wrap(self, obj, attr, name):
        fn = getattr(obj, attr)
        Event = self.torch.cuda.Event

        def timed(*args, **kwargs):
            start, end = Event(enable_timing=True), Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.pending.append((name, start, end))
            return out

        setattr(obj, attr, timed)

    def read(self):
        self.torch.cuda.synchronize()
        out = {}
        for name, start, end in self.pending:
            out.setdefault(name, []).append(start.elapsed_time(end))
        self.pending = []
        return out


def cgaug_generator(torch, ldm, sam_model, detector_model, tokenizer, seed, device="cuda",
                    steps=CGAUG_STEPS):
    """The reference path's ``MultiShiftGenerator`` over the given towers:
    gates set so that every attempt runs all three backends once and is
    accepted (IoU above -1, score at least -inf, one attempt). Returns it and
    the recorded gate values (``iou``, ``mean_score`` per attempt)."""
    from multishiftseg_torch.cgaug import generate, sd_pipeline
    from multishiftseg_torch.cgaug.sam import SAMSegmenter

    diffusion = sd_pipeline.SDControlNetGenerator(
        ldm, tokenizer, seed=seed, device=device, sampler=sd_pipeline.SamplerConfig(steps=steps))
    segmenter = SAMSegmenter(sam_model, device=device)
    detector = generate.make_m2f_detector(detector_model, device=device)
    cfg = generate.GenerationConfig(seed=seed, iou_threshold=-1.0, score_threshold=float("-inf"),
                                    max_retries=1, paste_min_size=CGAUG_PASTE[0],
                                    paste_max_size=CGAUG_PASTE[1])
    gen = generate.MultiShiftGenerator(diffusion, SeededAnomalySource(), cfg,
                                       segmenter=segmenter, detector=detector)
    gates = {"iou": [], "mean_score": []}
    seg_fn, det_fn, gen_fn = segmenter.segment_box, detector.anomaly_score, gen.generate
    seen = {}

    def segment_box(image, box):
        seen["seg"] = seg_fn(image, box)
        return seen["seg"]

    def anomaly_score(image):
        seen["score"] = det_fn(image)
        return seen["score"]

    def generate_one(label):
        out = gen_fn(label)
        mask = out[1]
        gates["iou"].append(generate._iou(seen.pop("seg"), mask))
        gates["mean_score"].append(float(seen.pop("score")[mask == 1].mean()))
        return out

    segmenter.segment_box, detector.anomaly_score, gen.generate = (segment_box, anomaly_score,
                                                                   generate_one)
    return gen, gates


def phase_cgaug(torch, warmup=1, timed=2):
    """``cgaug``: CG-Aug's reference generation path at full widths (SD1.5 UNet
    + ControlNet-v15 + VAE + CLIP-L, SAM ViT-H, the default M2F R-50 + GMA
    detector), seeded weights, a synthetic vocab and a seeded anomaly source,
    on a seeded 512x1024 Cityscapes colour label: ``MultiShiftGenerator.generate``
    (remap, paste, prompt, 50 guided DDIM steps, decode, SAM's box IoU, the
    detector's mean score), ``warmup`` + ``timed`` calls in f32 (TF32 for
    cuDNN's convs, not for matmuls: PyTorch's defaults), and, with the SD
    towers and SAM in bf16, one timed call (the first in bf16: it carries that
    dtype's first-use cost). Per call: seconds, the stages' device times (text
    encode, UNet + ControlNet a DDIM step, sampling, VAE decode, SAM encode /
    predict, detector), ``stage_span_share``, the stages' summed CUDA-event
    spans over the call's wall time (a gap inside a span counts as busy, so
    it bounds the device's busy share from above), the gate values; peak
    memory; the timed f32 calls' launches
    (path ``cgaug``: 6 bilinear deformable forwards, one anomaly and one
    semantic tail a call, nothing else)."""
    import dataclasses
    import tempfile

    from multishiftseg_torch.cgaug import clip_text, sd_pipeline
    from multishiftseg_torch.cgaug.sam import SAM, sam_vit_h
    from multishiftseg_torch.core.config import load_config
    from multishiftseg_torch.models.maskformer import maskformer_from_config
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts

    dev = "cuda"
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    label = city_colour_label(SEED + 150, CGAUG_HW)
    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_vocab(tmp)
        tokenizer = clip_text.load_tokenizer(tmp)
    ldm = seeded_on(torch, sd_pipeline.ControlLDM, SEED + 151, dev)
    sam_model = seeded_on(torch, lambda: SAM(sam_vit_h()), SEED + 152, dev)
    torch.manual_seed(SEED + 153)
    detector = seeded(torch, maskformer_from_config(load_config(None).model.m2f), SEED + 153)
    res = {"phase": "cgaug", "label_hw": list(CGAUG_HW), "paste_px": list(CGAUG_PASTE),
           "ddim_steps": CGAUG_STEPS, "guidance": 9.0, "batch": 1,
           "towers": "SD1.5 UNet + ControlNet-v15 + VAE + CLIP-L/14 text, SAM ViT-H, "
                     "M2F R-50 + GMA detector (f32)",
           "params_m": {"unet": sum(p.numel() for p in ldm.unet.parameters()) / 1e6,
                        "controlnet": sum(p.numel() for p in ldm.control_model.parameters()) / 1e6,
                        "vae": sum(p.numel() for p in ldm.vae.parameters()) / 1e6,
                        "clip_text": sum(p.numel() for p in ldm.clip.parameters()) / 1e6,
                        "sam": sum(p.numel() for p in sam_model.parameters()) / 1e6,
                        "detector": sum(p.numel() for p in detector.parameters()) / 1e6}}

    def instrument(gen):
        """Stage timers on ``gen``'s backends, wrapped once."""
        times = StageTimes(torch)
        pipe, pred = gen.diffusion.pipe, gen.segmenter.predictor
        for obj, attr, name in ((pipe, "encode_text", "text_encode_ms"),
                                (pipe, "eps", "unet_controlnet_step_ms"),
                                (pipe, "sample", "sampling_ms"), (pipe, "decode", "vae_decode_ms"),
                                (pred, "set_image", "sam_encode_ms"),
                                (pred, "predict", "sam_predict_ms"),
                                (gen.detector, "anomaly_score", "detector_ms")):
            times.wrap(obj, attr, name)
        return times

    def run(gen, gates, times, calls):
        out, images = [], []
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            image, mask, name, domain = gen.generate(label)
            seconds = time.perf_counter() - t0
            stages = times.read()
            steps = stages.pop("unet_controlnet_step_ms")
            stage_ms = {k: sum(v) for k, v in stages.items()}
            out.append({"seconds": seconds, **stage_ms,
                        "stage_span_share": sum(stage_ms.values()) / (seconds * 1e3),
                        "unet_controlnet_step_ms_median": statistics.median(steps),
                        "ddim_steps": len(steps), "iou": gates["iou"][-1],
                        "mean_score": gates["mean_score"][-1], "ood": name, "domain": domain,
                        "pasted_px": int(mask.sum())})
            images.append((image, mask))
        return out, images

    gen, gates = cgaug_generator(torch, ldm, sam_model, detector, tokenizer, SEED + 154)
    times = instrument(gen)
    seconds = {"build": time.perf_counter() - t0}
    warm, first = run(gen, gates, times, warmup)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    calls, images = run(gen, gates, times, timed)
    counts = launch_counts()
    res["f32"] = {"warmup": warm, "timed": calls,
                  "seconds_per_image": statistics.mean(c["seconds"] for c in calls),
                  "ddim_step_ms": statistics.mean(c["sampling_ms"] / c["ddim_steps"]
                                                  for c in calls),
                  "stage_span_share": statistics.mean(c["stage_span_share"] for c in calls),
                  "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    res["launches"] = {k: v for k, v in counts.items() if v}
    want = {k: 0 for k in counts}
    want.update(ms_deform_attn_bilinear=6 * timed, mask_scores_anomaly=timed,
                mask_scores_semantic=timed)
    res["launches_ok"] = counts == want
    outputs_ok = all(im.dtype == np.uint8 and im.shape == (*CGAUG_HW, 3) and m.shape == CGAUG_HW
                     and m.sum() > 0 for im, m in first + images)
    gates_ok = all(np.isfinite(v) for v in gates["iou"] + gates["mean_score"])
    seconds["f32"] = time.perf_counter() - t0 - seconds["build"]
    f32_image = first[0][0]
    del gen, gates
    torch.cuda.empty_cache()

    bf16 = torch.bfloat16
    cfgs16 = dict(unet_cfg=dataclasses.replace(sd_pipeline.SDUNetConfig(), dtype=bf16),
                  vae_cfg=dataclasses.replace(sd_pipeline.VAEConfig(), dtype=bf16),
                  clip_cfg=dataclasses.replace(clip_text.CLIPTextConfig(), dtype=bf16))
    with torch.device("meta"):
        ldm16, sam16 = sd_pipeline.ControlLDM(**cfgs16), SAM(dataclasses.replace(sam_vit_h(),
                                                                                  dtype=bf16))
    ldm16, sam16 = ldm16.to_empty(device=dev), sam16.to_empty(device=dev)
    ldm16.load_state_dict(ldm.state_dict())
    sam16.load_state_dict(sam_model.state_dict())
    del ldm, sam_model
    torch.cuda.empty_cache()
    gen, gates = cgaug_generator(torch, ldm16.eval(), sam16.eval(), detector, tokenizer, SEED + 154)
    times = instrument(gen)
    torch.cuda.reset_peak_memory_stats()
    calls16, first16 = run(gen, gates, times, 1)
    res["bf16"] = {"timed_first_call": calls16,
                   "seconds_per_image": calls16[0]["seconds"],
                   "ddim_step_ms": calls16[0]["sampling_ms"] / calls16[0]["ddim_steps"],
                   "stage_span_share": calls16[0]["stage_span_share"],
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "mean_abs_uint8_vs_f32_same_draws": float(np.abs(
                       first16[0][0].astype(np.int16) - f32_image).mean())}
    outputs_ok = outputs_ok and all(im.shape == (*CGAUG_HW, 3) for im, _ in first16)
    gates_ok = gates_ok and all(np.isfinite(v) for v in gates["iou"] + gates["mean_score"])
    res["outputs_ok"], res["gates_finite"] = bool(outputs_ok), bool(gates_ok)
    seconds["bf16"] = time.perf_counter() - t0 - seconds["build"] - seconds["f32"]
    res["seconds"] = seconds
    del gen, gates, ldm16, sam16, detector
    torch.cuda.empty_cache()
    res["ok"] = bool(res["launches_ok"] and outputs_ok and gates_ok)
    return res, {"cgaug": counts}


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


PHASES = ("kernels", "slice_parity", "serve", "train_parity", "train", "deeplab_parity",
          "deeplab_serve", "deeplab_train_parity", "deeplab_train", "stage1_parity",
          "stage1_train", "validate", "evaluate", "train_loop", "instance_parity",
          "instance_train", "alt_parity", "alt_serve", "alt_train", "dp_train", "deploy",
          "pipeline", "tensor_parallel", "spatial", "cgaug_parity", "cgaug")


def parse_args(argv):
    """No arguments: every phase, as the smoke test runs. ``--phases a,b``
    runs the build and those phases only (for A/B timing) and ends with
    ``{"ok": ..., "phases": [...]}`` instead of the device line; ``--root DIR``
    imports ``multishiftseg_torch`` from DIR instead of this script's
    checkout (another tree under the same harness)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent),
                    help="the checkout whose multishiftseg_torch to run")
    args = ap.parse_args(argv)
    args.phases = [p for p in args.phases.split(",") if p]
    unknown = set(args.phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    return args


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    try:
        import multishiftseg_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2

    phases = []

    def run(name, fn, *a):
        """Run phase ``name`` if selected: its JSON line, and its launch
        counts where it returns them ({} when not run)."""
        if name not in args.phases:
            return {}
        out = fn(torch, *a)
        res, counts = out if isinstance(out, tuple) else (out, {})
        emit(res)
        phases.append(res)
        return counts

    build = phase_build()
    emit(build)
    phases.append(build)
    rows = {}
    if "kernels" in args.phases:
        rows, kernels = phase_kernels(torch)
        emit(kernels)
        phases.append(kernels)
    run("slice_parity", phase_slice_parity)
    launches = run("serve", phase_serve)
    for seed in TRAIN_PARITY_SEEDS:
        run("train_parity", phase_train_parity, seed)
    train_launches = run("train", phase_train)
    run("deeplab_parity", phase_deeplab_parity)
    dl_launches = run("deeplab_serve", phase_deeplab_serve)
    for seed in DL_TRAIN_PARITY_SEEDS:
        run("deeplab_train_parity", phase_deeplab_train_parity, seed)
    dl_train_launches = run("deeplab_train", phase_deeplab_train)
    run("stage1_parity", phase_stage1_parity)
    s1_launches = run("stage1_train", phase_stage1_train)
    val_launches = run("validate", phase_validate)
    eval_launches = run("evaluate", phase_evaluate)
    loop_launches = run("train_loop", phase_train_loop)
    run("instance_parity", phase_instance_parity)
    inst_launches = run("instance_train", phase_instance_train)
    run("alt_parity", phase_alt_parity)
    alt_launches = {**run("alt_serve", phase_alt_serve), **run("alt_train", phase_alt_train)}
    dp_launches = run("dp_train", phase_dp_train)
    deploy_launches = run("deploy", phase_deploy)
    pipe_launches = run("pipeline", phase_pipeline)
    tp_launches = run("tensor_parallel", phase_tensor_parallel)
    spatial_launches = run("spatial", phase_spatial)
    run("cgaug_parity", phase_cgaug_parity)
    cgaug_launches = run("cgaug", phase_cgaug)
    dp_row = next((p.pop("kernel_row") for p in phases if p["phase"] == "dp_train"), None)
    if rows and dp_row is not None:
        rows["bottom_k_sum_global"] = dp_row

    # each main path was run with the counts set to 0 just before it; a row
    # counts its counter over its paths (default: every path)
    paths = {"serve": launches, "train": train_launches, "deeplab_serve": dl_launches,
             "deeplab_train": dl_train_launches, "stage1_train": s1_launches,
             "validate": val_launches, "evaluate": eval_launches,
             "train_loop": loop_launches, "instance_eval": inst_launches.get("instance_eval", {}),
             **{p: inst_launches.get(p, {}) for p in (f"instance_train_{r}"
                                                      for r in INSTANCE_RECIPES)},
             **{p: alt_launches.get(p, {}) for p in ALT_PATHS},
             **{f"dp_train_{r}": dp_launches.get(f"dp_train_{r}", {}) for r in DP_RECIPES},
             "dp_train_two_ranks": dp_launches.get("dp_train_two_ranks", {}),
             **{p: deploy_launches.get(p, {}) for p in DEPLOY_PATHS},
             "pipeline": pipe_launches.get("pipeline", {}),
             **{f"tp_train_{r}": tp_launches.get(f"tp_train_{r}", {}) for r in TP_RECIPES},
             **{f"spatial_{f}": spatial_launches.get(f"spatial_{f}", {})
                for f in ("deeplab", "m2f")},
             "cgaug": cgaug_launches.get("cgaug", {})}
    for name, row in rows.items():
        row["launches"] = sum(paths[p].get(row.get("counter", name), 0)
                              for p in row.get("paths", paths))
    everything = set(args.phases) == set(PHASES)
    ok = all(p["ok"] for p in phases) and (
        not everything or all(r["launches"] > 0 for r in rows.values()
                              if r.get("paths", paths)))
    key_order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                 "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the redesigned kernels' rows also carry their spreads and device times
    # (the forward's, the levels it staged in shared memory; the assignment's
    # and the selection's, their device kernels a call, the assignment's
    # longest search and the selection's staged share of keys; a row with no
    # main path, its empty "paths")
    extra = ("ms_spread", "device_ms", "device_ms_spread", "host_ms", "staged_levels",
             "device_kernels", "max_steps", "device_ns_per_step", "staged_fraction", "paths")
    if rows:
        emit({"kernels": [{k: r[k] for k in key_order + extra if k in r}
                          for r in rows.values()]})
    print(build["nvidia_smi"], flush=True)
    if not ok:
        failed = [p["phase"] for p in phases if not p["ok"]]
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    if not everything:
        emit({"ok": True, "phases": args.phases})
        return 0
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
