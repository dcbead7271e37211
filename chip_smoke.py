#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dynamic_multiview_3d_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root; needs one CUDA card

Phases, each fatal (nothing is caught; any failure exits non-zero):
  1. build the port's CUDA kernels (one nvcc per source and, for the
     multi-source kernels, per instantiation: each (T, padding) pair this
     script launches is a library of its own), the native frame packer,
     the zstd decoder and the CRC32C (g++), all started together, and
     print each build's seconds and ptxas resource use;
  2. print the card's name and power limit (nvidia-smi); [pose] the camera
     math (look_at_extrinsics, relative_transform, intrinsics_matrix) on
     CUDA inputs must issue no host-to-device copy (torch.profiler);
     [data] the port's exporters write small png, packed, tfrecord and
     shapenet datasets (no imageio, OpenCV or TensorFlow), each read back
     through make_source (uint8 and f32 batches of the expected shapes;
     png and packed bitwise equal); the native packer within 1 ulp of its
     numpy version; the resident bank's gather on the card bitwise equal to
     the host batch of the same indices; the device draw on the card equal
     to the CPU's (the table pinned by tests/test_torch_resident.py, and
     c3md-shaped draws), and a device_sample equal to the CPU draw's gather;
  3. [kernel] at the c2 shape (N = 128 targets of 3 x 128 x 128), hold the
     forward warp + composite kernel (#1) against its plain PyTorch version
     in both paddings and both precisions (bitwise) in two layouts: the
     model's (16 channels-last frames, each shared by its K = 8 targets)
     and one contiguous copy per target (128 images, K = 1), which must
     also give the model's output; and at C = 1 and 5 (16 shared frames of
     64 x 64), the instantiations the model does not launch. Time it on the
     model's layout (border: the model's padding): the kernel's device time
     under torch.profiler, the wrapper's with its staging copy, a call of
     the wrapper with CUDA events, the per-target copy's device time, the
     plain version and F.grid_sample(border, align_corners=True) of the 16
     frames at the same coordinates — the library yardstick, which does the
     warp only — beside the memory bound;
  4. [reference] hold the port's CUDA path against its CPU path on the tiny
     f32 config (TF32 off; 1e-4, the tolerance the CPU tests hold the port
     to JAX with);
  5. [serve] a c2 Model.init_random (bf16) on the card answers 3 predict
     requests of B = 16, T = 1, K = 8 from the port's SyntheticScenes; the
     forward kernel's launch counter must rise by exactly 3 (the other
     kernels' by 0), and the staging copies of the last frame
     (``_build.stage``) by 3, one a request; the third request's aux outputs are recomposited with
     the plain version (1e-5); then a window of 50 requests is timed:
     latency p50, p90 and views/s; one request is profiled; a request must
     show no op repeating the [B, 3, H, W] last frame (torch.profiler with
     input shapes), and a planted repeat_interleave of that frame, the
     detector's control, must show one;
  6. [kernel-bwd] on the inputs of phase 3 (both layouts, C = 1 and 5),
     hold the backward kernel (#3) against the plain backward in both
     paddings and both precisions: with d_img (one per frame), with and
     without the warped cotangent, and without d_img or the warped
     cotangent (the training path's launch): d_ix, d_iy, d_mask, d_rgb
     bitwise, d_img (atomics, run-dependent order) to 1e-5 of its largest
     magnitude; time it on the model's layout with d_img off (the training
     path: the kernel's device time on the staged frame the autograd op
     keeps, the wrapper's from the channels-last frames with its staging
     copy, calls as in 3) and on, the per-target copy, the plain backward
     and the backward of F.grid_sample beside the bound;
  7. [train-reference] one train step of the tiny f32 config on CUDA and on
     the CPU from the same weights and batch: loss 1e-5 relative, every
     gradient 1e-4 in relative L2 (the zero-gradient biases: 1e-6 of the
     global gradient norm), as the CPU tests hold the port to JAX;
  8. [train] c2 init_state (bf16, Adam 2e-4) takes 3 steps on uint8 batches
     of B = 16, K = 8: the c2 kernels' launch counters must rise by exactly
     3 each, with no d_img, the multi-source ones' by 0, the staging
     copies by 3 (the forward's: the backward copies nothing); then a window of 30
     steps on one batch is timed (step p50, p90, steps/s, target views/s,
     peak memory) and its loss must fall; one step is profiled; a step
     must show no op repeating the last frame (as in 5);
  9. [loop-c2] in a temporary directory, the c2 preset at full width
     through the training loop, the checkpoints and the CLIs:
     cli.train takes 8 steps (checkpoint and log every 4): #1 and #3
     (composite, no d_img) launch 8 times each, the staging copies rise
     by 8, the other kernels 0; the image summaries, where the card has
     TensorBoard and PIL, a forward at steps 4 and 8, are counted apart
     (#1 and the copies +2, path loop_c2_summaries); the logged
     losses are finite, the manager holds the steps of Orbax's policy
     (1, 4, 8) and the model dir step 8. Exact resume with
     cudnn.deterministic on (restored afterwards): 4 steps straight
     against 4 steps killed after step 1 (FaultInjected) and resumed,
     every parameter and both Adam moments bitwise; cli.snapshot of the
     killed run exports its step 2. Model.from_checkpoint of the model dir
     answers 3 c2 requests (#1 +3) bitwise equal to the trained module in
     eval mode; one manager save and restore (bitwise) and one model-dir
     save and load are timed with their bytes; cli.eval (2 batches of 16,
     #1 +2) gives finite PSNR and SSIM at ckpt_step 8, timed as views/s
     of the whole call; cli.predict (#1 +1) writes 5 PNGs of 128 x 128,
     decoded here with zlib (chunk CRCs, IHDR, unfiltered rows), the
     source equal to the scene's frame. The loop's step p50 (host batch +
     train step) and its host-batch share print beside [train]'s p50; no
     module of JAX or the JAX package may be in sys.modules;
     [loop-c2-stream] the c2 preset, nothing cut, through cli.train with
     data.streaming (4 worker processes render the batches ahead), 48
     steps (checkpoint and log every 16): #1 and #3 48 launches each, the
     copies 48, the image summaries counted apart; the loop step (the
     iterator's wait + the train step) p50 and the share spent waiting,
     after the first batch and over the last 16 steps (past the workers'
     prefetch buffer), print beside [loop-c2]'s and [train]'s; then a
     streamed 4-step run killed after step 1 and resumed from the
     stream's state ends bitwise equal to an uninterrupted one;
 10. [kernel-mf] at the c3md shape (N = 8 examples of 3 x 128 x 128
     sources, P = K*H*W = 32,768) with T = 3, 8 (c3md's), 16, 17 and 24
     sources, hold the multi-source forward kernel against its plain
     version in both paddings (border, the model's, and zeros), both
     precisions and both frame layouts (channels-last: NHWC frames
     permuted, as the model passes them and the kernel takes them; and
     contiguous, which the wrapper copies into channels-last) (bitwise); at
     T = 8 time the kernel on channels-last frames (device time and call,
     as in 3; the device time also on flows of at most 2 px, whose taps
     neighbouring pixels share, and on contiguous frames, the copy
     included), the plain version and two
     yardsticks: F.grid_sample of all N*T frames at their K*H*W
     coordinates (warp only) and the whole function composed of PyTorch
     calls (grid_sample, the validity bias, softmax over T, the weighted
     sum, the composite), beside the memory bound;
 11. [kernel-mf-bwd] on those inputs, hold the multi-source backward kernel
     against the plain backward in both paddings, precisions and layouts at
     T = 3, 8, 16, 17 and 24 for three launches: the multidepth training
     launch (d_multi, no d_wts, no d_imgs), the multiflow one (neither) and
     the full one (d_multi, d_wts, d_imgs, which must come back in the
     frames' layout): d_ix, d_iy, d_conf, d_mask, d_rgb bitwise, d_imgs to
     1e-5 of its largest magnitude; time each at T = 8 on channels-last
     frames (device
     time and call, as in 3; the multidepth launch's device time also on 2
     px flows and on contiguous frames, as in 10) beside its bound, the
     plain backward and two yardsticks: the backward of F.grid_sample
     (grid gradient only) and the autograd backward of 9's composition;
 12. [reference-mf] phases 4 and 7 for the tiny f32 multiflow and
     multidepth models, shared and baked heads, T = 3, K = 2;
 13. [serve-c3md] a c3md Model.init_random (bf16, shared multidepth heads)
     answers 3 requests of B = 8, T = 8, K = 2 (synthetic orbit sources,
     dynamic scenes): the multi-source forward counter must rise by 3, the
     others by 0; the view must equal mask * warped + (1 - mask) * rgb from
     its own aux outputs (1e-5) and the blend weights sum to 1; a window of
     50 requests is timed and one request profiled;
 14. [train-c3md] c3md init_state (Adam 2e-4, constant schedule, remat)
     takes 3 steps: both multi-source counters +3, no d_imgs, the c2
     kernels +0; a window of 30 steps on one batch is timed (as in 8) and
     its loss must fall; one step is profiled; the batches come from the
     preset's own source (SyntheticFrames, host path; C3MD_OVERRIDES);
     [loop-c3md] the c3md preset through cli.train with its own data
     settings (data.source=frames with an empty root: SyntheticFrames;
     materialize_packed; device_resident=auto; device_sampling;
     steps_per_dispatch=16; cosine lr), 32 steps (checkpoint and log every
     16), cut only to data.num_scenes=64: residency must engage (auto
     resolving to off is fatal), #4 and #5 launch 32 times each, the
     image summaries counted apart; the bank's bytes, the host seconds a
     frame to materialize it and whether the full 512-scene bank fits
     data.resident_budget_mb print; then, under cudnn.deterministic, a run
     killed after its first dispatch (fail_after_step=15) and resumed to
     32 ends bitwise equal to an uninterrupted one, one of whose
     dispatches is profiled: no host-to-device copy may carry a frame's
     bytes;
     [jax-resume] a training run moved between the JAX package and the
     card (f32, warp exact, TF32 off): (a) the committed JAX run
     (tests/torch_goldens/jax_orbax/c2_adam_run: the c2 preset at tiny
     widths, adamw, cosine lr with a warmup step, EMA; stopped at step 2)
     resumed through cli.train for step 3: the loss within 1e-5 relative
     of the JAX loop's, the params within 1e-6 of optax.adamw's update of
     the JAX step with the card's gradients (written out in float64) and
     within 1e-4 of the JAX loop's step 3 plus what Adam makes of the
     gradients' difference, #1 and #3 +1 each (the image summary counted
     apart), the step it writes in the JAX layout and read back bitwise;
     (b) the c2 preset (Adam) for 2 steps, killed, its manager step
     written in the JAX layout (bytes, restore and save seconds printed),
     cli.train resuming it for 2 more in that layout: every tensor
     bitwise equal to 4 uninterrupted steps (cudnn.deterministic), #1 / #3
     +2 each; (c) the c3md preset as [loop-c3md] runs it: one dispatch,
     a JAX-layout step (bytes, seconds), a second dispatch, bitwise equal
     to [loop-c3md]'s 32 uninterrupted steps, #4 / #5 16 a dispatch; (d)
     the TF1 checkpoint tests/torch_goldens/tf1 read with no TensorFlow
     (every tensor's digest equal to TensorFlow's), imported onto the tiny
     c2 model through its name map and served on the card: views within
     1e-4 of the JAX model's, #1 +1;
 15. [kernel-sample] on the model's layout (16 c2 frames, channels-last,
     each sampled at the pixels of its K = 8 targets: P = K*H*W) and on
     128 contiguous images (one per target, the reference's layout), hold
     the plain sampler's kernel (#2) against its plain version in both
     paddings and precisions (bitwise), and, on the model's layout (no
     copy of the frames: they are staged as the forward stages them) and
     the 128 images, its backward (the no-composite launch of phase 6's
     kernel) against the plain backward (bitwise; d_img 1e-5 of its
     largest magnitude); time #2 as in 3 on the model's layout beside
     F.grid_sample on the same inputs and the bound, and on the per-target
     copy of those frames (device time, the staging copy included), and
     the no-composite backward on the model's layout beside its bound;
 16. [kernel-reproject] at the c2 shape on c2 cameras (a c2 batch's last
     frames and its B x K look-at poses, the model's intrinsics), on a
     smooth depth and on random per-pixel depths (many pixels behind the
     camera or off the image; the shares of valid pixels, in-image taps
     and pixels with no tap in the image are printed), hold the depth
     reprojection kernels #6 (sample) and #7 (sample + composite) against
     their plain versions in both precisions (max |kernel - plain| 0.0:
     value for value, a zero's sign aside, since the kernels skip the
     loads of taps without weight), on the model's layout (the 16 frames
     staged as [16, H, W, 4], each shared by its K = 8 targets), on the
     channels-last frames (the wrapper stages them) and on one contiguous
     copy per target; at C = 1 and 5 on 16 shared channels-last frames;
     and under two edge cases on the model's layout, no pixel valid and
     every correspondence off the image. Time them on the model's layout
     on both depths (the kernel alone), with the staging copy (from the
     channels-last frames), beside two yardsticks, F.grid_sample (zeros)
     of the frames at the same coordinates on both depths and the whole
     function composed of PyTorch calls (the correspondence from depth
     with torch ops, grid_sample, the validity product, the composite),
     and the bounds;
 17. [kernel-reproject-bwd] on those inputs, in those three layouts, hold
     the fused depth backward against the plain backward in both
     precisions for three launches: composite (d_view, d_geo; depth
     synthesis's training launch), sample (d_geo; the geometric side
     view's) and full (composite with d_img, one per frame): d_depth,
     d_mask, d_rgb bitwise, d_img to 1e-6 of its largest magnitude; time
     each on the model's layout (the staged frames the autograd ops keep)
     on both depths beside its bound, the plain backward and the backward
     of F.grid_sample (zeros, grid gradient only) on the same frames, and
     the composite and sample launches on the per-target copy;
 18. [reference-depth] phases 4 and 7 for the tiny c2d and c2g models;
 19. [serve-c2d] / [train-c2d] the c2 preset with the depth switches
     (DEPTH_OVERRIDES["c2d"]: depth synthesis) as in 5 and 8: exact launch
     counts per request (#2, #7) and per step (#2, #7, the depth backward's
     composite launch, no d_img), one staging copy of the last frame per
     request and per step (the forward's; none in the backward), the request's aux outputs recomputed with
     the plain versions (warp, reprojection, composite; 1e-5), windows of
     50 requests and 30 steps with a falling loss, one request and one step
     profiled; a request must show no copy of the last frame per target
     (as in 5);
 20. [serve-c2g] / [train-c2g] the same for flow synthesis with the
     geometric side view (DEPTH_OVERRIDES["c2g"]: #1 and #6 per request;
     #1, #3's composite launch, #6 and the depth backward's sample launch
     per step; one staging copy of the last frame per request and per
     step, read by both), with windows of 20 requests and 10 steps,
     unprofiled; no copy of the last frame per target (as in 5);
 21. [kernel-c1] / [serve-c1] / [train-c1], then the same for c3 and c5:
     each preset of the JAX suite beside c2 at its per-chip slice
     (benchmarks/run.py; PRESET_SLICES: c1 B = T = K = 1 at 64 x 64 in
     f32 with 4 levels; c3 B = 8, T = 8, K = 4 with remat_scan; c5 B = 4
     of its 128, T = 4, K = 2 at 256 x 256 with 6 levels, mesh.data=1),
     full width, random seed-0 weights, 4 batches rendered once from the
     preset's own source (c5: the frames source with no root,
     SyntheticFrames). [kernel-*] holds #1 and #3 at the preset's shape
     (B channels-last frames, each shared by its K targets; c1 N = 1 at
     64^2, c3 N = 32 from 8 frames at 128^2, c5 N = 8 from 4 frames at
     256^2, P = 65,536) bitwise equal to their plain versions in both
     paddings and precisions (d_img to 1e-5), and times both beside their
     bounds; [serve-*] as 5: 3 requests launch #1 and the staging copy 3
     times and nothing else, the third's view recomposited with the plain
     version (1e-5), a window of requests (p50, p90, views/s, peak
     memory), one request profiled (device busy / wall); [train-*] as 8:
     3 steps launch #1, #3's training launch and the copy 3 times, a
     window of steps with a falling loss, one step profiled. c1 also: the
     full-width f32 request on the card within 1e-4 of the CPU's on the
     same weights (warp exact, TF32 off);
 22. [serve-artifact] the serving artifacts (serving.py): a c2, a c3md
     (seq_len=(8, 3)), a c2d and a c2g model (Model.init_random, seed 0,
     on the card) exported on the CPU (torch.export programs whose
     kernels are the registered dmv3d:: operators), loaded on the card
     with no model code and served: 3 requests a T, the launch counts
     exact (c2: #1 and one staging copy a request; c3md: #4 at each T;
     c2d: #2, #7 and one copy; c2g: #1, #6 and one copy), the views
     bitwise equal to Model.predict of the same module on the same
     batches, a pose-less c3md request refused; export seconds, artifact
     bytes, load seconds, a window of 50 c2 requests and 20 c3md ones
     (p50, p90, views/s) beside [serve]'s and [serve-c3md]'s; the host
     cost of an operator's dispatch (a call of the registered operator
     against its CUDA implementation called directly); and
     torch.library.opcheck of the five forward operators on CUDA inputs;
 23. [batch-gap] the c2 preset (seed-0 weights) on the 16 rows of 3 c2
     batches and on the same rows as two halves of 8, eager: the views
     bitwise equal in bf16 and f32 with TF32 off, and in bf16 with TF32
     on (the layers in which cuDNN's bf16 result depends on the batch
     size compute in f32 with TF32 off, models/dmv3d.py _F32_CONVS);
     printed: the views' max and mean |difference|, in bf16 the first
     module whose output differs (forward hooks), the layers that differ
     given one input, and where the pixels that differ most sit against
     the image edge;
 24. [serve-mesh] the c2 artifact of 22 served with ``predict(mesh=)``
     over 2 ranks on the card (processes spawned by
     ``parallel.dryrun.spawn``, gloo: NCCL refuses two ranks on one
     device), each running its 8 rows of a B = 16 request, the views
     gathered on every rank: 3 requests a rank launch #1 and the staging
     copy 3 times; the gathered views bitwise equal to the one-process
     program on the same rows and to its request of all 16 rows;
 25. [dp-reference] the tiny f32 config, TF32 off, targets subsampled
     (K = 4 -> 2): 2 ranks on 2 rows each against one process on the
     global B = 4: loss 1e-6 relative, every gradient 1e-5 in relative L2
     (the zero-gradient biases 1e-6 of the global norm), the ranks' params
     bitwise equal after 3 steps;
 26. [dp-c4] the c4 preset at full width (B = 64 global, 32 a rank, K =
     2) through cli.train under ``torch.distributed.run`` with
     mesh.data=2 (the preset's 8 devices become 2 ranks on the card,
     gloo), cudnn.deterministic on: 8 steps (checkpoint and log every 4),
     #1 and #3 8 launches on each rank (rank 0's image summaries counted
     apart), a 4 + 4 resume pair bitwise equal to the 8 straight steps,
     only rank 0's files (manager steps 1, 4, 8, the model dir, one metrics
     log); the train step p50 and the gradient all-reduce of the c4
     params alone (host-staged through gloo); a manager step saved on the
     card restored into a CPU template, saved there and restored onto the
     card, every tensor bitwise equal to the card's save (a resume across
     devices); the two ranks' params, Adam moments and EMA bitwise equal
     after the 8 steps (a digest of each); one rank over NCCL;
 27. [dp-c3md] the c3md preset's data settings with
     data.resident_sharding=scenes, data.num_scenes=64 and mesh.data=2, 2
     spawned ranks, one dispatch of 16 device-sampled steps through the
     loop: each rank materializes and holds only its 32 scenes (half of
     [loop-c3md]'s 201,326,592 B), draws only from them, launches #4 and
     #5 16 times, and copies no pixel to the card in the profiled dispatch
     (its host-to-device copies are the all-reduces' staging); the two
     ranks' params, Adam moments and EMA bitwise equal after it;
 28. [tp-reference] the tiny f32 config, TF32 off, targets subsampled (K
     = 4 -> 2), on 4 ranks of a (data=2, model=2) mesh whose weights of
     ``model_axis_rules(min_size=16)`` are split by output channel
     (``parallel/tensor.py``) against one process on the global B = 4:
     loss 1e-6 relative, every gathered gradient 1e-5 in relative L2 (the
     zero-gradient biases 1e-6 of the global norm); after 3 steps every
     replicated param bitwise equal on the 4 ranks and each block between
     its two data ranks;
 29. [tp-c4] in the same 4 ranks, launched by ``torch.distributed.run``
     (gloo), the c4 preset at full width through cli.train with
     mesh.data=2 mesh.model=2 (the preset's 8 devices become a (2, 2)
     mesh on the card; the 23 wide convs split, min_size 128; B = 64
     global, 32 a data rank), cudnn.deterministic on: 4 steps (checkpoint
     and log every 2), #1 and #3 4 launches on each rank (rank 0's image
     summaries, rendered from the gathered module, counted apart), a 2 +
     2 resume pair bitwise equal to the 4 straight steps (gathered params
     and Adam moments), only rank 0's files (manager steps 1, 2, 4, the
     model dir, one metrics log), the replicated tensors (params, moments)
     bitwise equal on the 4 ranks and each block between its data ranks,
     the gathered state equal on all ranks and to the manager's step 4
     restored into a one-process CPU c4 template (digests); the first
     step's loss within 1e-2 relative of one process's c4 step on the
     same weights and global batch (bf16); prints the state bytes a rank
     (params, gradients, both Adam moments) beside one process's, the
     train step p50, the model axis's bytes gathered (bf16 activations)
     and reduced (f32 input gradients) a step with their ms (2 more steps,
     each collective between synchronizes) and the peak memory a rank;
 30. [jax-ckpt] checkpoints the JAX package wrote (Orbax: zstd, OCDBT,
     zarr v2; tests/torch_goldens/jax_orbax/, made by
     tests/_make_torch_orbax_goldens.py), read by the port's own reader on
     a machine with no JAX, tensorstore or zstd module: (a) every leaf of
     the tiny c2 model dir, the tiny c3md model dir and the tiny c2 run's
     manager step bitwise equal to tensorstore's reading (sha256 digests of
     dtype, shape and bytes in expected.npz); (b) Model.from_checkpoint of
     the two model dirs on the card in f32 (warp exact, TF32 off): views
     within 1e-4 of the JAX model's (max |d| / (1 + |ref|), [reference]'s
     tolerance), one request each, #1 +1 for c2 and #4 +1 for c3md, the
     other kernels 0; (c) cli.snapshot of the JAX run dir exports its EMA
     params ({"ema": true}, the model dir bitwise equal to the step's
     ema_params), whose views are within 1e-4 of the JAX EMA model's, and
     cli.predict of it on the card writes 5 PNGs (#1 +1); (d) a c2 preset
     model (Model.init_random, f32 params) written with
     save_checkpoint(fmt="orbax") and read back by Model.from_checkpoint:
     bytes, write and read seconds and MB/s printed beside the card's name
     and power limit; the state_dict bitwise equal, and 3 requests of
     B = 16, T = 1, K = 8 bitwise equal to the original model's (#1 +3);
 31. [bench] bench_torch.py as a user runs it, its one JSON line printed
     here (an earlier line, not the last); then bench_torch.py --preset
     c1 c3 c4 c5 (one line each, under the JAX suite's config names) and
     --preset c1 --device cpu, on the card's host CPU;
 32. print the kernels line — each kernel's "ms" is its device time,
     "call_ms" a call of its wrapper, "library_ms" the one-call yardstick
     named by "library", "composition_ms" the composed one where timed;
     "launches_by_path" includes the served artifacts' paths and rank
     0's launches on the data- and model-parallel paths — then the
     result line last.

Every profiled request and step also prints its count of host-to-device
copies; "[time]" lines split the run's wall by phase group.

The fixed-batch c3md phases run the preset with its model and source
unchanged; their overrides (C3MD_OVERRIDES) keep only what a window of 30
single steps on one host batch needs: no device sampling or materialized
bank, one step a call, a constant learning rate. [loop-c3md] runs the
preset's data settings as they are, with 64 of its 512 scenes. No preset
turns depth on: c2d and c2g are the c2 preset with the model switches of
DEPTH_OVERRIDES.

Exits 1 with no result when no CUDA device is present, and fails at import
when run outside a checkout of the repo.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import hashlib
import io
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import warnings
import zlib

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM data-sheet peaks (dense): HBM bandwidth and f32 (non-tensor-core)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def _timed_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, CUDA events:
    the device's time, or the host's where the host issues the calls more
    slowly than the device runs them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _queued_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn`` from CUDA events, its calls queued
    behind a sleep on the device so that the host's issue time does not
    show: all of ``fn``'s kernels, the gaps between launches included."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _profiled(fn, iters: int):
    """The CUDA kernel events of one torch.profiler session of ``iters``
    calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.count > 0]


def _kernel_ms(fn, kernel: str, iters: int = 20, sessions: int = 8) -> float:
    """Device time per call of ``fn`` of the CUDA kernel whose name holds
    ``kernel`` (torch.profiler): the kernel alone, whatever the host spends
    around its launch; ``fn`` launches it once. Late in a long run the
    profiler delivers only some of a session's launches (0 to 19 of 20 on
    an H100), so sessions are added
    until they show ``iters`` launches in all, up to ``sessions``, and the
    mean is over the launches shown. Where none shows, ``_queued_ms``."""
    fn()
    torch.cuda.synchronize()
    seen, total_us = 0, 0.0
    for done in range(1, sessions + 1):
        events = [e for e in _profiled(fn, iters) if kernel in e.key]
        seen += sum(e.count for e in events)
        total_us += sum(e.self_device_time_total for e in events)
        if seen >= iters:
            break
    if seen < done * iters:
        print(f"[profile] {done} sessions saw {seen} of {done * iters} "
              f"launches of {kernel}" + (": their mean" if seen else
                                         ": CUDA events instead"))
    if not seen:
        return _queued_ms(fn, iters)
    return total_us / seen / 1e3


def _device_ms(fn, iters: int = 20, sessions: int = 8) -> tuple:
    """Device time per call of ``fn``, all its CUDA kernels together
    (torch.profiler), and each kernel's share by name: a kernel's mean over
    the launches shown, times its launches per call (those shown over
    ``iters``, rounded; see ``_kernel_ms`` for the launches a session
    drops). A session that shows no kernel is profiled again; where none
    shows one, ``_queued_ms`` and no shares."""
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        parts = {e.key: e.self_device_time_total / e.count / 1e3
                 * max(1, round(e.count / iters))
                 for e in _profiled(fn, iters)
                 if e.self_device_time_total > 0}
        if parts:
            return sum(parts.values()), parts
    print(f"[profile] {sessions} sessions saw no kernel: CUDA events "
          f"instead")
    return _queued_ms(fn, iters), {}


# the kernel sources built once each, and the multi-source ones, built per
# (T, padding) instantiation: every pair the phases below launch
KERNEL_SOURCES = ("warp_composite", "warp_composite_bwd", "sample",
                  "reproject", "reproject_bwd")
MF_SOURCES = ("multiflow_composite", "multiflow_composite_bwd")
MF_TS = (3, 8, 16, 17, 24)                 # 8: c3md's; 3: the tiny models'
PADDINGS = ("border", "zeros")

# the c3md preset at full width on its own source (SyntheticFrames: frames,
# empty root), cut only to what a window of 30 single steps on one fixed
# host batch needs: no device sampling or materialized bank (the batch is
# the host's), one step a call, a constant lr (so 30 steps show a falling
# loss). [loop-c3md] runs the preset's data settings as they are.
C3MD_OVERRIDES = ("data.device_sampling=false",
                  "data.materialize_packed=false",
                  "train.steps_per_dispatch=1", "train.lr_schedule=constant")

# the depth slice at full c2 width: depth synthesis (c2d) and flow synthesis
# with the geometric side view (c2g)
DEPTH_OVERRIDES = {"c2d": ("model.synthesis=depth", "model.predict_depth=true"),
                   "c2g": ("model.predict_depth=true",)}

# the counts a function keeps, and their keys' suffixes: a kernel
# wrapper's launches, of a backward's launches those that computed the
# image gradient and those with the composite; the staging copies of
# _build.stage
_COUNTERS = (("launches", ""), ("img_launches", ":img"),
             ("composite_launches", ":composite"), ("copies", ":copies"))


def _counted(gs, mf, rp) -> dict:
    """Each kernel's wrapper by its name in the kernels line, and
    ``_build.stage`` (its copies: the model stages its last frame once per
    forward, and no wrapper copies it again)."""
    return {"warp_composite_fwd": gs.warp_composite_pix,
            "warp_composite_bwd": gs.warp_composite_pix_bwd,
            "multiflow_composite_fwd": mf.multiflow_composite_pix,
            "multiflow_composite_bwd": mf.multiflow_composite_pix_bwd,
            "sample_fwd": gs.sample_pixel_coords,
            "reproject_sample_fwd": rp.reproject_sample_pix,
            "reproject_composite_fwd": rp.reproject_composite_pix,
            "reproject_bwd": rp.reproject_pix_bwd,
            "stage": rp._build.stage}


def _reset_counts(counted: dict) -> None:
    for fn in counted.values():
        for attr, _ in _COUNTERS:
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def _read_counts(counted: dict) -> dict:
    """Launches per kernel (``<name>``), of a backward's launches those
    that computed the image gradient (``<name>:img``) and those with the
    composite (``<name>:composite``), and the staging copies
    (``stage:copies``)."""
    return {name + suffix: getattr(fn, attr)
            for attr, suffix in _COUNTERS for name, fn in counted.items()
            if hasattr(fn, attr)}


def _set_counts(counted: dict, counts: dict) -> None:
    """Put back counts that ``_read_counts`` read."""
    for attr, suffix in _COUNTERS:
        for name, fn in counted.items():
            if hasattr(fn, attr):
                setattr(fn, attr, counts[name + suffix])


def _expect_counts(what: str, counts: dict, want: dict) -> None:
    """Every count is 0 except those in ``want``."""
    expected = {k: want.get(k, 0) for k in counts}
    print(f"[{what}] launches: {counts}")
    if counts != expected:
        raise AssertionError(f"{what}: expected launches {expected}, saw "
                             f"{counts}")


def phase_build(build, mf, native, zstd, tf1) -> float:
    """Every library this script launches, one nvcc each, the native
    frame packer, the zstd decoder and the CRC32C of the TensorFlow
    checkpoint reader (g++), all started together; each build's cold
    seconds (under the others' contention) and ptxas summary. -> the
    packer's build seconds."""
    jobs = [(name, ()) for name in KERNEL_SOURCES] + [
        (name, mf._defines(t, padding)) for name in MF_SOURCES
        for t in MF_TS for padding in PADDINGS]

    def one(job):
        t0 = time.perf_counter()
        log = build.build(*job)
        return job, time.perf_counter() - t0, log

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs) + 1) as pool:
        packer = pool.submit(native.build)
        decoder = pool.submit(zstd.build)
        crc = pool.submit(tf1.build)
        results = list(pool.map(one, jobs))
        _, packer_s = packer.result()
        _, decoder_s = decoder.result()
        _, crc_s = crc.result()
    print(f"[build] {len(jobs)} libraries, the frame packer and the zstd "
          f"decoder in "
          f"{time.perf_counter() - t0:.2f} s, all started together on "
          f"{os.cpu_count()} CPUs (nvcc {' '.join(build.NVCC_FLAGS)})")
    print(f"[build] native frame packer (g++ {' '.join(native.CXX_FLAGS)}) "
          f"in {packer_s:.2f} s" + (" (cached)" if not packer_s else ""))
    print(f"[build] zstd decoder (g++ {' '.join(zstd.CXX_FLAGS)}) in "
          f"{decoder_s:.2f} s" + (" (cached)" if not decoder_s else ""))
    print(f"[build] CRC32C (g++ {' '.join(tf1.CXX_FLAGS)}) in "
          f"{crc_s:.2f} s" + (" (cached)" if not crc_s else ""))
    native.load()
    zstd.load()
    tf1.fast_crc32c(b"")
    for (name, defines), secs, log in results:
        what = " ".join([name, *defines])
        print(f"[build] {what} in {secs:.2f} s")
        for line in ptxas_summary(log).splitlines():
            print(f"[build] {what}: {line}")
        build.load(name, defines)
    return packer_s


def ptxas_summary(log: str) -> str:
    """ptxas's registers and spills (-Xptxas=-v), one line per kernel and
    its instantiations' template flags (registers by the first template
    argument where there are several, as the multi-source kernels' T), and
    a line per instantiation that spills."""
    import re
    rows, spills, name = {}, [], None
    for line in log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"\d([a-z][a-z_]*_kernel)(I(?:Li(\d+)E)?"
                          r"((?:Lb\dE)*))?", line)
            name = (m.group(1), int(m.group(3) or 0),
                    "".join(re.findall(r"Lb(\d)E", m.group(4) or "")))
        elif name and "spill stores" in line and not \
                line.strip().startswith("0 bytes stack frame, 0 bytes spill"):
            spills.append(f"spills {name}: {line.strip()}")
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.setdefault((name[0], name[2]), {})[name[1]] = int(m.group(1))
    out = [f"{k} flags {f or '-'}: registers "
           + (str(v[0]) if list(v) == [0] else
              f"by T {dict(sorted(v.items()))}")
           for (k, f), v in sorted(rows.items())]
    return "\n".join(out + (spills or ["no spills"]))


def phase_card() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print("[card] name, power limit (nvidia-smi):")
    print(line)
    return line


def _kernel_inputs():
    """The warp's inputs at the c2 shape, from seed 0: image, coordinates,
    mask, rgb."""
    n, c, h, w = 128, 3, 128, 128
    p = h * w
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    img = uniform((n, c, h, w), -1.0, 1.0)
    # flows of up to 80 px: reach past every border, most pixels stay inside
    flow = uniform((n, 2, h, w), -80.0, 80.0)
    ix = (torch.arange(w, device=dev, dtype=torch.float32) + flow[:, 0]) \
        .reshape(n, p).contiguous()
    iy = (torch.arange(h, device=dev, dtype=torch.float32)[:, None]
          + flow[:, 1]).reshape(n, p).contiguous()
    mask = uniform((n, p), 0.0, 1.0)
    rgb = uniform((n, c, p), -1.0, 1.0)
    return img, ix, iy, mask, rgb


def _grid(ix, iy, h, w):
    """Pixel coordinates [N, P] in an h x w image as F.grid_sample's
    normalized grid (align_corners), [N, P / w, w, 2]: P = K*h*w, the K
    targets of a shared frame, stacks their rows."""
    n = ix.shape[0]
    return torch.stack([ix.reshape(n, -1, w) * (2.0 / (w - 1)) - 1.0,
                        iy.reshape(n, -1, w) * (2.0 / (h - 1)) - 1.0], dim=-1)


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


# the two layouts #1 and #3 are held and timed in: flow synthesis's and the
# reference's (one image per target)
MODEL_LAYOUT = "model (16 shared channels-last frames, K=8)"
COPY_LAYOUT = "per-target copy (128 contiguous images, K=1)"


def _warp_layouts() -> dict:
    """#1/#3's inputs at the c2 shape, N = 128 targets of 3 x 128 x 128 with
    ``_kernel_inputs``'s coordinates (80 px flows), mask and rgb, in two
    layouts: the model's, the 16 channels-last frames of
    ``_shared_sample_inputs``, each shared by its K = 8 targets; and one
    contiguous copy of each frame per target."""
    frames = _shared_sample_inputs()[0]
    rest = _kernel_inputs()[1:]
    k = rest[0].shape[0] // frames.shape[0]
    return {MODEL_LAYOUT: (frames, *rest),
            COPY_LAYOUT: (_per_target_copy(frames, k), *rest)}


def _warp_c_inputs(c: int, b: int = 16, k: int = 8, hw: int = 64,
                   max_flow: float = 80.0):
    """#1/#3's inputs for C = ``c`` channels (the instantiations the model
    does not launch), from seed 7: b channels-last frames of c x hw x hw,
    each shared by its k targets, flows of up to ``max_flow`` px."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    n, p = b * k, hw * hw
    frames = (torch.rand((b, hw, hw, c), generator=g, device=dev) * 2 - 1) \
        .permute(0, 3, 1, 2)
    flow = torch.rand((n, 2, hw, hw), generator=g, device=dev) \
        * (2 * max_flow) - max_flow
    base = torch.arange(hw, device=dev, dtype=torch.float32)
    ix = (base + flow[:, 0]).reshape(n, p).contiguous()
    iy = (base[:, None] + flow[:, 1]).reshape(n, p).contiguous()
    mask = torch.rand((n, p), generator=g, device=dev)
    rgb = torch.rand((n, c, p), generator=g, device=dev) * 2 - 1
    return frames, ix, iy, mask, rgb


def _warp_cases() -> dict:
    """Every input set #1/#3 are held on: both c2 layouts, and C = 1 and 5
    on shared channels-last frames."""
    cases = _warp_layouts()
    cases.update({f"C={c} (16 shared channels-last frames of {c} x 64 x 64, "
                  f"K=8)": _warp_c_inputs(c) for c in (1, 5)})
    return cases


def _warp_bytes(n, c, p, n_frames, hw, per_pixel):
    """Bytes #1/#3 move: ``per_pixel`` f32 values per target pixel, and
    the frames read once."""
    return 4 * (n * p * per_pixel + n_frames * c * hw)


def phase_kernel(gs) -> dict:
    cases = _warp_cases()
    errs = []
    for layout, inp in cases.items():
        for padding in PADDINGS:
            for precision in ("exact", "fast"):
                ours = gs.warp_composite_pix(*inp, padding, precision)
                torch.cuda.synchronize()
                ref = gs.warp_composite_pix_plain(*inp, padding, precision)
                if layout == COPY_LAYOUT:             # the model's output too
                    ref = gs.warp_composite_pix_plain(
                        *cases[MODEL_LAYOUT], padding, precision)
                err = max(float((o - r).abs().max()) for o, r in zip(ours,
                                                                     ref))
                print(f"[kernel] {layout}, {padding}, {precision}: max "
                      f"|kernel - plain| = {err!r} (valid share "
                      f"{float(ours[2].mean()):.3f})")
                if err != 0.0:
                    raise AssertionError(f"kernel disagrees with plain "
                                         f"({layout}, {padding}, "
                                         f"{precision}): {err}")
                errs.append(err)

    frames, ix, iy, mask, rgb = cases[MODEL_LAYOUT]
    b, c, h, w = frames.shape
    n, p = ix.shape
    args = (*cases[MODEL_LAYOUT], "border")
    copy = (*cases[COPY_LAYOUT], "border", "fast")
    call_ms = {prec: _timed_ms(lambda: gs.warp_composite_pix(*args, prec),
                               50) for prec in ("fast", "exact")}
    kernel_ms = _kernel_ms(lambda: gs.warp_composite_pix(*args, "fast"),
                           "warp_composite_fwd_kernel")
    # the wrapper's device time: the frames' staging copy and the kernel
    staged_ms, _ = _device_ms(lambda: gs.warp_composite_pix(*args, "fast"))
    copy_ms, _ = _device_ms(lambda: gs.warp_composite_pix(*copy))
    copy_kernel_ms = _kernel_ms(lambda: gs.warp_composite_pix(*copy),
                                "warp_composite_fwd_kernel")
    # the same copy in NHWC memory, as the public flow_warp_composite
    # passes one image per target: its staging copy reads NHWC
    nhwc = (copy[0].movedim(1, -1).contiguous().movedim(-1, 1),
            *copy[1:])
    nhwc_ms, _ = _device_ms(lambda: gs.warp_composite_pix(*nhwc))
    plain_ms = _timed_ms(lambda: gs.warp_composite_pix_plain(*args, "fast"),
                         10)
    grid = _grid(ix.reshape(b, -1), iy.reshape(b, -1), h, w)
    library_ms = _timed_ms(lambda: F.grid_sample(
        frames, grid, mode="bilinear", padding_mode="border",
        align_corners=True), 50)
    # each input read once, each output written once: ix, iy, mask, 3 rgb
    # in, 3 view, 3 warped, valid out per pixel (f32); the frames once
    nbytes = _warp_bytes(n, c, p, b, h * w, 3 + c + 2 * c + 1)
    # per pixel ~20 flops of coordinates and weights, ~12 per channel
    bound_ms, bound_by = _bound(nbytes, n * p * (20 + 12 * c))
    print(f"[kernel] c2 shape, the model's layout: {n} targets of {c} x {h}"
          f" x {w} from {b} frames, border: kernel fast {kernel_ms!r} ms on "
          f"the device (profiler), with the frames' staging copy "
          f"{staged_ms!r} ms; call of the wrapper fast {call_ms['fast']!r} "
          f"ms, exact {call_ms['exact']!r} ms (events, 50 back to back); "
          f"per-target copy (the staging copy and the kernel) {copy_ms!r} "
          f"ms, its kernel {copy_kernel_ms!r} ms, in NHWC memory (the public "
          f"NHWC op's) {nhwc_ms!r} ms; plain (fast) {plain_ms!r} "
          f"ms; F.grid_sample of the {b} frames at the same coordinates "
          f"(warp only) {library_ms!r} ms; bound {bound_ms!r} ms ({nbytes} "
          f"B at 3.35 TB/s)")
    return {"max_abs_err": max(errs), "ms": kernel_ms,
            "ms_with_staging": staged_ms, "ms_per_target_copy": copy_ms,
            "ms_per_target_nhwc": nhwc_ms,
            "call_ms": call_ms["fast"], "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "F.grid_sample border (warp only), the same frames "
                       "and coordinates", "bound_ms": bound_ms,
            "bound_by": bound_by}


def _tiny_config(config):
    """The tiny f32 config the CPU tests hold the port to JAX with."""
    return config.override(config.Config(), [
        "model.image_size=32", "model.num_levels=3", "model.base_features=8",
        "model.max_features=16", "model.gru_features=16",
        "model.pose_embed_dim=8", "model.dtype=float32",
        "model.warp_precision=exact", "data.image_size=32"])


def phase_reference(config, Model, DMV3D, synthetic, extra=(), t=2, k=3,
                    tag="reference"):
    """The tiny f32 config (plus ``extra`` overrides) on CUDA against the
    CPU, from the same weights, on T = t frames and K = k targets."""
    cfg = config.override(_tiny_config(config), list(extra))
    cpu = Model.init_random(cfg, seed=123, device="cpu")
    module = DMV3D(cfg.model, num_sources=cpu.module.num_sources)
    module.load_state_dict(cpu.module.state_dict())
    gpu = Model(cfg, module.to("cuda").eval())
    rng = np.random.default_rng(0)
    seq = synthetic.smooth_images(rng, 2, t, 32)
    poses = synthetic.random_poses(rng, 2, t + k)
    ref = cpu.predict(seq, poses[:, t:], source_poses=poses[:, :t],
                      return_aux=True)
    out = gpu.predict(seq, poses[:, t:], source_poses=poses[:, :t],
                      return_aux=True)
    scale = {"flow": cfg.model.max_flow * cfg.model.image_size}
    errs = {k: float((out[k].cpu() - ref[k]).abs().max()) / scale.get(k, 1.0)
            for k in ref}
    print(f"[{tag}] tiny f32 config {list(extra)}, CUDA vs CPU path (flow "
          f"in units of its range): {errs}")
    bad = {k: e for k, e in errs.items() if not e <= 1e-4}
    if bad:
        raise AssertionError(f"CUDA path disagrees with the CPU path: {bad}")


def c2_batches(config, synthetic, count=4):
    """``count`` c2 batches (B = 16, T = 1, K = 8) of uint8 images from the
    port's SyntheticScenes, seed 0."""
    cfg = config.get_config("c2")
    b = cfg.data.batch_size
    t0 = time.perf_counter()
    scenes = synthetic.SyntheticScenes(
        num_scenes=64, image_size=cfg.model.image_size,
        seq_len=cfg.data.seq_len, num_targets=cfg.data.num_targets, seed=0)
    batches = [scenes.batch(range(i * b, (i + 1) * b), raw=True)
               for i in range(count)]
    print(f"[data] {count} c2 batches of B={b} K={cfg.data.num_targets} "
          f"rendered "
          f"in {time.perf_counter() - t0:.2f} s")
    return batches


def phase_serve(config, Model, synthetic, gs, counted, raw_batches) -> dict:
    cfg = config.get_config("c2")
    b, k, hw = cfg.data.batch_size, cfg.data.num_targets, cfg.model.image_size
    t0 = time.perf_counter()
    model = Model.init_random(cfg, seed=0, device="cuda")
    batches = [dict(raw, image_seq=synthetic.to_model(raw["image_seq"]),
                    tgt_images=synthetic.to_model(raw["tgt_images"]))
               for raw in raw_batches]
    print(f"[serve] c2 model ({sum(p.numel() for p in model.module.parameters())}"
          f" params, {cfg.model.dtype}, warp {cfg.model.warp_precision}) in "
          f"{time.perf_counter() - t0:.2f} s")

    def request(batch, aux=False):
        return model.predict(batch["image_seq"], batch["tgt_poses"],
                             source_poses=batch["src_poses"], return_aux=aux)

    request(batches[0])                       # warm-up (cuDNN plans, build)
    torch.cuda.synchronize()
    _reset_counts(counted)
    outs = [request(batch, aux=(i == 2))
            for i, batch in enumerate(batches[1:])]
    torch.cuda.synchronize()
    counts = _read_counts(counted)
    _expect_counts("serve", counts, {"warp_composite_fwd": 3,
                                     "stage:copies": 3})

    for view in outs[:2] + [outs[2]["view"]]:
        if tuple(view.shape) != (b, k, hw, hw, 3) or \
                not bool(torch.isfinite(view).all()):
            raise AssertionError(f"bad view: shape {tuple(view.shape)}")
    _recomposite("serve", gs, cfg, batches[3], outs[2])
    _time_requests("serve", request, batches, 50, b * k)
    phase_profile(lambda: request(batches[1]), "one c2 request")
    copies = frame_copies(lambda: request(batches[1]), b, hw, hw)
    # the detector's control: a call that does repeat such a frame
    frame = torch.as_tensor(batches[1]["image_seq"][:, -1], device="cuda") \
        .permute(0, 3, 1, 2)
    planted = frame_copies(lambda: frame.repeat_interleave(k, dim=0), b, hw,
                           hw)
    print(f"[serve] ops repeating the [{b}, 3, {hw}, {hw}] last frame per "
          f"target in one c2 request: {copies}; in the planted copy (the "
          f"control): {planted}")
    if copies or not planted:
        raise AssertionError(f"the c2 request copied the frame per target "
                             f"({copies}), or the planted copy went unseen "
                             f"({planted})")
    return counts


WINDOWS = {}        # tag -> (p50 ms, p90 ms, views/s) of _time_requests


def _time_requests(tag, request, batches, requests, views):
    """Latency p50, p90 and views/s over a window of requests, kept in
    ``WINDOWS[tag]``."""
    latencies = []
    t_window = time.perf_counter()
    for i in range(requests):
        t0 = time.perf_counter()
        request(batches[i % len(batches)])
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
    window = time.perf_counter() - t_window
    p50, p90, lo, hi = (float(x) for x in np.percentile(
        np.asarray(latencies) * 1e3, [50, 90, 0, 100]))
    print(f"[{tag}] {requests} requests in {window!r} s: latency p50 {p50!r} "
          f"ms, p90 {p90!r} ms, min {lo!r} ms, max {hi!r} ms; "
          f"{requests * views / window!r} views/s")
    WINDOWS[tag] = (p50, p90, requests * views / window)


def phase_kernel_bwd(gs) -> dict:
    cases = _warp_cases()
    errs = []
    # (need_img, d_warped given): the last is the training path's launch
    variants = ((True, True), (True, False), (False, False))
    for layout, inp in cases.items():
        g = torch.Generator(device="cuda").manual_seed(1)
        d_view, d_warped = (torch.randn(inp[4].shape, generator=g,
                                        device="cuda") for _ in range(2))
        for padding, precision in ((pd, pr) for pd in PADDINGS
                                   for pr in ("exact", "fast")):
            for need_img, with_warped in variants:
                dw = d_warped if with_warped else None
                ours = gs.warp_composite_pix_bwd(*inp, d_view, dw, padding,
                                                 precision,
                                                 need_img=need_img)
                torch.cuda.synchronize()
                ref = gs.warp_composite_pix_bwd_plain(*inp, d_view, dw,
                                                      padding, precision,
                                                      need_img=need_img)
                err = max(float((o - r).abs().max())
                          for o, r in zip(ours[1:], ref[1:]))
                if need_img:
                    img_scale = max(1.0, float(ref[0].abs().max()))
                    img_err = float((ours[0] - ref[0]).abs().max()) \
                        / img_scale
                    img_note = f"d_img {img_err!r} of its largest |value| " \
                        f"{img_scale!r}"
                    if ours[0].shape != inp[0].shape:
                        img_err = float("inf")
                else:
                    img_err = 0.0 if ours[0] is None else float("inf")
                    img_note = "d_img " + ("None" if ours[0] is None
                                           else "returned")
                print(f"[kernel-bwd] {layout}, {padding}, {precision}, d_img "
                      f"{'on' if need_img else 'off'}, d_warped "
                      f"{'given' if dw is not None else 'None'}: max "
                      f"|kernel - plain| over d_ix, d_iy, d_mask, d_rgb = "
                      f"{err!r}; {img_note}")
                if not (err == 0.0 and img_err <= 1e-5):
                    raise AssertionError(
                        f"backward kernel disagrees with plain ({layout}, "
                        f"{padding}, {precision}, need_img {need_img}): "
                        f"{err}, d_img {img_err}")
                errs.append(err)

    frames, ix, iy, mask, rgb = cases[MODEL_LAYOUT]
    b, c, h, w = frames.shape
    n, p = ix.shape
    g = torch.Generator(device="cuda").manual_seed(1)
    d_view = torch.randn(rgb.shape, generator=g, device="cuda")
    # the frame as the autograd op keeps it for the backward: staged
    staged = gs._build.stage(frames)
    rest = (ix, iy, mask, rgb, d_view, None, "border")

    def kernel(img, precision, need_img):
        return lambda: gs.warp_composite_pix_bwd(img, *rest, precision,
                                                 need_img=need_img)
    call_ms = {(prec, img_on): _timed_ms(kernel(staged, prec, img_on), 50)
               for prec in ("fast", "exact") for img_on in (False, True)}
    kernel_ms = _kernel_ms(kernel(staged, "fast", False),
                           "warp_composite_bwd_kernel")
    staged_ms, _ = _device_ms(kernel(frames, "fast", False))
    copy = cases[COPY_LAYOUT][0]
    copy_ms, _ = _device_ms(kernel(copy, "fast", False))
    copy_kernel_ms = _kernel_ms(
        kernel(gs._build.stage(copy), "fast", False),
        "warp_composite_bwd_kernel")
    plain_ms = _timed_ms(lambda: gs.warp_composite_pix_bwd_plain(
        frames, *rest, "fast", need_img=False), 10)
    grid = _grid(ix.reshape(b, -1), iy.reshape(b, -1), h, w) \
        .requires_grad_(True)
    out = F.grid_sample(frames, grid, mode="bilinear", padding_mode="border",
                        align_corners=True)
    d_out = d_view.reshape(b, -1, c, p).transpose(1, 2).reshape(out.shape)
    library_ms = _timed_ms(lambda: torch.autograd.grad(
        out, grid, d_out, retain_graph=True), 50)
    # each input read once, each output written once: ix, iy, mask, 3 rgb,
    # 3 d_view in; d_ix, d_iy, d_mask, 3 d_rgb out per pixel (f32); the
    # frames once; d_img adds its own [N/K, C, H, W] output
    nbytes = _warp_bytes(n, c, p, b, h * w, 3 + 2 * c + 3 + c)
    # per pixel ~30 flops of coordinates, weights and subgradients, ~35
    # per channel
    bound_ms, bound_by = _bound(nbytes, n * p * (30 + 35 * c))
    bound_img_ms, _ = _bound(nbytes + 4 * b * c * h * w,
                             n * p * (30 + 43 * c))
    print(f"[kernel-bwd] c2 shape, the model's layout: {n} targets from {b} "
          f"frames, no d_warped: kernel without d_img fast {kernel_ms!r} ms "
          f"on the device (profiler, the staged frame the autograd op "
          f"keeps), from the channels-last frames (staging copy included) "
          f"{staged_ms!r} ms; calls (events): without d_img fast "
          f"{call_ms['fast', False]!r} ms, exact "
          f"{call_ms['exact', False]!r} ms; with d_img fast "
          f"{call_ms['fast', True]!r} ms, exact {call_ms['exact', True]!r} "
          f"ms; per-target copy (staging copy and kernel) {copy_ms!r} ms, "
          f"its kernel {copy_kernel_ms!r} ms; plain (fast, no d_img) "
          f"{plain_ms!r} ms; F.grid_sample backward of the {b} frames (grid "
          f"only) {library_ms!r} ms; bound {bound_ms!r} ms ({nbytes} B at "
          f"3.35 TB/s), with d_img {bound_img_ms!r} ms")
    return {"max_abs_err": max(errs), "ms": kernel_ms,
            "ms_with_staging": staged_ms, "ms_per_target_copy": copy_ms,
            "call_ms": call_ms["fast", False], "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "F.grid_sample border backward (grid only), the same "
                       "frames and coordinates", "bound_ms": bound_ms,
            "bound_by": bound_by}


# the tiny config's biases whose true gradient is zero: each feeds a
# GroupNorm with one channel per group, which subtracts it again
ZERO_GRAD = ("recurrent.encoder.stem.conv.bias", "decoder.fuse0_x.bias")
# multidepth's shared head emits one confidence logit for every source: its
# bias shifts all of them alike, and the softmax over sources ignores that
ZERO_GRAD_MD_SHARED = ZERO_GRAD + ("decoder.srchead_out.bias",)


def phase_train_reference(config, synthetic, tstep, extra=(), t=1, k=3,
                          zero=ZERO_GRAD, tag="train-reference"):
    """One train step of the tiny f32 config (plus ``extra``) on CUDA and
    on the CPU from the same weights and batch."""
    cfg = config.override(_tiny_config(config),
                          ["data.batch_size=2", *extra])
    rng = np.random.default_rng(0)
    batch = {"image_seq": synthetic.smooth_images(rng, 2, t, 32),
             "src_poses": synthetic.random_poses(rng, 2, t),
             "tgt_poses": synthetic.random_poses(rng, 2, k),
             "tgt_images": synthetic.smooth_images(rng, 2, k, 32)}
    runs = {}
    for dev in ("cpu", "cuda"):
        state = tstep.init_state(cfg, seed=123, device=dev)
        _, metrics = tstep.make_train_step(cfg, device=dev)(state, batch)
        runs[dev] = (metrics["loss/total"],
                     {n: q.grad.detach().cpu().double()
                      for n, q in state.module.named_parameters()})
    (loss_ref, ref), (loss, ours) = runs["cpu"], runs["cuda"]
    norm = float(torch.sqrt(sum((g * g).sum() for g in ref.values())))
    loss_err = abs(loss - loss_ref) / abs(loss_ref)
    rel, zeros, bad = {}, {}, {}
    for name, r in ref.items():
        err = float((ours[name] - r).norm())
        if name in zero:
            zeros[name] = err / norm
            ok = err <= 1e-6 * norm
        else:
            rel[name] = err / float(r.norm())
            ok = rel[name] <= 1e-4
        if not ok:
            bad[name] = err
    worst = max(rel, key=rel.get)
    print(f"[{tag}] tiny f32 config {list(extra)}, one train step, CUDA vs "
          f"CPU: loss {loss!r} vs {loss_ref!r} ({loss_err!r} relative); "
          f"{len(rel)} gradients, max relative L2 {rel[worst]!r} ({worst}); "
          f"zero-gradient biases / global norm {zeros}")
    if not (loss_err <= 1e-5 and not bad):
        raise AssertionError(f"CUDA train step disagrees with the CPU one: "
                             f"loss {loss_err}, gradients {bad}")


def phase_train(config, tstep, counted, raw_batches) -> tuple:
    cfg = config.get_config("c2")
    t0 = time.perf_counter()
    state = tstep.init_state(cfg, seed=0, device="cuda")
    step = tstep.make_train_step(cfg, device="cuda")
    t = cfg.train
    print(f"[train] c2 state ({sum(q.numel() for q in state.module.parameters())}"
          f" params, {cfg.model.dtype}, warp {cfg.model.warp_precision}, "
          f"{t.optimizer} lr {t.lr} {t.lr_schedule}, targets_per_step "
          f"{cfg.data.targets_per_step}) in {time.perf_counter() - t0:.2f} s")
    counts, p50 = _train_window(
        "train", "c2", state, step, counted, raw_batches,
        {"warp_composite_fwd": 3, "warp_composite_bwd": 3,
         "warp_composite_bwd:composite": 3, "stage:copies": 3},
        cfg.data.batch_size * cfg.data.num_targets)
    b, hw = cfg.data.batch_size, cfg.model.image_size
    copies = frame_copies(lambda: step(state, raw_batches[0]), b, hw, hw)
    print(f"[train] ops repeating the [{b}, 3, {hw}, {hw}] last frame per "
          f"target in one c2 step: {copies}")
    if copies:
        raise AssertionError("the c2 step copied the frame per target")
    return counts, p50


def _train_window(tag, name, state, step, counted, raw_batches, want,
                  views, steps=30, profile=True):
    """A warm-up step; 3 steps in which every kernel launches as ``want``
    says (absent: 0; no backward computes the image gradient); a window of
    ``steps`` steps on one batch (step p50, p90, steps/s, target views/s,
    peak memory) whose loss must fall; one profiled step. -> (the 3 steps'
    launch counts, the window's step p50 in ms)."""
    step(state, raw_batches[0])               # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    _reset_counts(counted)
    losses = [step(state, batch)[1]["loss/total"] for batch in raw_batches[1:]]
    torch.cuda.synchronize()
    counts = _read_counts(counted)
    print(f"[{tag}] losses over 3 steps: {losses}")
    _expect_counts(tag, counts, want)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")

    torch.cuda.reset_peak_memory_stats()
    times, window_losses = [], []
    t_window = time.perf_counter()
    for _ in range(steps):
        t0 = time.perf_counter()
        _, metrics = step(state, raw_batches[0])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        window_losses.append(metrics["loss/total"])
    window = time.perf_counter() - t_window
    p50, p90, lo, hi = (float(x) for x in np.percentile(
        np.asarray(times) * 1e3, [50, 90, 0, 100]))
    print(f"[{tag}] {steps} steps on one batch in {window!r} s: step p50 "
          f"{p50!r} ms, p90 {p90!r} ms, min {lo!r} ms, max {hi!r} ms; "
          f"{steps / window!r} steps/s, {steps * views / window!r} target "
          f"views/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    print(f"[{tag}] loss over the window: first {window_losses[0]!r}, last "
          f"{window_losses[-1]!r}")
    if not window_losses[-1] < window_losses[0]:
        raise AssertionError("the loss did not fall over the window")
    if profile:
        phase_profile(lambda: step(state, raw_batches[0]),
                      f"one {name} train step")
    return counts, p50


# the c2 preset through the training loop and the CLIs ([loop-c2]): 8 steps
# with a checkpoint every 4 and a log line every 4
LOOP_SETS = ("train.num_steps=8", "train.ckpt_every=4", "train.log_every=4")
# Orbax's default save policy over steps 1..8: the first step (no
# checkpoint yet), then every 4th; max_to_keep 3 keeps all three
LOOP_MANAGER_STEPS = [1, 4, 8]


@contextlib.contextmanager
def _loop_timers(loop_lib, counted):
    """Host seconds of each call of the loop's batch function and of its
    train step (which ends in a sync: the metrics' fetch), by wrapping the
    two factories the loop calls; and the launches of its image summaries
    (a forward each), kept apart from the steps' counts."""
    times = {"batch": [], "step": []}
    summary_counts = dict.fromkeys(_read_counts(counted), 0)
    make_batch, make_step = loop_lib._make_batch_fn, \
        loop_lib.step_lib.make_train_step
    write_summaries = loop_lib._write_image_summaries

    def summaries(*args, **kw):
        before = _read_counts(counted)
        _reset_counts(counted)
        write_summaries(*args, **kw)
        for key, n in _read_counts(counted).items():
            summary_counts[key] += n
        _set_counts(counted, before)

    def timed(kind, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            times[kind].append(time.perf_counter() - t0)
            return out
        return run

    loop_lib._make_batch_fn = lambda *a, **k: timed("batch",
                                                    make_batch(*a, **k))
    loop_lib.step_lib.make_train_step = lambda *a, **k: timed(
        "step", make_step(*a, **k))
    loop_lib._write_image_summaries = summaries
    try:
        yield times, summary_counts
    finally:
        loop_lib._make_batch_fn = make_batch
        loop_lib.step_lib.make_train_step = make_step
        loop_lib._write_image_summaries = write_summaries


def _run_cli(main, argv) -> str:
    """Run a CLI's ``main`` and return (and echo) what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    out = buf.getvalue()
    print(out, end="")
    return out


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _png_pixels(path) -> np.ndarray:
    """Decode a PNG of 8-bit RGB, unfiltered rows (what ``utils.png``
    writes) with zlib, checking the signature, each chunk's CRC and the
    IHDR fields."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise AssertionError(f"{path}: bad CRC in {tag!r}")
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + length
    w, h, depth, color, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", chunks[b"IHDR"])
    if (depth, color, comp, filt, interlace) != (8, 2, 0, 0, 0) \
            or b"IEND" not in chunks:
        raise AssertionError(f"{path}: not an 8-bit RGB PNG")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8) \
        .reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: filtered rows")
    return rows[:, 1:].reshape(h, w, 3)


def _same_state(a, b) -> dict:
    """Every parameter and both Adam moments of two train states: the
    names that differ, with their largest absolute difference."""
    diff = {}
    pa, pb = dict(a.module.named_parameters()), dict(b.module.named_parameters())
    for name in pa:
        sa, sb = a.optimizer.state[pa[name]], b.optimizer.state[pb[name]]
        for what, x, y in (("param", pa[name], pb[name]),
                           ("exp_avg", sa["exp_avg"], sb["exp_avg"]),
                           ("exp_avg_sq", sa["exp_avg_sq"],
                            sb["exp_avg_sq"])):
            if not torch.equal(x, y):
                diff[f"{what} {name}"] = float((x - y).abs().max())
    return diff


def _state_digest(state) -> dict:
    """SHA-256 of a train state's params, optimizer state and EMA, each
    over its tensors' bytes in order (plus the step): ranks that stay in
    sync give equal digests. -> {group: [hex digest, tensors hashed]}."""
    import hashlib
    opt = state.optimizer.state_dict()["state"]
    groups = {"params": list(state.module.named_parameters()),
              "optimizer": [(f"{i}/{k}", v) for i, s in opt.items()
                            for k, v in sorted(s.items())],
              "ema": sorted((state.ema or {}).items())}
    out = {"step": state.step}
    for group, named in groups.items():
        h = hashlib.sha256()
        for name, t in named:
            h.update(name.encode())
            h.update(t.detach().reshape(-1).contiguous().view(torch.uint8)
                     .cpu().numpy().tobytes() if torch.is_tensor(t)
                     else repr(t).encode())
        out[group] = [h.hexdigest(), len(named)]
    return out


def _check_replicas(tag: str, digests: list) -> None:
    """The ranks' ``_state_digest``s must be equal."""
    print(f"[{tag}] the ranks' state digests (params, Adam moments, EMA): "
          f"{digests[0]}; equal on all {len(digests)} ranks: "
          f"{all(d == digests[0] for d in digests)}")
    if any(d != digests[0] for d in digests):
        raise AssertionError(f"[{tag}]: the ranks' states differ: {digests}")


def phase_loop_c2(config, counted, raw_batches, train_p50) -> tuple:
    """[loop-c2] the c2 preset at full width through the training loop, the
    checkpoints and the CLIs, in a temporary directory: train, exact
    resume, snapshot, load and predict, eval, predict to PNGs. -> (each
    path's launch counts, the loop step p50 in ms)."""
    from dynamic_multiview_3d_torch.api import Model
    from dynamic_multiview_3d_torch.cli import eval as eval_cli
    from dynamic_multiview_3d_torch.cli import predict as predict_cli
    from dynamic_multiview_3d_torch.cli import snapshot as snapshot_cli
    from dynamic_multiview_3d_torch.cli import train as train_cli
    from dynamic_multiview_3d_torch.data import pipeline
    from dynamic_multiview_3d_torch.data.synthetic import to_model, to_uint8
    from dynamic_multiview_3d_torch.train import checkpoint as ckpt_lib
    from dynamic_multiview_3d_torch.train import loop as loop_lib
    from dynamic_multiview_3d_torch.train import metrics as metrics_lib
    from dynamic_multiview_3d_torch.train import step as tstep

    paths = {}
    with tempfile.TemporaryDirectory(prefix="dmv3d_loop_c2_") as tmp:
        # 1. train: 8 steps through cli.train
        run = os.path.join(tmp, "run")
        sets = LOOP_SETS + (f"train.ckpt_dir={run}",)
        cfg = config.get_config("c2", sets)
        probe = metrics_lib.MetricsWriter(os.path.join(tmp, "probe"))
        images = probe.has_images
        print(f"[loop-c2] metrics writer: JSONL"
              f"{' + TensorBoard' if probe.has_tensorboard else ' only'}"
              f" (image summaries: {images})")
        probe.close()
        summaries = 2 if images else 0     # at steps 4 and 8, B = 2
        _reset_counts(counted)
        with _loop_timers(loop_lib, counted) as (times, summary_counts):
            t0 = time.perf_counter()
            state, metrics = train_cli.main(
                ["--preset", "c2", *(a for s in sets for a in ("--set", s)),
                 "--logdir", os.path.join(tmp, "logs"), "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        paths["loop_c2"] = counts = _read_counts(counted)
        _expect_counts("loop-c2", counts, {
            "warp_composite_fwd": 8, "warp_composite_bwd": 8,
            "warp_composite_bwd:composite": 8, "stage:copies": 8})
        paths["loop_c2_summaries"] = summary_counts
        _expect_counts("loop-c2 image summaries", summary_counts, {
            "warp_composite_fwd": summaries, "stage:copies": summaries})
        it = np.asarray(times["batch"]) + np.asarray(times["step"])
        p50, batch_p50 = (float(np.percentile(x, 50)) * 1e3
                          for x in (it, times["batch"]))
        print(f"[loop-c2] {state.step} steps through cli.train in {wall!r} "
              f"s: loop step (host batch + train step) p50 {p50!r} ms, "
              f"host batch p50 {batch_p50!r} ms ({100 * batch_p50 / p50!r}% "
              f"of the loop step); [train]'s step p50 on a fixed batch in "
              f"this run {train_p50!r} ms")
        _loop_logs("loop-c2", run, os.path.join(tmp, "logs"), [1, 4, 8],
                   LOOP_MANAGER_STEPS, 8)

        # 2. exact resume at c2 width: 4 steps straight, against 4 steps
        # with a failure injected after step 1 and a resume
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        _reset_counts(counted)
        try:
            runs = {}
            for name in ("a", "b"):
                runs[name] = config.get_config("c2", (
                    "train.num_steps=4",
                    f"train.ckpt_dir={os.path.join(tmp, name)}"))
            state_a, _ = loop_lib.train(runs["a"], device="cuda")
            try:
                loop_lib.train(config.override(runs["b"],
                                               ["train.fail_after_step=1"]),
                               device="cuda")
                raise AssertionError("no FaultInjected")
            except loop_lib.FaultInjected as e:
                print(f"[loop-c2] resume: {e}; manager steps "
                      f"{ckpt_lib.manager_steps(os.path.join(tmp, 'b'))}")
            state_b, _ = loop_lib.train(runs["b"], device="cuda")
        finally:
            torch.backends.cudnn.deterministic = prev
        paths["resume_c2"] = counts = _read_counts(counted)
        _expect_counts("loop-c2 resume", counts, {
            "warp_composite_fwd": 8, "warp_composite_bwd": 8,
            "warp_composite_bwd:composite": 8, "stage:copies": 8})
        diff = _same_state(state_a, state_b)
        print(f"[loop-c2] resumed vs uninterrupted after 4 c2 steps "
              f"(cudnn.deterministic): {len(diff)} of "
              f"{3 * len(list(state_a.module.parameters()))} tensors differ "
              f"{diff}")
        if diff or state_b.step != 4:
            raise AssertionError("resume is not exact at c2")
        del state_a, state_b

        # 3. snapshot of the interrupted run: its latest manager step
        snap = os.path.join(tmp, "snap")
        out = json.loads(_run_cli(snapshot_cli.main, [
            "--ckpt-dir", os.path.join(tmp, "b"), "--out", snap]))
        saved = ckpt_lib.read_step(os.path.join(tmp, "b"), 2)["module"]
        exported, _, _ = ckpt_lib.load_model(snap)
        if out["step"] != 2 or any(not torch.equal(v, saved[k])
                                   for k, v in exported.items()):
            raise AssertionError(f"snapshot exported the wrong step: {out}")

        # 4. load the model dir and predict, against the trained module
        batches = [dict(raw, image_seq=to_model(raw["image_seq"]))
                   for raw in raw_batches[1:]]

        def requests(model):
            return [model.predict(b["image_seq"], b["tgt_poses"],
                                  source_poses=b["src_poses"])
                    for b in batches]
        loaded = Model.from_checkpoint(os.path.join(run, "model"),
                                       device="cuda")
        _reset_counts(counted)
        views = requests(loaded)
        torch.cuda.synchronize()
        paths["predict_ckpt_c2"] = counts = _read_counts(counted)
        _expect_counts("loop-c2 predict", counts,
                       {"warp_composite_fwd": 3, "stage:copies": 3})
        state.module.eval()
        ref = requests(Model(cfg, state.module))
        same = [bool(torch.equal(v, r)) for v, r in zip(views, ref)]
        print(f"[loop-c2] 3 c2 requests from the model dir vs the trained "
              f"module in eval mode: bitwise {same}")
        if not all(same):
            raise AssertionError("the checkpoint predicts otherwise than "
                                 "the trained module")

        # one manager save and restore, one model-dir save and load
        mgr = ckpt_lib.make_manager(os.path.join(tmp, "timing"), None, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(state.step, state)
        t_save = time.perf_counter() - t0
        fresh = tstep.init_state(cfg, seed=1, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.restore(state.step, fresh)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        step_bytes = _dir_bytes(os.path.join(tmp, "timing"))
        restored_diff = _same_state(state, fresh)
        t0 = time.perf_counter()
        Model(cfg, state.module).save_checkpoint(os.path.join(tmp, "m"),
                                                 step=state.step)
        t_msave = time.perf_counter() - t0
        t0 = time.perf_counter()
        Model.from_checkpoint(os.path.join(tmp, "m"), device="cuda")
        torch.cuda.synchronize()
        t_mload = time.perf_counter() - t0
        print(f"[loop-c2] manager step (module, Adam, step): {step_bytes} "
              f"bytes, save {t_save!r} s, restore {t_restore!r} s "
              f"(restored state differs in {len(restored_diff)} tensors); "
              f"model dir {_dir_bytes(os.path.join(tmp, 'm'))} bytes, save "
              f"{t_msave!r} s, load {t_mload!r} s")
        if restored_diff:
            raise AssertionError(f"manager round trip: {restored_diff}")
        del fresh

        # 5. eval: 2 batches of 16 examples (K = 8)
        _reset_counts(counted)
        t0 = time.perf_counter()
        result = json.loads(_run_cli(eval_cli.main, [
            "--ckpt", os.path.join(run, "model"), "--num-batches", "2",
            "--batch-size", "16", "--device", "cuda"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        paths["eval_c2"] = counts = _read_counts(counted)
        _expect_counts("loop-c2 eval", counts,
                       {"warp_composite_fwd": 2, "stage:copies": 2})
        print(f"[loop-c2] eval: {result['num_views']} views in {wall!r} s "
              f"(the whole CLI call: checkpoint load, host rendering, 2 "
              f"batches): {result['num_views'] / wall!r} views/s")
        if not (np.isfinite(result["psnr"]) and np.isfinite(result["ssim"])
                and result["ckpt_step"] == 8 and result["num_views"] == 256):
            raise AssertionError(f"eval: {result}")

        # 6. predict: 4 azimuths to PNGs
        views_dir = os.path.join(tmp, "views")
        _reset_counts(counted)
        _run_cli(predict_cli.main, ["--ckpt", os.path.join(run, "model"),
                                    "--out", views_dir, "--device", "cuda"])
        torch.cuda.synchronize()
        paths["predict_cli_c2"] = counts = _read_counts(counted)
        _expect_counts("loop-c2 predict-cli", counts,
                       {"warp_composite_fwd": 1, "stage:copies": 1})
        names = sorted(os.listdir(views_dir))
        pixels = {n: _png_pixels(os.path.join(views_dir, n)) for n in names}
        source = to_uint8(pipeline.make_source(cfg.data).example(0)
                          ["image_seq"][-1])
        print(f"[loop-c2] predict wrote {names}, "
              f"{sorted({p.shape for p in pixels.values()})}")
        if names != ["source.png"] + [f"view_{i:02d}.png" for i in range(4)] \
                or any(p.shape != (128, 128, 3) for p in pixels.values()) \
                or not np.array_equal(pixels["source.png"], source):
            raise AssertionError("cli.predict wrote the wrong PNGs")
    jax_modules = sorted(n for n in sys.modules if n.split(".")[0] in (
        "jax", "jaxlib", "flax", "orbax", "dynamic_multiview_3d_tpu"))
    print(f"[loop-c2] modules of JAX or the JAX package imported by this "
          f"process: {jax_modules}")
    if jax_modules:
        raise AssertionError("the port's path imported JAX")
    return paths, p50


def _mf_inputs(max_flow: float = 80.0, t: int = 8):
    """The multi-source kernel's inputs at the c3md shape (T = ``t``
    sources; c3md's 8 by default), from seed 0: frames, per-source
    coordinates (flows of up to ``max_flow`` px; 80 reaches past every
    border and leaves most inside), logits, mask, rgb. The frames are
    contiguous [N,T,C,H,W]; ``_channels_last`` gives the model's layout."""
    n, c, h, w, k = 8, 3, 128, 128, 2
    p = k * h * w
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    imgs = uniform((n, t, c, h, w), -1.0, 1.0)
    flow = uniform((n, t, 2, k, h, w), -max_flow, max_flow)
    ix = (torch.arange(w, device=dev, dtype=torch.float32) + flow[:, :, 0]) \
        .reshape(n, t, p).contiguous()
    iy = (torch.arange(h, device=dev, dtype=torch.float32)[:, None]
          + flow[:, :, 1]).reshape(n, t, p).contiguous()
    conf = 2.0 * torch.randn((n, t, p), generator=g, device=dev)
    mask = uniform((n, p), 0.0, 1.0)
    rgb = uniform((n, c, p), -1.0, 1.0)
    return imgs, ix, iy, conf, mask, rgb


def _channels_last(args):
    """The inputs with the frames as the model passes them: NHWC memory,
    a [N,T,C,H,W] view (channel stride 1)."""
    imgs = args[0].permute(0, 1, 3, 4, 2).contiguous().permute(0, 1, 4, 2, 3)
    return (imgs,) + tuple(args[1:])


def _mf_layouts(args) -> dict:
    return {"contiguous": tuple(args), "channels_last": _channels_last(args)}


def _mf_grid(imgs, ix, iy):
    """All N*T frames [N*T, C, H, W] and their K*H*W pixel coordinates as
    F.grid_sample's normalized grid [N*T, K*H, W, 2] (align_corners)."""
    n, t, c, h, w = imgs.shape
    grid = torch.stack([ix * (2.0 / (w - 1)) - 1.0,
                        iy * (2.0 / (h - 1)) - 1.0], dim=-1)
    return imgs.reshape(n * t, c, h, w), grid.reshape(n * t, -1, w, 2)


def _mf_composition(imgs, ix, iy, conf, mask, rgb):
    """The multi-source kernel's whole function composed of PyTorch calls
    (a yardstick, timed only; the port never calls it): F.grid_sample of
    the N*T frames (border), the -30 validity bias, torch.softmax over T,
    the weighted sum and the composite."""
    n, t, c, h, w = imgs.shape
    frames, grid = _mf_grid(imgs, ix, iy)
    sampled = F.grid_sample(frames, grid, mode="bilinear",
                            padding_mode="border", align_corners=True) \
        .reshape(n, t, c, -1)
    valid = ((ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)).float()
    wts = torch.softmax(conf + (valid - 1.0) * 30.0, dim=1)
    multi = (wts[:, :, None] * sampled).sum(1)
    view = mask[:, None] * multi + (1.0 - mask[:, None]) * rgb
    return view, multi, valid.amax(1), wts


def phase_kernel_mf(mf) -> dict:
    """#4 against its plain version (bitwise) in both paddings, precisions
    and frame layouts at every T of MF_TS; timed at c3md (T = 8, border),
    channels-last (the model's layout) on 80 px and 2 px flows, contiguous
    beside it."""
    errs = {}
    for t in MF_TS:
        for layout, args in _mf_layouts(_mf_inputs(t=t)).items():
            for padding in PADDINGS:
                for precision in ("exact", "fast"):
                    ours = mf.multiflow_composite_pix(*args, padding,
                                                      precision)
                    torch.cuda.synchronize()
                    ref = mf.multiflow_composite_pix_plain(*args, padding,
                                                           precision)
                    err = max(float((o - r).abs().max())
                              for o, r in zip(ours, ref))
                    print(f"[kernel-mf] T={t}, {layout}, {padding}, "
                          f"{precision}: max |kernel - plain| over view, "
                          f"multi, any_valid, wts = {err!r} (valid share "
                          f"{float(ours[2].mean()):.3f})")
                    if err != 0.0:
                        raise AssertionError(
                            f"multi-source kernel disagrees with plain "
                            f"(T={t}, {layout}, {padding}, {precision}): "
                            f"{err}")
                    errs[t, layout, padding, precision] = err
    flat = _mf_inputs()
    args = _channels_last(flat)
    imgs = args[0]
    n, t, c, h, w = imgs.shape
    p = args[1].shape[-1]
    times = {prec: _timed_ms(
        lambda: mf.multiflow_composite_pix(*args, precision=prec), 50)
        for prec in ("fast", "exact")}
    kernel_ms = _kernel_ms(lambda: mf.multiflow_composite_pix(
        *args, precision="fast"), "multiflow_fwd_kernel")
    # contiguous frames: the wrapper's copy into channels-last, then the
    # kernel
    flat_ms, _ = _device_ms(lambda: mf.multiflow_composite_pix(
        *flat, precision="fast"))
    # the same work where neighbouring pixels gather neighbouring taps
    near = _channels_last(_mf_inputs(max_flow=2.0))
    near_ms = _kernel_ms(lambda: mf.multiflow_composite_pix(
        *near, precision="fast"), "multiflow_fwd_kernel")
    plain_ms = _timed_ms(lambda: mf.multiflow_composite_pix_plain(
        *args, precision="fast"), 10)
    frames, grid = _mf_grid(*flat[:3])
    library_ms = _timed_ms(lambda: F.grid_sample(
        frames, grid, mode="bilinear", padding_mode="border",
        align_corners=True), 50)
    composition_ms = _timed_ms(lambda: _mf_composition(*flat), 50)
    # each input read once, each output written once: frames; per pixel
    # ix, iy, conf (3T), mask, rgb (C) in; view, multi (2C), any_valid,
    # wts (T) out (f32)
    nbytes = 4 * (n * t * c * h * w + n * p * (3 * t + 1 + c)
                  + n * p * (2 * c + 1 + t))
    # per pixel and source ~30 flops of logit, softmax and weights, ~14 per
    # channel of sample and blend
    bound_ms, bound_by = _bound(nbytes, n * p * t * (30 + 14 * c))
    print(f"[kernel-mf] c3md shape N={n} T={t} C={c} {h}x{w} P={p}, fast: "
          f"kernel on the device (profiler), channels-last frames (the "
          f"model's) {kernel_ms!r} ms, {near_ms!r} ms on flows of at most 2 "
          f"px; contiguous frames, the copy into channels-last and the "
          f"kernel {flat_ms!r} ms; call of the autograd "
          f"wrapper, channels-last, fast {times['fast']!r} ms, exact "
          f"{times['exact']!r} ms (events, 50 back to back); plain (fast) "
          f"{plain_ms!r} ms; yardsticks: F.grid_sample of the {n * t} frames "
          f"(warp only) {library_ms!r} ms, the whole function composed of "
          f"PyTorch calls {composition_ms!r} ms; bound {bound_ms!r} ms "
          f"({nbytes} B at 3.35 TB/s)")
    return {"max_abs_err": max(errs.values()), "ms": kernel_ms,
            "ms_2px": near_ms, "ms_contiguous": flat_ms,
            "call_ms": times["fast"], "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "F.grid_sample (warp only)",
            "composition_ms": composition_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_kernel_mf_bwd(mf) -> dict:
    """#5 against the plain backward in both paddings, precisions and frame
    layouts at every T of MF_TS, for three launches: the multidepth
    training launch (d_multi, no d_wts, no d_imgs), the multiflow one
    (neither) and the full one (d_multi, d_wts, d_imgs); timed at c3md
    (border), channels-last."""
    g = torch.Generator(device="cuda").manual_seed(1)
    errs = []
    cots = {}
    for t in MF_TS:
        base = _mf_inputs(t=t)
        d_view, d_multi = (torch.randn(base[5].shape, generator=g,
                                       device="cuda") for _ in range(2))
        d_wts = torch.randn(base[3].shape, generator=g, device="cuda")
        # (d_multi, d_wts, d_imgs) of each launch
        launches = {"multidepth": (d_multi, None, False),
                    "multiflow": (None, None, False),
                    "full": (d_multi, d_wts, True)}
        cots[t] = d_view, d_multi, launches
        for layout, args in _mf_layouts(base).items():
            for padding, precision, what in (
                    (pd, pr, wh) for pd in PADDINGS
                    for pr in ("exact", "fast") for wh in launches):
                dm, dw, need = launches[what]
                ours = mf.multiflow_composite_pix_bwd(
                    *args, d_view, dm, dw, padding, precision,
                    need_imgs=need)
                torch.cuda.synchronize()
                ref = mf.multiflow_composite_pix_bwd_plain(
                    *args, d_view, dm, dw, padding, precision,
                    need_imgs=need)
                err = max(float((o - r).abs().max())
                          for o, r in zip(ours[1:], ref[1:]))
                if need:
                    scale = max(1.0, float(ref[0].abs().max()))
                    img_err = float((ours[0] - ref[0]).abs().max()) \
                        / scale
                    note = (f"d_imgs {img_err!r} of its largest |value| "
                            f"{scale!r}")
                    if ours[0].stride() != args[0].stride():
                        raise AssertionError("d_imgs is not in the "
                                             "frames' layout")
                else:
                    img_err = 0.0 if ours[0] is None else float("inf")
                    note = (f"d_imgs "
                            f"{'None' if ours[0] is None else 'returned'}")
                print(f"[kernel-mf-bwd] T={t}, {layout}, {padding}, "
                      f"{precision}, {what} launch: max |kernel - plain| "
                      f"over d_ix, d_iy, d_conf, d_mask, d_rgb = "
                      f"{err!r}; {note}")
                if not (err == 0.0 and img_err <= 1e-5):
                    raise AssertionError(
                        f"multi-source backward kernel disagrees with "
                        f"plain (T={t}, {layout}, {padding}, "
                        f"{precision}, {what}): {err}, d_imgs "
                        f"{img_err}")
                errs.append(err)

    flat = _mf_inputs()
    args = _channels_last(flat)
    n, t, c, h, w = args[0].shape
    p = args[1].shape[-1]
    d_view, d_multi, launches = cots[t]

    def kernel(what, precision="fast", inputs=args):
        dm, dw, need = launches[what]
        return lambda: mf.multiflow_composite_pix_bwd(
            *inputs, d_view, dm, dw, precision=precision, need_imgs=need)
    times = {what: _timed_ms(kernel(what), 50) for what in launches}
    exact_ms = _timed_ms(kernel("multidepth", "exact"), 50)
    kernel_ms = {what: _kernel_ms(kernel(what), "multiflow_bwd_kernel")
                 for what in launches}
    flat_ms, _ = _device_ms(kernel("multidepth", inputs=flat))
    near_ms = _kernel_ms(kernel("multidepth", inputs=_channels_last(
        _mf_inputs(max_flow=2.0))), "multiflow_bwd_kernel")
    plain_ms = _timed_ms(lambda: mf.multiflow_composite_pix_bwd_plain(
        *args, d_view, d_multi, None, precision="fast", need_imgs=False), 5)
    frames, grid = _mf_grid(*flat[:3])
    grid.requires_grad_(True)
    out = F.grid_sample(frames, grid, mode="bilinear", padding_mode="border",
                        align_corners=True)
    d_out = torch.randn(out.shape, generator=g, device="cuda")
    library_ms = _timed_ms(lambda: torch.autograd.grad(
        out, grid, d_out, retain_graph=True), 50)
    # the composition's autograd backward to ix, iy, conf, mask and rgb
    # from the multidepth launch's cotangents (d_view, d_multi)
    leaves = [x.detach().requires_grad_(True) for x in flat[1:]]
    view, multi, _, _ = _mf_composition(flat[0], *leaves)
    composition_ms = _timed_ms(lambda: torch.autograd.grad(
        (view, multi), leaves, (d_view, d_multi), retain_graph=True), 50)
    # each input read once, each output written once. Multidepth launch:
    # frames; per pixel ix, iy, conf (3T), mask, rgb, d_view, d_multi (3C)
    # in; d_ix, d_iy, d_conf (3T), d_mask, d_rgb (C) out
    frames_b = 4 * n * t * c * h * w
    nbytes = {"multidepth": frames_b + 4 * n * p * ((3 * t + 1 + 3 * c)
                                                    + (3 * t + 1 + c))}
    nbytes["multiflow"] = nbytes["multidepth"] - 4 * n * p * c
    nbytes["full"] = nbytes["multidepth"] + 4 * n * p * t + frames_b
    # per pixel and source ~30 flops of softmax and weights, ~40 per
    # channel of sample, blend and gradients (8 more with d_imgs)
    ops = n * p * t * (30 + 40 * c)
    bounds = {what: _bound(nb, ops + (n * p * t * 8 * c if what == "full"
                                      else 0))
              for what, nb in nbytes.items()}
    print(f"[kernel-mf-bwd] c3md shape N={n} T={t} C={c} {h}x{w} P={p}, "
          f"fast, kernel on the device (profiler), channels-last frames: "
          + ", ".join(f"{what} launch {kernel_ms[what]!r} ms"
                      for what in launches)
          + f"; multidepth launch on flows of at most 2 px {near_ms!r} ms, "
          f"on contiguous frames, the copy into channels-last and the "
          f"kernel {flat_ms!r} ms")
    print(f"[kernel-mf-bwd] calls of the wrapper (events, 50 back to back), "
          f"fast, channels-last: multidepth launch {times['multidepth']!r} "
          f"ms (exact {exact_ms!r} ms), multiflow launch "
          f"{times['multiflow']!r} ms, full launch (d_multi, d_wts, d_imgs) "
          f"{times['full']!r} ms; plain (fast, multidepth launch) "
          f"{plain_ms!r} ms; yardsticks: F.grid_sample backward (grid only) "
          f"{library_ms!r} ms, the autograd backward of the whole function "
          f"composed of PyTorch calls {composition_ms!r} ms; bounds "
          + ", ".join(f"{what} {bounds[what][0]!r} ms ({nbytes[what]} B)"
                      for what in launches) + " at 3.35 TB/s")
    return {"max_abs_err": max(errs), "ms": kernel_ms["multidepth"],
            "ms_2px": near_ms, "ms_contiguous": flat_ms,
            "call_ms": times["multidepth"], "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "F.grid_sample backward (grid gradient only)",
            "composition_ms": composition_ms,
            "bound_ms": bounds["multidepth"][0],
            "bound_by": bounds["multidepth"][1]}


def phase_reference_mf(config, Model, DMV3D, synthetic, tstep):
    """Phases 4 and 7 for the tiny multi-source models."""
    for synthesis in ("multiflow", "multidepth"):
        for mode in ("shared", "baked"):
            extra = (f"model.synthesis={synthesis}",
                     f"model.multi_head_mode={mode}", "data.seq_len=3")
            phase_reference(config, Model, DMV3D, synthetic, extra, t=3,
                            k=2, tag="reference-mf")
            zero = (ZERO_GRAD_MD_SHARED
                    if (synthesis, mode) == ("multidepth", "shared")
                    else ZERO_GRAD)
            phase_train_reference(config, synthetic, tstep, extra, t=3, k=2,
                                  zero=zero, tag="reference-mf")


def c3md_batches(config, pipeline):
    """4 c3md batches (B = 8, T = 8 orbit sources of a dynamic scene, K = 2)
    of uint8 images from the preset's source (SyntheticFrames: the frames
    source with an empty root), seed 0."""
    cfg = config.get_config("c3md", C3MD_OVERRIDES)
    b = cfg.data.batch_size
    t0 = time.perf_counter()
    source = pipeline.make_source(cfg.data)
    batches = [source.batch(range(i * b, (i + 1) * b), raw=True)
               for i in range(4)]
    print(f"[data] 4 c3md batches of B={b} T={cfg.data.seq_len} "
          f"K={cfg.data.num_targets} ({cfg.data.src_views} sources, dynamic "
          f"{cfg.data.dynamic}) from {type(source).__name__} rendered in "
          f"{time.perf_counter() - t0:.2f} s")
    return batches


def phase_serve_c3md(config, Model, synthetic, counted, raw_batches) -> dict:
    cfg = config.get_config("c3md", C3MD_OVERRIDES)
    m = cfg.model
    b, k, hw = cfg.data.batch_size, cfg.data.num_targets, m.image_size
    t = cfg.data.seq_len
    t0 = time.perf_counter()
    model = Model.init_random(cfg, seed=0, device="cuda")
    batches = [dict(raw, image_seq=synthetic.to_model(raw["image_seq"]),
                    tgt_images=synthetic.to_model(raw["tgt_images"]))
               for raw in raw_batches]
    print(f"[serve-c3md] c3md model ({sum(q.numel() for q in model.module.parameters())}"
          f" params, {m.dtype}, synthesis {m.synthesis}, {m.multi_head_mode} "
          f"heads, warp {m.warp_precision}, overrides {list(C3MD_OVERRIDES)})"
          f" in {time.perf_counter() - t0:.2f} s")

    def request(batch, aux=False):
        return model.predict(batch["image_seq"], batch["tgt_poses"],
                             source_poses=batch["src_poses"], return_aux=aux)

    request(batches[0])                       # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    _reset_counts(counted)
    outs = [request(batch, aux=(i == 2))
            for i, batch in enumerate(batches[1:])]
    torch.cuda.synchronize()
    counts = _read_counts(counted)
    _expect_counts("serve-c3md", counts, {"multiflow_composite_fwd": 3})
    for view in outs[:2] + [outs[2]["view"]]:
        if tuple(view.shape) != (b, k, hw, hw, 3) or \
                not bool(torch.isfinite(view).all()):
            raise AssertionError(f"bad view: shape {tuple(view.shape)}")
    aux = outs[2]
    mask = aux["mask"]
    err = float((mask * aux["warped"] + (1.0 - mask) * aux["rgb"]
                 - aux["view"]).abs().max())
    wsum = float((aux["conf_weights"].sum(-1) - 1.0).abs().max())
    print(f"[serve-c3md] view vs mask * warped + (1 - mask) * rgb from its "
          f"aux outputs: max err {err!r}; blend weights [B,K,H,W,{t}] sum to "
          f"1 within {wsum!r}; geo_valid share "
          f"{float(aux['geo_valid'].mean()):.3f}; depth in "
          f"[{float(aux['depth'].min()):.3f}, "
          f"{float(aux['depth'].max()):.3f}]")
    if not (err <= 1e-5 and wsum <= 1e-5
            and bool((aux["depth"] > 0).all())):
        raise AssertionError("served c3md outputs are inconsistent")
    _time_requests("serve-c3md", request, batches, 50, b * k)
    phase_profile(lambda: request(batches[1]), "one c3md request")
    return counts


def phase_train_c3md(config, tstep, counted, raw_batches) -> tuple:
    cfg = config.get_config("c3md", C3MD_OVERRIDES)
    t0 = time.perf_counter()
    state = tstep.init_state(cfg, seed=0, device="cuda")
    step = tstep.make_train_step(cfg, device="cuda")
    tc = cfg.train
    print(f"[train-c3md] c3md state ({sum(q.numel() for q in state.module.parameters())}"
          f" params, {cfg.model.dtype}, remat {cfg.model.remat_scan}, "
          f"{tc.optimizer} lr {tc.lr} {tc.lr_schedule}, geo_weight "
          f"{tc.geo_weight}, targets_per_step {cfg.data.targets_per_step}) "
          f"in {time.perf_counter() - t0:.2f} s")
    return _train_window("train-c3md", "c3md", state, step, counted,
                         raw_batches, {"multiflow_composite_fwd": 3,
                                       "multiflow_composite_bwd": 3},
                         cfg.data.batch_size * cfg.data.num_targets)


def _shared_sample_inputs():
    """#2's inputs as depth synthesis passes them at the c2 shape, from
    seed 6: B = 16 frames of 3 x 128 x 128, channels-last (NHWC memory),
    each sampled at the pixels of its K = 8 targets (flows of up to 80 px,
    as in ``_kernel_inputs``): frames [B, 3, H, W], ix, iy [B, K*H*W]."""
    b, k, c, h, w = 16, 8, 3, 128, 128
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    frames = (torch.rand((b, h, w, c), generator=g, device=dev) * 2.0 - 1.0) \
        .permute(0, 3, 1, 2)
    flow = torch.rand((b, k, 2, h, w), generator=g, device=dev) * 160.0 - 80.0
    ix = torch.arange(w, device=dev, dtype=torch.float32) + flow[:, :, 0]
    iy = torch.arange(h, device=dev, dtype=torch.float32)[:, None] \
        + flow[:, :, 1]
    return frames, ix.reshape(b, -1).contiguous(), iy.reshape(b, -1) \
        .contiguous()


def _per_target_copy(frames, k):
    """One contiguous copy of each frame per target: the reference's
    layout, [B*K, C, H, W]."""
    return frames.repeat_interleave(k, dim=0).contiguous()


def phase_kernel_sample(gs) -> dict:
    """#2 held bitwise against its plain version in both paddings and
    precisions on the model's layout (one channels-last frame per example,
    sampled at its K targets' pixels), on the same frames copied once per
    target and on 128 contiguous images; its backward (site #3's
    no-composite launch) against the plain backward on the model's layout
    and the 128 images; both timed on the model's layout, #2 also on the
    per-target copy."""
    frames, sx, sy = _shared_sample_inputs()
    b, c, h, w = frames.shape
    k = sx.shape[1] // (h * w)
    n, p = b * k, h * w
    layouts = {"model (shared channels-last frames)": (frames, sx, sy),
               "per-target copy": (_per_target_copy(frames, k),
                                   sx.reshape(n, p), sy.reshape(n, p)),
               "128 contiguous images": _kernel_inputs()[:3]}
    errs = []
    for layout, inp in layouts.items():
        for padding in PADDINGS:
            for precision in ("exact", "fast"):
                out = gs.sample_pixel_coords(*inp, padding, precision)
                torch.cuda.synchronize()
                ref = gs.sample_pixel_coords_plain(*inp, padding, precision)
                err = float((out - ref).abs().max())
                if layout == "per-target copy":       # the model's output too
                    shared = gs.sample_pixel_coords_plain(
                        *layouts["model (shared channels-last frames)"],
                        padding, precision)
                    err = max(err, float((out.reshape(b, k, c, p)
                                          .transpose(1, 2).reshape(b, c, -1)
                                          - shared).abs().max()))
                print(f"[kernel-sample] {layout}, {padding}, {precision}: "
                      f"max |kernel - plain| = {err!r}")
                if err != 0.0:
                    raise AssertionError(f"sampler kernel disagrees with "
                                         f"plain ({layout}, {padding}, "
                                         f"{precision}): {err}")
                errs.append(err)

    g = torch.Generator(device="cuda").manual_seed(2)
    douts = {}
    for layout in ("model (shared channels-last frames)",
                   "128 contiguous images"):
        img, ix, iy = layouts[layout]
        douts[layout] = dout = torch.randn((img.shape[0], c, ix.shape[1]),
                                           generator=g, device="cuda")
        for padding in PADDINGS:
            for precision in ("exact", "fast"):
                grads = gs.sample_pixel_coords_bwd(img, ix, iy, dout,
                                                   padding, precision)
                torch.cuda.synchronize()
                ref = gs.sample_pixel_coords_bwd_plain(img, ix, iy, dout,
                                                       padding, precision)
                bwd_err = max(float((o - r).abs().max())
                              for o, r in zip(grads[1:], ref[1:]))
                scale = max(1.0, float(ref[0].abs().max()))
                img_err = float((grads[0] - ref[0]).abs().max()) / scale
                print(f"[kernel-sample] no-composite backward, {layout}, "
                      f"{padding}, {precision}: d_ix, d_iy {bwd_err!r}, "
                      f"d_img {img_err!r} of its largest |value| {scale!r}")
                if not (bwd_err == 0.0 and img_err <= 1e-5
                        and grads[0].shape == img.shape):
                    raise AssertionError(f"sampler backward disagrees with "
                                         f"plain ({layout}, {padding}, "
                                         f"{precision})")
                errs.append(bwd_err)

    args = (frames, sx, sy, "border")
    call_ms = {prec: _timed_ms(lambda: gs.sample_pixel_coords(*args, prec),
                               50) for prec in ("fast", "exact")}
    kernel_ms = _kernel_ms(lambda: gs.sample_pixel_coords(*args, "fast"),
                           "sample_fwd_kernel")
    # the wrapper's device time: the frames' staging copy and the kernel
    staged_ms, _ = _device_ms(lambda: gs.sample_pixel_coords(*args, "fast"))
    # the per-target copy, staged likewise
    copy_ms, _ = _device_ms(lambda: gs.sample_pixel_coords(
        *layouts["per-target copy"], "border", "fast"))
    plain_ms = _timed_ms(lambda: gs.sample_pixel_coords_plain(*args, "fast"),
                         10)
    grid = _grid(sx, sy, h, w)
    library_ms = _timed_ms(lambda: F.grid_sample(
        frames, grid, mode="bilinear", padding_mode="border",
        align_corners=True), 50)
    # the backward on the staged frames the autograd op keeps: no copy
    staged = gs._build.stage(frames)
    bwd_ms = _kernel_ms(lambda: gs.sample_pixel_coords_bwd(
        staged, sx, sy, douts["model (shared channels-last frames)"],
        "border", "fast", need_img=False), "warp_composite_bwd_kernel")
    # each input read once, each output written once: the frames, ix, iy
    # in; the sample out (f32)
    nbytes = 4 * (b * c * h * w + 2 * b * k * p + b * c * k * p)
    # per pixel ~20 flops of coordinates and weights, ~10 per channel
    bound_ms, bound_by = _bound(nbytes, n * p * (20 + 10 * c))
    # the no-composite launch: ix, iy, 3 d_warped in, d_ix, d_iy out per
    # pixel; the frames once
    bwd_bound_ms, _ = _bound(4 * (b * c * h * w + n * p * (2 + c + 2)),
                             n * p * (30 + 30 * c))
    print(f"[kernel-sample] c2 shape, the model's layout: {b} frames of {c} x "
          f"{h} x {w} sampled at the {k * p} pixels of their K={k} targets, "
          f"border: kernel fast {kernel_ms!r} ms on the device (profiler), "
          f"with the frames' staging copy {staged_ms!r} ms; "
          f"call of the wrapper fast {call_ms['fast']!r} ms, exact "
          f"{call_ms['exact']!r} ms (events, 50 back to back); per-target "
          f"copy ({n} contiguous images, the staging copy and the "
          f"kernel) {copy_ms!r} ms on the device; plain (fast) {plain_ms!r} "
          f"ms; F.grid_sample of the {b} frames at the same coordinates "
          f"{library_ms!r} ms; bound {bound_ms!r} ms ({nbytes} B at 3.35 "
          f"TB/s); no-composite backward on the model's layout (no d_img) "
          f"{bwd_ms!r} ms on the device against its bound {bwd_bound_ms!r} "
          f"ms")
    return {"max_abs_err": max(errs), "ms": kernel_ms,
            "ms_with_staging": staged_ms, "ms_per_target_copy": copy_ms,
            "call_ms": call_ms["fast"],
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "F.grid_sample border, the same frames and "
                       "coordinates", "bound_ms": bound_ms,
            "bound_by": bound_by}


def _c2_params(rp, pose_ops, src_last, tgt, h, w):
    """The model's 12 camera scalars per target image ([N, 12]): focal
    max(h, w), centred principal point, the last source camera -> the
    target camera (look-at poses), as models/dmv3d.py computes them."""
    n = tgt.shape[0]
    intr = pose_ops.intrinsics_matrix(
        torch.full((n,), float(max(h, w)), device=tgt.device),
        (w - 1) / 2.0, (h - 1) / 2.0)
    rel = pose_ops.relative_transform(pose_ops.look_at_extrinsics(src_last),
                                      pose_ops.look_at_extrinsics(tgt))
    return rp.host_params(intr, rel)


def _reproject_inputs(rp, pose_ops, synthetic, raw, depth_kind):
    """#6/#7's inputs at the c2 shape on c2 cameras (a c2 batch's last
    source frames and poses, B = 16 x K = 8 target poses), in the model's
    layout: the B frames [B, 3, H, W] channels-last (NHWC memory), each
    shared by its K targets; the N = B*K targets' depth, camera scalars,
    mask and rgb. ``depth_kind`` "smooth": a smooth surface
    about the orbit's centre (depth 1.7-2.3, the model's kind of field);
    "random": independent depths in [0.5, 6] per pixel, which scatter the
    correspondences (many off the image or behind the camera)."""
    dev = torch.device("cuda")
    b, k = raw["tgt_poses"].shape[:2]
    frames = torch.as_tensor(synthetic.to_model(raw["image_seq"][:, -1]),
                             device=dev)                       # [B,H,W,3]
    h, w = frames.shape[1:3]
    n, p = b * k, h * w
    img = frames.permute(0, 3, 1, 2)
    src = torch.as_tensor(raw["src_poses"][:, -1], device=dev) \
        .repeat_interleave(k, dim=0)
    params = _c2_params(rp, pose_ops, src,
                        torch.as_tensor(raw["tgt_poses"], device=dev)
                        .reshape(n, 3), h, w)
    g = torch.Generator(device=dev).manual_seed(3)
    if depth_kind == "smooth":
        ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
        xs = torch.arange(w, device=dev, dtype=torch.float32)
        phase = torch.rand((n, 1, 1), generator=g, device=dev) * 6.28
        depth = 2.0 + 0.3 * torch.sin(xs / 19.0 + phase) \
            * torch.cos(ys / 23.0 - phase)
    else:
        depth = torch.rand((n, h, w), generator=g, device=dev) * 5.5 + 0.5
    mask = torch.rand((n, p), generator=g, device=dev)
    rgb = torch.rand((n, 3, p), generator=g, device=dev) * 2.0 - 1.0
    return img, depth.reshape(n, p).contiguous(), params, mask, rgb


def _reproject_composition(img, depth, params, mask=None, rgb=None):
    """#6's function (and #7's, given mask and rgb) composed of PyTorch
    calls (a yardstick, timed only; the port never calls it): the
    correspondence from depth and the 12 camera scalars with torch ops,
    F.grid_sample (zeros), the validity product and the composite."""
    n, c, h, w = img.shape
    idx = torch.arange(h * w, device=depth.device)
    u, v = (idx % w).to(torch.float32), (idx // w).to(torch.float32)
    m, t = params[:, :9].reshape(n, 3, 3, 1), params[:, 9:, None]
    q = depth[:, None] * (m[:, :, 0] * u + m[:, :, 1] * v + m[:, :, 2]) + t
    valid = q[:, 2] > 1e-6
    z = torch.where(valid, q[:, 2], 1.0)
    x = torch.where(valid, q[:, 0] / z, -1e6)
    y = torch.where(valid, q[:, 1] / z, -1e6)
    geo = F.grid_sample(img, _grid(x, y, h, w), mode="bilinear",
                        padding_mode="zeros", align_corners=True) \
        .reshape(n, c, -1) * valid[:, None]
    if mask is None:
        return geo, valid.float()
    return (mask[:, None] * geo + (1.0 - mask[:, None]) * rgb, geo,
            valid.float())


def _reproject_layouts(rp, inp) -> dict:
    """The inputs in the model's layout (the shared frames staged as the
    model stages them on CUDA, ``_build.stage``), with the frames
    channels-last (the NHWC frames unstaged: the wrapper stages them), and
    with one contiguous copy of the frame per target."""
    img, depth = inp[:2]
    return {"model": (rp._build.stage(img),) + tuple(inp[1:]),
            "channels-last": inp,
            "per-target copy": (_per_target_copy(img, depth.shape[0]
                                                 // img.shape[0]),)
            + tuple(inp[1:])}


def _frames_grid(img, x, y):
    """The shared frames [B, C, H, W] and the coordinates [B*K, H*W] of
    their targets as F.grid_sample's grid [B, K*H, W, 2]."""
    b, _, h, w = img.shape
    return _grid(x.reshape(b, -1), y.reshape(b, -1), h, w)


def _reproject_c_inputs(inp, c):
    """``inp`` with C = ``c`` channels (the instantiations the model does
    not launch), from seed 8: the frames (channels-last) and rgb made
    anew, depth, cameras and mask kept."""
    img, depth, params, mask, rgb = inp
    b, _, h, w = img.shape
    g = torch.Generator(device="cuda").manual_seed(8)
    frames = (torch.rand((b, h, w, c), generator=g, device="cuda") * 2 - 1) \
        .permute(0, 3, 1, 2)
    rgb = torch.rand((rgb.shape[0], c, rgb.shape[2]), generator=g,
                     device="cuda") * 2 - 1
    return frames, depth, params, mask, rgb


def _edge_params(params, kind):
    """Camera scalars like ``params`` under which no pixel is valid
    ("invalid": M = I, q.z = depth - 10 < 0 at depths under 10) or every
    correspondence lies far off the image ("off": x = u + 1e4 at q.z =
    depth)."""
    edge = torch.zeros_like(params)
    edge[:, [0, 4, 8]] = 1.0
    if kind == "invalid":
        edge[:, 11] = -10.0
    else:
        edge[:, [2, 5]] = 1e4
    return edge


def _shares(rp, inp) -> tuple:
    """The share of valid pixels, of in-image taps among the 4 of every
    pixel (the taps whose loads the kernels issue), and of pixels with no
    tap in the image."""
    img, depth, params = inp[:3]
    h, w = img.shape[2:]
    cr = rp.correspondence_plain(depth, params, h, w)

    def inside(coord, size):          # the floor tap and the next, in 0/1
        c0 = torch.floor(coord)
        return [((t >= 0) & (t <= size - 1)).float() for t in (c0, c0 + 1)]
    taps = sum(a * b for a in inside(cr["x"], w) for b in inside(cr["y"], h))
    return (float(cr["valid"].mean()), float(taps.mean()) / 4,
            float((taps == 0).float().mean()))


def phase_kernel_reproject(rp, inputs) -> tuple:
    """#6 and #7 at the c2 shape on c2 cameras (``inputs``: the smooth and
    the random depth's ``_reproject_inputs``): held against their plain
    versions in both precisions on both depths (max |kernel - plain| 0.0:
    value for value; the kernels skip the loads of taps without weight, so
    a zero may differ in sign), on the model's layout (staged frames), on
    the channels-last frames and on the per-target copy; at C = 1 and 5 on
    16 shared frames; and on the model's layout under two edge cases, no
    pixel valid and every correspondence off the image. Timed on both
    depths on the model's layout (the kernel alone), with the staging copy
    (from the channels-last frames), beside F.grid_sample on both depths
    and the bounds."""
    errs = {"reproject_sample_fwd": [], "reproject_composite_fwd": []}

    def check(what, src, depth, params, mask, rgb):
        for precision in ("exact", "fast"):
            ours = (rp.reproject_sample_pix(src, depth, params, precision)
                    + rp.reproject_composite_pix(src, depth, params, mask,
                                                 rgb, precision))
            torch.cuda.synchronize()
            ref = (rp.reproject_sample_pix_plain(src, depth, params,
                                                 precision)
                   + rp.reproject_composite_pix_plain(
                       src, depth, params, mask, rgb, precision))
            diff = [float((o - r).abs().max()) for o, r in zip(ours, ref)]
            errs["reproject_sample_fwd"].append(max(diff[:2]))
            errs["reproject_composite_fwd"].append(max(diff[2:]))
            print(f"[kernel-reproject] {what}, {precision}: max |kernel - "
                  f"plain| over geo, valid (#6) {max(diff[:2])!r}, over "
                  f"view, geo, valid (#7) {max(diff[2:])!r} (valid share "
                  f"{float(ours[1].mean()):.3f})")
            if max(diff) != 0.0:
                raise AssertionError(f"reprojection kernels disagree with "
                                     f"plain ({what}, {precision}): {diff}")
            if not all(bool(torch.isfinite(o).all()) for o in ours):
                raise AssertionError(f"non-finite output ({what})")

    shares = {}
    for kind, inp in inputs.items():
        shares[kind] = _shares(rp, inp)
        print(f"[kernel-reproject] {kind} depth: valid pixels "
              f"{shares[kind][0]!r}, in-image taps (the loads issued) "
              f"{shares[kind][1]!r}, pixels with no tap in the image "
              f"{shares[kind][2]!r}")
        for layout, args in _reproject_layouts(rp, inp).items():
            check(f"{kind} depth, {layout}", *args)
        for c in (1, 5):
            check(f"{kind} depth, C = {c} (16 shared channels-last frames)",
                  *_reproject_c_inputs(inp, c))
    model = _reproject_layouts(rp, inputs["random"])["model"]
    for edge in ("invalid", "off"):
        args = list(model)
        args[2] = _edge_params(args[2], edge)
        check(f"edge case {edge}, model", *args)
        geo, valid = rp.reproject_sample_pix(*args[:3], "fast")
        if bool(geo.any()) or float(valid.max()) != float(edge == "off"):
            raise AssertionError(f"edge case {edge}: geo not 0 or valid "
                                 f"wrong")

    img, depth, params, mask, rgb = inputs["smooth"]
    b, c, h, w = img.shape
    n, p = depth.shape[0], h * w
    copy = _reproject_layouts(rp, inputs["smooth"])["per-target copy"]
    stats = {}
    for name, kernel, fn, plain, composite in (
            ("reproject_sample_fwd", "reproject_sample_kernel",
             rp.reproject_sample_pix, rp.reproject_sample_pix_plain, False),
            ("reproject_composite_fwd", "reproject_composite_kernel",
             rp.reproject_composite_pix, rp.reproject_composite_pix_plain,
             True)):
        def call(f, inp, precision="fast", composite=composite):
            """f on the frame, depth and scalars (mask and rgb too for the
            composite) of ``inp``."""
            return lambda: f(*inp[:5 if composite else 3], precision)
        staged = {kind: _reproject_layouts(rp, inp)["model"]
                  for kind, inp in inputs.items()}
        device_ms = {kind: _kernel_ms(call(fn, staged[kind]), kernel)
                     for kind in inputs}
        # the wrapper on the channels-last frames: the staging copy and the
        # kernel, each launch of one call (the profiler)
        with_staging_ms, _ = _device_ms(call(fn, inputs["smooth"]))
        call_ms = _timed_ms(call(fn, staged["smooth"]), 50)
        exact_ms = _timed_ms(call(fn, staged["smooth"], "exact"), 50)
        plain_ms = _timed_ms(call(plain, inputs["smooth"]), 10)
        library_ms = {}
        for kind, inp in inputs.items():
            cr = rp.correspondence_plain(inp[1], inp[2], h, w)
            grid = _frames_grid(img, cr["x"], cr["y"])
            library_ms[kind] = _timed_ms(lambda: F.grid_sample(
                img, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True), 50)
        composed = copy[:5 if composite else 3]
        composition_ms = _timed_ms(
            lambda: _reproject_composition(*composed), 50)
        ours = call(fn, staged["smooth"])()
        theirs = _reproject_composition(*composed)
        agree = max(float((o - r).abs().max()) for o, r in zip(ours, theirs))
        # each input read once, each output written once: params, depth,
        # the B frames in; geo, valid out; the composite adds mask, rgb in
        # and view out (f32)
        nbytes = 4 * (12 * n + n * p + b * c * h * w + n * c * p + n * p
                      + (n * p + 2 * n * c * p if composite else 0))
        # per pixel ~30 flops of correspondence, ~20 of tap weights, ~10
        # per channel (4 more with the composite)
        bound_ms, bound_by = _bound(nbytes, n * p * (50 + (14 if composite
                                                           else 10) * c))
        print(f"[kernel-reproject] {name}, c2 shape N={n} targets of C={c} "
              f"{h}x{w} sharing {b} staged frames: kernel fast "
              f"{device_ms['smooth']!r} ms on the device (profiler) on the "
              f"smooth depth, {device_ms['random']!r} ms on the random one; "
              f"from the channels-last frames (the staging copy and the "
              f"kernel) {with_staging_ms!r} ms; call of the wrapper fast "
              f"{call_ms!r} ms, exact {exact_ms!r} ms (events, 50 back to "
              f"back); plain (fast) {plain_ms!r} ms; yardsticks: "
              f"F.grid_sample of the {b} frames (zeros, sample only, at the "
              f"same coordinates) {library_ms['smooth']!r} ms on the smooth "
              f"depth, {library_ms['random']!r} ms on the random one; the "
              f"whole function composed of PyTorch calls on the per-target "
              f"copy {composition_ms!r} ms (f32, max |kernel fast - "
              f"composition| {agree!r}); bound {bound_ms!r} ms ({nbytes} B "
              f"at 3.35 TB/s)")
        stats[name] = {"max_abs_err": max(errs[name]),
                       "ms": device_ms["smooth"],
                       "ms_random_depth": device_ms["random"],
                       "ms_with_staging": with_staging_ms,
                       "call_ms": call_ms, "plain_ms": plain_ms,
                       "library_ms": library_ms["smooth"],
                       "library_ms_random_depth": library_ms["random"],
                       "library": "F.grid_sample zeros of the frames "
                                  "(sample only)",
                       "composition_ms": composition_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "valid_share": {k: v[0] for k, v in shares.items()},
                       "in_image_tap_share": {k: v[1]
                                              for k, v in shares.items()}}
    return stats["reproject_sample_fwd"], stats["reproject_composite_fwd"]


def phase_kernel_reproject_bwd(rp, inputs) -> dict:
    """The fused depth backward at the c2 shape on the inputs of
    ``phase_kernel_reproject``, on the model's layout (the staged frames
    the autograd ops keep), on the channels-last frames and on the
    per-target copy, three launches: composite (d_view, d_geo, no d_img:
    depth synthesis's training launch), sample (d_geo, no d_img: the
    geometric side view's) and full (composite with d_img). d_depth,
    d_mask, d_rgb bitwise, d_img (one per frame; atomics; contiguous where
    the frames are, else channels-last) to 1e-6 of its largest magnitude;
    timed on smooth and random depths on the model's layout, and the
    composite and sample launches on the per-target copy."""
    img, depth, params, mask, rgb = inputs["smooth"]
    b, c, h, w = img.shape
    n, p = depth.shape[0], h * w
    g = torch.Generator(device="cuda").manual_seed(4)
    d_view, d_geo = (torch.randn(rgb.shape, generator=g, device="cuda")
                     for _ in range(2))
    launches = {"composite": (True, d_view, d_geo, False),
                "sample": (False, None, d_geo, False),
                "full": (True, d_view, d_geo, True)}

    def args(inp, what):
        composite, dv, dg, need = launches[what]
        im, dp, pr, m, r = inp
        return ((im, dp, pr, m if composite else None,
                 r if composite else None, dv, dg), need)

    errs = []
    for kind, both in inputs.items():
        for layout, inp in _reproject_layouts(rp, both).items():
            for precision in ("exact", "fast"):
                for what in launches:
                    a, need = args(inp, what)
                    ours = rp.reproject_pix_bwd(*a, precision, need)
                    torch.cuda.synchronize()
                    ref = rp.reproject_pix_bwd_plain(*a, precision, need)
                    err = max(float((o - r).abs().max())
                              for o, r in zip(ours[1:], ref[1:])
                              if r is not None)
                    if need:
                        scale = max(1.0, float(ref[0].abs().max()))
                        img_err = float((ours[0] - ref[0]).abs().max()) \
                            / scale
                        note = f"d_img {tuple(ours[0].shape)} {img_err!r} " \
                            f"of its largest |value| {scale!r}"
                        if ours[0].is_contiguous() != \
                                a[0].is_contiguous() or not (
                                    ours[0].is_contiguous()
                                    or rp._build.channels_last(ours[0])):
                            raise AssertionError("d_img is not in the "
                                                 "frames' layout")
                    else:
                        img_err = 0.0 if ours[0] is None else float("inf")
                        note = f"d_img " \
                            f"{'None' if ours[0] is None else 'given'}"
                    print(f"[kernel-reproject-bwd] {kind} depth, {layout}, "
                          f"{precision}, {what} launch: max |kernel - plain| "
                          f"over d_depth, d_mask, d_rgb = {err!r}; {note}")
                    if not (err == 0.0 and img_err <= 1e-6):
                        raise AssertionError(
                            f"depth backward disagrees with plain ({kind}, "
                            f"{layout}, {precision}, {what}): {err}, d_img "
                            f"{img_err}")
                    errs.append(err)

    def call(inp, what, precision="fast"):
        a, need = args(inp, what)
        return lambda: rp.reproject_pix_bwd(*a, precision, need)
    staged = {kind: _reproject_layouts(rp, inp)["model"]
              for kind, inp in inputs.items()}
    device_ms = {(kind, what): _kernel_ms(call(staged[kind], what),
                                          "reproject_bwd_kernel")
                 for kind in inputs for what in launches}
    call_ms = {what: _timed_ms(call(staged["smooth"], what), 50)
               for what in launches}
    exact_ms = _timed_ms(call(staged["smooth"], "composite", "exact"), 50)
    copy = _reproject_layouts(rp, inputs["smooth"])["per-target copy"]
    # the per-target copy: the wrapper's staging copy included
    copy_ms = {what: _device_ms(call(copy, what))[0]
               for what in ("composite", "sample")}
    a, need = args(inputs["smooth"], "composite")
    plain_ms = _timed_ms(lambda: rp.reproject_pix_bwd_plain(
        *a, "fast", need), 10)
    cr = rp.correspondence_plain(depth, params, h, w)
    grid = _frames_grid(img, cr["x"], cr["y"]).requires_grad_(True)
    out = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    d_out = d_geo.reshape(b, -1, c, p).transpose(1, 2).reshape(out.shape)
    library_ms = _timed_ms(lambda: torch.autograd.grad(
        out, grid, d_out, retain_graph=True), 50)
    # each input read once, each output written once. Composite launch:
    # params, depth, the B frames, mask, rgb, d_view, d_geo in; d_depth,
    # d_mask, d_rgb out. Sample launch: params, depth, frames, d_geo in;
    # d_depth out. Full: the composite launch plus d_img (one per frame)
    # out.
    base = 4 * (12 * n + n * p + b * c * h * w)
    nbytes = {"composite": base + 4 * (n * p + 3 * n * c * p + 2 * n * p
                                       + n * c * p),
              "sample": base + 4 * (n * c * p + n * p)}
    nbytes["full"] = nbytes["composite"] + 4 * b * c * h * w
    # per pixel ~60 flops of correspondence, weights and the depth chain
    # rule, ~35 per channel of sample and gradients (+8 composite, +8 d_img)
    ops = {"composite": n * p * (60 + 43 * c), "sample": n * p * (60 + 35 * c),
           "full": n * p * (60 + 51 * c)}
    bounds = {what: _bound(nbytes[what], ops[what]) for what in launches}
    print(f"[kernel-reproject-bwd] c2 shape N={n} targets of C={c} {h}x{w} "
          f"sharing {b} staged frames, fast, kernel on the device "
          f"(profiler): "
          + ", ".join(f"{what} launch {device_ms['smooth', what]!r} ms "
                      f"(random depth {device_ms['random', what]!r} ms)"
                      for what in launches)
          + "; on the per-target copy (the staging copy and the "
          "kernel): " + ", ".join(f"{what} launch {ms!r} ms"
                                  for what, ms in copy_ms.items()))
    print(f"[kernel-reproject-bwd] calls of the wrapper (events, 50 back to "
          f"back), fast: "
          + ", ".join(f"{what} {call_ms[what]!r} ms" for what in launches)
          + f" (composite exact {exact_ms!r} ms); plain (fast, composite "
          f"launch) {plain_ms!r} ms; F.grid_sample backward of the {b} frames "
          f"(zeros, grid only) {library_ms!r} ms; bounds "
          + ", ".join(f"{what} {bounds[what][0]!r} ms ({nbytes[what]} B)"
                      for what in launches) + " at 3.35 TB/s")
    return {"max_abs_err": max(errs), "ms": device_ms["smooth", "composite"],
            "ms_random_depth": device_ms["random", "composite"],
            "ms_sample_launch": device_ms["smooth", "sample"],
            "ms_per_target_copy": copy_ms["composite"],
            "ms_sample_launch_per_target_copy": copy_ms["sample"],
            "call_ms": call_ms["composite"], "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "F.grid_sample backward zeros of the frames (grid "
                       "gradient only)",
            "bound_ms": bounds["composite"][0],
            "bound_by": bounds["composite"][1],
            "bound_ms_sample_launch": bounds["sample"][0]}


def phase_reference_depth(config, Model, DMV3D, synthetic, tstep):
    """Phases 4 and 7 for the tiny c2d and c2g models."""
    for variant, extra in DEPTH_OVERRIDES.items():
        phase_reference(config, Model, DMV3D, synthetic, extra,
                        tag=f"reference-depth {variant}")
        phase_train_reference(config, synthetic, tstep, extra,
                              tag=f"reference-depth {variant}")


# each depth variant's launches per request and per train step, and its
# staging copies of the last frame: one per forward, none in the backward
DEPTH_SERVE_LAUNCHES = {
    "c2d": {"sample_fwd": 1, "reproject_composite_fwd": 1,
            "stage:copies": 1},
    "c2g": {"warp_composite_fwd": 1, "reproject_sample_fwd": 1,
            "stage:copies": 1}}
DEPTH_TRAIN_LAUNCHES = {
    "c2d": {"sample_fwd": 1, "reproject_composite_fwd": 1,
            "reproject_bwd": 1, "reproject_bwd:composite": 1,
            "stage:copies": 1},
    "c2g": {"warp_composite_fwd": 1, "reproject_sample_fwd": 1,
            "warp_composite_bwd": 1, "warp_composite_bwd:composite": 1,
            "reproject_bwd": 1, "stage:copies": 1}}


def phase_serve_depth(variant, config, Model, synthetic, gs, rp, pose_ops,
                      counted, raw_batches, requests, profile) -> dict:
    """A c2 model with the depth switches of ``variant`` answers 3 requests
    with exactly its launches; its aux outputs are recomputed with the
    plain versions (warp, reprojection, composite: 1e-5); then a window of
    ``requests`` requests is timed."""
    tag = f"serve-{variant}"
    cfg = config.get_config("c2", DEPTH_OVERRIDES[variant])
    b, k, hw = cfg.data.batch_size, cfg.data.num_targets, cfg.model.image_size
    prec = cfg.model.warp_precision
    t0 = time.perf_counter()
    model = Model.init_random(cfg, seed=0, device="cuda")
    batches = [dict(raw, image_seq=synthetic.to_model(raw["image_seq"]),
                    tgt_images=synthetic.to_model(raw["tgt_images"]))
               for raw in raw_batches]
    print(f"[{tag}] c2 model with {list(DEPTH_OVERRIDES[variant])} "
          f"({sum(q.numel() for q in model.module.parameters())} params, "
          f"{cfg.model.dtype}, warp {prec}) in {time.perf_counter() - t0:.2f}"
          f" s")

    def request(batch, aux=False):
        return model.predict(batch["image_seq"], batch["tgt_poses"],
                             source_poses=batch["src_poses"], return_aux=aux)

    request(batches[0])                       # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    _reset_counts(counted)
    outs = [request(batch, aux=(i == 2))
            for i, batch in enumerate(batches[1:])]
    torch.cuda.synchronize()
    counts = _read_counts(counted)
    _expect_counts(tag, counts, {name: 3 * c for name, c in
                                 DEPTH_SERVE_LAUNCHES[variant].items()})
    for view in outs[:2] + [outs[2]["view"]]:
        if tuple(view.shape) != (b, k, hw, hw, 3) or \
                not bool(torch.isfinite(view).all()):
            raise AssertionError(f"bad view: shape {tuple(view.shape)}")

    aux, batch = outs[2], batches[3]
    n, p = b * k, hw * hw

    def pix(x, c):                            # [B,K,H,W,C] -> [N, C, P]
        return x.reshape(n, p, c).transpose(1, 2).contiguous()
    last = torch.as_tensor(batch["image_seq"][:, -1], device="cuda") \
        .permute(0, 3, 1, 2).repeat_interleave(k, dim=0).contiguous()
    flow = aux["flow"].reshape(n, hw, hw, 2)
    base = torch.arange(hw, device="cuda", dtype=torch.float32)
    ix = (base + flow[..., 0]).reshape(n, p).contiguous()
    iy = (base[:, None] + flow[..., 1]).reshape(n, p).contiguous()
    mask, rgb = pix(aux["mask"], 1)[:, 0].contiguous(), pix(aux["rgb"], 3)
    if variant == "c2d":
        warped = gs.sample_pixel_coords_plain(last, ix, iy, "border", prec)
        view = None
    else:
        view, warped, _ = gs.warp_composite_pix_plain(last, ix, iy, mask, rgb,
                                                      "border", prec)
    src = torch.as_tensor(batch["src_poses"][:, -1], device="cuda") \
        .repeat_interleave(k, dim=0)
    params = _c2_params(rp, pose_ops, src, torch.as_tensor(
        batch["tgt_poses"], device="cuda").reshape(n, 3), hw, hw)
    geo, valid = rp.reproject_sample_pix_plain(
        last, aux["depth"].reshape(n, p).contiguous(), params, prec)
    if view is None:
        view = mask[:, None] * geo + (1.0 - mask[:, None]) * rgb
    errs = {"warped": float((warped - pix(aux["warped"], 3)).abs().max()),
            "geo_view": float((geo - pix(aux["geo_view"], 3)).abs().max()),
            "view": float((view - pix(aux["view"], 3)).abs().max())}
    valid_same = bool(torch.equal(valid, aux["geo_valid"].reshape(n, p)))
    print(f"[{tag}] aux outputs vs the plain versions from the request's "
          f"frames, flow, depth, mask and rgb: max err {errs}; geo_valid "
          f"identical: {valid_same} (share "
          f"{float(aux['geo_valid'].mean()):.3f}); depth in "
          f"[{float(aux['depth'].min()):.3f}, "
          f"{float(aux['depth'].max()):.3f}]")
    if not (max(errs.values()) <= 1e-5 and valid_same):
        raise AssertionError(f"served {variant} outputs disagree with the "
                             f"plain versions")
    _time_requests(tag, request, batches, requests, b * k)
    if profile:
        phase_profile(lambda: request(batches[1]), f"one {variant} request")
    copies = frame_copies(lambda: request(batches[1]), b, hw, hw)
    print(f"[{tag}] ops repeating the [{b}, 3, {hw}, {hw}] last frame per "
          f"target in one request: {copies}")
    if copies:
        raise AssertionError(f"{variant} copied the frame per target")
    return counts


def phase_train_depth(variant, config, tstep, counted, raw_batches, steps,
                      profile) -> dict:
    tag = f"train-{variant}"
    cfg = config.get_config("c2", DEPTH_OVERRIDES[variant])
    t0 = time.perf_counter()
    state = tstep.init_state(cfg, seed=0, device="cuda")
    step = tstep.make_train_step(cfg, device="cuda")
    tc = cfg.train
    print(f"[{tag}] c2 state with {list(DEPTH_OVERRIDES[variant])} "
          f"({sum(q.numel() for q in state.module.parameters())} params, "
          f"{cfg.model.dtype}, {tc.optimizer} lr {tc.lr} {tc.lr_schedule}, "
          f"geo_weight {tc.geo_weight}) in {time.perf_counter() - t0:.2f} s")
    return _train_window(tag, variant, state, step, counted, raw_batches,
                         {name: 3 * c for name, c in
                          DEPTH_TRAIN_LAUNCHES[variant].items()},
                         cfg.data.batch_size * cfg.data.num_targets,
                         steps=steps, profile=profile)[0]


# ------------------------------------------------------ c1, c3 and c5 presets
# each preset at the JAX suite's per-chip slice (benchmarks/run.py; c5's
# global batch of 128 over 32 chips), and its windows: (requests, steps)
PRESET_SLICES = {"c1": (), "c3": (),
                 "c5": ("data.batch_size=4", "mesh.data=1",
                        "mesh.multihost=false")}
PRESET_WINDOWS = {"c1": (30, 20), "c3": (20, 10), "c5": (20, 10)}
# one request launches #1 and stages its frame once; a step adds #3's
# training launch (composite, no d_img) and no copy
PRESET_SERVE = {"warp_composite_fwd": 1, "stage:copies": 1}
PRESET_TRAIN = {"warp_composite_fwd": 1, "warp_composite_bwd": 1,
                "warp_composite_bwd:composite": 1, "stage:copies": 1}


def preset_batches(config, pipeline, preset: str) -> list:
    """4 batches of ``preset``'s per-chip slice, uint8, from its own source
    (c1: static synthetic scenes at 64 x 64; c3: dynamic ones over T = 8;
    c5: the frames source with an empty root, SyntheticFrames, 256 x 256
    over T = 4), seed 0."""
    cfg = config.get_config(preset, PRESET_SLICES[preset])
    b = cfg.data.batch_size
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # c5: the SyntheticFrames note
        source = pipeline.make_source(cfg.data)
    batches = [source.batch(range(i * b, (i + 1) * b), raw=True)
               for i in range(4)]
    print(f"[data] 4 {preset} batches of B={b} T={cfg.data.seq_len} "
          f"K={cfg.data.num_targets} at {cfg.data.image_size}^2 (dynamic "
          f"{cfg.data.dynamic}) from {type(source).__name__} rendered in "
          f"{time.perf_counter() - t0:.2f} s")
    return batches


def _recomposite(tag, gs, cfg, batch, aux) -> None:
    """The request's view and validity recomputed with #1's plain version
    from its last frame and its aux flow, mask and rgb (1e-5)."""
    b, k = cfg.data.batch_size, cfg.data.num_targets
    hw, n = cfg.model.image_size, b * k
    last = torch.as_tensor(batch["image_seq"][:, -1], device="cuda") \
        .repeat_interleave(k, dim=0)
    view, _, valid = gs.flow_warp_composite_plain(
        last, aux["flow"].reshape(n, hw, hw, 2),
        aux["mask"].reshape(n, hw, hw, 1), aux["rgb"].reshape(n, hw, hw, 3),
        precision=cfg.model.warp_precision)
    err = float((view.reshape(b, k, hw, hw, 3) - aux["view"]).abs().max())
    valid_same = bool(torch.equal(valid.reshape(b, k, hw, hw),
                                  aux["flow_valid"]))
    print(f"[{tag}] view vs plain recomposite from aux: max err {err!r}; "
          f"flow_valid identical: {valid_same}")
    if not (err <= 1e-5 and valid_same):
        raise AssertionError(f"[{tag}] view disagrees with the plain version")


def phase_serve_preset(preset, config, Model, synthetic, gs, counted,
                       raw_batches) -> dict:
    """[serve-<preset>]: the preset at full width (random seed-0 weights)
    answers 3 requests of its slice: #1 and the staging copy once each a
    request, every other kernel 0; the third request's view recomposited
    with the plain version; a window of requests timed; one request
    profiled (device busy / wall)."""
    tag = f"serve-{preset}"
    cfg = config.get_config(preset, PRESET_SLICES[preset])
    m, d = cfg.model, cfg.data
    b, k, hw = d.batch_size, d.num_targets, m.image_size
    t0 = time.perf_counter()
    model = Model.init_random(cfg, seed=0, device="cuda")
    batches = [dict(raw, image_seq=synthetic.to_model(raw["image_seq"]))
               for raw in raw_batches]
    print(f"[{tag}] {cfg.name} model ({sum(q.numel() for q in model.module.parameters())}"
          f" params, {m.dtype}, {m.num_levels} levels, remat_scan "
          f"{m.remat_scan}, warp {m.warp_precision}), B={b} T={d.seq_len} "
          f"K={k} at {hw}^2, in {time.perf_counter() - t0:.2f} s")

    def request(batch, aux=False):
        return model.predict(batch["image_seq"], batch["tgt_poses"],
                             source_poses=batch["src_poses"], return_aux=aux)

    request(batches[0])                       # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    _reset_counts(counted)
    outs = [request(batch, aux=(i == 2))
            for i, batch in enumerate(batches[1:])]
    torch.cuda.synchronize()
    counts = _read_counts(counted)
    _expect_counts(tag, counts, {n: 3 * c for n, c in PRESET_SERVE.items()})
    for view in outs[:2] + [outs[2]["view"]]:
        if tuple(view.shape) != (b, k, hw, hw, 3) or \
                not bool(torch.isfinite(view).all()):
            raise AssertionError(f"[{tag}] bad view: shape "
                                 f"{tuple(view.shape)}")
    _recomposite(tag, gs, cfg, batches[3], outs[2])
    torch.cuda.reset_peak_memory_stats()
    _time_requests(tag, request, batches, PRESET_WINDOWS[preset][0], b * k)
    print(f"[{tag}] peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    phase_profile(lambda: request(batches[1]), f"one {preset} request")
    return counts


def phase_train_preset(preset, config, tstep, counted, raw_batches) -> dict:
    """[train-<preset>]: the preset's train state (its optimizer and
    schedule, remat_scan as it says) takes 3 steps: #1, #3's training
    launch and the staging copy once each a step, every other kernel 0;
    then a window of steps on one batch (p50, p90, peak memory, a falling
    loss) and one profiled step."""
    tag = f"train-{preset}"
    cfg = config.get_config(preset, PRESET_SLICES[preset])
    t0 = time.perf_counter()
    state = tstep.init_state(cfg, seed=0, device="cuda")
    step = tstep.make_train_step(cfg, device="cuda")
    tc = cfg.train
    print(f"[{tag}] {cfg.name} state ({sum(q.numel() for q in state.module.parameters())}"
          f" params, {cfg.model.dtype}, remat_scan {cfg.model.remat_scan}, "
          f"{tc.optimizer} lr {tc.lr} {tc.lr_schedule}) in "
          f"{time.perf_counter() - t0:.2f} s")
    return _train_window(tag, preset, state, step, counted, raw_batches,
                         {n: 3 * c for n, c in PRESET_TRAIN.items()},
                         cfg.data.batch_size * cfg.data.num_targets,
                         steps=PRESET_WINDOWS[preset][1])[0]


def phase_kernel_preset(preset, config, gs) -> dict:
    """#1 and #3 at ``preset``'s shape (B frames of 3 x H x W,
    channels-last, each shared by its K targets; flows of up to 0.6 of the
    image): the forward in both paddings and precisions and the backward's
    training launch (no d_img, no d_warped) bitwise equal to the plain
    versions, the backward with d_img to 1e-5 of its largest magnitude;
    both timed (border, fast: the kernel under torch.profiler) beside
    their bounds. -> {"fwd": ..., "bwd": ...} stats."""
    tag = f"kernel-{preset}"
    cfg = config.get_config(preset, PRESET_SLICES[preset])
    b, k, hw = cfg.data.batch_size, cfg.data.num_targets, cfg.model.image_size
    inp = _warp_c_inputs(3, b=b, k=k, hw=hw, max_flow=0.6 * hw)
    g = torch.Generator(device="cuda").manual_seed(1)
    d_view = torch.randn(inp[4].shape, generator=g, device="cuda")
    errs, bwd_errs = [], []
    for padding in PADDINGS:
        for precision in ("exact", "fast"):
            ours = gs.warp_composite_pix(*inp, padding, precision)
            ref = gs.warp_composite_pix_plain(*inp, padding, precision)
            errs.append(max(float((o - r).abs().max())
                            for o, r in zip(ours, ref)))
            for need_img in (False, True):
                ours = gs.warp_composite_pix_bwd(*inp, d_view, None, padding,
                                                 precision, need_img=need_img)
                ref = gs.warp_composite_pix_bwd_plain(
                    *inp, d_view, None, padding, precision,
                    need_img=need_img)
                bwd_errs.append(max(float((o - r).abs().max())
                                    for o, r in zip(ours[1:], ref[1:])))
                if need_img and not float((ours[0] - ref[0]).abs().max()) \
                        <= 1e-5 * max(1.0, float(ref[0].abs().max())):
                    raise AssertionError(f"[{tag}] d_img disagrees "
                                         f"({padding}, {precision})")
    n, p = inp[1].shape
    print(f"[{tag}] {n} targets of 3 x {hw} x {hw} from {b} shared "
          f"channels-last frames (P = {p}): max |kernel - plain| forward "
          f"{max(errs)!r}, backward {max(bwd_errs)!r} (d_ix, d_iy, d_mask, "
          f"d_rgb; both paddings and precisions)")
    if max(errs) != 0.0 or max(bwd_errs) != 0.0:
        raise AssertionError(f"[{tag}] #1 or #3 disagrees with its plain "
                             f"version: {errs}, {bwd_errs}")
    staged = gs._build.stage(inp[0])
    fwd_ms = _kernel_ms(lambda: gs.warp_composite_pix(staged, *inp[1:],
                                                      "border", "fast"),
                        "warp_composite_fwd_kernel")
    bwd_ms = _kernel_ms(lambda: gs.warp_composite_pix_bwd(
        staged, *inp[1:], d_view, None, "border", "fast", need_img=False),
        "warp_composite_bwd_kernel")
    fwd_bytes = _warp_bytes(n, 3, p, b, hw * hw, 3 + 3 + 6 + 1)
    bwd_bytes = _warp_bytes(n, 3, p, b, hw * hw, 3 + 6 + 3 + 3)
    fwd_bound, fwd_by = _bound(fwd_bytes, n * p * (20 + 12 * 3))
    bwd_bound, bwd_by = _bound(bwd_bytes, n * p * (30 + 35 * 3))
    print(f"[{tag}] border, fast, on the staged frames: #1 {fwd_ms!r} ms "
          f"(bound {fwd_bound!r} ms, {fwd_bytes} B at 3.35 TB/s), #3's "
          f"training launch {bwd_ms!r} ms (bound {bwd_bound!r} ms, "
          f"{bwd_bytes} B)")
    return {"fwd": {"max_abs_err": max(errs), "ms": fwd_ms,
                    "bound_ms": fwd_bound, "bound_by": fwd_by},
            "bwd": {"max_abs_err": max(bwd_errs), "ms": bwd_ms,
                    "bound_ms": bwd_bound, "bound_by": bwd_by}}


def phase_c1_cpu(config, Model, synthetic, raw_batch) -> None:
    """The c1 preset at full width in f32 (TF32 off, warp exact): one
    request on the card against the same request on the CPU from the same
    weights, every output within 1e-4 (flow in units of its range), as
    [reference] holds the tiny model."""
    cfg = config.get_config("c1", ["model.warp_precision=exact"])
    cpu = Model.init_random(cfg, seed=0, device="cpu")
    gpu = Model.init_random(cfg, seed=0, device="cuda")
    gpu.module.load_state_dict(cpu.module.state_dict())
    seq = synthetic.to_model(raw_batch["image_seq"])
    args = (seq, raw_batch["tgt_poses"])
    kw = dict(source_poses=raw_batch["src_poses"], return_aux=True)
    ref, out = cpu.predict(*args, **kw), gpu.predict(*args, **kw)
    scale = {"flow": cfg.model.max_flow * cfg.model.image_size}
    errs = {k: float((out[k].cpu() - ref[k]).abs().max()) / scale.get(k, 1.0)
            for k in ref}
    print(f"[serve-c1] full-width c1 (f32, warp exact, TF32 off), the card "
          f"vs the CPU on the same weights and request: {errs}")
    if not max(errs.values()) <= 1e-4:
        raise AssertionError(f"[serve-c1] the card's c1 request is off the "
                             f"CPU's: {errs}")


def phase_presets(config, Model, synthetic, pipeline, gs, tstep,
                  counted) -> tuple:
    """c1, c3 and c5: each preset's kernels at its shape, its serve and
    train phases, and c1 against the CPU. -> (launch counts by path, the
    kernels' stats by preset)."""
    paths, stats = {}, {}
    for preset in PRESET_SLICES:
        stats[preset] = phase_kernel_preset(preset, config, gs)
        raw = preset_batches(config, pipeline, preset)
        paths[f"serve_{preset}"] = phase_serve_preset(
            preset, config, Model, synthetic, gs, counted, raw)
        paths[f"train_{preset}"] = phase_train_preset(
            preset, config, tstep, counted, raw)
        if preset == "c1":
            phase_c1_cpu(config, Model, synthetic, raw[1])
    return paths, stats


# the artifacts [serve-artifact] exports: preset, overrides, source counts
# (None: the preset's) and the launches of one request at each T
ARTIFACTS = {
    "c2": ("c2", (), None, {"warp_composite_fwd": 1, "stage:copies": 1}),
    "c3md": ("c3md", C3MD_OVERRIDES, (8, 3), {"multiflow_composite_fwd": 1}),
    "c2d": ("c2", DEPTH_OVERRIDES["c2d"], None, DEPTH_SERVE_LAUNCHES["c2d"]),
    "c2g": ("c2", DEPTH_OVERRIDES["c2g"], None, DEPTH_SERVE_LAUNCHES["c2g"]),
}


def _op_cases(gs, mf, rp, dev):
    """(operator, args) for each forward operator on small seeded inputs
    on ``dev`` (tests/test_torch_serving.py's cases): 2 frames shared by 2
    targets each, contiguous and staged, both precisions; 2 examples of 3
    sources for the multi-source operator, both paddings."""
    g = torch.Generator(device=dev).manual_seed(0)

    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo
    n_src, n, c, h, w = 2, 4, 3, 6, 8
    p = h * w
    img = u(n_src, c, h, w)
    ix, iy = u(n, p, lo=-2, hi=w + 1), u(n, p, lo=-2, hi=h + 1)
    mask, rgb = u(n, p), u(n, c, p)
    depth = u(n, p, lo=0.5, hi=3.0)
    cam = torch.eye(3, device=dev).expand(n, 3, 3) \
        * torch.tensor([8.0, 8.0, 1.0], device=dev)
    cam = cam.clone()
    cam[:, 0, 2], cam[:, 1, 2] = 3.5, 2.5
    rel = torch.eye(4, device=dev).expand(n, 4, 4).clone()
    rel[:, :3, 3] = u(n, 3, lo=-0.2, hi=0.2)
    params = rp.host_params(cam, rel)
    t = 3
    imgs = u(2, t, c, h, w)
    mix, miy = u(2, t, p, lo=-2, hi=w + 1), u(2, t, p, lo=-2, hi=h + 1)
    cases = []
    for img_in in (img, gs._build.stage(img)):
        for prec in ("exact", "fast"):
            cases += [
                (gs.warp_composite_fwd,
                 (img_in, ix, iy, mask, rgb, "border", prec)),
                (gs.sample_fwd, (img_in, ix[:n_src], iy[:n_src], "zeros",
                                 prec)),
                (rp.reproject_sample_fwd, (img_in, depth, params, prec)),
                (rp.reproject_composite_fwd,
                 (img_in, depth, params, mask, rgb, prec))]
    for padding in PADDINGS:
        cases.append((mf.multiflow_composite_fwd,
                      (imgs, mix, miy, u(2, t, p, lo=-1, hi=1), u(2, p),
                       u(2, c, p), padding, "fast")))
    return cases


def _dispatch_us(gs, calls: int = 200) -> tuple:
    """Host microseconds a call of ``dmv3d::warp_composite_fwd`` and of its
    CUDA implementation called directly, at a tiny shape (1 frame of 3 x 8
    x 8, staged) where the host's cost is the whole call: the operator's
    dispatch is the difference."""
    dev = torch.device("cuda")
    img = gs._build.stage(torch.rand(1, 3, 8, 8, device=dev))
    ix = torch.rand(1, 64, device=dev) * 7
    args = (img, ix, ix.clone(), torch.rand(1, 64, device=dev),
            torch.rand(1, 3, 64, device=dev), "border", "fast")
    out = {}
    for name, fn in (("op", gs.warp_composite_fwd),
                     ("impl", gs._warp_composite_fwd_cuda)):
        samples = []
        for _ in range(5):
            fn(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) / calls * 1e6)
        out[name] = float(np.median(samples))
    return out["op"], out["impl"]


def phase_serve_artifact(config, Model, serving, synthetic, gs, mf, rp,
                         counted, raw_c2, raw_c3md, keep_dir) -> dict:
    """[serve-artifact]: each of ARTIFACTS exported on the CPU from a
    seeded full-width model on the card, loaded on the card and served
    bitwise equal to Model.predict with its exact launches; timings beside
    the eager phases'; opcheck of the forward operators on CUDA; the c2
    artifact copied into ``keep_dir`` for [serve-mesh]. -> the served
    paths' launch counts."""
    from torch.library import opcheck
    cases = _op_cases(gs, mf, rp, torch.device("cuda"))
    t0 = time.perf_counter()
    for op, args in cases:
        opcheck(op, args)
    print(f"[serve-artifact] torch.library.opcheck of "
          f"{sorted({op._qualname for op, _ in cases})} on CUDA inputs: "
          f"{len(cases)} cases passed in {time.perf_counter() - t0:.2f} s")
    op_us, impl_us = _dispatch_us(gs)
    print(f"[serve-artifact] host time a call at a tiny shape (median of 5 "
          f"x 200 calls): the operator dmv3d::warp_composite_fwd {op_us!r} "
          f"us, its CUDA implementation called directly {impl_us!r} us: "
          f"dispatch {op_us - impl_us!r} us")
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (preset, extra, seq_len, want) in ARTIFACTS.items():
            tag = f"serve-artifact {name}"
            cfg = config.get_config(preset, extra)
            b, k = cfg.data.batch_size, cfg.data.num_targets
            model = Model.init_random(cfg, seed=0, device="cuda")
            path = os.path.join(tmp, f"{name}.dmv3d")
            t0 = time.perf_counter()
            manifest = serving.export_predict(model, path, batch=b,
                                              seq_len=seq_len, num_targets=k)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            served = serving.ServedModel.load(path)
            load_s = time.perf_counter() - t0
            nodes = {}                 # T -> (operator nodes, of them checks)
            for t in served.seq_lens:
                ops = [str(n.target) for n in served.call_for(t).graph.nodes
                       if n.op == "call_function"]
                nodes[t] = (len(ops), sum("assert_tensor" in o for o in ops))
            print(f"[{tag}] exported on the CPU in {export_s:.2f} s "
                  f"({os.path.getsize(path)} bytes, T {served.seq_lens}, "
                  f"operators {manifest['custom_ops']}); loaded on "
                  f"{served.device} in {load_s:.2f} s; operator nodes by T "
                  f"(of them _assert_tensor_metadata): {nodes}")
            raws = raw_c3md if preset == "c3md" else raw_c2
            for t in served.seq_lens:
                # a T below the batches' keeps each example's last T sources
                batches = [dict(image_seq=synthetic.to_model(
                    raw["image_seq"][:, -t:]),
                    src_poses=raw["src_poses"][:, -t:],
                    tgt_poses=raw["tgt_poses"]) for raw in raws]

                def request(batch, fn=served.predict):
                    return fn(batch["image_seq"], batch["tgt_poses"],
                              source_poses=batch["src_poses"])
                request(batches[0])                       # warm-up
                torch.cuda.synchronize()
                _reset_counts(counted)
                outs = [request(batch) for batch in batches[1:]]
                torch.cuda.synchronize()
                path_name = f"serve_artifact_{name}" + (
                    f"_T{t}" if len(served.seq_lens) > 1 else "")
                paths[path_name] = _read_counts(counted)
                _expect_counts(f"{tag} T={t}", paths[path_name],
                               {kk: 3 * v for kk, v in want.items()})
                refs = [request(batch, model.predict)
                        for batch in batches[1:]]
                errs = [float((o - r).abs().max()) for o, r in
                        zip(outs, refs)]
                same = all(torch.equal(o, r) for o, r in zip(outs, refs))
                print(f"[{tag}] T={t}: served views {tuple(outs[0].shape)} "
                      f"{outs[0].dtype} vs Model.predict of the same module "
                      f"on the same batches: bitwise {same} (max err "
                      f"{max(errs)!r})")
                if not same or not all(bool(torch.isfinite(o).all())
                                       for o in outs):
                    raise AssertionError(f"{tag} T={t}: served views are not "
                                         f"Model.predict's")
            if name == "c3md":
                try:
                    served.predict(batches[1]["image_seq"],
                                   batches[1]["tgt_poses"])
                except ValueError as err:
                    print(f"[{tag}] a request without source poses is "
                          f"refused: {str(err)[:60]}...")
                else:
                    raise AssertionError("a pose-less c3md request was "
                                         "served")
            if name in ("c2", "c3md"):
                eager = "serve" if name == "c2" else "serve-c3md"
                batches = [dict(image_seq=synthetic.to_model(
                    raw["image_seq"]), src_poses=raw["src_poses"],
                    tgt_poses=raw["tgt_poses"]) for raw in raws]
                _time_requests(tag, request, batches,
                               50 if name == "c2" else 20, b * k)
                print(f"[{tag}] served p50 / p90 / views/s "
                      f"{WINDOWS[tag]} beside [{eager}]'s {WINDOWS[eager]} "
                      f"in this run")
            if name == "c2":
                shutil.copyfile(path, os.path.join(keep_dir, "c2.dmv3d"))
                copies = frame_copies(lambda: request(batches[1]), b,
                                      cfg.model.image_size,
                                      cfg.model.image_size)
                print(f"[{tag}] ops repeating the last frame per target in "
                      f"one served request: {copies}")
                if copies:
                    raise AssertionError("the served c2 request copied the "
                                         "frame per target")
            del model, served
            torch.cuda.empty_cache()
    return paths


def phase_pose(pose_ops):
    """The camera math on CUDA inputs copies nothing from the host: its
    constants (up vector, bottom rows, principal point) are filled in on
    the device. Fails on any Memcpy HtoD under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device="cuda").manual_seed(5)
    pose = torch.rand((128, 3), generator=g, device="cuda") + 0.5
    other = torch.rand((128, 3), generator=g, device="cuda") + 0.5
    focal = torch.full((128,), 128.0, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rel = pose_ops.relative_transform(pose_ops.look_at_extrinsics(pose),
                                          pose_ops.look_at_extrinsics(other))
        intr = pose_ops.intrinsics_matrix(focal, 63.5, 63.5)
        torch.cuda.synchronize()
    copies = sum(e.count for e in prof.key_averages()
                 if "Memcpy HtoD" in e.key)
    print(f"[pose] look_at_extrinsics x2, relative_transform, "
          f"intrinsics_matrix on CUDA inputs: {copies} host-to-device "
          f"copies; rel {tuple(rel.shape)}, K {tuple(intr.shape)}")
    if copies or not (bool(torch.isfinite(rel).all())
                      and bool((rel[:, 3] == torch.tensor(
                          [0.0, 0.0, 0.0, 1.0], device="cuda")).all())
                      and float(intr[0, 0, 2]) == 63.5):
        raise AssertionError(f"the camera math copied to the device "
                             f"({copies}) or is wrong")


# the device draw pinned by tests/test_torch_resident.py (seed 7, step 11,
# 3 examples), which the card must give as the CPU does
DRAW_META = {"num_scenes": 5, "num_views": 6, "t_avail": 5, "t_len": 4,
             "num_targets": 3, "orbit": True}
DRAW_PINNED = {"seq_idx": [[20, 11, 7, 18], [45, 56, 32, 38],
                           [45, 41, 32, 38]],
               "tgt_idx": [[18, 13, 8], [48, 53, 33], [58, 53, 43]]}
# [loop-c3md]'s bank: 64 scenes of 8 views x 8 frames, K = 2 targets
C3MD_DRAW_META = {"num_scenes": 64, "num_views": 8, "t_avail": 8,
                  "t_len": 8, "num_targets": 2, "orbit": True}


def phase_data(config, packer_s):
    """[data] the port's exporters and sources (none of imageio, OpenCV or
    TensorFlow), the native packer against its numpy version, the resident
    gather and the device draw on the card."""
    from dynamic_multiview_3d_torch.data import (frames, native, pipeline,
                                                 resident, shapenet,
                                                 tfrecords)
    with tempfile.TemporaryDirectory(prefix="dmv3d_data_") as tmp:
        kw = dict(num_scenes=2, image_size=64, num_views=4, seq_len=2)
        t0 = time.perf_counter()
        roots = {
            "png": frames.export_synthetic(f"{tmp}/png", fmt="png", **kw),
            "packed": frames.export_synthetic(f"{tmp}/packed", fmt="packed",
                                              **kw),
            "tfrecords": tfrecords.export_tfrecords(f"{tmp}/tfr", shards=2,
                                                    **kw),
            "shapenet_dir": shapenet.export_fixture(
                f"{tmp}/snet", num_scenes=2, image_size=64, num_views=4)}
        print(f"[data] exported png, packed, tfrecord and shapenet datasets "
              f"(2 scenes of 4 views, 64²) in "
              f"{time.perf_counter() - t0:.2f} s")
        cfgs, sources, raw, f32 = {}, {}, {}, {}
        for name, root in roots.items():
            source = "frames" if name in ("png", "packed") else name
            cfgs[name] = config.get_config("default", [
                f"data.source={source}", f"data.root={root}",
                "data.image_size=64", "data.seq_len=2", "data.num_targets=2",
                "data.src_views=orbit"]).data
            t0 = time.perf_counter()
            src = sources[name] = pipeline.make_source(cfgs[name])
            raw[name] = src.batch(range(8), raw=True)
            f32[name] = src.batch(range(8))
            secs = time.perf_counter() - t0
            t_len = 1 if name == "shapenet_dir" else 2
            want = {"image_seq": (8, t_len, 64, 64, 3),
                    "src_poses": (8, t_len, 3), "tgt_poses": (8, 2, 3),
                    "tgt_images": (8, 2, 64, 64, 3)}
            shapes = {k: tuple(v.shape) for k, v in raw[name].items()}
            print(f"[data] {name}: {type(src).__name__}, "
                  f"{len(src.scenes)} scenes; 8 examples (uint8 and f32) "
                  f"in {secs:.3f} s: {shapes}")
            if shapes != want or raw[name]["image_seq"].dtype != np.uint8 \
                    or not all(np.isfinite(f32[name][k]).all()
                               and np.abs(f32[name][k]).max() <= 1
                               for k in ("image_seq", "tgt_images")):
                raise AssertionError(f"{name}: bad batch {shapes}")
        same = {f"{kind} {k}": bool(np.array_equal(b["png"][k],
                                                   b["packed"][k]))
                for kind, b in (("uint8", raw), ("f32", f32))
                for k in b["png"]}
        print(f"[data] png vs packed decodes (the same scenes): bitwise "
              f"{same}")
        if not all(same.values()):
            raise AssertionError("png and packed decodes differ")

        packed = sources["packed"]
        flat = np.asarray(packed._packed(packed.scenes[0])).reshape(
            -1, 64, 64, 3)
        rows = np.arange(len(flat))[::-1]
        pairs = {"gather_pack": (native.gather_pack(flat, rows),
                                 native.gather_pack(flat, rows,
                                                    native=False)),
                 "resize_normalize_pack 64->128": (
                     native.resize_normalize_pack(flat, 128, 128),
                     native.resize_normalize_pack(flat, 128, 128,
                                                  native=False))}
        ulps = {k: int(np.abs(a.view(np.int32) - b.view(np.int32)).max())
                for k, (a, b) in pairs.items()}
        print(f"[data] native packer (built in {packer_s:.2f} s; "
              f"{native.load().dmv3d_num_threads()} OpenMP threads) vs its "
              f"numpy version: max ulps {ulps}")
        if max(ulps.values()) > 1:
            raise AssertionError("the native packer disagrees with numpy")

        res = resident.ResidentFrames(packed, cfgs["packed"], "cuda")
        idx = res.index_batch(range(16))
        got = res.gather(res.frames, res.poses, idx)
        host = packed.batch(range(16), raw=True)
        same = {k: bool(np.array_equal(got[k].cpu().numpy(), host[k]))
                for k in host}
        print(f"[data] resident gather on the card ({res.nbytes} B bank) "
              f"vs the host batch of the same 16 examples: bitwise {same}")
        draw = resident.ResidentFrames.device_draw
        checks = {"pinned table": all(
            draw(DRAW_META, 7, 11, 3, "cuda")[k].tolist() == v
            for k, v in DRAW_PINNED.items())}
        for step in (0, 1, 15, 10 ** 6):
            a = draw(C3MD_DRAW_META, 0, step, 8, "cuda")
            b = draw(C3MD_DRAW_META, 0, step, 8, "cpu")
            checks[f"c3md step {step}"] = all(torch.equal(a[k].cpu(), b[k])
                                              for k in b)
        meta = res.sample_meta()
        drawn = res.device_sample(meta, 3, 5, 16)
        ref = res.gather(res.frames.cpu(), res.poses.cpu(),
                         draw(meta, 3, 5, 16, "cpu"))
        checks["device_sample vs the CPU draw's gather"] = all(
            torch.equal(drawn[k].cpu(), ref[k]) for k in ref)
        print(f"[data] device draws on the card vs the CPU: equal {checks}")
        if not (all(same.values()) and all(checks.values())):
            raise AssertionError("the resident bank or the device draw "
                                 "differs on the card")


# [loop-c3md]: the c3md preset's own data and schedule settings, with the
# loop's schedule knobs as [loop-c2] sets them: 2 dispatches of 16 steps
LOOP_C3MD_SETS = ("train.num_steps=32", "train.ckpt_every=16",
                  "train.log_every=16")
# the one cut: 64 of the preset's 512 scenes rendered into the bank (the
# host renders every frame of the bank once, ~2-3 ms a frame)
LOOP_C3MD_CUT = ("data.num_scenes=64",)


@contextlib.contextmanager
def _recording_resident(loop_lib):
    """What the loop's ``_maybe_resident`` returns and the source it was
    given, the seconds of the source's ``materialize_packed`` and of the
    whole call (materialize and upload)."""
    rec = {}
    resolve = loop_lib._maybe_resident

    def recording(cfg, source, device):
        materialize = source.materialize_packed

        def timed(*args):
            t0 = time.perf_counter()
            materialize(*args)
            rec["materialize_s"] = time.perf_counter() - t0
        source.materialize_packed = timed
        t0 = time.perf_counter()
        try:
            res = resolve(cfg, source, device)
        finally:
            del source.materialize_packed      # the class's method again
        rec.update(resident=res, source=source,
                   seconds=time.perf_counter() - t0)
        return res

    loop_lib._maybe_resident = recording
    try:
        yield rec
    finally:
        loop_lib._maybe_resident = resolve


@contextlib.contextmanager
def _profiled_dispatch(loop_lib, which: int):
    """Profile the ``which``-th call of the loop's train step (a dispatch)
    on the device: its host-to-device copies, counted with their bytes
    from torch.profiler's Chrome trace, and its kernels."""
    out = {}
    make_step = loop_lib.step_lib.make_train_step

    def make(*a, **k):
        step = make_step(*a, **k)
        calls = []

        def run(*args, **kw):
            calls.append(1)
            if len(calls) != which:
                return step(*args, **kw)
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                result = step(*args, **kw)
                torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            copies = [e for e in events if e.get("cat") == "gpu_memcpy"
                      and "HtoD" in e.get("name", "")]
            out["bytes"] = [e.get("args", {}).get("bytes") for e in copies]
            out["kernels"] = sum(e.get("cat") == "kernel" for e in events)
            return result
        return run

    loop_lib.step_lib.make_train_step = make
    try:
        yield out
    finally:
        loop_lib.step_lib.make_train_step = make_step


def _loop_logs(tag, run, logdir, log_steps, manager_steps, final):
    """The loop's logged losses, manager steps and model dir step."""
    from dynamic_multiview_3d_torch.train import checkpoint as ckpt_lib
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    with open(os.path.join(run, "model", "config.json")) as f:
        model_step = json.load(f)["step"]
    steps = ckpt_lib.manager_steps(run)
    print(f"[{tag}] logged losses {[(r['step'], r['loss/total']) for r in logged]}"
          f"; manager steps {steps}; model dir at step {model_step}")
    if not (model_step == final and [r["step"] for r in logged] == log_steps
            and all(np.isfinite(r["loss/total"]) for r in logged)
            and steps == manager_steps):
        raise AssertionError(f"{tag}: the training loop went wrong")


def phase_loop_c3md(config, counted, train_p50) -> tuple:
    """[loop-c3md] the c3md preset through cli.train with its own data
    settings (frames source with an empty root: SyntheticFrames,
    materialized, resident by auto, device-sampled, 16 steps a dispatch,
    cosine lr), cut only to 64 scenes; then exact resume at the dispatch
    boundary, with one dispatch profiled for host-to-device copies. ->
    (each path's launch counts, the materialized source and the state of
    the uninterrupted 32 steps, which [jax-resume] resumes against)."""
    from dynamic_multiview_3d_torch.cli import train as train_cli
    from dynamic_multiview_3d_torch.data import resident as resident_lib
    from dynamic_multiview_3d_torch.train import loop as loop_lib
    from dynamic_multiview_3d_torch.train import metrics as metrics_lib

    paths = {}
    full = config.get_config("c3md")
    with tempfile.TemporaryDirectory(prefix="dmv3d_loop_c3md_") as tmp:
        run = os.path.join(tmp, "run")
        sets = LOOP_C3MD_SETS + LOOP_C3MD_CUT + (f"train.ckpt_dir={run}",)
        cfg = config.get_config("c3md", sets)
        d, t = cfg.data, cfg.train
        spd = t.steps_per_dispatch
        print(f"[loop-c3md] data: source={d.source} root={d.root!r} "
              f"materialize_packed={d.materialize_packed} device_resident="
              f"{d.device_resident} device_sampling={d.device_sampling}; "
              f"train: steps_per_dispatch={spd} lr_schedule="
              f"{t.lr_schedule} (warmup {t.warmup_steps}); cut: "
              f"{list(LOOP_C3MD_CUT)} of the preset's {full.data.num_scenes}")
        if not (d.source == "frames" and not d.root and d.materialize_packed
                and d.device_resident == "auto" and d.device_sampling
                and spd == 16 and t.lr_schedule == "cosine"
                and _preset_but_cut(full, cfg)):
            raise AssertionError("[loop-c3md] is not the c3md preset")
        probe = metrics_lib.MetricsWriter(os.path.join(tmp, "probe"))
        summaries = 2 if probe.has_images else 0   # at steps 16 and 32
        probe.close()
        _reset_counts(counted)
        with warnings.catch_warnings(record=True) as caught, \
                _recording_resident(loop_lib) as rec, \
                _loop_timers(loop_lib, counted) as (times, summary_counts):
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            state, _ = train_cli.main(
                ["--preset", "c3md", *(a for s in sets for a in ("--set", s)),
                 "--logdir", os.path.join(tmp, "logs"), "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        off = [str(w.message) for w in caught
               if "resolved to OFF" in str(w.message)]
        res = rec.get("resident")
        print(f"[loop-c3md] residency: {'on' if res is not None else 'OFF'}"
              f"{'; ' + off[0] if off else ''}")
        if off or res is None:
            raise AssertionError("[loop-c3md]: residency did not engage")
        paths["loop_c3md"] = counts = _read_counts(counted)
        _expect_counts("loop-c3md", counts, {"multiflow_composite_fwd": 32,
                                             "multiflow_composite_bwd": 32})
        paths["loop_c3md_summaries"] = summary_counts
        _expect_counts("loop-c3md image summaries", summary_counts,
                       {"multiflow_composite_fwd": summaries})
        n_frames = res.num_scenes * res.num_views * res.t_avail
        full_bytes = resident_lib.bank_nbytes(
            full.data.num_scenes, res.num_views, res.t_avail, d.image_size)
        budget = d.resident_budget_mb * 2 ** 20
        print(f"[loop-c3md] bank: {res.num_scenes} scenes x {res.num_views} "
              f"views x {res.t_avail} frames = {n_frames} frames, "
              f"{res.nbytes} B on the card; materialized in "
              f"{rec['materialize_s']!r} s ({1e3 * rec['materialize_s'] / n_frames!r}"
              f" ms a frame), uploaded in "
              f"{rec['seconds'] - rec['materialize_s']!r} s; the full "
              f"{full.data.num_scenes}-scene bank would be {full_bytes} B: "
              f"fits data.resident_budget_mb={d.resident_budget_mb} "
              f"({budget} B): {full_bytes <= budget}")
        dispatch_ms = [1e3 * x for x in times["step"]]
        per_step = [x / spd for x in dispatch_ms]
        print(f"[loop-c3md] {state.step} steps through cli.train in "
              f"{wall!r} s (materialize and upload included); dispatches "
              f"of {spd} steps {dispatch_ms!r} ms; loop step per optimizer "
              f"step p50 {float(np.percentile(per_step, 50))!r} ms "
              f"(dispatch 2 alone {per_step[-1]!r} ms); host batch: "
              f"{len(times['batch'])} calls (device sampling: no batch "
              f"function); [train-c3md]'s step p50 on a fixed host batch "
              f"in this run {train_p50!r} ms")
        _loop_logs("loop-c3md", run, os.path.join(tmp, "logs"), [16, 32],
                   [16, 32], 32)
        if len(times["step"]) != 2 or times["batch"]:
            raise AssertionError("[loop-c3md]: not 2 dispatches without a "
                                 "host batch")

        # exact resume at the dispatch boundary, on the materialized source
        src = rec["source"]
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        _reset_counts(counted)
        try:
            runs = {name: config.get_config("c3md", LOOP_C3MD_SETS
                                            + LOOP_C3MD_CUT + (
                f"train.ckpt_dir={os.path.join(tmp, name)}",))
                for name in ("a", "b")}
            with _profiled_dispatch(loop_lib, 2) as h2d:
                state_a, _ = loop_lib.train(runs["a"], data_source=src,
                                            device="cuda")
            try:
                loop_lib.train(config.override(runs["b"],
                                               ["train.fail_after_step=15"]),
                               data_source=src, device="cuda")
                raise AssertionError("no FaultInjected")
            except loop_lib.FaultInjected as e:
                print(f"[loop-c3md] resume: {e}; manager steps "
                      f"{loop_lib.ckpt_lib.manager_steps(os.path.join(tmp, 'b'))}")
            state_b, _ = loop_lib.train(runs["b"], data_source=src,
                                        device="cuda")
        finally:
            torch.backends.cudnn.deterministic = prev
        paths["resume_c3md"] = counts = _read_counts(counted)
        _expect_counts("loop-c3md resume", counts, {
            "multiflow_composite_fwd": 64, "multiflow_composite_bwd": 64})
        diff = _same_state(state_a, state_b)
        print(f"[loop-c3md] resumed at step 16 vs uninterrupted after 32 "
              f"c3md steps (cudnn.deterministic): {len(diff)} of "
              f"{3 * len(list(state_a.module.parameters()))} tensors "
              f"differ {diff}")
        if diff or state_b.step != 32:
            raise AssertionError("resume is not exact at c3md")
        b, k, s = d.batch_size, d.num_targets, d.image_size
        host_px = spd * b * (d.seq_len + k) * s * s * 3
        index_b = spd * b * 2 * (d.seq_len + k) * 4
        print(f"[loop-c3md] a profiled dispatch of {spd} device-sampled "
              f"steps: {h2d['kernels']} kernels, {len(h2d['bytes'])} "
              f"host-to-device copies of {h2d['bytes']} B (the host pixel "
              f"path would copy {host_px} B a dispatch, the index path "
              f"{index_b} B)")
        if any(n is None for n in h2d["bytes"]) \
                or sum(h2d["bytes"]) >= s * s * 3:
            raise AssertionError("a device-sampled dispatch copied pixels "
                                 "(or the trace lacks the copies' bytes)")
    return paths, {"source": src, "state": state_a}


def _preset_but_cut(full, cut) -> bool:
    """``cut`` is the preset ``full`` but for data.num_scenes and the
    loop's schedule knobs (num_steps, ckpt_every, log_every, ckpt_dir)."""
    import dataclasses
    knobs = ("num_steps", "ckpt_every", "log_every", "ckpt_dir")
    return (full.model == cut.model
            and dataclasses.replace(cut.data, num_scenes=full.data.num_scenes)
            == full.data
            and dataclasses.replace(cut.train, **{
                n: getattr(full.train, n) for n in knobs}) == full.train)


# [loop-c2-stream]: the c2 preset, nothing cut, streamed by 4 worker
# processes, with a checkpoint and a log line every 16 steps. 48 steps: the
# workers fill their prefetch buffer (4 x data.prefetch = 8 batches) while
# the loop starts, and the loop drains it in the first ~16 steps; the last
# 16 show the rate the workers sustain
LOOP_STREAM_SETS = ("data.streaming=true", "data.grain_workers=4")
STREAM_STEPS = 48


@contextlib.contextmanager
def _stream_waits(pipeline):
    """Host seconds of each ``next`` the loop takes from a stream
    iterator."""
    waits = []
    take = pipeline.StreamIterator.__next__

    def timed(self):
        t0 = time.perf_counter()
        out = take(self)
        waits.append(time.perf_counter() - t0)
        return out

    pipeline.StreamIterator.__next__ = timed
    try:
        yield waits
    finally:
        pipeline.StreamIterator.__next__ = take


def phase_loop_c2_stream(config, counted, train_p50, loop_p50) -> dict:
    """[loop-c2-stream] the c2 preset through cli.train with the batches
    rendered ahead by the stream iterator's 4 worker processes: launches,
    the loop step p50 after the first batch and its share spent waiting
    on the iterator; then exact resume of a streamed run (the stream's
    state restored). -> each path's launch counts."""
    from dynamic_multiview_3d_torch.cli import train as train_cli
    from dynamic_multiview_3d_torch.data import pipeline
    from dynamic_multiview_3d_torch.train import loop as loop_lib
    from dynamic_multiview_3d_torch.train import metrics as metrics_lib

    paths = {}
    with tempfile.TemporaryDirectory(prefix="dmv3d_loop_stream_") as tmp:
        run = os.path.join(tmp, "run")
        sets = LOOP_STREAM_SETS + (f"train.num_steps={STREAM_STEPS}",
                                   "train.ckpt_every=16",
                                   "train.log_every=16",
                                   f"train.ckpt_dir={run}")
        cfg = config.get_config("c2", sets)
        probe = metrics_lib.MetricsWriter(os.path.join(tmp, "probe"))
        summaries = 3 if probe.has_images else 0   # at steps 16, 32, 48
        probe.close()
        _reset_counts(counted)
        with _stream_waits(pipeline) as waits, \
                _loop_timers(loop_lib, counted) as (times, summary_counts):
            t0 = time.perf_counter()
            state, _ = train_cli.main(
                ["--preset", "c2", *(a for s in sets for a in ("--set", s)),
                 "--logdir", os.path.join(tmp, "logs"), "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        paths["loop_c2_stream"] = counts = _read_counts(counted)
        n = STREAM_STEPS
        _expect_counts("loop-c2-stream", counts, {
            "warp_composite_fwd": n, "warp_composite_bwd": n,
            "warp_composite_bwd:composite": n, "stage:copies": n})
        paths["loop_c2_stream_summaries"] = summary_counts
        _expect_counts("loop-c2-stream image summaries", summary_counts, {
            "warp_composite_fwd": summaries, "stage:copies": summaries})
        if len(waits) != n or len(times["step"]) != n:
            raise AssertionError(f"[loop-c2-stream]: {len(waits)} batches, "
                                 f"{len(times['step'])} steps")
        waits, steps = np.asarray(waits), np.asarray(times["step"])
        loop = waits + steps
        print(f"[loop-c2-stream] iterator waits by step, ms: "
              f"{[round(1e3 * float(w), 2) for w in waits]}")
        print(f"[loop-c2-stream] {state.step} steps through cli.train with "
              f"{cfg.data.grain_workers} workers in {wall!r} s; first batch "
              f"(workers starting) {1e3 * float(waits[0])!r} ms; "
              f"[loop-c2]'s loop step p50 (host batch in the loop) "
              f"{loop_p50!r} ms and "
              f"[train]'s fixed-batch p50 {train_p50!r} ms in this run")
        for what, part in (("after the first batch", slice(1, None)),
                           ("the last 16 steps", slice(-16, None))):
            print(f"[loop-c2-stream] {what}: loop step (iterator wait + "
                  f"train step) p50 "
                  f"{float(np.percentile(loop[part], 50)) * 1e3!r} ms, wait "
                  f"p50 {float(np.percentile(waits[part], 50)) * 1e3!r} ms, "
                  f"train step p50 "
                  f"{float(np.percentile(steps[part], 50)) * 1e3!r} ms; "
                  f"waiting "
                  f"{100 * float(waits[part].sum() / loop[part].sum())!r}% "
                  f"of the loop")
        _loop_logs("loop-c2-stream", run, os.path.join(tmp, "logs"),
                   [1, 16, 32, 48], [16, 32, 48], n)

        # exact resume of a streamed run: 4 steps straight, against 4
        # steps killed after step 1 and resumed from the stream's state
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        _reset_counts(counted)
        try:
            runs = {name: config.get_config("c2", LOOP_STREAM_SETS + (
                "train.num_steps=4",
                f"train.ckpt_dir={os.path.join(tmp, name)}"))
                for name in ("a", "b")}
            state_a, _ = loop_lib.train(runs["a"], device="cuda")
            try:
                loop_lib.train(config.override(runs["b"],
                                               ["train.fail_after_step=1"]),
                               device="cuda")
                raise AssertionError("no FaultInjected")
            except loop_lib.FaultInjected as e:
                with open(os.path.join(tmp, "b", "stream_state_2_p0.json")) \
                        as f:
                    print(f"[loop-c2-stream] resume: {e}; stream state "
                          f"{json.load(f)}")
            state_b, _ = loop_lib.train(runs["b"], device="cuda")
        finally:
            torch.backends.cudnn.deterministic = prev
        paths["resume_c2_stream"] = counts = _read_counts(counted)
        _expect_counts("loop-c2-stream resume", counts, {
            "warp_composite_fwd": 8, "warp_composite_bwd": 8,
            "warp_composite_bwd:composite": 8, "stage:copies": 8})
        diff = _same_state(state_a, state_b)
        print(f"[loop-c2-stream] resumed vs uninterrupted after 4 streamed "
              f"c2 steps (cudnn.deterministic): {len(diff)} of "
              f"{3 * len(list(state_a.module.parameters()))} tensors differ "
              f"{diff}")
        if diff or state_b.step != 4:
            raise AssertionError("streamed resume is not exact at c2")
    return paths


def frame_copies(run, b, h, w) -> int:
    """Ops of one call of ``run`` (torch.profiler, CPU side, with input
    shapes) that repeat a [b, 3, h, w] tensor: the model's last frame
    copied once per target."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages(group_by_input_shape=True)
               if e.key in ("aten::repeat_interleave", "aten::repeat",
                            "aten::index_select")
               and e.input_shapes and list(e.input_shapes[0]) == [b, 3, h, w])


# name fragments of the port's own kernels under torch.profiler
PORT_KERNELS = ("warp_composite", "multiflow", "sample_fwd", "reproject")


def phase_profile(run, what):
    """Device time of one call by kernel (torch.profiler), and the device's
    busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    timed = [e for e in prof.key_averages() if e.self_device_time_total > 0
             and not getattr(e, "is_user_annotation", False)]
    # kernels are events of their own; an operator's self device time
    # repeats theirs, and so does a user annotation's range on the device
    # timeline (Optimizer.step): count operators only where no kernel
    # event shows, and annotations never
    kernels = [e for e in timed
               if e.device_type == torch.autograd.DeviceType.CUDA] or timed
    busy_us = sum(e.self_device_time_total for e in kernels)
    h2d = [e for e in kernels if "Memcpy HtoD" in e.key]
    print(f"[profile] {what}: wall {wall_us:.1f} us (profiled), device "
          f"busy {busy_us:.1f} us ({100 * busy_us / wall_us:.1f}%), "
          f"{len(kernels)} kernel names; "
          f"{sum(e.count for e in h2d)} host-to-device copies (Memcpy HtoD, "
          f"{sum(e.self_device_time_total for e in h2d):.1f} us)")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    # the top 15, then the port's own kernels wherever they rank
    for e in ranked[:15] + [e for e in ranked[15:]
                            if any(k in e.key for k in PORT_KERNELS)]:
        print(f"[profile] {e.self_device_time_total:10.1f} us "
              f"{100 * e.self_device_time_total / max(busy_us, 1e-9):5.1f}% "
              f"x{e.count:<4d} {e.key[:110]}")


# ---------------------------------------------------------------- data parallel
# Ranks are processes on the one card, joined over gloo (NCCL refuses two
# ranks on one device), spawned by parallel.dryrun.spawn with a join
# timeout, or launched by torch.distributed.run ([dp-c4]).
DP_TIMEOUT_S = 600.0


def _port():
    """The port's modules a rank needs (imported in the rank)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dynamic_multiview_3d_torch import config
    from dynamic_multiview_3d_torch.kernels import grid_sample as gs
    from dynamic_multiview_3d_torch.kernels import multiflow as mf
    from dynamic_multiview_3d_torch.kernels import reproject as rp
    from dynamic_multiview_3d_torch.parallel import mesh as mesh_lib
    return config, mesh_lib, _counted(gs, mf, rp)


def _numpy(named) -> dict:
    return {n: t.detach().float().cpu().numpy() for n, t in named}


def _dp_reference_rank(mesh, cfg_dict, state_dict, batches):
    """[dp-reference] (and [tp-reference]) on one rank: TF32 off, the
    data rank's rows of each global batch, on a mesh with a 'model' axis
    the weights of ``model_axis_rules(min_size=16)`` split; -> the first
    step's metrics and averaged gradients (gathered whole), the rank's
    params after the last and the names of its blocks."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config, mesh_lib, _ = _port()
    from dynamic_multiview_3d_torch.parallel import tensor as tensor_lib
    from dynamic_multiview_3d_torch.train import step as tstep
    cfg = config.from_dict(cfg_dict)
    state = tstep.init_state(cfg, device=mesh.device)
    state.module.load_state_dict({k: torch.as_tensor(v)
                                  for k, v in state_dict.items()})
    mesh_lib.replicate(mesh, state)
    state = tensor_lib.shard_state(state, mesh, mesh_lib.model_axis_rules(
        state.module, mesh, min_size=16))
    step = tstep.make_train_step(cfg, mesh=mesh)
    first = None
    for batch in batches:
        state, metrics = step(state, mesh_lib.shard_batch(mesh, batch))
        if first is None:
            first = (metrics, _numpy(tensor_lib.full_tensors(
                state.module, mesh, {n: p.grad for n, p in
                                     state.module.named_parameters()})
                .items()))
    return {"metrics": first[0], "grads": first[1],
            "params": _numpy(state.module.named_parameters()),
            "blocks": sorted(tensor_lib.block_names(state.module))}


def _dp_reference_inputs(config, synthetic, tstep) -> tuple:
    """[dp-reference]'s config (the tiny f32 one, K = 4 targets of which 2
    are drawn, B = 4), 3 global batches and the seeded weights."""
    cfg = config.override(_tiny_config(config), [
        "data.batch_size=4", "data.num_targets=4", "data.targets_per_step=2",
        "mesh.data=2"])
    rng = np.random.default_rng(0)
    batches = [{"image_seq": synthetic.smooth_images(rng, 4, 1, 32),
                "src_poses": synthetic.random_poses(rng, 4, 1),
                "tgt_poses": synthetic.random_poses(rng, 4, 4),
                "tgt_images": synthetic.smooth_images(rng, 4, 4, 32)}
               for _ in range(3)]
    sd = {k: v.numpy() for k, v in tstep.init_state(
        cfg, seed=123, device="cpu").module.state_dict().items()}
    return cfg, batches, sd


def check_dp_reference(out, cfg, batches, sd, tstep, tag="dp-reference",
                       model=1) -> None:
    """[dp-reference] (or [tp-reference], ``model`` 2) the ranks' step
    (``_dp_reference_rank``) against one process on the global B = 4 on
    the card, TF32 off: loss 1e-6 relative, every gradient (gathered)
    1e-5 in relative L2 (the zero-gradient biases 1e-6 of the global
    norm); after 3 steps every replicated param bitwise equal on every
    rank, each block bitwise equal between its data ranks (global ranks r
    and r + model)."""
    one = tstep.init_state(cfg, device="cuda")
    one.module.load_state_dict({k: torch.as_tensor(v)
                                for k, v in sd.items()})
    _, ref_m = tstep.make_train_step(cfg, device="cuda")(one, batches[0])
    ref = {n: p.grad.detach().double().cpu()
           for n, p in one.module.named_parameters()}
    norm = float(torch.sqrt(sum((g * g).sum() for g in ref.values())))
    worst, bad = {}, {}
    for r, got in enumerate(out):
        loss_err = abs(got["metrics"]["loss/total"] - ref_m["loss/total"]) \
            / abs(ref_m["loss/total"])
        rel = {}
        for name, g in ref.items():
            err = float((torch.from_numpy(got["grads"][name]).double()
                         - g).norm())
            lim = 1e-6 * norm if name in ZERO_GRAD else 1e-5 * float(g.norm())
            rel[name] = err / (norm if name in ZERO_GRAD else float(g.norm()))
            if not err <= lim:
                bad[(r, name)] = err
        w = max(rel, key=rel.get)
        worst[r] = (loss_err, w, rel[w])
        if not loss_err <= 1e-6:
            bad[(r, "loss")] = loss_err
    blocks = set(out[0]["blocks"])
    differ = [(r, n) for r, got in enumerate(out)
              for n, p in got["params"].items()
              if not np.array_equal(p, out[(r + model) % len(out)
                                           if n in blocks else 0]
                                    ["params"][n])]
    print(f"[{tag}] tiny f32 config, B = 4 (K = 4, 2 drawn), {len(out)} "
          f"ranks (data {len(out) // model} x model {model}; "
          f"{len(blocks)} weights split) vs one process on 4: per rank "
          f"(loss relative error, worst gradient, its relative L2) {worst}; "
          f"(rank, param) pairs differing from their replica after 3 "
          f"steps: {len(differ)} of {len(out) * len(out[0]['params'])}")
    if bad or differ or (model > 1) != bool(blocks):
        raise AssertionError(f"[{tag}]: {bad}, replicas differ in "
                             f"{differ}, blocks {sorted(blocks)}")


DP_C4_SETS = ("mesh.data=2", "train.num_steps=8", "train.ckpt_every=4",
              "train.log_every=4")


def _dp_c4_argv(cfg_sets, ckpt_dir, logdir):
    sets = DP_C4_SETS + tuple(cfg_sets) + (f"train.ckpt_dir={ckpt_dir}",)
    return ["--preset", "c4", *(a for s in sets for a in ("--set", s)),
            "--logdir", logdir, "--device", "cuda"]


def _dp_c4_rank(out: str) -> int:
    """A rank of [dp-c4] under torch.distributed.run: cli.train of the c4
    preset at mesh.data=2 (8 steps, counted and timed), a 4 + 4 resume
    pair against it (cudnn.deterministic throughout), then the gradient
    all-reduce timed alone; writes rank<r>.json into ``out``."""
    config, mesh_lib, counted = _port()
    from dynamic_multiview_3d_torch.cli import train as train_cli
    from dynamic_multiview_3d_torch.train import loop as loop_lib
    mesh = mesh_lib.make_mesh(config.MeshConfig(data=2), device="cuda")
    torch.backends.cudnn.deterministic = True
    res = {"rank": mesh.rank, "backend": mesh.backend,
           "device": str(mesh.device)}
    _reset_counts(counted)
    with _loop_timers(loop_lib, counted) as (times, summary_counts):
        t0 = time.perf_counter()
        state_a, _ = train_cli.main(_dp_c4_argv(
            (), os.path.join(out, "a"), os.path.join(out, "logs_a")))
        torch.cuda.synchronize()
        res["wall_s"] = time.perf_counter() - t0
    res["counts"], res["summary_counts"] = _read_counts(counted), \
        dict(summary_counts)
    res["step_ms"] = [1e3 * x for x in times["step"]]
    res["batch_ms"] = [1e3 * x for x in times["batch"]]
    res["params"] = sum(p.numel() for p in state_a.module.parameters())
    res["digest"] = _state_digest(state_a)
    _reset_counts(counted)
    with _loop_timers(loop_lib, counted):    # summaries apart
        try:
            train_cli.main(_dp_c4_argv(("train.fail_after_step=3",),
                                       os.path.join(out, "b"),
                                       os.path.join(out, "logs_b")))
            raise AssertionError("no FaultInjected")
        except loop_lib.FaultInjected:
            pass
        state_b, _ = train_cli.main(_dp_c4_argv(
            (), os.path.join(out, "b"), os.path.join(out, "logs_b")))
    res["resume_counts"] = _read_counts(counted)
    res["resume_diff"] = _same_state(state_a, state_b)
    res["step_b"] = state_b.step
    del state_b
    buf = torch.randn(res["params"], device=mesh.device)
    ms = []
    for i in range(13):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh_lib.all_reduce_mean_(mesh, [buf])
        torch.cuda.synchronize()
        if i >= 3:
            ms.append(1e3 * (time.perf_counter() - t0))
    res["allreduce_ms"] = ms
    with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(res, f)
    mesh_lib.shutdown()
    return 0


def _nccl_rank(mesh, n: int):
    """One rank over NCCL: the backend joins on the card and reduces,
    broadcasts and gathers CUDA tensors."""
    _, mesh_lib, _ = _port()
    buf = torch.arange(n, device=mesh.device, dtype=torch.float32)
    want = buf.clone()
    mesh_lib.all_reduce_mean_(mesh, [buf])
    mesh_lib.broadcast_(mesh, [buf])
    rows = mesh_lib.all_gather_rows(mesh, buf[:8].reshape(2, 4))
    mesh_lib.barrier(mesh)
    return {"backend": mesh.backend, "device": str(mesh.device),
            "equal": bool(torch.equal(buf, want)
                          and torch.equal(rows.reshape(-1), want[:8]))}


def _state_payload_equal(a: dict, b: dict) -> list:
    """The keys (paths) where two manager-step payloads differ."""
    if isinstance(a, dict):
        return [f"{k}/{p}" for k in a for p in
                _state_payload_equal(a[k], b[k])] + \
            [str(k) for k in set(b) - set(a)]
    if isinstance(a, (list, tuple)):
        return [f"{i}/{p}" for i, (x, y) in enumerate(zip(a, b))
                for p in _state_payload_equal(x, y)]
    if torch.is_tensor(a):
        same = torch.is_tensor(b) and a.dtype == b.dtype \
            and a.shape == b.shape and torch.equal(a, b)
        return [] if same else [""]
    return [] if a == b else [""]


def phase_dp_c4(config, tstep) -> dict:
    """[dp-c4] the c4 preset at full width through cli.train under
    torch.distributed.run, mesh.data=2 on the one card (its 8 devices
    become 2 ranks; the global batch of 64 is kept, 32 a rank), gloo:
    8 steps checkpointed every 4, #1 and #3 8 launches a rank, a 4 + 4
    resume pair bitwise equal to 8 straight steps, only rank 0's files;
    the step p50 and the gradient all-reduce's time. Then a manager step
    saved on the card restored into a CPU template and back, every tensor
    bitwise (the resume across devices), and one rank over NCCL. -> rank
    0's launch counts."""
    from dynamic_multiview_3d_torch.parallel import dryrun
    from dynamic_multiview_3d_torch.train import checkpoint as ckpt_lib
    full = config.get_config("c4")
    cfg = config.get_config("c4", DP_C4_SETS)
    b, k = cfg.data.batch_size, cfg.data.num_targets
    print(f"[dp-c4] c4 preset: {cfg.model.image_size}^2, B = {b} global "
          f"({b // 2} a rank), T = {cfg.data.seq_len}, K = {k}, "
          f"{cfg.model.dtype}; mesh.data {full.mesh.data} -> 2 (one card)")
    with tempfile.TemporaryDirectory(prefix="dmv3d_dp_c4_") as out:
        argv = [sys.executable, "-m", "torch.distributed.run", "--nnodes",
                "1", "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
                "--master-port", str(dryrun.free_port()),
                os.path.abspath(__file__), "--dp-c4-rank", out]
        t0 = time.perf_counter()
        run = subprocess.run(argv, capture_output=True, text=True,
                             timeout=DP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        print(run.stdout[-3000:], end="")
        if run.returncode:
            print(run.stderr[-6000:], file=sys.stderr)
            raise AssertionError(f"[dp-c4]: the launcher exited "
                                 f"{run.returncode}")
        ranks = []
        for r in range(2):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        want = {"warp_composite_fwd": 8, "warp_composite_bwd": 8,
                "warp_composite_bwd:composite": 8, "stage:copies": 8}
        for r, res in enumerate(ranks):
            _expect_counts(f"dp-c4 rank {r}", res["counts"], want)
            _expect_counts(f"dp-c4 rank {r} resume pair",
                           res["resume_counts"], want)
            summaries = 2 if r == 0 and any(res["summary_counts"].values()) \
                else 0
            _expect_counts(f"dp-c4 rank {r} image summaries",
                           res["summary_counts"], {
                               "warp_composite_fwd": summaries,
                               "stage:copies": summaries})
            steps, ar = np.asarray(res["step_ms"]), res["allreduce_ms"]
            print(f"[dp-c4] rank {r} ({res['backend']}, {res['device']}): "
                  f"8 steps in {res['wall_s']!r} s; train step p50 "
                  f"{float(np.percentile(steps, 50))!r} ms (steps "
                  f"{res['step_ms']!r}), host batch p50 "
                  f"{float(np.percentile(res['batch_ms'], 50))!r} ms; "
                  f"gradient all-reduce of {res['params']} f32 "
                  f"({4 * res['params']} B) alone: p50 "
                  f"{float(np.percentile(ar, 50))!r} ms (min {min(ar)!r}); "
                  f"resumed 4 + 4 vs 8 straight (cudnn.deterministic): "
                  f"{len(res['resume_diff'])} tensors differ")
            if res["resume_diff"] or res["step_b"] != 8:
                raise AssertionError(f"[dp-c4] rank {r}: resume not exact "
                                     f"{res['resume_diff']}")
        _check_replicas("dp-c4", [res["digest"] for res in ranks])
        files = {d: sorted(os.listdir(os.path.join(out, d)))
                 for d in ("a", "b", "logs_a")}
        with open(os.path.join(out, "logs_a", "metrics.jsonl")) as f:
            logged = [json.loads(line)["step"] for line in f]
        events = [n for n in files["logs_a"] if n.startswith("events")]
        print(f"[dp-c4] launcher wall {wall:.2f} s; files: {files}; metrics "
              f"logged at {logged}")
        if files["a"] != ["1", "4", "8", "model", "train_config.json"] \
                or logged != [1, 4, 8] or len(events) > 1:
            raise AssertionError("[dp-c4]: a rank other than 0 wrote, or "
                                 "rank 0 did not")

        # the resume across devices: card -> CPU -> card, every tensor
        t0 = time.perf_counter()
        saved = ckpt_lib.read_step(os.path.join(out, "a"), 8)
        cpu = tstep.init_state(cfg, device="cpu")
        ckpt_lib.make_manager(os.path.join(out, "a")).restore(8, cpu)
        cpu_dir = os.path.join(out, "from_cpu")
        ckpt_lib.make_manager(cpu_dir).save(8, cpu, force=True)
        card = tstep.init_state(full, device="cuda")
        ckpt_lib.make_manager(cpu_dir).restore(8, card)
        again = os.path.join(out, "from_card")
        ckpt_lib.make_manager(again).save(8, card, force=True)
        differ = (_state_payload_equal(saved, ckpt_lib.read_step(cpu_dir, 8))
                  + _state_payload_equal(saved,
                                         ckpt_lib.read_step(again, 8)))
        n = len(saved["module"]) + sum(
            len(s) for s in saved["optimizer"]["state"].values())
        print(f"[dp-c4] resume across devices: manager step 8 saved on the "
              f"card, restored into a CPU template, saved there, restored "
              f"onto the card and saved again: {len(differ)} of {n} tensors "
              f"differ from the card's save; {time.perf_counter() - t0:.2f}"
              f" s; CPU state on {next(cpu.module.parameters()).device}")
        if differ or cpu.step != 8 or card.step != 8:
            raise AssertionError(f"[dp-c4]: card -> CPU -> card is not "
                                 f"bitwise: {differ[:10]}")
        del cpu, card

    nccl = dryrun.spawn(_nccl_rank, 1, (1 << 20,), device="cuda",
                        timeout_s=DP_TIMEOUT_S)[0]
    print(f"[dp-c4] one rank over NCCL: {nccl}")
    if nccl["backend"] != "nccl" or not nccl["equal"]:
        raise AssertionError(f"[dp-c4]: NCCL on the card: {nccl}")
    return ranks[0]["counts"]


def _dp_c3md_rank(mesh, ckpt_dir):
    """[dp-c3md] on one rank: the loop's scene-sharded bank (recorded) and
    one profiled dispatch of 16 device-sampled steps; -> counts, the bank,
    the dispatch's host-to-device copies and the draws' rows."""
    config, mesh_lib, counted = _port()
    from dynamic_multiview_3d_torch.train import loop as loop_lib
    cfg = config.get_config("c3md", DP_C3MD_SETS + (
        f"train.ckpt_dir={ckpt_dir}",))
    _reset_counts(counted)
    with _recording_resident(loop_lib) as rec, \
            _profiled_dispatch(loop_lib, 1) as h2d:
        t0 = time.perf_counter()
        state, metrics = loop_lib.train(cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _read_counts(counted)
    res, src = rec["resident"], rec["source"]
    meta = res.sample_meta()
    lo, hi = mesh_lib.local_rows(mesh, cfg.data.batch_size)
    rows = [res.device_draw(meta, cfg.data.seed, s, hi - lo, mesh.device,
                            index_offset=lo) for s in range(16)]
    n_rows, n_poses = res.frames.shape[0], res.poses.shape[0]
    inside = all(int(r[k].min()) >= 0 and int(r[k].max()) < lim
                 for r in rows for k, lim in (
                     ("seq_idx", n_rows), ("tgt_idx", n_rows),
                     ("src_pose_idx", n_poses), ("tgt_pose_idx", n_poses)))
    scenes = sorted({res.scene_offset + int(s) for r in rows
                     for s in (r["src_pose_idx"] // res.num_views).flatten()})
    return {"counts": counts, "nbytes": res.nbytes,
            "num_scenes": res.num_scenes, "scene_offset": res.scene_offset,
            "materialized": sorted(src._pack_cache),
            "own": list(src.scenes[res.scene_offset:
                                   res.scene_offset + res.num_scenes]),
            "h2d": h2d["bytes"], "kernels": h2d["kernels"],
            "inside": inside, "scenes_drawn": scenes,
            "materialize_s": rec["materialize_s"], "wall_s": wall,
            "params": sum(p.numel() for p in state.module.parameters()),
            "digest": _state_digest(state),
            "loss": metrics.get("loss/total"), "step": state.step}


DP_C3MD_SETS = ("data.resident_sharding=scenes", "data.num_scenes=64",
                "mesh.data=2", "train.num_steps=16", "train.ckpt_every=16",
                "train.log_every=16")


def check_dp_c3md(out, config) -> dict:
    """[dp-c3md] the c3md preset's data settings (SyntheticFrames,
    materialized, resident, device sampling, 16 steps a dispatch) with
    data.resident_sharding=scenes over the 2 ranks, 64 scenes
    (``_dp_c3md_rank``): each rank materializes and holds its 32, half of
    [loop-c3md]'s bank, draws only from them, and one dispatch of 16 steps
    launches #4 and #5 16 times a rank and copies no pixel to the card
    (the host copies are the gradient and metrics all-reduces' staging
    through gloo); the ranks' states bitwise equal after it. -> rank 0's
    launch counts."""
    d = config.get_config("c3md", DP_C3MD_SETS).data
    frame = d.image_size * d.image_size * 3
    for r, res in enumerate(out):
        _expect_counts(f"dp-c3md rank {r}", res["counts"], {
            "multiflow_composite_fwd": 16, "multiflow_composite_bwd": 16})
        grads = 4 * res["params"]
        collective = [n for n in res["h2d"] if n in (grads, 4 * 3, 4 * 4,
                                                     4 * 5)]
        pixels = [n for n in res["h2d"] if n not in collective]
        lo = 32 * r
        print(f"[dp-c3md] rank {r}: scenes [{res['scene_offset']}, "
              f"{res['scene_offset'] + res['num_scenes']}) materialized "
              f"({res['materialize_s']!r} s) and held: {res['nbytes']} B "
              f"(the 64-scene bank {LOOP_C3MD_BANK_BYTES} B); drawn rows "
              f"inside its bank {res['inside']}, scenes drawn "
              f"{res['scenes_drawn'][:4]}...{res['scenes_drawn'][-2:]}; one "
              f"dispatch of 16 steps in {res['wall_s']!r} s of loop "
              f"(materialize and profiling included), {res['kernels']} "
              f"kernels, {len(res['h2d'])} host-to-device copies: "
              f"{len(collective)} of the all-reduces' staging "
              f"({sum(collective)} B), others {pixels}; loss "
              f"{res['loss']!r}")
        if (res["nbytes"] * 2 != LOOP_C3MD_BANK_BYTES
                or res["num_scenes"] != 32 or res["scene_offset"] != lo
                or not res["inside"] or res["materialized"] != res["own"]
                or not all(lo <= s < lo + 32 for s in res["scenes_drawn"])
                or any(n is None for n in res["h2d"])
                or sum(pixels) >= frame or res["step"] != 16):
            raise AssertionError(f"[dp-c3md] rank {r} failed: "
                                 f"{ {k: v for k, v in res.items() if k != 'h2d'} }")
    _check_replicas("dp-c3md", [res["digest"] for res in out])
    return out[0]["counts"]


# [loop-c3md]'s bank: 64 scenes x 8 views x 8 frames of 128 x 128 x 3
LOOP_C3MD_BANK_BYTES = 201_326_592


def _serve_mesh_rank(mesh, path, batches):
    """[serve-mesh] on one rank: the artifact served over the mesh."""
    _, _, counted = _port()
    from dynamic_multiview_3d_torch import serving
    served = serving.ServedModel.load(path, device=mesh.device)

    def request(b):
        return served.predict(b["image_seq"], b["tgt_poses"],
                              source_poses=b["src_poses"], mesh=mesh)
    request(batches[0])
    torch.cuda.synchronize()
    _reset_counts(counted)
    views = [request(b) for b in batches[1:]]
    torch.cuda.synchronize()
    counts = _read_counts(counted)
    return {"counts": counts,
            "views": [v.cpu().numpy() for v in views]}


def check_serve_mesh(out, path, serving, batches) -> dict:
    """[serve-mesh] the c2 artifact of [serve-artifact] served with
    ``predict(mesh=)`` over the 2 ranks (``_serve_mesh_rank``): each rank
    runs its 8 rows of a B = 16 request, the views gathered on every
    rank; 3 requests a rank launch #1 3 times with 3 staging copies. The
    gathered views must equal, bitwise, the one-process program on the
    same rows and the one-process request of all 16 rows: a row's views
    do not depend on the batch it rides in ([batch-gap]). -> rank 0's
    launch counts."""
    served = serving.ServedModel.load(path)
    call = served.call_for()
    whole, blocks = [], []
    with torch.inference_mode():
        for b in batches[1:]:
            whole.append(served.predict(b["image_seq"], b["tgt_poses"],
                                        source_poses=b["src_poses"]))
            args = [torch.as_tensor(np.asarray(b[k]), device="cuda")
                    for k in ("image_seq", "src_poses", "tgt_poses")]
            n = args[0].shape[0] // 2
            blocks.append(torch.cat([call(served.params,
                                          *(a[i:i + n] for a in args))
                                     for i in (0, n)]))
    for r, res in enumerate(out):
        _expect_counts(f"serve-mesh rank {r}", res["counts"], {
            "warp_composite_fwd": 3, "stage:copies": 3})
        same_blocks = all(np.array_equal(v, w.cpu().numpy())
                          for v, w in zip(res["views"], blocks))
        same = all(np.array_equal(v, w.cpu().numpy())
                   for v, w in zip(res["views"], whole))
        err = max(float(np.abs(v - w.cpu().numpy()).max())
                  for v, w in zip(res["views"], whole))
        print(f"[serve-mesh] rank {r}: gathered views "
              f"{res['views'][0].shape}; vs the one-process program on the "
              f"same rows: bitwise {same_blocks}; vs the one-process "
              f"request of all rows: bitwise {same} (max err {err!r})")
        if not (same_blocks and same):
            raise AssertionError(f"[serve-mesh] rank {r}: views differ")
    return out[0]["counts"]


def _rows_args(raw_batches) -> list:
    """Each batch's (image_seq, src_poses, tgt_poses) on the card."""
    from dynamic_multiview_3d_torch.data import synthetic
    return [[torch.as_tensor(np.asarray(x), device="cuda") for x in (
        synthetic.to_model(raw["image_seq"]), raw["src_poses"],
        raw["tgt_poses"])] for raw in raw_batches]


def _halves(module, args) -> dict:
    """``module``'s outputs on the rows of ``args`` run as two halves,
    joined."""
    n = args[0].shape[0] // 2
    parts = [module(*(a[i:i + n] for a in args)) for i in (0, n)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _recorded(module, run) -> list:
    """(name, output) of every submodule that returns a tensor, in the
    order of their calls in ``run()``."""
    seen = []
    handles = [m.register_forward_hook(
        lambda _, __, out, name=name: seen.append((name, out.float()))
        if isinstance(out, torch.Tensor) else None)
        for name, m in module.named_modules() if name]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return seen


def _first_divergence(module, args) -> dict | None:
    """The first submodule, in call order, whose output on the rows of
    ``args`` differs between one run of all of them and two runs of
    their halves, with its max and mean |difference|."""
    whole = _recorded(module, lambda: module(*args))
    n = args[0].shape[0] // 2
    parts = [_recorded(module, lambda i=i: module(*(a[i:i + n]
                                                     for a in args)))
             for i in (0, n)]
    for (name, w), (_, h0), (_, h1) in zip(whole, *parts):
        h = torch.cat([h0, h1])
        if h.shape == w.shape and not torch.equal(h, w):
            d = (h - w).abs()
            return {"module": name, "shape": list(w.shape),
                    "max": float(d.max()), "mean": float(d.mean())}
    return None


def _variant_alone(module, args) -> dict:
    """Every convolution, dense layer and GroupNorm that, given one input
    (the one it sees in a run of all the rows), returns other values for
    the two halves of its rows than for all of them: name -> max
    |difference|."""
    from dynamic_multiview_3d_torch.models import layers
    inputs = {}
    kinds = (layers.Conv, layers.Dense, layers.FastGroupNorm)
    handles = [m.register_forward_pre_hook(
        lambda _, a, name=name: inputs.setdefault(name, a[0]))
        for name, m in module.named_modules() if isinstance(m, kinds)]
    try:
        module(*args)
    finally:
        for h in handles:
            h.remove()
    out = {}
    for name, x in inputs.items():
        m = module.get_submodule(name)
        n = x.shape[0] // 2
        d = (m(x).float() - torch.cat([m(x[:n]), m(x[n:])]).float()).abs()
        if float(d.max()) > 0:
            out[name] = float(d.max())
    return out


def _edge_share(whole: dict, halves: dict) -> dict:
    """Where the views of the two runs differ by more than 0.1 (any
    channel): the share of those pixels whose warp validity differs
    between the runs, and whose flow sends the tap off the image in
    either run, beside that share over every pixel; the median |flow
    difference| in px there and the mean over every pixel."""
    big = ((whole["view"] - halves["view"]).abs().amax(-1) > 0.1)
    off = (whole["flow_valid"] == 0) | (halves["flow_valid"] == 0)
    dflow = (whole["flow"] - halves["flow"]).abs().amax(-1)
    n_big = int(big.sum())
    share = (lambda m: float(m[big].float().mean())) if n_big else \
        (lambda m: 0.0)
    return {"pixels": n_big,
            "validity_differs": share(whole["flow_valid"]
                                      != halves["flow_valid"]),
            "tap_off_image": share(off),
            "tap_off_image_all_pixels": float(off.float().mean()),
            "flow_diff_px_median": float(dflow[big].median()) if n_big
            else 0.0,
            "flow_diff_px_mean_all": float(dflow.mean())}


def phase_batch_gap(config, Model, raw_batches) -> dict:
    """[batch-gap] the c2 preset (seed-0 weights) on the 16 rows of 3 c2
    batches, and on the same rows as two halves of 8, in bf16 (the
    preset's dtype) and in f32, TF32 off, eager: the views' max and mean
    |difference| and the shares off by more than 1e-2 and 0.1; in bf16 the
    first module (forward hooks, in call order) whose output differs, the
    layers that differ given one input, and whether the pixels that
    differ most follow a flow that takes a tap off the image; then bf16
    again with TF32 on (PyTorch's default for cuDNN). All three must be
    bitwise: the layers in which cuDNN's bf16 result depends on the batch
    size compute in f32 with TF32 off (models/dmv3d.py ``_F32_CONVS``).
    -> the stats by dtype."""
    args = _rows_args(raw_batches[1:])
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32
    for dtype, tag in (("bfloat16", "bfloat16"), ("float32", "float32"),
                       ("bfloat16", "bfloat16, TF32 on")):
        cfg = config.get_config("c2", (f"model.dtype={dtype}",))
        module = Model.init_random(cfg, seed=0, device="cuda").module
        torch.backends.cudnn.allow_tf32 = "TF32" in tag
        with torch.inference_mode():
            whole = [module(*a) for a in args]
            halves = [_halves(module, a) for a in args]
            d = torch.cat([(w["view"] - h["view"]).abs().flatten()
                           for w, h in zip(whole, halves)])
            out[tag] = {"max": float(d.max()), "mean": float(d.mean()),
                        ">1e-2": float((d > 1e-2).float().mean()),
                        ">1e-1": float((d > 1e-1).float().mean())}
            print(f"[batch-gap] c2 {tag}, 16 rows against two halves of "
                  f"8, views |difference|: {out[tag]}")
            if tag == "bfloat16":
                first = _first_divergence(module, args[0])
                alone = _variant_alone(module, args[0])
                edge = _edge_share(whole[0], halves[0])
                print(f"[batch-gap] bf16: first module whose output differs "
                      f"(call order): {first}")
                print(f"[batch-gap] bf16: layers whose output differs given "
                      f"one input ({len(alone)}): {alone}")
                print(f"[batch-gap] bf16: pixels off by > 0.1 and the "
                      f"flow's taps: {edge}")
                out[tag].update(first=first, alone=alone, edge=edge)
        torch.backends.cudnn.allow_tf32 = tf32
        del module, whole, halves
    if any(o["max"] != 0.0 for o in out.values()):
        raise AssertionError(f"[batch-gap] 16 rows and two halves of 8 "
                             f"differ: {out}")
    return out


def _rank_jobs(mesh, jobs) -> dict:
    """Each (name, fn, args) of ``jobs`` on this rank, in order, TF32 off
    as in the parent: {name: fn(mesh, *args)}."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return {name: fn(mesh, *args) for name, fn, args in jobs}


def phase_spawned_ranks(config, serving, synthetic, tstep, path,
                        raw_c2) -> dict:
    """[serve-mesh], [dp-reference] and [dp-c3md] on the same 2 ranks,
    processes spawned once on the card (gloo; a CUDA process takes tens
    of seconds to start), joined with a timeout; each phase checked in
    turn. -> their paths' launch counts (rank 0's)."""
    from dynamic_multiview_3d_torch.parallel import dryrun
    batches = [dict(image_seq=synthetic.to_model(raw["image_seq"]),
                    src_poses=raw["src_poses"], tgt_poses=raw["tgt_poses"])
               for raw in raw_c2]
    ref_cfg, ref_batches, sd = _dp_reference_inputs(config, synthetic,
                                                    tstep)
    with tempfile.TemporaryDirectory(prefix="dmv3d_dp_c3md_") as tmp:
        jobs = [("serve-mesh", _serve_mesh_rank, (path, batches)),
                ("dp-reference", _dp_reference_rank,
                 (config.to_dict(ref_cfg), sd, ref_batches)),
                ("dp-c3md", _dp_c3md_rank, (os.path.join(tmp, "run"),))]
        t0 = time.perf_counter()
        out = dryrun.spawn(_rank_jobs, 2, (jobs,), device="cuda",
                           timeout_s=DP_TIMEOUT_S)
        print(f"[dp] 2 ranks spawned on the card, ran {[j[0] for j in jobs]}"
              f" and joined in {time.perf_counter() - t0:.2f} s")
    paths = {"serve_mesh": check_serve_mesh(
        [o["serve-mesh"] for o in out], path, serving, batches)}
    check_dp_reference([o["dp-reference"] for o in out], ref_cfg,
                       ref_batches, sd, tstep)
    paths["dp_c3md"] = check_dp_c3md([o["dp-c3md"] for o in out], config)
    return paths


# ---------------------------------------------------------- the model axis
# 4 processes on the one card, gloo, launched by torch.distributed.run
# on a (data=2, model=2) mesh: [tp-reference] then [tp-c4] in the same
# ranks (a CUDA process takes seconds to start).
TP_C4_SETS = ("mesh.data=2", "mesh.model=2", "train.num_steps=4",
              "train.ckpt_every=2", "train.log_every=2")


def _tp_c4_argv(cfg_sets, ckpt_dir, logdir):
    sets = TP_C4_SETS + tuple(cfg_sets) + (f"train.ckpt_dir={ckpt_dir}",)
    return ["--preset", "c4", *(a for s in sets for a in ("--set", s)),
            "--logdir", logdir, "--device", "cuda"]


def _replica_digests(state, blocks) -> dict:
    """SHA-256 of the rank's replicated tensors and of its blocks
    (params, Adam moments, EMA), each over the tensors' bytes in name
    order."""
    import hashlib
    params = dict(state.module.named_parameters())
    named = {}
    for n, p in params.items():
        named[f"param {n}"] = p
        for k, v in sorted(state.optimizer.state[p].items()):
            if k != "step":
                named[f"{k} {n}"] = v
    named.update({f"ema {n}": t for n, t in (state.ema or {}).items()})
    out = {}
    for kind in ("replicated", "blocks"):
        h, count = hashlib.sha256(), 0
        for key in sorted(named):
            if (key.split(" ", 1)[1] in blocks) == (kind == "blocks"):
                h.update(key.encode())
                h.update(named[key].detach().reshape(-1).contiguous()
                         .view(torch.uint8).cpu().numpy().tobytes())
                count += 1
        out[kind] = [h.hexdigest(), count]
    return out


@contextlib.contextmanager
def _model_axis_traffic(mesh_lib):
    """Bytes, host seconds and calls of the model axis's collectives (the
    activations' all-gather, the input gradients' f32 all-reduce), each
    between two synchronizes, by wrapping the two functions of
    ``parallel/mesh.py`` that ``parallel/tensor.py`` calls."""
    rec = {"gather": [0, 0.0, 0], "reduce": [0, 0.0, 0]}
    gather, reduce = mesh_lib.all_gather_model, mesh_lib.all_reduce_model

    def timed(kind, fn):
        def run(mesh, x, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = fn(mesh, x, *args)
            torch.cuda.synchronize()
            r = rec[kind]
            r[0] += y.numel() * (y.element_size() if kind == "gather" else 4)
            r[1] += time.perf_counter() - t0
            r[2] += 1
            return y
        return run

    mesh_lib.all_gather_model = timed("gather", gather)
    mesh_lib.all_reduce_model = timed("reduce", reduce)
    try:
        yield rec
    finally:
        mesh_lib.all_gather_model, mesh_lib.all_reduce_model = gather, reduce


def _tp_c4_rank(out: str) -> int:
    """A rank of [tp-reference] and [tp-c4] under torch.distributed.run on
    a (data=2, model=2) mesh: the tiny config's step (TF32 off), then
    cli.train of the c4 preset (4 steps, counted and timed), a 2 + 2
    resume pair against it (cudnn.deterministic), and 2 more steps with
    the model axis's collectives timed; writes rank<r>.pt into ``out``."""
    config, mesh_lib, counted = _port()
    from dynamic_multiview_3d_torch.cli import train as train_cli
    from dynamic_multiview_3d_torch.data import pipeline
    from dynamic_multiview_3d_torch.parallel import tensor as tensor_lib
    from dynamic_multiview_3d_torch.train import loop as loop_lib
    from dynamic_multiview_3d_torch.train import step as tstep
    mesh = mesh_lib.make_mesh(config.MeshConfig(data=2, model=2),
                              device="cuda")
    ref = torch.load(os.path.join(out, "reference.pt"), weights_only=False)
    res = {"rank": mesh.rank, "backend": mesh.backend,
           "device": str(mesh.device),
           "reference": _dp_reference_rank(mesh, ref["cfg"], ref["sd"],
                                           ref["batches"])}
    torch.backends.cudnn.allow_tf32 = True          # PyTorch's default
    torch.backends.cudnn.deterministic = True
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(counted)
    with _loop_timers(loop_lib, counted) as (times, summary_counts):
        t0 = time.perf_counter()
        state_a, _ = train_cli.main(_tp_c4_argv(
            (), os.path.join(out, "a"), os.path.join(out, "logs_a")))
        torch.cuda.synchronize()
        res["wall_s"] = time.perf_counter() - t0
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["counts"], res["summary_counts"] = _read_counts(counted), \
        dict(summary_counts)
    res["step_ms"] = [1e3 * x for x in times["step"]]
    res["batch_ms"] = [1e3 * x for x in times["batch"]]
    blocks = tensor_lib.block_names(state_a.module)
    res["blocks"] = sorted(blocks)
    res["params"] = sum(p.numel() for p in state_a.module.parameters())
    res["replicas"] = _replica_digests(state_a, blocks)
    full_a = tensor_lib.full_state(state_a, mesh)
    res["full_digest"] = _state_digest(full_a)
    _reset_counts(counted)
    with _loop_timers(loop_lib, counted):    # summaries apart
        try:
            train_cli.main(_tp_c4_argv(("train.fail_after_step=1",),
                                       os.path.join(out, "b"),
                                       os.path.join(out, "logs_b")))
            raise AssertionError("no FaultInjected")
        except loop_lib.FaultInjected:
            pass
        state_b, _ = train_cli.main(_tp_c4_argv(
            (), os.path.join(out, "b"), os.path.join(out, "logs_b")))
    res["resume_counts"] = _read_counts(counted)
    res["resume_diff"] = _same_state(full_a, tensor_lib.full_state(state_b,
                                                                   mesh))
    res["step_b"] = state_b.step
    del full_a, state_a
    # the model axis's traffic: 2 more steps on the next batches
    cfg = config.get_config("c4", TP_C4_SETS)
    batch_fn = loop_lib._make_batch_fn(cfg, pipeline.make_source(cfg.data),
                                       mesh=mesh)
    step = tstep.make_train_step(cfg, mesh=mesh)
    batches = [batch_fn(s) for s in (4, 5)]
    torch.cuda.synchronize()
    with _model_axis_traffic(mesh_lib) as traffic:
        t0 = time.perf_counter()
        for batch in batches:
            step(state_b, batch)
        res["traffic_steps_s"] = time.perf_counter() - t0
    res["traffic"] = traffic
    torch.save(res, os.path.join(out, f"rank{mesh.rank}.pt"))
    mesh_lib.shutdown()
    return 0


def phase_tp(config, synthetic, pipeline, tstep) -> dict:
    """[tp-reference] and [tp-c4]: 4 ranks on the card (gloo), launched by
    torch.distributed.run, each running ``_tp_c4_rank``. [tp-reference]:
    ``check_dp_reference`` on the (2, 2) mesh, min_size 16. [tp-c4]: the c4
    preset at full width through cli.train with mesh.data=2 mesh.model=2
    (its 8 devices become a (2, 2) mesh on the one card; the global batch
    of 64 kept, 32 a data rank), cudnn.deterministic: 4 steps checkpointed
    and logged every 2, #1 and #3 4 launches a rank (rank 0's image
    summaries apart), a 2 + 2 resume pair bitwise equal to 4 straight
    steps (gathered params and moments), only rank 0's files, replicated
    tensors bitwise equal on every rank and each block between its data
    ranks; the manager's step 4 restored into a one-process CPU c4
    template equals the gathered state (digests); the first step's loss
    within 1e-2 relative of one process's c4 step on the same weights and
    global batch (bf16). Prints the state bytes a rank beside one
    process's, the step p50, the model axis's bytes and ms a step and the
    peak memory a rank. -> rank 0's launch counts."""
    from dynamic_multiview_3d_torch.parallel import dryrun
    from dynamic_multiview_3d_torch.train import checkpoint as ckpt_lib
    from dynamic_multiview_3d_torch.train import loop as loop_lib
    full = config.get_config("c4")
    cfg = config.get_config("c4", TP_C4_SETS)
    b, k = cfg.data.batch_size, cfg.data.num_targets
    ref_cfg, ref_batches, sd = _dp_reference_inputs(config, synthetic, tstep)
    print(f"[tp-c4] c4 preset: {cfg.model.image_size}^2, B = {b} global "
          f"({b // 2} a data rank), T = {cfg.data.seq_len}, K = {k}, "
          f"{cfg.model.dtype}; mesh {full.mesh.data} x {full.mesh.model} "
          f"-> data 2 x model 2 (4 ranks on one card)")
    with tempfile.TemporaryDirectory(prefix="dmv3d_tp_c4_") as out:
        torch.save({"cfg": config.to_dict(ref_cfg), "sd": sd,
                    "batches": ref_batches},
                   os.path.join(out, "reference.pt"))
        argv = [sys.executable, "-m", "torch.distributed.run", "--nnodes",
                "1", "--nproc-per-node", "4", "--master-addr", "127.0.0.1",
                "--master-port", str(dryrun.free_port()),
                os.path.abspath(__file__), "--tp-c4-rank", out]
        t0 = time.perf_counter()
        run = subprocess.run(argv, capture_output=True, text=True,
                             timeout=DP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        print(run.stdout[-3000:], end="")
        if run.returncode:
            print(run.stderr[-6000:], file=sys.stderr)
            raise AssertionError(f"[tp-c4]: the launcher exited "
                                 f"{run.returncode}")
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"),
                            weights_only=False) for r in range(4)]
        check_dp_reference([r["reference"] for r in ranks], ref_cfg,
                           ref_batches, sd, tstep, tag="tp-reference",
                           model=2)

        want = {"warp_composite_fwd": 4, "warp_composite_bwd": 4,
                "warp_composite_bwd:composite": 4, "stage:copies": 4}
        one_bytes = 16 * sum(p.numel() for p in tstep.init_state(
            cfg, device="cpu").module.parameters())
        for r, res in enumerate(ranks):
            _expect_counts(f"tp-c4 rank {r}", res["counts"], want)
            _expect_counts(f"tp-c4 rank {r} resume pair",
                           res["resume_counts"], want)
            summaries = 2 if r == 0 and any(res["summary_counts"].values()) \
                else 0
            _expect_counts(f"tp-c4 rank {r} image summaries",
                           res["summary_counts"], {
                               "warp_composite_fwd": summaries,
                               "stage:copies": summaries})
            steps = np.asarray(res["step_ms"])
            tr = res["traffic"]
            print(f"[tp-c4] rank {r} ({res['backend']}, {res['device']}): "
                  f"{len(res['blocks'])} weights split; state (params, "
                  f"gradients, Adam moments: 16 B a param) "
                  f"{16 * res['params']} B a rank vs {one_bytes} B in one "
                  f"process; 4 steps in {res['wall_s']!r} s; train step p50 "
                  f"{float(np.percentile(steps, 50))!r} ms (steps "
                  f"{res['step_ms']!r}), host batch p50 "
                  f"{float(np.percentile(res['batch_ms'], 50))!r} ms; "
                  f"model axis a step (2 steps timed, "
                  f"{res['traffic_steps_s']!r} s): gathered "
                  f"{tr['gather'][0] // 2} B in {tr['gather'][2] // 2} "
                  f"calls, {1e3 * tr['gather'][1] / 2!r} ms; reduced "
                  f"{tr['reduce'][0] // 2} B (f32) in {tr['reduce'][2] // 2}"
                  f" calls, {1e3 * tr['reduce'][1] / 2!r} ms; peak memory "
                  f"{res['peak_bytes']} B; resumed 2 + 2 vs 4 straight "
                  f"(cudnn.deterministic): {len(res['resume_diff'])} "
                  f"tensors differ")
            if res["resume_diff"] or res["step_b"] != 4 or not res["blocks"]:
                raise AssertionError(f"[tp-c4] rank {r}: resume not exact "
                                     f"{res['resume_diff']}")
        reps = [res["replicas"] for res in ranks]
        print(f"[tp-c4] digests (replicated, blocks) by rank: {reps}")
        if any(rep["replicated"] != reps[0]["replicated"] for rep in reps) \
                or any(reps[r]["blocks"] != reps[r + 2]["blocks"]
                       for r in (0, 1)) \
                or reps[0]["blocks"] == reps[1]["blocks"]:
            raise AssertionError("[tp-c4]: replicas differ, or model peers "
                                 "hold the same blocks")
        _check_replicas("tp-c4 gathered", [res["full_digest"]
                                           for res in ranks])
        files = {d: sorted(os.listdir(os.path.join(out, d)))
                 for d in ("a", "b", "logs_a")}
        with open(os.path.join(out, "logs_a", "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        events = [n for n in files["logs_a"] if n.startswith("events")]
        print(f"[tp-c4] launcher wall {wall:.2f} s; files: {files}; metrics "
              f"logged at {[m['step'] for m in logged]}")
        if files["a"] != ["1", "2", "4", "model", "train_config.json"] \
                or [m["step"] for m in logged] != [1, 2, 4] \
                or len(events) > 1:
            raise AssertionError("[tp-c4]: a rank other than 0 wrote, or "
                                 "rank 0 did not")

        # the mesh's manager step in one process on the CPU
        cpu = tstep.init_state(cfg, device="cpu")
        ckpt_lib.make_manager(os.path.join(out, "a")).restore(4, cpu)
        same = _state_digest(cpu) == ranks[0]["full_digest"]
        print(f"[tp-c4] manager step 4 of the (2, 2) mesh restored into a "
              f"one-process CPU c4 template: digests equal to the gathered "
              f"state: {same}")
        if not same or cpu.step != 4:
            raise AssertionError("[tp-c4]: the manager step is not the "
                                 "gathered state")
        del cpu

    # the first step against one process on the global batch
    one = tstep.init_state(cfg, device="cuda")
    batch = loop_lib._make_batch_fn(cfg, pipeline.make_source(cfg.data))(0)
    _, m = tstep.make_train_step(cfg, device="cuda")(one, batch)
    err = abs(logged[0]["loss/total"] - m["loss/total"]) / m["loss/total"]
    print(f"[tp-c4] first step's loss: (2, 2) mesh {logged[0]['loss/total']!r}"
          f", one process on the {b} rows {m['loss/total']!r}, relative "
          f"{err!r} (bf16)")
    if not err <= 1e-2:
        raise AssertionError(f"[tp-c4]: first loss off by {err}")
    del one
    return ranks[0]["counts"]


# checkpoints the JAX package wrote (tests/_make_torch_orbax_goldens.py):
# each fixture dir and its Orbax tree
JAX_ORBAX = os.path.join("tests", "torch_goldens", "jax_orbax")
JAX_FIXTURES = {"c2_model": "params_3", "c3md_model": "params_5",
                "c2_run": "1/default"}
JAX_TOL = 1e-4          # [reference]'s, the CPU tests' port-to-JAX bound


def _leaf_digest(a) -> str:
    """tests/_make_torch_orbax_goldens.py's ``leaf_digest``: sha256 of the
    dtype name, shape and C-order bytes (a bf16 tensor by its bits)."""
    if torch.is_tensor(a):
        name, shape = "bfloat16", tuple(a.shape)
        data = a.contiguous().view(torch.int16).numpy().tobytes()
    else:
        a = np.ascontiguousarray(a)
        name, shape, data = a.dtype.name, a.shape, a.tobytes()
    head = f"{name}|{','.join(map(str, shape))}|".encode()
    return hashlib.sha256(head + data).hexdigest()


def _close_to_jax(tag, views, want) -> float:
    """max |views - want| / (1 + |want|), which must be <= JAX_TOL."""
    got = views.float().cpu().numpy()
    if got.shape != want.shape:
        raise AssertionError(f"[{tag}] views {got.shape}, JAX's {want.shape}")
    gap = float((np.abs(got - want) / (1 + np.abs(want))).max())
    print(f"[{tag}] views vs the JAX model's: max |d| / (1 + |ref|) "
          f"{gap!r} (bound {JAX_TOL})")
    if not gap <= JAX_TOL:
        raise AssertionError(f"[{tag}] the views differ from JAX's")
    return gap


def phase_jax_ckpt(config, Model, synthetic, counted, raw_batches,
                   card) -> dict:
    """[jax-ckpt] checkpoints the JAX package wrote, read on the card's
    machine by the port's own Orbax reader (no JAX, no tensorstore), and a
    full-width c2 model through the port's Orbax writer and back."""
    from dynamic_multiview_3d_torch import weights
    from dynamic_multiview_3d_torch.cli import predict as predict_cli
    from dynamic_multiview_3d_torch.cli import snapshot as snapshot_cli
    from dynamic_multiview_3d_torch.train import orbax

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        JAX_ORBAX)
    expected = np.load(os.path.join(root, "expected.npz"))
    paths = {}
    # (a) every leaf of each fixture, bitwise to tensorstore's digests
    for name, sub in JAX_FIXTURES.items():
        t0 = time.perf_counter()
        leaves = orbax.read_orbax(os.path.join(root, name, sub))
        secs = time.perf_counter() - t0
        prefix = f"sha256/{name}/{sub}/"
        want = {k[len(prefix):]: str(expected[k]) for k in expected.files
                if k.startswith(prefix)}
        got = {k: _leaf_digest(v) for k, v in leaves.items()}
        bad = sorted(k for k in set(want) | set(got)
                     if want.get(k) != got.get(k))
        print(f"[jax-ckpt] {name}/{sub}: {len(got)} leaves read in "
              f"{secs!r} s, {len(bad)} differ from tensorstore's digests")
        if bad or not got:
            raise AssertionError(f"[jax-ckpt] {name}: leaves {bad[:5]}")

    # (b) the model fixtures on the card, f32 exact, TF32 off
    for name, kernel in (("c2_model", {"warp_composite_fwd": 1,
                                       "stage:copies": 1}),
                         ("c3md_model", {"multiflow_composite_fwd": 1})):
        x = {k: expected[f"inputs/{name}/{k}"] for k in ("seq", "src", "tgt")}
        model = Model.from_checkpoint(os.path.join(root, name), device="cuda")
        _reset_counts(counted)
        views = model.predict(x["seq"], x["tgt"], source_poses=x["src"])
        torch.cuda.synchronize()
        paths[f"jax_ckpt_{name}"] = counts = _read_counts(counted)
        _expect_counts(f"jax-ckpt {name}", counts, kernel)
        _close_to_jax(f"jax-ckpt {name}", views, expected[f"views/{name}"])

    with tempfile.TemporaryDirectory(prefix="dmv3d_jax_ckpt_") as tmp:
        # (c) cli.snapshot of the JAX run dir, then cli.predict of it
        snap = os.path.join(tmp, "snap")
        line = json.loads(_run_cli(snapshot_cli.main, [
            "--ckpt-dir", os.path.join(root, "c2_run"), "--out", snap])
            .strip().splitlines()[-1])
        if line != {"out": snap, "step": 1, "ema": True}:
            raise AssertionError(f"[jax-ckpt] snapshot: {line}")
        state = orbax.read_orbax(os.path.join(root, "c2_run", "1",
                                              "default"))
        model = Model.from_checkpoint(snap, device="cuda")
        sd = model.module.state_dict()
        ema = weights.from_flax({k[len("ema_params/"):]: v for k, v in
                                 state.items()
                                 if k.startswith("ema_params/")},
                                model.module)
        differ = [k for k, v in ema.items() if not torch.equal(
            v, sd[k].cpu())]
        print(f"[jax-ckpt] snapshot of the JAX run: {line}; the model dir "
              f"differs from the step's EMA params in {len(differ)} tensors")
        if differ:
            raise AssertionError(f"[jax-ckpt] snapshot is not the EMA: "
                                 f"{differ[:5]}")
        x = {k: expected[f"inputs/c2_run/{k}"] for k in ("seq", "src", "tgt")}
        _close_to_jax("jax-ckpt c2_run", model.predict(
            x["seq"], x["tgt"], source_poses=x["src"]),
            expected["views/c2_run"])
        _reset_counts(counted)
        _run_cli(predict_cli.main, ["--ckpt", snap, "--out",
                                    os.path.join(tmp, "views"),
                                    "--device", "cuda"])
        torch.cuda.synchronize()
        paths["jax_ckpt_predict_cli"] = counts = _read_counts(counted)
        _expect_counts("jax-ckpt predict-cli", counts,
                       {"warp_composite_fwd": 1, "stage:copies": 1})
        names = sorted(os.listdir(os.path.join(tmp, "views")))
        if names != ["source.png"] + [f"view_{i:02d}.png" for i in range(4)]                 or any(_png_pixels(os.path.join(tmp, "views", n)).shape
                       != (32, 32, 3) for n in names):
            raise AssertionError(f"[jax-ckpt] cli.predict wrote {names}")

        # (d) full width: the c2 preset through the Orbax writer and back
        cfg = config.get_config("c2")
        model = Model.init_random(cfg, seed=0, device="cuda")
        path = os.path.join(tmp, "c2_orbax")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.save_checkpoint(path, step=0, fmt="orbax")
        t_save = time.perf_counter() - t0
        nbytes = _dir_bytes(path)
        t0 = time.perf_counter()
        back = Model.from_checkpoint(path, device="cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        sd, sd_back = model.module.state_dict(), back.module.state_dict()
        differ = [k for k in sd if not torch.equal(sd[k], sd_back[k])]
        n_params = sum(p.numel() for p in model.module.parameters())
        print(f"[jax-ckpt] c2 preset ({n_params} params, f32 as stored) "
              f"written as Orbax: {nbytes} bytes in {t_save!r} s; read back "
              f"by Model.from_checkpoint onto the card in {t_load!r} s "
              f"({nbytes / t_load / 1e6!r} MB/s); state_dict differs in "
              f"{len(differ)} tensors; {card}")
        if differ or sorted(sd) != sorted(sd_back):
            raise AssertionError(f"[jax-ckpt] c2 round trip: {differ[:5]}")
        batches = [dict(raw, image_seq=synthetic.to_model(raw["image_seq"]))
                   for raw in raw_batches[1:4]]

        def requests(m):
            return [m.predict(b["image_seq"], b["tgt_poses"],
                              source_poses=b["src_poses"]) for b in batches]
        ref = requests(model)
        torch.cuda.synchronize()
        _reset_counts(counted)
        views = requests(back)
        torch.cuda.synchronize()
        paths["jax_ckpt_c2"] = counts = _read_counts(counted)
        _expect_counts("jax-ckpt c2", counts, {"warp_composite_fwd": 3,
                                               "stage:copies": 3})
        same = [bool(torch.equal(v, r)) for v, r in zip(views, ref)]
        print(f"[jax-ckpt] 3 c2 requests (B = 16, T = 1, K = 8) from the "
              f"read-back model vs the original: bitwise {same}")
        if not all(same):
            raise AssertionError("[jax-ckpt] the read-back model predicts "
                                 "otherwise")
    return paths


# [jax-resume]: a training run moved between the JAX package and the card.
# The committed JAX run tests/torch_goldens/jax_orbax/c2_adam_run (written
# by tests/_make_torch_orbax_goldens.py) stopped at step 2 of 3: the c2
# preset at its tiny widths (JAX_TINY) with JAX_ADAM (adamw, cosine lr
# with a warmup step, EMA); the TF1 fixture tests/torch_goldens/tf1 (by
# tests/_make_torch_tf1_goldens.py) is the c2 preset at JAX_TINY
JAX_TINY = ("model.image_size=32", "model.num_levels=3",
            "model.base_features=8", "model.max_features=16",
            "model.gru_features=16", "model.pose_embed_dim=8",
            "model.dtype=float32", "model.use_pallas=False",
            "data.image_size=32", "model.warp_precision=exact")
JAX_ADAM = ("train.optimizer=adamw", "train.weight_decay=0.01",
            "train.lr_schedule=cosine", "train.warmup_steps=1",
            "train.ema_decay=0.9", "train.lr=1e-3", "train.num_steps=3",
            "train.ckpt_every=1", "train.log_every=1", "data.batch_size=2",
            "data.num_scenes=2", "mesh.data=1")
JAX_RUN = "c2_adam_run"
TF1_FIXTURE = os.path.join("tests", "torch_goldens", "tf1")
# (b): the c2 preset, 2 steps, a JAX-layout manager step, 2 more
RESUME_C2_SETS = ("train.num_steps=4", "train.ckpt_every=2",
                  "train.log_every=2")


def _flax_sub(flat: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in flat.items()
            if k.startswith(prefix + "/")}


def _adamw_update(cfg, t: int, p, m, v, g):
    """The params after optax.adamw's t-th update (scale_by_adam, eps 1e-8;
    add_decayed_weights; the scheduled lr), written out in float64 from
    the moments before it and the gradient."""
    from dynamic_multiview_3d_torch.train import step as tstep
    b1, b2 = cfg.train.beta1, cfg.train.beta2
    lr = tstep.make_lr(cfg)(t - 1)
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    u = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + 1e-8)
    return p - lr * (u + cfg.train.weight_decay * p)


def _adam_gap_bounds(cfg, t: int, nu_before: dict, gap: dict) -> dict:
    """How far Adam's t-th update can move a parameter apart between two
    gradients ``gap`` apart (tests/test_torch_jax_resume.py ``_bounds``):
    1e-4 plus the integral of |du/dg| <= lr ((1 - b1) / c1 + R sqrt((1 -
    b2) / c2)) / (sqrt(b2 v_before / c2) + eps) over the gap, capped at 2
    lr R, R the Cauchy-Schwarz bound on |m_hat| / sqrt(v_hat)."""
    from dynamic_multiview_3d_torch.train import step as tstep
    b1, b2 = cfg.train.beta1, cfg.train.beta2
    lr = tstep.make_lr(cfg)(t - 1)
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    r = ((1 - b1) / (1 - b2) ** 0.5
         * sum((b1 * b1 / b2) ** k for k in range(t)) ** 0.5
         * c2 ** 0.5 / c1)
    gain = lr * ((1 - b1) / c1 + r * ((1 - b2) / c2) ** 0.5)
    return {n: 1e-4 + (gain * g / ((b2 * nu_before[n].double() / c2).sqrt()
                                   + 1e-8)).clamp(max=2 * lr * r)
            for n, g in gap.items()}


def _ema_diff(a, b) -> list:
    if (a.ema is None) != (b.ema is None):
        return ["ema present on one side"]
    return [f"ema {n}" for n in a.ema or {}
            if not torch.equal(a.ema[n], b.ema[n])]


def _jax_step_timed(ckpt_lib, tstep, cfg, run: str, step: int,
                    copy: str) -> tuple:
    """The manager's restore of the JAX-layout ``step`` onto the card and
    its save of that state in the JAX layout again, each timed; the copy
    restored once more must equal it bitwise. -> (restore s, save s)."""
    state = tstep.init_state(cfg, seed=1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt_lib.make_manager(run, cfg=cfg).restore(step, state)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt_lib.make_manager(copy, cfg=cfg, fmt="orbax").save(step, state,
                                                           force=True)
    t_save = time.perf_counter() - t0
    back = tstep.init_state(cfg, seed=2, device="cuda")
    ckpt_lib.make_manager(copy, cfg=cfg).restore(step, back)
    diff = list(_same_state(state, back)) + _ema_diff(state, back)
    if diff or back.step != step:
        raise AssertionError(f"[jax-resume] the JAX layout round trip "
                             f"differs: {diff[:5]}")
    return t_restore, t_save


def phase_jax_resume(config, counted, c3md_run, card) -> dict:
    """[jax-resume] (a) the committed JAX run resumed on the card through
    cli.train, (b) / (c) full-width c2 and c3md runs through a JAX-layout
    step and back, (d) the TF1 fixture imported and served. -> each
    path's launch counts."""
    from dynamic_multiview_3d_torch import weights
    from dynamic_multiview_3d_torch.api import Model
    from dynamic_multiview_3d_torch.cli import train as train_cli
    from dynamic_multiview_3d_torch.models import DMV3D
    from dynamic_multiview_3d_torch.train import checkpoint as ckpt_lib
    from dynamic_multiview_3d_torch.train import loop as loop_lib
    from dynamic_multiview_3d_torch.train import step as tstep
    from dynamic_multiview_3d_torch.train import tf1

    here = os.path.dirname(os.path.abspath(__file__))
    expected = np.load(os.path.join(here, JAX_ORBAX, "expected.npz"))
    paths = {}
    warp = {"warp_composite_fwd": 1, "warp_composite_bwd": 1,
            "warp_composite_bwd:composite": 1, "stage:copies": 1}

    def argv(preset, sets, logdir):
        return ["--preset", preset, *(a for s in sets for a in ("--set", s)),
                "--logdir", logdir, "--device", "cuda"]

    with tempfile.TemporaryDirectory(prefix="dmv3d_jax_resume_") as tmp:
        # (a) step 3 of the JAX run, on the card through cli.train
        run = os.path.join(tmp, "a")
        shutil.copytree(os.path.join(here, JAX_ORBAX, JAX_RUN), run)
        sets = JAX_TINY + JAX_ADAM + (f"train.ckpt_dir={run}",)
        cfg = config.get_config("c2", sets)
        with open(os.path.join(run, "train_config.json")) as f:
            if config.override(config.from_dict(json.load(f)),
                               [f"train.ckpt_dir={run}"]) != cfg:
                raise AssertionError("[jax-resume] the overrides are not the "
                                     "JAX run's config")
        before = ckpt_lib.read_jax_step(run, 2)
        _reset_counts(counted)
        with _loop_timers(loop_lib, counted) as (_, summary_counts):
            state, metrics = train_cli.main(argv("c2", sets,
                                                 os.path.join(tmp, "la")))
            torch.cuda.synchronize()
        paths["jax_resume_tiny"] = counts = _read_counts(counted)
        _expect_counts("jax-resume tiny", counts, dict(warp))
        module = state.module
        p0, m0, v0 = (weights.from_flax(_flax_sub(before, k), module)
                      for k in ("params", "opt_state/0/mu",
                                "opt_state/0/nu"))
        jax3 = {k[len(JAX_RUN) + 1:]: expected[k] for k in expected.files
                if k.startswith(JAX_RUN + "/")}
        p3, m3 = (weights.from_flax(_flax_sub(jax3, k), module)
                  for k in ("params", "mu"))
        b1 = cfg.train.beta1
        own, gap = {}, {}
        for n, p in module.named_parameters():
            g = p.grad.double().cpu()
            ref = _adamw_update(cfg, 3, p0[n].double(), m0[n].double(),
                                v0[n].double(), g)
            own[n] = float((p.detach().double().cpu() - ref).abs().max())
            gap[n] = (g - (m3[n].double() - b1 * m0[n].double())
                      / (1 - b1)).abs()
        bounds = _adam_gap_bounds(cfg, 3, v0, gap)
        far = {n: float((p.detach().double().cpu() - p3[n].double()).abs()
                        .max())
               for n, p in module.named_parameters()
               if ((p.detach().double().cpu() - p3[n].double()).abs()
                   > bounds[n]).any()}
        loss, want = metrics["loss/total"], float(expected[f"{JAX_RUN}/loss"])
        rel = abs(loss - want) / abs(want)
        worst = max(own.values())
        print(f"[jax-resume] (a) the JAX run's step 2 resumed on the card "
              f"for step {state.step} through cli.train (f32, warp exact, "
              f"TF32 off): loss {loss!r} vs JAX's {want!r}, relative "
              f"{rel!r} (bound 1e-05); params vs optax.adamw's update of "
              f"the JAX step with the card's gradients: max |d| {worst!r} "
              f"(bound 1e-06); vs the JAX loop's step 3, beyond 1e-4 plus "
              f"what Adam makes of the gradients' difference: {far}; "
              f"image summaries apart: {summary_counts}")
        if not (rel <= 1e-5 and worst <= 1e-6) or far or state.step != 3:
            raise AssertionError("[jax-resume] (a) the resumed step differs "
                                 "from JAX's")
        back = tstep.init_state(cfg, seed=1, device="cuda")
        ckpt_lib.make_manager(run, cfg=cfg).restore(3, back)
        diff = list(_same_state(state, back)) + _ema_diff(state, back)
        print(f"[jax-resume] (a) the step it wrote: manager steps "
              f"{ckpt_lib.manager_steps(run)}, JAX layout "
              f"{ckpt_lib.is_jax_step(run, 3)}, read back: {len(diff)} "
              f"tensors differ")
        if diff or back.step != 3 or not ckpt_lib.is_jax_step(run, 3):
            raise AssertionError(f"[jax-resume] (a) step 3: {diff[:5]}")
        del state, back

        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            # (b) the c2 preset: 2 steps, a JAX-layout step, 2 more
            sets_b = RESUME_C2_SETS + (
                f"train.ckpt_dir={os.path.join(tmp, 'b')}",)
            cfg_b = config.get_config("c2", sets_b)
            whole, _ = loop_lib.train(config.override(cfg_b, [
                f"train.ckpt_dir={os.path.join(tmp, 'b_whole')}"]),
                device="cuda")
            try:
                loop_lib.train(config.override(cfg_b, [
                    "train.fail_after_step=1"]), device="cuda",
                    ckpt_format="orbax")
                raise AssertionError("no FaultInjected")
            except loop_lib.FaultInjected:
                pass
            step_dir = os.path.join(tmp, "b", "2")
            nbytes = _dir_bytes(step_dir)
            t_restore, t_save = _jax_step_timed(
                ckpt_lib, tstep, cfg_b, os.path.join(tmp, "b"), 2,
                os.path.join(tmp, "b_copy"))
            _reset_counts(counted)
            with _loop_timers(loop_lib, counted) as (_, summary_counts):
                resumed, _ = train_cli.main(argv("c2", sets_b,
                                                 os.path.join(tmp, "lb")))
                torch.cuda.synchronize()
            paths["jax_resume_c2"] = counts = _read_counts(counted)
            _expect_counts("jax-resume c2", counts,
                           {k: 2 * v for k, v in warp.items()})
            diff = list(_same_state(whole, resumed)) + _ema_diff(whole,
                                                                 resumed)
            n_params = sum(p.numel() for p in whole.module.parameters())
            print(f"[jax-resume] (b) c2 preset ({n_params} params, Adam): "
                  f"a JAX-layout manager step of {nbytes} bytes (params and "
                  f"both moments, f32 raw blocks), restored onto the card "
                  f"in {t_restore!r} s, saved in {t_save!r} s; cli.train "
                  f"resumed it for steps 3-4 (manager steps "
                  f"{ckpt_lib.manager_steps(os.path.join(tmp, 'b'))}, JAX "
                  f"layout {ckpt_lib.is_jax_step(os.path.join(tmp, 'b'), 4)}"
                  f"): {len(diff)} tensors differ from 4 uninterrupted "
                  f"steps (cudnn.deterministic); {card}")
            if diff or resumed.step != 4 \
                    or not ckpt_lib.is_jax_step(os.path.join(tmp, "b"), 4):
                raise AssertionError(f"[jax-resume] (b) c2: {diff[:5]}")
            del whole, resumed

            # (c) the c3md preset as [loop-c3md] runs it: one dispatch, a
            # JAX-layout step, a second dispatch, against its 32 steps
            sets_c = LOOP_C3MD_SETS + LOOP_C3MD_CUT + (
                f"train.ckpt_dir={os.path.join(tmp, 'c')}",)
            cfg_c = config.get_config("c3md", sets_c)
            src = c3md_run["source"]
            _reset_counts(counted)
            try:
                loop_lib.train(config.override(cfg_c, [
                    "train.fail_after_step=15"]), data_source=src,
                    device="cuda", ckpt_format="orbax")
                raise AssertionError("no FaultInjected")
            except loop_lib.FaultInjected:
                pass
            paths["jax_resume_c3md_cut"] = counts = _read_counts(counted)
            _expect_counts("jax-resume c3md cut", counts, {
                "multiflow_composite_fwd": 16, "multiflow_composite_bwd": 16})
            nbytes = _dir_bytes(os.path.join(tmp, "c", "16"))
            t_restore, t_save = _jax_step_timed(
                ckpt_lib, tstep, cfg_c, os.path.join(tmp, "c"), 16,
                os.path.join(tmp, "c_copy"))
            _reset_counts(counted)
            resumed, _ = loop_lib.train(cfg_c, data_source=src,
                                        device="cuda")
            torch.cuda.synchronize()
            paths["jax_resume_c3md"] = counts = _read_counts(counted)
            _expect_counts("jax-resume c3md", counts, {
                "multiflow_composite_fwd": 16, "multiflow_composite_bwd": 16})
        finally:
            torch.backends.cudnn.deterministic = prev
        whole = c3md_run["state"]
        diff = list(_same_state(whole, resumed)) + _ema_diff(whole, resumed)
        n_params = sum(p.numel() for p in whole.module.parameters())
        print(f"[jax-resume] (c) c3md preset ({n_params} params, Adam, "
              f"cosine lr; resident, device-sampled, 16 steps a dispatch, "
              f"{LOOP_C3MD_CUT[0]}): a JAX-layout manager step of {nbytes} "
              f"bytes, restored onto the card in {t_restore!r} s, saved in "
              f"{t_save!r} s; the second dispatch resumed from it (manager "
              f"steps {ckpt_lib.manager_steps(os.path.join(tmp, 'c'))}): "
              f"{len(diff)} tensors differ from [loop-c3md]'s 32 "
              f"uninterrupted steps (cudnn.deterministic); {card}")
        if diff or resumed.step != 32 \
                or not ckpt_lib.is_jax_step(os.path.join(tmp, "c"), 32):
            raise AssertionError(f"[jax-resume] (c) c3md: {diff[:5]}")
        del resumed

    # (d) the TF1 fixture, read with no TensorFlow, imported and served
    root = os.path.join(here, TF1_FIXTURE)
    prefix = os.path.join(root, "model.ckpt")
    tf_expected = np.load(os.path.join(root, "expected.npz"))
    with open(os.path.join(root, "name_map.json")) as f:
        name_map = json.load(f)
    t0 = time.perf_counter()
    reader = tf1.BundleReader(prefix)
    digests = {n: _leaf_digest(reader.tensor(n)) for n in reader.names()}
    t_read = time.perf_counter() - t0
    bad = sorted(n for n in digests
                 if str(tf_expected.get(f"sha256/{n}")) != digests[n])
    cfg = config.get_config("c2", JAX_TINY)
    module = DMV3D(cfg.model, num_sources=cfg.data.seq_len)
    module.load_state_dict(ckpt_lib.import_tf1_state_dict(prefix, name_map,
                                                          module))
    model = Model(cfg, module.to("cuda").eval())
    _reset_counts(counted)
    views = model.predict(tf_expected["inputs/seq"], tf_expected["inputs/tgt"],
                          source_poses=tf_expected["inputs/src"])
    torch.cuda.synchronize()
    paths["jax_resume_tf1"] = counts = _read_counts(counted)
    _expect_counts("jax-resume tf1", counts, {"warp_composite_fwd": 1,
                                              "stage:copies": 1})
    print(f"[jax-resume] (d) the TF1 checkpoint ({len(digests)} tensors) "
          f"read with no TensorFlow in {t_read!r} s, {len(bad)} differ "
          f"from TensorFlow's digests; imported through its name map of "
          f"{len(name_map)} names and served on the card")
    if bad:
        raise AssertionError(f"[jax-resume] (d) tensors {bad[:5]}")
    _close_to_jax("jax-resume tf1", views, tf_expected["views"])
    return paths


# the lines of bench_torch.py --preset: the JAX suite's config names and
# the key each must report
BENCH_PRESETS = {"c1": ("c1_single64", "views_per_sec"),
                 "c3": ("c3_dynamic", "views_per_sec"),
                 "c4": ("c4_train128", "steps_per_sec_per_chip"),
                 "c5": ("c5_multihost256",
                        "train256_steps_per_sec_per_chip_compute")}


def _bench(*args) -> list:
    """bench_torch.py run as a user runs it, with ``args``: its stderr
    and its JSON lines printed here; -> the lines."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "bench_torch.py")
    run = subprocess.run([sys.executable, script, *args],
                         capture_output=True, text=True, timeout=600)
    print(run.stderr[-2000:], end="")
    if run.returncode:
        raise AssertionError(f"[bench] bench_torch.py {list(args)} exited "
                             f"{run.returncode}")
    lines = run.stdout.strip().splitlines()
    for line in lines:
        print(line)
    return [json.loads(line) for line in lines]


def phase_bench() -> None:
    """[bench] bench_torch.py as a user runs it: the c2 headline's one
    line; then one line each for c1, c3, c4 and c5 on the card (one
    process), and c1 on the card's host CPU."""
    print("[bench] bench_torch.py (c2, DMV3D forward, CUDA events):")
    lines = _bench()
    if len(lines) != 1 or lines[0]["metric"] != \
            "novel_views_per_sec_per_chip_128px" or not lines[0]["value"] > 0:
        raise AssertionError(f"[bench] not one line of the metric: {lines}")
    print("[bench] bench_torch.py --preset c1 c3 c4 c5 (the JAX suite's "
          "per-chip slices):")
    lines = _bench("--preset", *BENCH_PRESETS)
    print("[bench] bench_torch.py --preset c1 --device cpu:")
    lines += _bench("--preset", "c1", "--device", "cpu", "--iters", "20")
    want = [(name, key, "cuda") for name, key in BENCH_PRESETS.values()] \
        + [("c1_single64_cpu", "views_per_sec", "cpu")]
    got = [(line["config"], line, line["backend"]) for line in lines]
    if len(got) != len(want) or any(
            (name, backend) != (g[0], g[2]) or not g[1][key] > 0
            for (name, key, backend), g in zip(want, got)):
        raise AssertionError(f"[bench] preset lines: {lines}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--dp-c4-rank"]:   # a rank of [dp-c4]'s launcher
        return _dp_c4_rank(sys.argv[2])
    if sys.argv[1:2] == ["--tp-c4-rank"]:   # a rank of [tp-c4]'s launcher
        return _tp_c4_rank(sys.argv[2])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dynamic_multiview_3d_torch import config
    from dynamic_multiview_3d_torch.data import native, pipeline, synthetic
    from dynamic_multiview_3d_torch import serving
    from dynamic_multiview_3d_torch.api import Model
    from dynamic_multiview_3d_torch.kernels import _build
    from dynamic_multiview_3d_torch.kernels import grid_sample as gs
    from dynamic_multiview_3d_torch.kernels import multiflow as mf
    from dynamic_multiview_3d_torch.kernels import reproject as rp
    from dynamic_multiview_3d_torch.models import DMV3D
    from dynamic_multiview_3d_torch.ops import pose as pose_ops
    from dynamic_multiview_3d_torch.train import step as tstep
    from dynamic_multiview_3d_torch.train import tf1
    from dynamic_multiview_3d_torch.utils import zstd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    def mark(tag):        # the run's wall split by phase
        print(f"[time] {time.perf_counter() - t_start:.1f} s: {tag}")
    counted = _counted(gs, mf, rp)
    packer_s = phase_build(_build, mf, native, zstd, tf1)
    mark("built; [pose], [data], c2 serve and train")
    card = phase_card()
    phase_pose(pose_ops)
    phase_data(config, packer_s)
    stats = {"warp_composite_fwd": phase_kernel(gs)}
    phase_reference(config, Model, DMV3D, synthetic)
    raw_batches = c2_batches(config, synthetic)
    paths = {"serve_c2": phase_serve(config, Model, synthetic, gs, counted,
                                     raw_batches)}
    stats["warp_composite_bwd"] = phase_kernel_bwd(gs)
    phase_train_reference(config, synthetic, tstep)
    paths["train_c2"], train_p50 = phase_train(config, tstep, counted,
                                               raw_batches)
    mark("[loop-c2]")
    loop_paths, loop_p50 = phase_loop_c2(config, counted, raw_batches,
                                         train_p50)
    paths.update(loop_paths)
    mark("[loop-c2-stream]")
    paths.update(phase_loop_c2_stream(config, counted, train_p50, loop_p50))
    mark("c3md kernels, serve and train")
    stats["multiflow_composite_fwd"] = phase_kernel_mf(mf)
    stats["multiflow_composite_bwd"] = phase_kernel_mf_bwd(mf)
    phase_reference_mf(config, Model, DMV3D, synthetic, tstep)
    raw_c3md = c3md_batches(config, pipeline)
    paths["serve_c3md"] = phase_serve_c3md(config, Model, synthetic, counted,
                                           raw_c3md)
    paths["train_c3md"], c3md_p50 = phase_train_c3md(config, tstep, counted,
                                                     raw_c3md)
    mark("[loop-c3md]")
    loop_c3md_paths, c3md_run = phase_loop_c3md(config, counted, c3md_p50)
    paths.update(loop_c3md_paths)
    mark("[jax-resume]")
    paths.update(phase_jax_resume(config, counted, c3md_run, card))
    del c3md_run
    mark("depth kernels, serve and train")
    stats["sample_fwd"] = phase_kernel_sample(gs)
    rp_inputs = {kind: _reproject_inputs(rp, pose_ops, synthetic,
                                         raw_batches[0], kind)
                 for kind in ("smooth", "random")}
    stats["reproject_sample_fwd"], stats["reproject_composite_fwd"] = \
        phase_kernel_reproject(rp, rp_inputs)
    stats["reproject_bwd"] = phase_kernel_reproject_bwd(rp, rp_inputs)
    phase_reference_depth(config, Model, DMV3D, synthetic, tstep)
    for variant, requests, steps, profile in (("c2d", 50, 30, True),
                                              ("c2g", 20, 10, False)):
        paths[f"serve_{variant}"] = phase_serve_depth(
            variant, config, Model, synthetic, gs, rp, pose_ops, counted,
            raw_batches, requests, profile)
        paths[f"train_{variant}"] = phase_train_depth(
            variant, config, tstep, counted, raw_batches, steps, profile)
    mark("c1, c3 and c5 kernels, serve and train")
    preset_paths, preset_stats = phase_presets(config, Model, synthetic,
                                               pipeline, gs, tstep, counted)
    paths.update(preset_paths)
    for name, part in (("warp_composite_fwd", "fwd"),
                       ("warp_composite_bwd", "bwd")):
        stats[name]["at_presets"] = {p: st[part]
                                     for p, st in preset_stats.items()}
    mark("[serve-artifact]")
    with tempfile.TemporaryDirectory(prefix="dmv3d_artifacts_") as keep:
        paths.update(phase_serve_artifact(config, Model, serving, synthetic,
                                          gs, mf, rp, counted, raw_batches,
                                          raw_c3md, keep))
        mark("[batch-gap]")
        phase_batch_gap(config, Model, raw_batches)
        mark("[serve-mesh], [dp-reference], [dp-c3md]")
        paths.update(phase_spawned_ranks(
            config, serving, synthetic, tstep,
            os.path.join(keep, "c2.dmv3d"), raw_batches))
    mark("[dp-c4]")
    paths["dp_c4"] = phase_dp_c4(config, tstep)
    mark("[tp-reference], [tp-c4]")
    paths["tp_c4"] = phase_tp(config, synthetic, pipeline, tstep)
    mark("[jax-ckpt]")
    paths.update(phase_jax_ckpt(config, Model, synthetic, counted,
                                raw_batches, card))
    mark("[bench]")
    phase_bench()
    mark("done")
    # each kernel: its source, the TPU kernel it replaces, and the path
    # whose launches are its own (the train step of its slice); the
    # launches of every path beside them. The depth backward has no TPU
    # kernel of its own: it replaces _sampling_bwd, which runs _bwd_kernel
    # (grid_sample_pallas.py:281) in zeros mode between XLA ops.
    table = {
        "warp_composite_fwd": ("warp_composite.cu",
                               "grid_sample_pallas.py:263", "train_c2"),
        "warp_composite_bwd": ("warp_composite_bwd.cu",
                               "grid_sample_pallas.py:281", "train_c2"),
        "multiflow_composite_fwd": ("multiflow_composite.cu",
                                    "multiflow_pallas.py:118", "train_c3md"),
        "multiflow_composite_bwd": ("multiflow_composite_bwd.cu",
                                    "multiflow_pallas.py:146", "train_c3md"),
        "sample_fwd": ("sample.cu", "grid_sample_pallas.py:253",
                       "train_c2d"),
        "reproject_sample_fwd": ("reproject.cu", "reproject_pallas.py:76",
                                 "train_c2g"),
        "reproject_composite_fwd": ("reproject.cu", "reproject_pallas.py:86",
                                    "train_c2d"),
        "reproject_bwd": ("reproject_bwd.cu", "reproject_pallas.py:226",
                          "train_c2d"),
    }
    kernels = [
        dict(name=name, route="cuda",
             source=f"dynamic_multiview_3d_torch/csrc/{src}",
             replaces=f"dynamic_multiview_3d_tpu/kernels/{tpu}",
             launches=paths[own][name],
             launches_by_path={path: c[name] for path, c in paths.items()},
             **stats[name])
        for name, (src, tpu, own) in table.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
